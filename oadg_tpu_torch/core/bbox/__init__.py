from .assign_sample import (ApproxMaxIoUAssigner, AssignResult, ATSSAssigner, GridAssigner,
                            MaxIoUAssigner, RandomSampler, SamplingResult, TaskAlignedAssigner)
from .coder import DeltaXYWHBBoxCoder, YOLOBBoxCoder
from .geometry import bbox_overlaps
from .hungarian import HungarianAssigner, auction_assign

__all__ = ["ApproxMaxIoUAssigner", "AssignResult", "ATSSAssigner", "TaskAlignedAssigner",
           "GridAssigner", "MaxIoUAssigner", "RandomSampler", "SamplingResult",
           "DeltaXYWHBBoxCoder", "YOLOBBoxCoder", "bbox_overlaps", "HungarianAssigner",
           "auction_assign"]
