from .assign_sample import (AssignResult, ATSSAssigner, GridAssigner, MaxIoUAssigner,
                            RandomSampler, SamplingResult, TaskAlignedAssigner)
from .coder import DeltaXYWHBBoxCoder, YOLOBBoxCoder
from .geometry import bbox_overlaps
from .hungarian import HungarianAssigner, auction_assign

__all__ = ["AssignResult", "ATSSAssigner", "TaskAlignedAssigner", "GridAssigner", "MaxIoUAssigner", "RandomSampler",
           "SamplingResult", "DeltaXYWHBBoxCoder", "YOLOBBoxCoder", "bbox_overlaps",
           "HungarianAssigner", "auction_assign"]
