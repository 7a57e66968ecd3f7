from .assign_sample import (AssignResult, GridAssigner, MaxIoUAssigner, RandomSampler,
                            SamplingResult)
from .coder import DeltaXYWHBBoxCoder, YOLOBBoxCoder
from .geometry import bbox_overlaps
from .hungarian import HungarianAssigner, auction_assign

__all__ = ["AssignResult", "GridAssigner", "MaxIoUAssigner", "RandomSampler",
           "SamplingResult", "DeltaXYWHBBoxCoder", "YOLOBBoxCoder", "bbox_overlaps",
           "HungarianAssigner", "auction_assign"]
