from .assign_sample import (AssignResult, MaxIoUAssigner, RandomSampler,
                            SamplingResult)
from .coder import DeltaXYWHBBoxCoder
from .geometry import bbox_overlaps

__all__ = ["AssignResult", "MaxIoUAssigner", "RandomSampler", "SamplingResult",
           "DeltaXYWHBBoxCoder", "bbox_overlaps"]
