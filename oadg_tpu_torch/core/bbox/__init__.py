from .coder import DeltaXYWHBBoxCoder
from .geometry import bbox_overlaps

__all__ = ["DeltaXYWHBBoxCoder", "bbox_overlaps"]
