"""RoI heads of the port."""
from .bbox_heads import BBoxHead, Shared2FCBBoxHead, Shared2FCContrastiveHead
from .mask_heads import FCNMaskHead
from .roi_extractors import SingleRoIExtractor
from .shared_heads import ResLayer
from .standard_roi_head import ContrastiveRoIHead, StandardRoIHead

__all__ = ["BBoxHead", "ResLayer", "Shared2FCBBoxHead", "Shared2FCContrastiveHead", "FCNMaskHead",
           "SingleRoIExtractor", "StandardRoIHead", "ContrastiveRoIHead"]
