"""RoI heads of the port."""
from .bbox_heads import Shared2FCBBoxHead, Shared2FCContrastiveHead
from .mask_heads import FCNMaskHead
from .roi_extractors import SingleRoIExtractor
from .standard_roi_head import ContrastiveRoIHead, StandardRoIHead

__all__ = ["Shared2FCBBoxHead", "Shared2FCContrastiveHead", "FCNMaskHead",
           "SingleRoIExtractor", "StandardRoIHead", "ContrastiveRoIHead"]
