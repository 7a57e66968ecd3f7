"""RoI heads of the port."""
from .bbox_heads import BBoxHead, DoubleConvFCBBoxHead, Shared2FCBBoxHead, Shared2FCContrastiveHead
from .cascade_roi_head import CascadeRoIHead
from .htc_scnet_heads import (FeatureRelayHead, FusedSemanticHead, GlobalContextHead,
                              HybridTaskCascadeRoIHead, SCNetRoIHead)
from .mask_heads import FCNMaskHead
from .more_roi_heads import (DoubleHeadRoIHead, DynamicRoIHead, MaskIoUHead,
                             MaskScoringRoIHead, PISARoIHead)
from .roi_extractors import SingleRoIExtractor
from .shared_heads import ResLayer
from .standard_roi_head import ContrastiveRoIHead, StandardRoIHead

__all__ = ["BBoxHead", "ResLayer", "Shared2FCBBoxHead", "Shared2FCContrastiveHead", "FCNMaskHead",
           "SingleRoIExtractor", "StandardRoIHead", "ContrastiveRoIHead", "CascadeRoIHead",
           "DoubleConvFCBBoxHead", "DoubleHeadRoIHead", "DynamicRoIHead", "FeatureRelayHead",
           "FusedSemanticHead", "GlobalContextHead", "HybridTaskCascadeRoIHead",
           "MaskIoUHead", "MaskScoringRoIHead", "PISARoIHead", "SCNetRoIHead"]
