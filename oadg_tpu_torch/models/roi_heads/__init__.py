"""RoI heads of the port."""
from .bbox_heads import BBoxHead, DoubleConvFCBBoxHead, Shared2FCBBoxHead, Shared2FCContrastiveHead
from .cascade_roi_head import CascadeRoIHead
from .htc_scnet_heads import (CoarseMaskHead, FeatureRelayHead, FusedSemanticHead,
                              GlobalContextHead, HybridTaskCascadeRoIHead, MaskPointHead,
                              PointRendRoIHead, SCNetRoIHead)
from .mask_heads import FCNMaskHead
from .more_roi_heads import (DoubleHeadRoIHead, DynamicRoIHead, GridHead, GridRoIHead,
                             MaskIoUHead, MaskScoringRoIHead, PISARoIHead, TridentRoIHead)
from .roi_extractors import SingleRoIExtractor
from .shared_heads import ResLayer
from .sparse_roi_head import DIIHead, EmbeddingRPNHead, SparseRoIHead
from .standard_roi_head import ContrastiveRoIHead, StandardRoIHead

__all__ = ["BBoxHead", "ResLayer", "Shared2FCBBoxHead", "Shared2FCContrastiveHead", "FCNMaskHead",
           "SingleRoIExtractor", "StandardRoIHead", "ContrastiveRoIHead", "CascadeRoIHead",
           "DoubleConvFCBBoxHead", "DoubleHeadRoIHead", "DynamicRoIHead", "FeatureRelayHead",
           "FusedSemanticHead", "GlobalContextHead", "HybridTaskCascadeRoIHead",
           "MaskIoUHead", "MaskScoringRoIHead", "PISARoIHead", "SCNetRoIHead", "CoarseMaskHead",
           "DIIHead", "EmbeddingRPNHead", "GridHead", "GridRoIHead", "MaskPointHead",
           "PointRendRoIHead", "SparseRoIHead", "TridentRoIHead"]
