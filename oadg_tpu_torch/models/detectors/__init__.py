"""Detectors of the port."""
from .panoptic import PanopticFPN, TwoStagePanopticSegmentor, heuristic_fuse_panoptic
from .single_stage import YOLOV3, SingleStageDetector
from .two_stage import FasterRCNN, MaskRCNN, TwoStageDetector

__all__ = ["TwoStageDetector", "FasterRCNN", "MaskRCNN", "PanopticFPN", "SingleStageDetector",
           "TwoStagePanopticSegmentor", "YOLOV3", "heuristic_fuse_panoptic"]
