"""Detectors of the port."""
from .single_stage import YOLOV3, SingleStageDetector
from .two_stage import FasterRCNN, MaskRCNN, TwoStageDetector

__all__ = ["TwoStageDetector", "FasterRCNN", "MaskRCNN", "SingleStageDetector", "YOLOV3"]
