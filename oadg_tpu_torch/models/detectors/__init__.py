"""Detectors of the port."""
from .two_stage import FasterRCNN, TwoStageDetector

__all__ = ["TwoStageDetector", "FasterRCNN"]
