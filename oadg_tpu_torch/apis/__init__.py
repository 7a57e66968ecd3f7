"""Inference API of the port."""
from .inference import DetectorHandle, init_detector, prepare_image

__all__ = ["DetectorHandle", "init_detector", "prepare_image"]
