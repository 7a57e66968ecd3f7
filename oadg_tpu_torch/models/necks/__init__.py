"""Necks of the port."""
from .fpn import FPN
from .yolo_neck import YOLOV3Neck

__all__ = ["FPN", "YOLOV3Neck"]
