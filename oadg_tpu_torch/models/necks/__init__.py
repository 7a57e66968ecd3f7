"""Necks of the port."""
from .fpn import FPN
from .more_necks import NASFCOS_FPN, NASFPN
from .yolo_neck import YOLOV3Neck

__all__ = ["FPN", "NASFCOS_FPN", "NASFPN", "YOLOV3Neck"]
