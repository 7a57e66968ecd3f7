"""Necks of the port."""
from .extra_necks import DilatedEncoder
from .fpn import FPN, ChannelMapper
from .more_necks import FPG, FPN_CARAFE, NASFCOS_FPN, NASFPN
from .yolo_neck import YOLOV3Neck
from .yolox_pafpn import YOLOXPAFPN

__all__ = ["ChannelMapper", "DilatedEncoder", "FPG", "FPN", "FPN_CARAFE", "NASFCOS_FPN", "NASFPN",
           "YOLOV3Neck", "YOLOXPAFPN"]
