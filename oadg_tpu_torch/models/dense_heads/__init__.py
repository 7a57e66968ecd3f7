"""Dense heads of the port."""
from .rpn_head import RPNHead
from .yolo_head import YOLOV3Head, YOLOV3HeadCont

__all__ = ["RPNHead", "YOLOV3Head", "YOLOV3HeadCont"]
