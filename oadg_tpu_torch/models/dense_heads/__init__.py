"""Dense heads of the port."""
from .retina_head import RetinaHead
from .rpn_head import RPNHead
from .yolo_head import YOLOV3Head, YOLOV3HeadCont

__all__ = ["RetinaHead", "RPNHead", "YOLOV3Head", "YOLOV3HeadCont"]
