"""Evaluation of the port: the COCO protocol, VOC mAP and recall, and the
native host kernels they and the image decoder call."""
from .coco_eval import COCOEvalBbox
from .mean_ap import average_precision, eval_map, eval_recalls

__all__ = ["COCOEvalBbox", "average_precision", "eval_map", "eval_recalls"]
