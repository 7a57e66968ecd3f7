"""Evaluation of the port: the COCO protocol, VOC mAP and recall. Their
matchers run in the port's host library (``utils/host_kernels.py``)."""
from .coco_eval import COCOEvalBbox
from .mean_ap import average_precision, eval_map, eval_recalls

__all__ = ["COCOEvalBbox", "average_precision", "eval_map", "eval_recalls"]
