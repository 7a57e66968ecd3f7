"""Dense heads of the port; the one-stage family's modules also register
their detectors (``FCOS``, ``ATSS``, ``GFL``, ``VFNet``, ``TOOD``, ``PAA``,
``AutoAssign``, ``FOVEA``, ``FSAF``,
``KnowledgeDistillationSingleStageDetector``, ``NASFCOS``, ``RepPointsDetector``,
``CenterNet``, ``CornerNet``, ``SSD``, ``YOLOF``, ``YOLOX``, ``SOLO``,
``YOLACT``, ``DETR``, ``DeformableDETR``)."""
from .atss_head import ATSSHead
from .autoassign_ld_heads import AutoAssignHead, LDHead, NASFCOSHead, PISARetinaHead
from .centernet_head import CenterNetHead
from .corner_heads import CentripetalHead, CornerHead
from .deformable_detr_head import DeformableDETRHead
from .detr_head import DETRHead
from .fcos_head import FCOSHead
from .fovea_fsaf_heads import FoveaHead, FSAFHead
from .free_anchor_heads import FreeAnchorRetinaHead, RetinaSepBNHead
from .gfl_head import GFLHead
from .instance_seg_heads import SOLOHead, YOLACTHead
from .guided_sabl_heads import GARetinaHead, SABLRetinaHead
from .paa_head import PAAHead
from .reppoints_head import RepPointsHead
from .retina_head import RetinaHead
from .rpn_head import RPNHead
from .ssd_head import SSDHead
from .tood_head import TOODHead
from .vfnet_head import VFNetHead
from .yolo_head import YOLOV3Head, YOLOV3HeadCont
from .yolof_head import YOLOFHead
from .yolox_head import YOLOXHead

__all__ = ["ATSSHead", "AutoAssignHead", "CenterNetHead", "CentripetalHead", "CornerHead",
           "DeformableDETRHead", "DETRHead",
           "FCOSHead", "FoveaHead", "FreeAnchorRetinaHead",
           "FSAFHead", "GARetinaHead", "GFLHead", "LDHead", "NASFCOSHead", "PAAHead",
           "PISARetinaHead", "RepPointsHead", "RetinaHead", "RetinaSepBNHead", "RPNHead", "SABLRetinaHead",
           "SOLOHead", "SSDHead", "TOODHead", "VFNetHead", "YOLACTHead", "YOLOFHead",
           "YOLOV3Head", "YOLOV3HeadCont", "YOLOXHead"]
