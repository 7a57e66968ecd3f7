"""Every non-``_base_`` config under ``configs/`` through the port's
``build_detector`` (on ``device='meta'``: shapes, no storage) and its
pipelines' ``PIPELINES`` entries, as ``tests/test_config_sweep.py`` builds
them with the JAX package: the 70 configs the port has ported build as
given, NAS-FCOS raises its stride refusal (its neck's outputs at strides 4
to 64 against its head's 8 to 128) and builds with
``model.neck.start_level=1``, the other 9 raise the port's refusal (a type
the port has not ported, "the port builds only the ported slices'
types"), never another error; TridentNet's refusal names the JAX
detector's fault.

Also the two reference-side faults the port does not copy (ROADMAP C): the
JAX package's ``RPN`` detector raises ``AttributeError`` (it is a bare
``TwoStageDetector`` whose forward calls its absent RoI head) and its
``FastRCNN`` runs its own RPN, never reading the batch's ``proposals``;
the port refuses both types.

Then RetinaNet's, the GIoU Faster R-CNN's, FCOS's and GFL's configs,
narrowed, through ``tools/torch_train.py`` and ``tools/torch_test.py`` on
the CPU, the weights of four long-tail models, of VFNet and TOOD, of FSAF
(mmdet's ``retina_cls`` / ``retina_reg``) and of LD (its ``teacher_model.``)
through ``load_mmdet_checkpoint`` under mmdet's names, and the one-stage
family's twelve configs at full width (their towers, GFL's bins, VFNet's
DCNs, TOOD's task decomposition, FreeAnchor's and PISA's RetinaHeads, LD's
teacher), with mmdet's tensors that the JAX heads lack refused; the same
for GA-RetinaNet, SABL-RetinaNet, NAS-FPN and NAS-FCOS (guided anchors on
DCNv1 with 4 deform groups, SABL's buckets, the searched necks' live BNs,
RetinaSepBNHead's shared convs under every level, mmdet's NAS neck parts
the JAX necks lack refused); and for RepPoints, CenterNet, CornerNet and
CentripetalNet (the point-set head on two DCNv1s, CenterNet's R18 with no
neck, the two-stack Hourglass-104 with live BNs, the corner pools and the
corner and centripetal heads; mmdet's ``BiCornerPool`` ``conv2``,
CentripetalNet's guiding shifts and the Hourglass ``low3`` downsample in
its last block refused, RepPoints' GNs after its DCNs named as missing);
and for YOLOF, YOLOX-S, SSD300, SOLO and YOLACT (the DilatedEncoder,
CSPDarknet with its Focus stem in mmdet's channel order, the PAFPN, SSD's
VGG-16, the instance heads; mmdet's YOLACT protonet and semantic head and
its SSDNeck refused, YOLOF's conv biases named as missing), with SOLO and
YOLACT refused by the box test path beside JAX's ``run_test``, which
misreads or raises on them; and for DETR, Deformable DETR and PanopticFPN
(the transformers at full width, ChannelMapper's 3 levels, the semantic
head; mmdet's ``input_proj`` as a 1x1 conv and its one shared deformable
``value_proj`` read into the port's layout, its DETR ``post_norm``, its
4-level ChannelMapper and offsets, its GN ChannelMapper and its
PanopticFPNHead refused); and for MobileNetV2, RegNetX-3.2GF, Res2Net-101,
ResNeSt-50, FPN-CARAFE and FPG (each module at its published width;
mmdet's CARAFE encoder read from its pixel-shuffle order, its FPN-CARAFE
extra P6 path, its FPG and its ResNeSt weights refused).
"""
import copy
import glob
import importlib.util
import json
import re
import os.path as osp

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from oadg_tpu.models import build_detector as jax_build_detector
import oadg_tpu_torch.data  # noqa: F401  (registers the pipelines)
from oadg_tpu_torch.config import load_config
from oadg_tpu_torch.models import build_detector
from oadg_tpu_torch.utils.registry import PIPELINES, build_from_cfg
from test_forward import BASE_MODEL, TEST_CFG, TRAIN_CFG, _batch

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
CFG_ROOT = osp.join(ROOT, "configs")
ALL_CONFIGS = sorted(osp.relpath(p, CFG_ROOT)
                     for p in glob.glob(osp.join(CFG_ROOT, "**", "*.py"), recursive=True)
                     if "_base_" not in p)
PORTED = {
    "OA-DG/cityscapes/faster_rcnn_r50_fpn_1x_cityscapes.py",
    "OA-DG/cityscapes/faster_rcnn_r50_fpn_1x_cityscapes_oadg.py",
    "OA-DG/cityscapes/yolov3_d53_mstrain-1024_20e.py",
    "OA-DG/cityscapes/yolov3_d53_mstrain-1024_20e_oadg.py",
    "OA-DG/dwd/faster_rcnn_r101_dc5_1x_dwd.py",
    "OA-DG/dwd/faster_rcnn_r101_dc5_1x_dwd_oadg.py",
    "atss/atss_r50_fpn_1x_coco.py",
    "autoassign/autoassign_r50_fpn_8x2_1x_coco.py",
    "cascade_rcnn/cascade_rcnn_r50_fpn_1x_coco.py",
    "cityscapes/faster_rcnn_r50_fpn_1x_cityscapes.py",
    "cityscapes/mask_rcnn_r50_fpn_1x_cityscapes.py",
    "dcn/faster_rcnn_r50_fpn_dconv_c3-c5_1x_coco.py",
    "double_heads/dh_faster_rcnn_r50_fpn_1x_coco.py",
    "dynamic_rcnn/dynamic_rcnn_r50_fpn_1x_coco.py",
    "faster_rcnn/faster_rcnn_r101_fpn_1x_coco.py",
    "faster_rcnn/faster_rcnn_r50_caffe_c4_1x_coco.py",
    "faster_rcnn/faster_rcnn_r50_caffe_dc5_1x_coco.py",
    "faster_rcnn/faster_rcnn_r50_caffe_fpn_1x_coco.py",
    "faster_rcnn/faster_rcnn_r50_fpn_1x_coco.py",
    "faster_rcnn/faster_rcnn_r50_fpn_2x_coco.py",
    "faster_rcnn/faster_rcnn_r50_fpn_bounded_iou_1x_coco.py",
    "faster_rcnn/faster_rcnn_r50_fpn_ciou_1x_coco.py",
    "faster_rcnn/faster_rcnn_r50_fpn_giou_1x_coco.py",
    "faster_rcnn/faster_rcnn_r50_fpn_iou_1x_coco.py",
    "faster_rcnn/faster_rcnn_r50_fpn_soft_nms_1x_coco.py",
    "faster_rcnn/faster_rcnn_x101_32x4d_fpn_1x_coco.py",
    "fcos/fcos_r50_fpn_1x_coco.py",
    "foveabox/fovea_r50_fpn_4x4_1x_coco.py",
    "free_anchor/retinanet_free_anchor_r50_fpn_1x_coco.py",
    "fsaf/fsaf_r50_fpn_1x_coco.py",
    "guided_anchoring/ga_retinanet_r50_fpn_1x_coco.py",
    "gfl/gfl_r50_fpn_1x_coco.py",
    "htc/htc_r50_fpn_1x_coco.py",
    "ld/ld_r18_gflv1_r101_fpn_coco_1x.py",
    "mask_rcnn/mask_rcnn_r50_fpn_1x_coco.py",
    "nas_fpn/retinanet_r50_nasfpn_crop640_50e_coco.py",
    "grid_rcnn/grid_rcnn_r50_fpn_gn-head_2x_coco.py",
    "ms_rcnn/ms_rcnn_r50_fpn_1x_coco.py",
    "paa/paa_r50_fpn_1x_coco.py",
    "pisa/pisa_faster_rcnn_r50_fpn_1x_coco.py",
    "pisa/pisa_retinanet_r50_fpn_1x_coco.py",
    "point_rend/point_rend_r50_caffe_fpn_mstrain_1x_coco.py",
    "queryinst/queryinst_r50_fpn_1x_coco.py",
    "reppoints/reppoints_moment_r50_fpn_1x_coco.py",
    "centernet/centernet_resnet18_140e_coco.py",
    "cornernet/cornernet_hourglass104_mstest_8x6_210e_coco.py",
    "centripetalnet/centripetalnet_hourglass104_mstest_16x6_210e_coco.py",
    "retinanet/retinanet_r50_fpn_1x_coco.py",
    "sabl/sabl_retinanet_r50_fpn_1x_coco.py",
    "scnet/scnet_r50_fpn_1x_coco.py",
    "sparse_rcnn/sparse_rcnn_r50_fpn_1x_coco.py",
    "tood/tood_r50_fpn_1x_coco.py",
    "vfnet/vfnet_r50_fpn_1x_coco.py",
    "yolo/yolov3_d53_320_273e_coco.py",
    "yolo/yolov3_d53_mstrain-416_273e_coco.py",
    "yolo/yolov3_d53_mstrain-608_273e_coco.py",
    "yolof/yolof_r50_c5_8x8_1x_coco.py",
    "yolox/yolox_s_8x8_300e_coco.py",
    "ssd/ssd300_coco.py",
    "solo/solo_r50_fpn_1x_coco.py",
    "yolact/yolact_r50_1x8_coco.py",
    "detr/detr_r50_8x2_150e_coco.py",
    "deformable_detr/deformable_detr_r50_16x2_50e_coco.py",
    "panoptic_fpn/panoptic_fpn_r50_fpn_1x_coco.py",
    "yolo/yolov3_mobilenetv2_mstrain-416_300e_coco.py",
    "regnet/faster_rcnn_regnetx-3.2GF_fpn_1x_coco.py",
    "res2net/faster_rcnn_r2_101_fpn_2x_coco.py",
    "resnest/faster_rcnn_s50_fpn_syncbn-backbone+head_mstrain-range_1x_coco.py",
    "carafe/faster_rcnn_r50_fpn_carafe_1x_coco.py",
    "fpg/faster_rcnn_r50_fpg_crop640_50e_coco.py",
}
REFUSAL = "the port builds only the ported slices' types"
# refused at build for a fault of its own, with the config option that
# repairs it (ROADMAP C)
STRIDE_REFUSED = {
    "nas_fcos/nas_fcos_nashead_r50_caffe_fpn_gn-head_4x4_1x_coco.py":
        (r"strides \[4, 8, 16, 32, 64\] and the head's points at \[8, 16, 32, 64, 128\].*"
         r"model\.neck\.start_level=1", {"model.neck.start_level": 1}),
}


def _build(rel, options=None):
    cfg = load_config(osp.join(CFG_ROOT, rel))
    cfg.merge_from_dict(options or {})
    det = build_detector(dict(cfg.model), device="meta",
                         num_views=int(cfg.get("num_views", 1) or 1))

    def check(pipeline):
        for op in pipeline or []:
            op = dict(op)
            if op.get("type") == "MultiScaleFlipAug":
                check(op.get("transforms"))
                continue
            assert build_from_cfg(op, PIPELINES) is not None, op.get("type")

    for split in ("train", "val", "test"):
        d = (cfg.get("data") or {}).get(split)
        for item in ([] if d is None else d if isinstance(d, list) else [d]):
            item = dict(item)
            while item.get("type") in ("RepeatDataset", "ClassBalancedDataset"):
                item = dict(item["dataset"])
            check(item.get("pipeline"))
    return det


def test_the_sweep_counts_49_of_80():
    """70 of the 80 build as given since MobileNetV2, RegNetX, Res2Net,
    ResNeSt, FPN-CARAFE and FPG (the name is the count's before
    GA-RetinaNet, SABL-RetinaNet and NAS-FPN), NAS-FCOS with its neck's
    ``start_level`` set to 1, 9 are refused."""
    assert len(ALL_CONFIGS) == 80
    assert PORTED <= set(ALL_CONFIGS) and len(PORTED) == 70
    assert set(STRIDE_REFUSED) <= set(ALL_CONFIGS) - PORTED
    assert len(set(ALL_CONFIGS) - PORTED - set(STRIDE_REFUSED)) == 9


@pytest.mark.parametrize("rel", ALL_CONFIGS)
def test_config_builds_or_is_refused(rel):
    if rel in PORTED:
        det = _build(rel)
        assert all(p.device.type == "meta" for p in det.parameters())
    elif rel in STRIDE_REFUSED:
        match, fix = STRIDE_REFUSED[rel]
        with pytest.raises(ValueError, match=match):
            _build(rel)
        det = _build(rel, fix)
        assert all(p.device.type == "meta" for p in det.parameters())
    else:
        with pytest.raises((KeyError, ValueError), match=REFUSAL):
            _build(rel)


def test_longtail_configs_build_their_modules():
    """The eight configs of the long tail's first slice build the modules
    they name."""
    heads = {"faster_rcnn/faster_rcnn_r50_fpn_iou_1x_coco.py": "IoULoss",
             "faster_rcnn/faster_rcnn_r50_fpn_giou_1x_coco.py": "GIoULoss",
             "faster_rcnn/faster_rcnn_r50_fpn_ciou_1x_coco.py": "CIoULoss",
             "faster_rcnn/faster_rcnn_r50_fpn_bounded_iou_1x_coco.py": "BoundedIoULoss"}
    for rel, loss in heads.items():
        head = _build(rel).roi_head.bbox_head
        assert head.reg_decoded_bbox and head.loss_bbox_cfg["type"] == loss
    retina = _build("retinanet/retinanet_r50_fpn_1x_coco.py")
    assert type(retina).__name__ == "RetinaNet"
    assert retina.neck.fpn_convs[3].conv.weight.shape[1] == 2048     # on_input: C5
    assert retina.bbox_head.prior_generator.num_base_anchors == [9] * 5
    c4 = _build("faster_rcnn/faster_rcnn_r50_caffe_c4_1x_coco.py")
    assert c4.roi_head.shared_head.layer4[0].conv1.weight.shape == (512, 1024, 1, 1)
    assert c4.roi_head.bbox_head.fc_cls.weight.shape == (81, 2048)
    assert c4.roi_head.bbox_roi_extractor.output_size == 14
    assert c4.rpn_head.train_cfg["allowed_border"] == 0
    x101 = _build("faster_rcnn/faster_rcnn_x101_32x4d_fpn_1x_coco.py")
    assert x101.backbone.layer1[0].conv2.groups == 32
    assert x101.backbone.layer1[0].conv2.weight.shape == (128, 4, 3, 3)
    dcn = _build("dcn/faster_rcnn_r50_fpn_dconv_c3-c5_1x_coco.py")
    assert type(dcn.backbone.layer1[0].conv2).__name__ == "Conv"
    assert [type(getattr(dcn.backbone, f"layer{i}")[0].conv2).__name__
            for i in (2, 3, 4)] == ["ModulatedDeformConv"] * 3


TWOSTAGE = {"cascade_rcnn/cascade_rcnn_r50_fpn_1x_coco.py": ("CascadeRCNN", "CascadeRoIHead"),
            "htc/htc_r50_fpn_1x_coco.py": ("HybridTaskCascade", "HybridTaskCascadeRoIHead"),
            "scnet/scnet_r50_fpn_1x_coco.py": ("SCNet", "SCNetRoIHead"),
            "dynamic_rcnn/dynamic_rcnn_r50_fpn_1x_coco.py": ("DynamicRCNN", "DynamicRoIHead"),
            "double_heads/dh_faster_rcnn_r50_fpn_1x_coco.py": ("FasterRCNN", "DoubleHeadRoIHead"),
            "ms_rcnn/ms_rcnn_r50_fpn_1x_coco.py": ("MaskScoringRCNN", "MaskScoringRoIHead"),
            "pisa/pisa_faster_rcnn_r50_fpn_1x_coco.py": ("FasterRCNN", "PISARoIHead")}


@pytest.mark.parametrize("rel", sorted(TWOSTAGE))
def test_twostage_configs_build_their_heads(rel):
    """The two-stage family's seven configs build their detector and RoI
    head at full width: the cascade's three box heads with their own
    coders, HTC's and SCNet's mask heads at the box layer's 7x7 (the
    configs give no mask RoI layer), the double head's branches, the mask
    IoU head."""
    det = _build(rel)
    assert (type(det).__name__, type(det.roi_head).__name__) == TWOSTAGE[rel]
    rh = det.roi_head
    if "Cascade" in TWOSTAGE[rel][1] or "SCNet" in TWOSTAGE[rel][1]:
        assert len(rh.bbox_head) == 3 and [s.num for s in rh.samplers] == [512] * 3
        assert [a.pos_iou_thr for a in rh.assigners] == [0.5, 0.6, 0.7]
        assert rh.bbox_head[0].fc_reg.weight.shape == (4, 1024)     # class-agnostic
    if TWOSTAGE[rel][1] in ("HybridTaskCascadeRoIHead", "SCNetRoIHead"):
        assert rh.mask_out_size == 7 and rh.mask_size == 14 and len(rh.mask_head) == 3
        assert rh.semantic_head.conv_logits.weight.shape == (183, 256, 1, 1)
        assert rh.semantic_roi_extractor.featmap_strides == (8,)
    if rel.startswith("double_heads"):
        assert rh.bbox_head.fc_branch[0].weight.shape == (1024, 256 * 49)
        assert rh.bbox_head.fc_reg.weight.shape == (320, 1024)
    if rel.startswith("ms_rcnn"):
        assert rh.mask_iou_head.fcs[0].weight.shape == (1024, 256 * 4 * 4)


LAST_TWOSTAGE = {"sparse_rcnn/sparse_rcnn_r50_fpn_1x_coco.py": ("SparseRCNN", "SparseRoIHead"),
                 "queryinst/queryinst_r50_fpn_1x_coco.py": ("QueryInst", "SparseRoIHead"),
                 "grid_rcnn/grid_rcnn_r50_fpn_gn-head_2x_coco.py": ("GridRCNN", "GridRoIHead"),
                 "point_rend/point_rend_r50_caffe_fpn_mstrain_1x_coco.py":
                     ("PointRend", "PointRendRoIHead")}


@pytest.mark.parametrize("rel", sorted(LAST_TWOSTAGE))
def test_last_twostage_configs_build_their_heads(rel):
    """The two-stage family's last four configs at full width: Sparse R-CNN's
    and QueryInst's 100 learned proposals and six DII stages, Grid R-CNN's
    head of 8 GN(36) convs of 576 channels, PointRend's point head (its
    mask RoIs at the box layer's 7x7: the config gives no mask RoI layer)."""
    det = _build(rel)
    assert (type(det).__name__, type(det.roi_head).__name__) == LAST_TWOSTAGE[rel]
    rh = det.roi_head
    if rh.__class__.__name__ == "SparseRoIHead":
        assert det.rpn_head.init_proposal_features.weight.shape == (100, 256)
        assert len(rh.bbox_head) == 6 and rh.bbox_roi_extractor.output_size == 7
        assert rh.bbox_head[5].attention.attn.in_proj_weight.shape == (768, 256)
        assert rh.bbox_head[0].instance_interactive_conv.fc_layer.weight.shape == (256, 49 * 256)
        assert rh.bbox_head[0].fc_cls.weight.shape == (80, 256)
    elif rel.startswith("grid"):
        assert len(rh.grid_head.convs) == 8 and rh.grid_head.convs[7].gn.num_groups == 36
        assert rh.grid_head.deconv2.weight.shape == (576, 9, 2, 2)
        assert rh.grid_roi_extractor.output_size == 14
    else:
        assert rh.mask_roi_extractor.output_size == 7
        assert rh.point_head.fcs[0].conv.weight.shape == (256, 256 + 80, 1)


ONESTAGE = {"atss/atss_r50_fpn_1x_coco.py": ("ATSS", "ATSSHead", 4),
            "fcos/fcos_r50_fpn_1x_coco.py": ("FCOS", "FCOSHead", 4),
            "gfl/gfl_r50_fpn_1x_coco.py": ("GFL", "GFLHead", 4),
            "vfnet/vfnet_r50_fpn_1x_coco.py": ("VFNet", "VFNetHead", 3),
            "tood/tood_r50_fpn_1x_coco.py": ("TOOD", "TOODHead", 6),
            "paa/paa_r50_fpn_1x_coco.py": ("PAA", "PAAHead", 4),
            "autoassign/autoassign_r50_fpn_8x2_1x_coco.py": ("AutoAssign", "AutoAssignHead", 4),
            "foveabox/fovea_r50_fpn_4x4_1x_coco.py": ("FOVEA", "FoveaHead", 4),
            "fsaf/fsaf_r50_fpn_1x_coco.py": ("FSAF", "FSAFHead", 4),
            "free_anchor/retinanet_free_anchor_r50_fpn_1x_coco.py":
                ("RetinaNet", "FreeAnchorRetinaHead", 4),
            "pisa/pisa_retinanet_r50_fpn_1x_coco.py": ("RetinaNet", "PISARetinaHead", 4),
            "ld/ld_r18_gflv1_r101_fpn_coco_1x.py":
                ("KnowledgeDistillationSingleStageDetector", "LDHead", 4)}
PLAIN_TOWERS = ("FoveaHead", "FSAFHead", "FreeAnchorRetinaHead", "PISARetinaHead")


@pytest.mark.parametrize("rel", sorted(ONESTAGE))
def test_onestage_configs_build_their_heads(rel):
    """The one-stage family's twelve configs at full width, 80 classes: the
    towers' depths (TOOD's shared stack), five per-level scales, GFL's
    4 x (16 + 1) bins, VFNet's two DCNs on 256 channels, TOOD's two task
    decompositions over its 6 x 256 stacked channels, PAA's IoU branch,
    AutoAssign's centre prior; FCOS on a caffe-style ResNet with ReLU before
    the extra convs, PAA's extra convs on C5. FoveaBox's and FSAF's plain
    towers (no GN, no scales) with 80 class and 4 box outputs, FoveaBox's
    edges and ranges; FreeAnchor's and PISA-RetinaNet's RetinaHead (9
    anchors a cell); LD's R18 student with a GFL head and its frozen
    R50-FPN GFL teacher."""
    det = _build(rel)
    kind, head_kind, depth = ONESTAGE[rel]
    head = det.bbox_head
    assert (type(det).__name__, type(head).__name__) == (kind, head_kind)
    tower = head.inter_convs if kind == "TOOD" else head.cls_convs
    assert len(tower) == depth and tower[0].conv.weight.shape == (256, 256, 3, 3)
    if head_kind in PLAIN_TOWERS:
        assert not hasattr(head, "scales") and not hasattr(tower[0], "gn")
    elif kind != "PAA":
        assert len(head.scales) == 5 and head.scales[0].scale.shape == ()
        assert tower[0].gn.num_groups == 32
    cls = {"ATSS": "atss_cls", "FCOS": "conv_cls", "GFL": "gfl_cls", "VFNet": "vfnet_cls",
           "TOOD": "tood_cls", "PAA": "retina_cls", "AutoAssign": "conv_cls",
           "FOVEA": "conv_cls", "FSAF": "conv_cls", "RetinaNet": "retina_cls",
           "KnowledgeDistillationSingleStageDetector": "gfl_cls"}[kind]
    anchors = 9 if kind == "RetinaNet" else 1
    assert getattr(head, cls).weight.shape == (80 * anchors, 256, 3, 3)
    if kind in ("FOVEA", "FSAF"):
        assert head.conv_reg.weight.shape == (4, 256, 3, 3)
    if kind == "FOVEA":
        assert head.base_edge_list == (16, 32, 64, 128, 256) and head.sigma == 0.4
        assert head.scale_ranges[-1] == (256, 2048)
    if head_kind == "FreeAnchorRetinaHead":
        assert head.pre_anchor_topk == 50 and head.reg_loss.loss_weight == 0.75
    if head_kind == "PISARetinaHead":
        assert head.carl_lambda == 5.0 and head.isr_k == 2.0
    if head_kind == "LDHead":
        assert det.neck.lateral_convs[0].conv.weight.shape[1] == 128           # R18's C3
        assert len(det.backbone.layer1) == 2
        teacher = det.teacher_model
        assert type(teacher.bbox_head).__name__ == "GFLHead" and len(teacher.backbone.layer3) == 6
        assert teacher.neck.lateral_convs[0].conv.weight.shape[1] == 512       # R50's C3
        assert not any(p.requires_grad for p in teacher.parameters())
        assert head.l_ld.T == 10 and head.l_ld.loss_weight == 0.25
    if kind == "GFL":
        assert head.gfl_reg.weight.shape == (68, 256, 3, 3) and head.reg_max == 16
    if kind == "VFNet":
        for dcn in (head.vfnet_reg_refine_dconv, head.vfnet_cls_dconv):
            assert type(dcn).__name__ == "DeformConv" and dcn.weight.shape == (256, 256, 3, 3)
        assert len(head.scales_refine) == 5
    if kind == "TOOD":
        for decomp in (head.cls_decomp, head.reg_decomp):
            assert type(decomp).__name__ == "TaskDecomposition"
            assert decomp.layer_attention[0].weight.shape == (64, 6 * 256, 1, 1)
            assert decomp.reduction_conv.conv.weight.shape == (256, 6 * 256, 1, 1)
        assert head.topk == 13
    if kind == "PAA":
        assert head.retina_iou.weight.shape == (1, 256, 3, 3) and head.topk == 9
        assert det.neck.fpn_convs[3].conv.weight.shape[1] == 2048      # on_input: C5
    if kind == "AutoAssign":
        assert head.center_prior.mean.shape == head.center_prior.sigma.shape == (80, 2)
    if kind == "FCOS":
        assert det.neck.relu_before_extra_convs and det.neck.fpn_convs[4].conv.weight.shape[1] == 256


def test_trident_refusal_names_the_jax_fault():
    with pytest.raises(ValueError, match=f"{REFUSAL}.*never tiles the gts.*test branch.*"
                                         "stride 32"):
        _build("tridentnet/tridentnet_r50_caffe_1x_coco.py")


# ------------------------------------------------ reference-side faults ----

def _rpn_only():
    model = copy.deepcopy(BASE_MODEL)
    model.update(type="RPN", roi_head=None)
    return model


@pytest.mark.parametrize("mode", ["train", "test"])
def test_jax_rpn_detector_raises(mode):
    det = jax_build_detector(_rpn_only(), TRAIN_CFG, TEST_CFG)
    batch = {k: jnp.asarray(v) for k, v in _batch().items()}
    with pytest.raises(AttributeError, match="roi"):
        jax.eval_shape(lambda r, b: det.init(r, b, mode),
                       {"params": jax.random.PRNGKey(0), "sampling": jax.random.PRNGKey(1)},
                       batch)


@pytest.mark.parametrize("mode", ["train", "test"])
def test_jax_fast_rcnn_ignores_its_proposals(mode):
    """Traced (not run): the batch's ``proposals`` and ``prop_valid`` are
    inputs no operation of JAX's ``FastRCNN`` reads."""
    model = copy.deepcopy(BASE_MODEL)
    model["type"] = "FastRCNN"
    det = jax_build_detector(model, TRAIN_CFG, TEST_CFG)
    batch = {k: jnp.asarray(v) for k, v in _batch().items()}
    rngs = {"params": jax.random.PRNGKey(0), "sampling": jax.random.PRNGKey(1)}
    variables = jax.eval_shape(lambda r, b: det.init(r, b, "test"), rngs, batch)
    n = batch["img"].shape[0]
    props = jnp.tile(jnp.asarray([[4.0, 4.0, 40.0, 30.0]]), (n, 8, 1))
    closed = jax.make_jaxpr(lambda v, p, pv: det.apply(
        v, dict(batch, proposals=p, prop_valid=pv), mode, rngs={"sampling": rngs["sampling"]}))(
        variables, props, jnp.ones((n, 8), bool))
    jaxpr = closed.jaxpr
    prop_vars = set(map(id, jaxpr.invars[-2:]))
    read = {id(v) for eqn in jaxpr.eqns for v in eqn.invars}
    assert not prop_vars & read
    assert not prop_vars & {id(v) for v in jaxpr.outvars}
    assert read & set(map(id, jaxpr.invars[:-2]))          # the weights are read


@pytest.mark.parametrize("kind", ["RPN", "FastRCNN"])
def test_port_refuses_rpn_and_fast_rcnn(kind):
    model = _rpn_only() if kind == "RPN" else dict(copy.deepcopy(BASE_MODEL), type=kind)
    with pytest.raises(KeyError, match=f"{kind} is not registered.*{REFUSAL}"):
        build_detector(dict(model, train_cfg=TRAIN_CFG, test_cfg=TEST_CFG), device="meta")


# ------------------------------------------------------------- the tools ----

def _tool(name):
    spec = importlib.util.spec_from_file_location(f"{name}_tool",
                                                  osp.join(ROOT, "tools", f"{name}.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


def _coco_json(ann_file, out):
    """The 4-PNG set's annotations under the 80 COCO categories (its 8
    classes as COCO's first 8 ids), for the COCO configs' ``CocoDataset``."""
    from oadg_tpu_torch.data.datasets.coco import CocoDataset
    with open(ann_file) as f:
        ann = json.load(f)
    ids = {c["id"]: i + 1 for i, c in enumerate(ann["categories"])}
    ann["categories"] = [dict(id=i + 1, name=n) for i, n in enumerate(CocoDataset.CLASSES)]
    for a in ann["annotations"]:
        a["category_id"] = ids[a["category_id"]]
    with open(out, "w") as f:
        json.dump(ann, f)
    return out


@pytest.mark.parametrize("rel", ["retinanet/retinanet_r50_fpn_1x_coco.py",
                                 "faster_rcnn/faster_rcnn_r50_fpn_giou_1x_coco.py"])
def test_longtail_config_trains_and_tests_through_the_tools(rel, tmp_path):
    """``tools/torch_train.py`` (one epoch of 2 steps and its evaluation) then
    ``tools/torch_test.py`` on the saved checkpoint, on the CPU, with the
    config's model narrowed (R18-FPN at 16 channels) and the 4-PNG set of
    ``torch_data_cases`` at 96x64. RetinaNet's config pairs 80 classes with
    the Cityscapes dataset base, whose 8 the tools' class check requires."""
    _through_the_tools(rel, tmp_path)


@pytest.mark.parametrize("rel", ["fcos/fcos_r50_fpn_1x_coco.py", "gfl/gfl_r50_fpn_1x_coco.py"])
def test_onestage_config_trains_and_tests_through_the_tools(rel, tmp_path):
    """FCOS (caffe-style ResNet, GN head, IoU and centerness losses) and GFL
    (ATSS assignment, QFL, DFL) as RetinaNet above: both tools on the CPU,
    the config narrowed, 8 classes for the Cityscapes dataset base."""
    _through_the_tools(rel, tmp_path)


def _through_the_tools(rel, tmp_path):
    import torch_data_cases as cases
    ann, prefix = cases.write_dataset(str(tmp_path / "ds"), sizes=cases.TRAIN_SIZES)
    cfg = load_config(osp.join(CFG_ROOT, rel))
    m = cfg.model
    m.backbone.update(depth=18, base_channels=16, stem_channels=16, init_cfg=None)
    m.neck.update(in_channels=[16, 32, 64, 128], out_channels=16)
    if "bbox_head" in m:                                     # single-stage
        m.bbox_head.update(in_channels=16, feat_channels=16, stacked_convs=1, num_classes=8)
        m.test_cfg.update(nms_pre=100)
        train = "data.train.dataset."
        opts = {"data.train.times": 1}
    else:
        ann = _coco_json(ann, str(tmp_path / "coco.json"))
        m.rpn_head.update(in_channels=16, feat_channels=16)
        m.roi_head.bbox_roi_extractor.update(out_channels=16)
        m.roi_head.bbox_head.update(in_channels=16, fc_out_channels=32)
        m.train_cfg.rpn_proposal.update(nms_pre=64, max_per_img=32)
        m.train_cfg.rpn.sampler.update(num=32)
        m.train_cfg.rcnn.sampler.update(num=16)
        m.test_cfg.rpn.update(nms_pre=60, max_per_img=30)
        train = "data.train."
        opts = {}
    pipeline = cfg.data.train.dataset.pipeline if train.endswith("dataset.") \
        else cfg.data.train.pipeline
    resize = [i for i, op in enumerate(pipeline) if op["type"] == "Resize"][0]
    opts.update({"data.samples_per_gpu": 2, "data.workers_per_gpu": 1,
                 train + "ann_file": ann, train + "img_prefix": prefix,
                 f"{train}pipeline.{resize}.img_scale": (96, 64),
                 "runner.max_epochs": 1, "log_config.interval": 1})
    for split in ("val", "test"):
        opts.update({f"data.{split}.ann_file": ann, f"data.{split}.img_prefix": prefix,
                     f"data.{split}.pipeline.1.img_scale": (96, 64)})
    cfg.merge_from_dict(opts)
    config = str(tmp_path / "tiny.py")
    cfg.dump(config)
    work = tmp_path / "work"
    _tool("torch_train").main([config, "--device", "cpu", "--work-dir", str(work),
                               "--seed", "0"])
    with open(work / "log.json") as f:
        lines = [json.loads(line) for line in f]
    assert [ln["mode"] for ln in lines] == ["train", "train", "val"]
    assert all(np.isfinite(ln["loss"]) for ln in lines[:2])
    metrics = _tool("torch_test").main([config, str(work / "epoch_1.pth"), "--device", "cpu",
                                        "--eval", "bbox"])
    assert metrics == {k: v for k, v in lines[-1].items() if k not in ("mode", "epoch")}


def _narrow(rel):
    """The config's model at narrow widths (the structure kept: DCN's
    stages, ResNeXt's groups, C4's ResLayer, RetinaNet's extra conv)."""
    m = load_config(osp.join(CFG_ROOT, rel)).model
    m.backbone.update(init_cfg=None)
    if m.backbone.type == "ResNeXt":
        m.backbone.update(groups=4, base_width=16, base_channels=16, stem_channels=16)
    else:
        m.backbone.update(base_channels=8, stem_channels=8)
    widths = [32 * 2 ** i for i in range(4)] if m.backbone.type != "ResNeXt" else \
        [64 * 2 ** i for i in range(4)]
    if "neck" in m:
        m.neck.update(in_channels=widths, out_channels=16)
    if "bbox_head" in m:                                     # single-stage
        m.bbox_head.update(in_channels=16, feat_channels=16, stacked_convs=1)
    elif "neck" in m:
        m.rpn_head.update(in_channels=16, feat_channels=16)
        m.roi_head.bbox_roi_extractor.update(out_channels=16)
        m.roi_head.bbox_head.update(in_channels=16, fc_out_channels=32)
    else:                                                    # C4: one level of 128
        m.rpn_head.update(in_channels=128, feat_channels=16)
        m.roi_head.bbox_roi_extractor.update(out_channels=128)
    return m


@pytest.mark.parametrize("rel", ["retinanet/retinanet_r50_fpn_1x_coco.py",
                                 "faster_rcnn/faster_rcnn_r50_caffe_c4_1x_coco.py",
                                 "faster_rcnn/faster_rcnn_x101_32x4d_fpn_1x_coco.py",
                                 "dcn/faster_rcnn_r50_fpn_dconv_c3-c5_1x_coco.py"])
def test_mmdet_checkpoint_carries_the_longtail_modules(rel, tmp_path):
    """A model's ``state_dict`` under mmdet's names, saved as an mmdet
    checkpoint (``state_dict`` and ``meta``), loads into the same config's
    model built from another seed through ``load_mmdet_checkpoint``: every
    tensor loaded, none missing or skipped, the two models equal (the
    RetinaHead towers, the extra FPN convs, the C4 shared head, the grouped
    and the deformable ``conv2`` with its ``conv_offset``)."""
    import torch
    from oadg_tpu_torch.apis import init_detector
    from oadg_tpu_torch.utils.checkpoint import load_mmdet_checkpoint
    model = _narrow(rel)
    src = init_detector({"model": model}, device="cpu", seed=1).model
    with torch.no_grad():
        for p in src.parameters():                # conv_offset is zero at init
            p.add_(0.01)
    path = tmp_path / "model.pth"
    torch.save({"state_dict": src.state_dict(), "meta": {}}, path)
    dst = init_detector({"model": model}, device="cpu", seed=2).model
    report = load_mmdet_checkpoint(dst, str(path))
    assert not report["missing"] and not report["skipped"]
    assert len(report["loaded"]) == len(src.state_dict())
    for k, v in src.state_dict().items():
        assert torch.equal(dst.state_dict()[k], v), k
    keys = set(report["loaded"])
    want = {"retinanet/retinanet_r50_fpn_1x_coco.py": "bbox_head.retina_cls.weight",
            "faster_rcnn/faster_rcnn_r50_caffe_c4_1x_coco.py":
                "roi_head.shared_head.layer4.0.conv2.weight",
            "faster_rcnn/faster_rcnn_x101_32x4d_fpn_1x_coco.py": "backbone.layer1.0.conv2.weight",
            "dcn/faster_rcnn_r50_fpn_dconv_c3-c5_1x_coco.py":
                "backbone.layer2.0.conv2.conv_offset.weight"}[rel]
    assert want in keys


@pytest.mark.parametrize("rel", ["vfnet/vfnet_r50_fpn_1x_coco.py", "tood/tood_r50_fpn_1x_coco.py"])
def test_mmdet_checkpoint_carries_the_onestage_heads(rel, tmp_path):
    """As above for VFNet (its two DCN weights, the per-level ``scales`` and
    ``scales_refine`` scalars, the GN towers) and TOOD (``inter_convs``, the
    task decompositions' ``layer_attention`` and ``reduction_conv``,
    ``cls_prob_module``, ``reg_offset_module``): every tensor loaded under
    mmdet's names, the models equal."""
    import torch
    from oadg_tpu_torch.apis import init_detector
    from oadg_tpu_torch.utils.checkpoint import load_mmdet_checkpoint
    model = _narrow(rel)
    src = init_detector({"model": model}, device="cpu", seed=1).model
    with torch.no_grad():
        for p in src.parameters():
            p.add_(0.01)
    path = tmp_path / "model.pth"
    torch.save({"state_dict": src.state_dict(), "meta": {}}, path)
    dst = init_detector({"model": model}, device="cpu", seed=2).model
    report = load_mmdet_checkpoint(dst, str(path))
    assert not report["missing"] and not report["skipped"]
    for k, v in src.state_dict().items():
        assert torch.equal(dst.state_dict()[k], v), k
    want = {"vfnet/vfnet_r50_fpn_1x_coco.py": ["bbox_head.vfnet_reg_refine_dconv.weight",
                                               "bbox_head.vfnet_cls_dconv.weight",
                                               "bbox_head.scales_refine.4.scale",
                                               "bbox_head.cls_convs.0.gn.weight"],
            "tood/tood_r50_fpn_1x_coco.py": ["bbox_head.inter_convs.0.conv.weight",
                                             "bbox_head.cls_decomp.layer_attention.2.weight",
                                             "bbox_head.reg_decomp.reduction_conv.gn.bias",
                                             "bbox_head.cls_prob_module.2.weight",
                                             "bbox_head.reg_offset_module.0.weight",
                                             "bbox_head.scales.0.scale"]}[rel]
    assert set(want) <= set(report["loaded"])


@pytest.mark.parametrize("case", ["vfnet_reg_conv", "vfnet_missing_gn", "paa_atss_parts"])
def test_mmdet_checkpoint_names_what_one_side_lacks(case, tmp_path):
    """mmdet's VFNet has a GN conv ``vfnet_reg_conv`` before ``vfnet_reg`` and
    no GN after its DCNs; mmdet's PAA head is an ATSS head (GN towers,
    ``scales``, ``atss_*`` convs), the JAX one a RetinaHead: a checkpoint
    with a tensor the port's head lacks raises naming it (``MMDET_ONLY``),
    one without a tensor the port's head has raises naming it (missing)."""
    import torch
    from oadg_tpu_torch.apis import init_detector
    from oadg_tpu_torch.utils.checkpoint import load_mmdet_checkpoint
    rel = "paa/paa_r50_fpn_1x_coco.py" if case.startswith("paa") else "vfnet/vfnet_r50_fpn_1x_coco.py"
    model = init_detector({"model": _narrow(rel)}, device="cpu", seed=1).model
    sd = dict(model.state_dict())
    if case == "vfnet_reg_conv":
        sd["bbox_head.vfnet_reg_conv.conv.weight"] = torch.zeros(16, 16, 3, 3)
        match = "vfnet_reg_conv"
    elif case == "vfnet_missing_gn":
        sd = {k: v for k, v in sd.items() if ".vfnet_cls_gn." not in k}
        match = "lacks 2 of the model's tensors: bbox_head.vfnet_cls_gn.bias"
    else:
        sd["bbox_head.atss_centerness.weight"] = torch.zeros(1, 16, 3, 3)
        sd["bbox_head.cls_convs.0.gn.weight"] = torch.zeros(16)
        match = "ATSS head.*atss_centerness"
    with pytest.raises(KeyError, match=match):
        load_mmdet_checkpoint(model, {"state_dict": sd})


@pytest.mark.parametrize("name", ["fsaf", "ld"])
def test_mmdet_checkpoint_names_fsaf_outputs_and_ld_teacher(name, tmp_path):
    """mmdet's FSAF head is a RetinaHead and names its outputs
    ``retina_cls`` and ``retina_reg``: the port's ``conv_cls`` and
    ``conv_reg`` load them (``FSAFHead.mmdet_names``). mmdet's LD detector
    keeps its teacher under ``teacher_model.``: the port's teacher loads
    from there. Both narrowed (``torch_onestage_cases.tiny_model``): every
    tensor loaded, the models equal."""
    import torch
    import torch_onestage_cases as oc
    from oadg_tpu_torch.apis import init_detector
    from oadg_tpu_torch.utils.checkpoint import load_mmdet_checkpoint
    model = oc.tiny_model(name)
    src = init_detector({"model": model}, device="cpu", seed=1).model
    with torch.no_grad():
        for p in src.parameters():
            p.add_(0.01)
    rename = {"bbox_head.conv_cls.": "bbox_head.retina_cls.",
              "bbox_head.conv_reg.": "bbox_head.retina_reg."} if name == "fsaf" else {}
    sd = {}
    for k, v in src.state_dict().items():
        for ours, theirs in rename.items():
            k = k.replace(ours, theirs)
        sd[k] = v
    path = tmp_path / "model.pth"
    torch.save({"state_dict": sd, "meta": {}}, path)
    dst = init_detector({"model": model}, device="cpu", seed=2).model
    report = load_mmdet_checkpoint(dst, str(path))
    assert not report["missing"] and not report["skipped"]
    for k, v in src.state_dict().items():
        assert torch.equal(dst.state_dict()[k], v), k
    want = {"fsaf": ["bbox_head.retina_cls.weight", "bbox_head.retina_reg.bias"],
            "ld": ["teacher_model.backbone.conv1.weight", "teacher_model.neck.fpn_convs.4.conv.weight",
                   "teacher_model.bbox_head.gfl_reg.weight", "bbox_head.gfl_reg.weight"]}[name]
    assert set(want) <= set(sd)
    assert set(k.replace("retina_", "conv_") for k in want) <= set(report["loaded"])


THIRD = {"guided_anchoring/ga_retinanet_r50_fpn_1x_coco.py": "GARetinaHead",
         "sabl/sabl_retinanet_r50_fpn_1x_coco.py": "SABLRetinaHead",
         "nas_fpn/retinanet_r50_nasfpn_crop640_50e_coco.py": "RetinaSepBNHead",
         "nas_fcos/nas_fcos_nashead_r50_caffe_fpn_gn-head_4x4_1x_coco.py": "NASFCOSHead"}


@pytest.mark.parametrize("rel", sorted(THIRD))
def test_onestage3_configs_build_their_heads(rel):
    """GA-RetinaNet, SABL-RetinaNet, NAS-FPN and NAS-FCOS at full width, 80
    classes: GA's loc and shape convs and its two DCNv1 adaptions of 4
    deform groups (72 offsets), SABL's 4 x 14 bucket outputs and 9 approx
    anchors a location, NAS-FPN's 3 laterals and 7 stacks of 8 cells with
    live BNs and RetinaSepBNHead's tower convs shared by its 5 levels'
    BNs, NAS-FCOS (with ``start_level=1``) on C3..C5 with 2 merge cells and
    FCOS's GN towers."""
    det = _build(rel, STRIDE_REFUSED.get(rel, (None, None))[1])
    head = det.bbox_head
    assert type(head).__name__ == THIRD[rel]
    assert type(det).__name__ == ("NASFCOS" if "nas_fcos" in rel else "RetinaNet")
    if THIRD[rel] == "GARetinaHead":
        assert len(head.cls_convs) == 4 and head.retina_cls.weight.shape == (80, 256, 3, 3)
        assert head.conv_loc.weight.shape == (1, 256, 1, 1)
        assert head.conv_shape.weight.shape == (2, 256, 1, 1)
        for fa in (head.feature_adaption_cls, head.feature_adaption_reg):
            assert fa.conv_offset.weight.shape == (72, 2, 1, 1)
            assert fa.conv_adaption.weight.shape == (256, 256, 3, 3)
            assert fa.conv_adaption.deform_groups == 4
    if THIRD[rel] == "SABLRetinaHead":
        assert head.retina_bbox_cls.weight.shape == head.retina_bbox_reg.weight.shape == \
            (56, 256, 3, 3)
        assert head.approxs_per_octave == 9 and head.square_gen.num_base_anchors == [1] * 5
        assert head.retina_cls.weight.shape == (80, 256, 3, 3)
    if THIRD[rel] == "RetinaSepBNHead":
        neck = det.neck
        assert [m.conv.weight.shape[1] for m in neck.lateral_convs] == [512, 1024, 2048]
        assert len(neck.fpn_stages) == 7 and len(neck.fpn_stages[6]) == 8
        cell = neck.fpn_stages[6]["gp_75_6"].out_conv
        assert cell.conv.bias is None and type(cell.bn).__name__ == "BatchNorm"
        assert len(head.cls_convs) == 5 and len(head.cls_convs[4]) == 4
        assert head.cls_convs[4][3].conv is head.cls_convs[0][3].conv
        assert head.cls_convs[4][3].bn is not head.cls_convs[0][3].bn
        assert head.retina_cls.weight.shape == (720, 256, 3, 3)
    if THIRD[rel] == "NASFCOSHead":
        assert [m.conv.weight.shape[1] for m in det.neck.adapt_convs] == [512, 1024, 2048]
        assert len(det.neck.merge_convs) == 2
        assert len(head.cls_convs) == 4 and head.cls_convs[0].gn.num_groups == 32
        assert head.strides == (8, 16, 32, 64, 128)


@pytest.mark.parametrize("name", ["ga_retina", "sabl_retina", "nas_fpn", "nas_fcos"])
def test_mmdet_checkpoint_carries_the_onestage3_modules(name, tmp_path):
    """The four narrowed (``torch_onestage_cases.tiny_model``) under mmdet's
    names: GA's ``feature_adaption_cls`` / ``_reg``, ``conv_loc`` and
    ``conv_shape``; SABL's ``retina_bbox_cls`` / ``retina_bbox_reg``; NAS-FPN's
    ``fpn_stages`` cells and RetinaSepBNHead's ``cls_convs.{level}.{i}`` (the
    shared conv under every level, each level's BN with its running
    statistics); NAS-FCOS's ``adapt_convs`` and ``merge_convs``: every tensor
    loaded, the models equal."""
    import torch
    import torch_onestage_cases as oc
    from oadg_tpu_torch.apis import init_detector
    from oadg_tpu_torch.utils.checkpoint import load_mmdet_checkpoint
    model = oc.tiny_model(name)
    src = init_detector({"model": model}, device="cpu", seed=1).model
    with torch.no_grad():
        for p in src.parameters():
            p.add_(0.01)
        for k, v in src.state_dict().items():
            if ".running_" in k:
                v.add_(0.5)
    path = tmp_path / "model.pth"
    torch.save({"state_dict": src.state_dict(), "meta": {}}, path)
    dst = init_detector({"model": model}, device="cpu", seed=2).model
    report = load_mmdet_checkpoint(dst, str(path))
    assert not report["missing"] and not report["skipped"]
    for k, v in src.state_dict().items():
        assert torch.equal(dst.state_dict()[k], v), k
    want = {"ga_retina": ["bbox_head.feature_adaption_cls.conv_offset.weight",
                          "bbox_head.feature_adaption_reg.conv_adaption.weight",
                          "bbox_head.conv_loc.bias", "bbox_head.conv_shape.weight"],
            "sabl_retina": ["bbox_head.retina_bbox_cls.weight", "bbox_head.retina_bbox_reg.bias"],
            "nas_fpn": ["neck.fpn_stages.1.gp_55_7.out_conv.bn.running_var",
                        "neck.lateral_convs.2.bn.weight", "bbox_head.cls_convs.4.0.conv.weight",
                        "bbox_head.reg_convs.3.0.bn.running_mean"],
            "nas_fcos": ["neck.adapt_convs.0.conv.weight", "neck.merge_convs.1.bn.running_mean",
                         "bbox_head.cls_convs.0.gn.weight"]}[name]
    assert set(want) <= set(report["loaded"])


# a tensor of mmdet's that the port lacks (its model, the key, what the
# refusal names), or (key None) one of the port's that mmdet's lacks
LACKS = {
    "nas_fpn_extra_downsample": ("nas_fpn", "neck.extra_downsamples.0.0.conv.weight",
                                 "extra levels"),
    "nas_fpn_sum_77_7": ("nas_fpn", "neck.fpn_stages.0.sum_77_7.out_conv.conv.weight",
                         "sum_77_7"),
    "nas_fpn_cell_bias": ("nas_fpn", "neck.fpn_stages.1.gp_64_4.out_conv.conv.bias",
                          "conv's bias"),
    "nas_fcos_concat_cell": ("nas_fcos", "neck.fpn.c22_1.conv.weight", "concat cells"),
    "nas_fcos_dcn_tower": ("nas_fcos", "bbox_head.cls_convs.0.conv.conv_offset.weight",
                           "deformable tower"),
    "ga_offset_bias_missing": ("ga_retina", None, "lacks 2 of the model's tensors: "
                               "bbox_head.feature_adaption_cls.conv_offset.bias"),
}


@pytest.mark.parametrize("case", sorted(LACKS))
def test_mmdet_checkpoint_names_the_nas_and_ga_parts_one_side_lacks(case):
    """mmdet's NAS-FPN has convs on its extra levels, a ``sum_77_7`` cell
    and biased cell convs; its NAS-FCOS neck is built of concat cells
    (``neck.fpn``) and its head's towers of deformable convs; mmdet's GA
    ``conv_offset`` has no bias, the JAX one's (and so the port's) has: a
    checkpoint with a tensor of the first kind raises naming it
    (``MMDET_ONLY``), one without a tensor the port has raises naming it
    (missing)."""
    import torch
    import torch_onestage_cases as oc
    from oadg_tpu_torch.apis import init_detector
    from oadg_tpu_torch.utils.checkpoint import load_mmdet_checkpoint
    name, extra, match = LACKS[case]
    model = init_detector({"model": oc.tiny_model(name)}, device="cpu", seed=1).model
    sd = dict(model.state_dict())
    if extra is None:
        sd = {k: v for k, v in sd.items() if not k.endswith("conv_offset.bias")}
    else:
        sd[extra] = torch.zeros(4)
    with pytest.raises(KeyError, match=match):
        load_mmdet_checkpoint(model, {"state_dict": sd})


FOURTH = {"reppoints/reppoints_moment_r50_fpn_1x_coco.py": ("RepPointsDetector", "RepPointsHead"),
          "centernet/centernet_resnet18_140e_coco.py": ("CenterNet", "CenterNetHead"),
          "cornernet/cornernet_hourglass104_mstest_8x6_210e_coco.py": ("CornerNet", "CornerHead"),
          "centripetalnet/centripetalnet_hourglass104_mstest_16x6_210e_coco.py":
              ("CornerNet", "CentripetalHead")}


@pytest.mark.parametrize("rel", sorted(FOURTH))
def test_onestage4_configs_build_their_heads(rel):
    """RepPoints, CenterNet, CornerNet and CentripetalNet at full width, 80
    classes: RepPoints' GN towers of 3, its two DCNv1s on 256 channels and
    the 18 point coordinates of both stages; CenterNet's R18 stage 2 (128
    channels at stride 8) and its three branches, no neck; the two-stack
    Hourglass-104 (5 levels of 256 to 512 channels, live BNs) and, on each
    stack, two corner pools and the heatmap, embedding (CornerNet) or
    centripetal-shift (CentripetalNet, which builds no embeddings) and
    offset branches."""
    det = _build(rel)
    kind, head_kind = FOURTH[rel]
    head = det.bbox_head
    assert type(det).__name__ == kind and type(head).__name__ == head_kind
    if head_kind == "RepPointsHead":
        assert len(head.cls_convs) == 3 and head.cls_convs[0].gn.num_groups == 32
        assert head.reppoints_cls_conv.weight.shape == (256, 256, 3, 3)
        assert head.reppoints_pts_refine_conv.weight.shape == (256, 256, 3, 3)
        assert head.reppoints_pts_init_out.weight.shape == (18, 256, 1, 1)
        assert head.reppoints_cls_out.weight.shape == (80, 256, 1, 1)
        assert head.moment_transfer.shape == (2,)
    if head_kind == "CenterNetHead":
        assert det.neck is None and det.backbone.out_indices == (1,)
        assert head.heatmap_head[0].weight.shape == (128, 128, 3, 3)
        assert head.heatmap_head[2].weight.shape == (80, 128, 1, 1)
        assert head.wh_head[2].weight.shape == head.offset_head[2].weight.shape == \
            (2, 128, 1, 1)
    if head_kind in ("CornerHead", "CentripetalHead"):
        bb = det.backbone
        assert det.neck is None and len(bb.hourglass_modules) == 2
        assert bb.stem[0].conv.weight.shape == (128, 3, 7, 7)
        level, depth = bb.hourglass_modules[0], 1
        while hasattr(level.low2, "low2"):
            level, depth = level.low2, depth + 1
        assert depth == 5 and len(level.low2) == 4
        assert level.low2[0].conv1.weight.shape == (512, 512, 3, 3)
        assert type(bb.out_convs[1].bn).__name__ == "BatchNorm"
        assert len(head.tl_pool) == 2 and len(head.br_heat) == 2
        assert head.tl_heat[1][1].conv.weight.shape == (80, 256, 1, 1)
        assert head.br_pool[0].direction1_conv.conv.weight.shape == (256, 256, 3, 3)
        assert head.tl_off[0][1].conv.weight.shape == (2, 256, 1, 1)
        if head_kind == "CornerHead":
            assert head.tl_emb[0][1].conv.weight.shape == (1, 256, 1, 1)
        else:
            assert not hasattr(head, "tl_emb")
            assert head.tl_centripetal_shift[0][1].conv.weight.shape == (2, 256, 1, 1)


@pytest.mark.parametrize("name", ["reppoints", "centernet", "cornernet", "centripetalnet"])
def test_mmdet_checkpoint_carries_the_onestage4_modules(name, tmp_path):
    """The four narrowed (``torch_onestage_cases.tiny_model``) under mmdet's
    names: RepPoints' ``reppoints_*`` convs and ``moment_transfer``,
    CenterNet's ``heatmap_head`` / ``wh_head`` / ``offset_head``, the
    Hourglass's ``stem``, ``hourglass_modules``, ``conv1x1s``,
    ``remap_convs`` and ``inters`` with their running statistics, the corner
    heads' ``tl_pool`` (``direction1_conv``, ``aftpool_conv``, ``conv1``),
    ``tl_heat``, ``tl_emb`` and ``tl_centripetal_shift``: every tensor
    loaded, the models equal."""
    import torch
    import torch_onestage_cases as oc
    from oadg_tpu_torch.apis import init_detector
    from oadg_tpu_torch.utils.checkpoint import load_mmdet_checkpoint
    model = oc.tiny_model(name)
    src = init_detector({"model": model}, device="cpu", seed=1).model
    with torch.no_grad():
        for p in src.parameters():
            p.add_(0.01)
        for k, v in src.state_dict().items():
            if ".running_" in k:
                v.add_(0.5)
    path = tmp_path / "model.pth"
    torch.save({"state_dict": src.state_dict(), "meta": {}}, path)
    dst = init_detector({"model": model}, device="cpu", seed=2).model
    report = load_mmdet_checkpoint(dst, str(path))
    assert not report["missing"] and not report["skipped"]
    for k, v in src.state_dict().items():
        assert torch.equal(dst.state_dict()[k], v), k
    want = {"reppoints": ["bbox_head.reppoints_cls_conv.weight", "bbox_head.moment_transfer",
                          "bbox_head.reppoints_pts_refine_out.bias"],
            "centernet": ["bbox_head.heatmap_head.0.weight", "bbox_head.offset_head.2.bias"],
            "cornernet": ["backbone.stem.0.bn.running_var",
                          "backbone.hourglass_modules.1.low2.low3.0.downsample.1.running_mean",
                          "backbone.conv1x1s.0.bn.weight", "backbone.inters.0.conv2.weight",
                          "bbox_head.tl_pool.1.aftpool_conv.bn.running_var",
                          "bbox_head.br_emb.0.1.conv.bias"],
            "centripetalnet": ["bbox_head.tl_centripetal_shift.1.0.conv.weight",
                               "bbox_head.br_pool.0.conv1.conv.weight"]}[name]
    assert set(want) <= set(report["loaded"])


LACKS4 = {
    "corner_pool_conv2": ("cornernet", "bbox_head.tl_pool.0.conv2.conv.weight",
                          "conv2 after mmdet's BiCornerPool"),
    "centripetal_guiding_shift": ("centripetalnet", "bbox_head.tl_guiding_shift.0.0.conv.weight",
                                  "guiding shifts"),
    "centripetal_feat_adaption": ("centripetalnet", "bbox_head.br_feat_adaption.0.weight",
                                  "feature adaption"),
    "hourglass_low3_last_block": (
        "cornernet", "backbone.hourglass_modules.0.low2.low3.1.downsample.0.weight",
        "low3 changes its channels in its last block"),
    "reppoints_gn_missing": ("reppoints", None, "lacks 4 of the model's tensors: "
                             "bbox_head.cls_gn_out.bias, bbox_head.cls_gn_out.weight"),
}


@pytest.mark.parametrize("case", sorted(LACKS4))
def test_mmdet_checkpoint_names_the_onestage4_parts_one_side_lacks(case):
    """mmdet's ``BiCornerPool`` ends in a 3x3 ``conv2``, its CentripetalHead
    has guiding shifts and a deformable feature adaption, and its Hourglass
    ``low3`` changes channels in its last block: a checkpoint with such a
    tensor raises naming it (``MMDET_ONLY``); RepPoints' GNs after its DCNs
    are the JAX head's, and a checkpoint without them raises naming them
    (missing)."""
    import torch
    import torch_onestage_cases as oc
    from oadg_tpu_torch.apis import init_detector
    from oadg_tpu_torch.utils.checkpoint import load_mmdet_checkpoint
    name, extra, match = LACKS4[case]
    model = init_detector({"model": oc.tiny_model(name)}, device="cpu", seed=1).model
    sd = dict(model.state_dict())
    if extra is None:
        sd = {k: v for k, v in sd.items() if not k.startswith(("bbox_head.cls_gn_out.",
                                                                "bbox_head.pts_refine_gn."))}
    else:
        sd[extra] = torch.zeros(4)
    with pytest.raises(KeyError, match=match):
        load_mmdet_checkpoint(model, {"state_dict": sd})


def test_centernet_config_names_no_data_or_schedule():
    """The reference-side fact: the repo's CenterNet config has a model and
    an optimizer but no ``data``, ``lr_config`` or ``runner`` (its
    ``_base_`` is the runtime alone): a run must be given a dataset, and
    trains at a constant LR where it is given no schedule (``chip_smoke.py``
    gives it the Cityscapes base's data, ``DATA_BASE``, and the Cityscapes
    config's warm-up, ``SCHEDULE_BASE``)."""
    cfg = load_config(osp.join(CFG_ROOT, "centernet/centernet_resnet18_140e_coco.py"))
    assert cfg.get("model") and cfg.get("optimizer")
    assert not any(cfg.get(k) for k in ("data", "lr_config", "runner"))


def test_chip_smoke_gives_centernet_data_and_a_warm_up():
    """``chip_smoke.onestage_cfg`` gives CenterNet's config the Cityscapes
    base's data and the Cityscapes config's linear warm-up: its two smoke
    steps run at ~1e-3 of the config's LR (at the constant LR the second
    step's losses reached 1.5e16)."""
    import chip_smoke
    from oadg_tpu_torch.engine import build_lr_schedule
    cfg = chip_smoke.onestage_cfg("centernet", "configs/centernet/centernet_resnet18_140e_coco.py")
    assert cfg.data.test.pipeline and cfg.img_norm_cfg
    assert cfg.lr_config["warmup"] == "linear" and cfg.optimizer["lr"] == 0.00125
    lr = build_lr_schedule(cfg.lr_config, cfg.optimizer["lr"], 100)
    assert lr(0) < lr(1) < 5e-6


FIFTH = {"yolof/yolof_r50_c5_8x8_1x_coco.py": ("YOLOF", "YOLOFHead"),
         "yolox/yolox_s_8x8_300e_coco.py": ("YOLOX", "YOLOXHead"),
         "ssd/ssd300_coco.py": ("SSD", "SSDHead"),
         "solo/solo_r50_fpn_1x_coco.py": ("SOLO", "SOLOHead"),
         "yolact/yolact_r50_1x8_coco.py": ("YOLACT", "YOLACTHead")}


@pytest.mark.parametrize("rel", sorted(FIFTH))
def test_fifth_configs_build_their_modules(rel):
    """YOLOF, YOLOX-S, SSD300, SOLO and YOLACT at full width, 80 classes:
    YOLOF's caffe R50 C5, its DilatedEncoder (4 blocks of 128 dilated by 2
    to 8, live BNs) and its 5-anchor head with the implicit objectness;
    YOLOX-S's CSPDarknet at 0.33 / 0.5 (the Focus stem's 12 inputs, 1 and 3
    bottlenecks a stage, the SPP of stage 4), its PAFPN at 128 and the
    decoupled head of 3 levels; SSD300's VGG-16 with its L2Norm, conv6
    dilated by 6 and the 8 extra convs, 4 / 6 / 6 / 6 / 4 / 4 anchors of 81
    softmax logits; SOLO's 7 GN convs a tower and 40^2 to 12^2 mask
    channels; YOLACT's one shared head conv, 3 anchors of 32 coefficients
    and its protonet."""
    det = _build(rel)
    kind, head_kind = FIFTH[rel]
    head = det.bbox_head
    assert type(det).__name__ == kind and type(head).__name__ == head_kind
    if kind == "YOLOF":
        assert det.backbone.out_indices == (3,)
        blocks = det.neck.dilated_encoder_blocks
        assert len(blocks) == 4 and [b.conv2.conv.dilation for b in blocks] == [(d, d) for d in
                                                                             (2, 4, 6, 8)]
        assert blocks[0].conv1.conv.weight.shape == (128, 512, 1, 1)
        assert type(det.neck.lateral_norm).__name__ == "BatchNorm"
        assert len(head.cls_subnet) == 2 and len(head.bbox_subnet) == 4
        assert head.cls_score.weight.shape == (400, 512, 3, 3)
        assert head.object_pred.weight.shape == (5, 512, 3, 3)
        assert head.bbox_coder.add_ctr_clamp and head.bbox_coder.ctr_clamp == 32
        assert (head.match_times, head.pos_ignore_thr, head.neg_ignore_thr) == (4, 0.15, 0.7)
    if kind == "YOLOX":
        bb = det.backbone
        assert bb.stem.conv.conv.weight.shape == (32, 12, 3, 3)
        assert [len(getattr(bb, f"stage{k}")[-1].blocks) for k in (1, 2, 3, 4)] == [1, 3, 3, 1]
        assert type(bb.stage4[1]).__name__ == "SPPBottleneck"
        assert bb.stage4[0].bn.eps == 1e-3 and bb.stage4[0].bn.momentum == 0.03
        assert [m.conv.weight.shape[0] for m in det.neck.out_convs] == [128] * 3
        assert len(head.multi_level_conv_cls) == 3
        assert head.multi_level_conv_cls[0].weight.shape == (80, 128, 1, 1)
        assert head.center_radius == 2.5
    if kind == "SSD":
        bb = det.backbone
        assert bb.features[31].dilation == (6, 6) and bb.features[31].padding == (6, 6)
        assert bb.l2_norm.weight.shape == (512,)
        assert len(bb.extra) == 8 and bb.extra[7].padding == (0, 0)
        assert [c.weight.shape[0] for c in head.cls_convs] == [a * 81 for a in (4, 6, 6, 6, 4, 4)]
        assert head.assigner.gt_max_assign_all is False and head.neg_pos_ratio == 3
    if kind == "SOLO":
        assert len(head.cls_convs) == len(head.mask_convs) == 7
        assert head.mask_convs[0].conv.weight.shape == (256, 258, 3, 3)
        assert [c.weight.shape[0] for c in head.conv_mask_list] == [s * s for s in
                                                                    (40, 36, 24, 16, 12)]
        assert head.strides == (8, 8, 16, 32, 32)
    if kind == "YOLACT":
        assert len(head.head_convs) == 1 and head.conv_cls.weight.shape == (243, 256, 3, 3)
        assert head.conv_coeff.weight.shape == (96, 256, 3, 3)
        assert len(head.proto_convs) == 3 and head.proto_out.weight.shape == (32, 256, 1, 1)
        assert head.segm_conv.weight.shape == (80, 256, 1, 1)


@pytest.mark.parametrize("name", ["yolof", "yolox", "ssd", "solo", "yolact"])
def test_mmdet_checkpoint_carries_the_fifth_modules(name, tmp_path):
    """The five narrowed (``torch_onestage_cases.tiny_model``) under mmdet's
    names (YOLOX's Focus stem weight in mmdet's channel order on file):
    every tensor loaded, the models equal."""
    import torch
    import torch_onestage_cases as oc
    from oadg_tpu_torch.apis import init_detector
    from oadg_tpu_torch.models.backbones.csp_darknet import focus_mmdet_order
    from oadg_tpu_torch.utils.checkpoint import load_mmdet_checkpoint
    model = oc.tiny_model(name)
    src = init_detector({"model": model}, device="cpu", seed=1).model
    with torch.no_grad():
        for p in src.parameters():
            p.add_(0.01)
        for k, v in src.state_dict().items():
            if ".running_" in k:
                v.add_(0.5)
    sd = dict(src.state_dict())
    if name == "yolox":
        sd["backbone.stem.conv.conv.weight"] = focus_mmdet_order(sd["backbone.stem.conv.conv.weight"])
    path = tmp_path / "model.pth"
    torch.save({"state_dict": sd, "meta": {}}, path)
    dst = init_detector({"model": model}, device="cpu", seed=2).model
    report = load_mmdet_checkpoint(dst, str(path))
    assert not report["missing"] and not report["skipped"]
    for k, v in src.state_dict().items():
        assert torch.equal(dst.state_dict()[k], v), k
    want = {"yolof": ["neck.dilated_encoder_blocks.3.conv2.bn.running_var",
                      "neck.lateral_norm.weight", "bbox_head.bbox_subnet.3.conv.weight",
                      "bbox_head.object_pred.bias"],
            "yolox": ["backbone.stem.conv.conv.weight", "backbone.stage4.1.conv2.bn.running_mean",
                      "neck.top_down_blocks.1.blocks.0.conv2.conv.weight",
                      "bbox_head.multi_level_conv_obj.2.bias", "bbox_head.stems.0.bn.weight"],
            "ssd": ["backbone.features.33.weight", "backbone.extra.7.bias",
                    "backbone.l2_norm.weight", "bbox_head.cls_convs.5.weight"],
            "solo": ["bbox_head.mask_convs.0.gn.weight", "bbox_head.conv_mask_list.4.bias",
                     "bbox_head.conv_cls.weight"],
            "yolact": ["bbox_head.head_convs.0.conv.weight", "bbox_head.conv_coeff.bias",
                       "bbox_head.proto_convs.2.weight", "bbox_head.segm_conv.weight"]}[name]
    assert set(want) <= set(report["loaded"])


LACKS5 = {
    "yolact_protonet": ("yolact", "mask_head.protonet.0.weight", "protonet"),
    "yolact_segm_head": ("yolact", "segm_head.segm_conv.weight", "segm_head"),
    "ssd_neck": ("ssd", "neck.l2_norm.weight", "SSDNeck"),
    "yolof_conv_bias_missing": ("yolof", None, "lacks 6 of the model's tensors: "
                                "bbox_head.bbox_subnet.0.conv.bias"),
}


@pytest.mark.parametrize("case", sorted(LACKS5))
def test_mmdet_checkpoint_names_the_fifth_parts_one_side_lacks(case):
    """mmdet's YOLACT keeps its protonet and semantic head as its own
    ``mask_head`` and ``segm_head``, and its SSD (2.18 on) the L2Norm and the
    extra convs in an ``SSDNeck``: a checkpoint with such a tensor raises
    naming it (``MMDET_ONLY``); mmdet's YOLOF towers have no conv bias, the
    JAX head's (and the port's) have, and a checkpoint without them raises
    naming them (missing)."""
    import torch
    import torch_onestage_cases as oc
    from oadg_tpu_torch.apis import init_detector
    from oadg_tpu_torch.utils.checkpoint import load_mmdet_checkpoint
    name, extra, match = LACKS5[case]
    model = init_detector({"model": oc.tiny_model(name)}, device="cpu", seed=1).model
    sd = dict(model.state_dict())
    if extra is None:
        sd = {k: v for k, v in sd.items() if not re.match(r"bbox_head\.\w+_subnet\.\d+\.conv\.bias", k)}
    else:
        sd[extra] = torch.zeros(4)
    with pytest.raises(KeyError, match=match):
        load_mmdet_checkpoint(model, {"state_dict": sd})


@pytest.mark.parametrize("rel", ["yolox/yolox_s_8x8_300e_coco.py", "ssd/ssd300_coco.py"])
def test_yolox_and_ssd_configs_name_no_data(rel):
    """The reference-side fact: the repo's YOLOX-S and SSD300 configs have a
    model and an optimizer but no ``data``, ``lr_config`` or ``runner``
    (``chip_smoke.py`` gives them the Cityscapes base's data and warm-up,
    ``DATA_BASE``; SSD's pipelines resized to its fixed 300x300)."""
    cfg = load_config(osp.join(CFG_ROOT, rel))
    assert cfg.get("model") and cfg.get("optimizer")
    assert not any(cfg.get(k) for k in ("data", "lr_config", "runner"))


@pytest.mark.parametrize("name", ["solo", "yolact"])
def test_box_test_path_refuses_solo_and_yolact(name):
    """JAX's ``run_test`` unpacks a test call as (dets, labels, valid): on
    SOLO's (masks, labels, scores) it indexes with the float scores and
    raises ``IndexError``, on YOLACT's four outputs the unpacking raises
    ``ValueError``. The port's ``single_gpu_test`` and
    ``inference_detector`` refuse both with a ``ValueError`` that says
    why; ``DetectorHandle.test`` serves them."""
    import torch
    import torch_onestage_cases as oc
    from oadg_tpu.apis.test import run_test as jax_run_test
    from oadg_tpu_torch.apis import inference_detector, init_detector
    from oadg_tpu_torch.apis.test import single_gpu_test
    k, hw, c = 6, (16, 24), 8
    outs = ((np.zeros((1, k, *hw), bool), np.zeros((1, k), np.int32), np.ones((1, k), np.float32))
            if name == "solo" else
            (np.zeros((1, k, 5), np.float32), np.zeros((1, k), np.int32), np.ones((1, k), bool),
             np.zeros((1, k, 32), np.float32)))
    batch = {"img": np.zeros((1, 64, 96, 3), np.float32)}
    with pytest.raises(IndexError if name == "solo" else ValueError):
        jax_run_test(lambda p, s, b: outs, None, None, [batch], c)
    handle = init_detector({"model": oc.tiny_model(name)}, device="cpu", seed=0)
    with pytest.raises(ValueError, match="cannot score it"):
        single_gpu_test(dict(handle=handle, test_fn=lambda b: None, num_classes=c), [batch])
    with pytest.raises(ValueError, match=f"{type(handle.model).__name__}'s test call returns"):
        inference_detector(handle, np.zeros((64, 96, 3), np.uint8))
    x = torch.zeros(1, 3, 64, 96)
    res = handle.test({"img": x, "img_shape": torch.tensor([[64.0, 96.0]]),
                       "scale_factor": torch.ones(1, 4)})
    assert len(res) == (3 if name == "solo" else 4)


TRANSFORMER = {"detr/detr_r50_8x2_150e_coco.py": ("DETR", "DETRHead"),
               "deformable_detr/deformable_detr_r50_16x2_50e_coco.py":
                   ("DeformableDETR", "DeformableDETRHead"),
               "panoptic_fpn/panoptic_fpn_r50_fpn_1x_coco.py": ("PanopticFPN", None)}


@pytest.mark.parametrize("rel", sorted(TRANSFORMER))
def test_transformer_and_panoptic_configs_build_their_modules(rel):
    """DETR, Deformable DETR and PanopticFPN at full width as given: DETR's
    dense ``input_proj`` from C5's 2048 channels, 6 encoder and 6 decoder
    layers of 256 channels, 8 heads and 2048 in the FFN, 100 queries, 81
    softmax logits; Deformable DETR's ChannelMapper of three 3x3 convs
    (``num_outs=4`` dropped), 6 + 6 layers with 1024 in the FFN, 3 levels'
    offsets (192) and weights (96), one value projection a level, 300
    queries of 512, 4 level embeddings, 6 classifiers and box branches;
    PanopticFPN's semantic head on the 5 FPN levels with 54 stuff logits at
    stride 8 and its mask head on the box layer's 7x7 (no mask RoI layer
    given)."""
    det = _build(rel)
    kind, head_kind = TRANSFORMER[rel]
    assert type(det).__name__ == kind
    if kind == "DETR":
        head = det.bbox_head
        assert type(head).__name__ == head_kind and det.neck is None
        assert head.input_proj.weight.shape == (256, 2048)
        t = head.transformer
        assert len(t.encoder.layers) == len(t.decoder.layers) == 6
        assert t.decoder.layers[5].attentions[1].attn.in_proj_weight.shape == (768, 256)
        assert t.encoder.layers[0].ffns[0].layers[0][0].weight.shape == (2048, 256)
        assert head.query_embedding.weight.shape == (100, 256)
        assert head.fc_cls.weight.shape == (81, 256)
        assert head.reg_ffn.layers[1].weight.shape == (256, 256)
    elif kind == "DeformableDETR":
        head = det.bbox_head
        assert [c.conv.weight.shape for c in det.neck.convs] == [
            (256, c, 3, 3) for c in (512, 1024, 2048)]
        t = head.transformer
        assert len(t.encoder.layers) == len(t.decoder.layers) == 6 and head.num_levels == 3
        att = t.decoder.layers[0].attentions[1]
        assert att.sampling_offsets.weight.shape == (192, 256)
        assert att.attention_weights.weight.shape == (96, 256) and len(att.value_proj) == 3
        assert t.encoder.layers[0].ffns[0].layers[0][0].weight.shape == (1024, 256)
        assert head.query_embedding.weight.shape == (300, 512)
        assert t.level_embeds.shape == (4, 256) and t.reference_points.weight.shape == (2, 256)
        assert len(head.cls_branches) == 6 and head.cls_branches[5].weight.shape == (80, 256)
        assert head.reg_branches[0][4].weight.shape == (4, 256)
        assert head.cls_branches[0] is not head.cls_branches[1]
    else:
        sem = det.semantic_head
        assert len(sem.lateral_convs) == 5 and len(sem.convs) == 4
        assert sem.conv_logits.weight.shape == (54, 256, 1, 1) and sem.fusion_level == 1
        assert det.roi_head.mask_roi_extractor.output_size == 7
        assert det.roi_head.mask_head.conv_logits.weight.shape == (80, 256, 1, 1)
        assert det.instance_outputs


def _mmdet_sd(name, src):
    """The tiny model's ``state_dict`` under mmdet's names: DETR's
    ``input_proj`` as a 1x1 conv, each deformable attention's one shared
    ``value_proj`` (the source's levels made equal first)."""
    import torch
    with torch.no_grad():
        for k, v in src.state_dict().items():
            if re.search(r"\.value_proj\.[1-9]\d*\.", k):
                v.copy_(src.state_dict()[re.sub(r"\.value_proj\.\d+\.", ".value_proj.0.", k)])
    sd = {}
    for k, v in src.state_dict().items():
        if k == "bbox_head.input_proj.weight" and name == "detr":
            v = v[..., None, None]
        sd[re.sub(r"\.value_proj\.\d+\.", ".value_proj.", k)] = v
    return sd


@pytest.mark.parametrize("name", ["detr", "deformable_detr", "panoptic_fpn"])
def test_mmdet_checkpoint_carries_the_transformer_and_panoptic_modules(name, tmp_path):
    """The three narrowed (``torch_detr_cases.tiny_model``) under mmdet's
    names: the transformers' ``attentions``, ``ffns`` and ``norms``,
    ``query_embedding``, DETR's ``reg_ffn`` and its 1x1-conv
    ``input_proj``, Deformable DETR's ``level_embeds``,
    ``reference_points``, ``cls_branches`` and ``reg_branches``, mmdet's one
    ``value_proj`` an attention copied into each level's, ChannelMapper's
    ``convs``, PanopticFPN's ``semantic_head``: every tensor loaded, the
    models equal."""
    import torch
    import torch_detr_cases as dcases
    from oadg_tpu_torch.apis import init_detector
    from oadg_tpu_torch.utils.checkpoint import load_mmdet_checkpoint
    model = dcases.torch_model(name)
    src = init_detector({"model": model}, device="cpu", seed=1).model
    with torch.no_grad():
        for p in src.parameters():
            p.add_(0.01)
    sd = _mmdet_sd(name, src)
    path = tmp_path / "model.pth"
    torch.save({"state_dict": sd, "meta": {}}, path)
    dst = init_detector({"model": model}, device="cpu", seed=2).model
    report = load_mmdet_checkpoint(dst, str(path))
    assert not report["missing"] and not report["skipped"]
    for k, v in src.state_dict().items():
        assert torch.equal(dst.state_dict()[k], v), k
    want = {"detr": ["bbox_head.input_proj.weight", "bbox_head.query_embedding.weight",
                     "bbox_head.transformer.decoder.layers.1.attentions.1.attn.in_proj_weight",
                     "bbox_head.transformer.encoder.layers.0.ffns.0.layers.0.0.bias",
                     "bbox_head.reg_ffn.layers.1.weight"],
            "deformable_detr": [
                "neck.convs.2.conv.weight", "bbox_head.transformer.level_embeds",
                "bbox_head.transformer.reference_points.weight",
                "bbox_head.transformer.encoder.layers.0.attentions.0.value_proj.2.weight",
                "bbox_head.transformer.decoder.layers.1.norms.2.bias",
                "bbox_head.cls_branches.1.bias", "bbox_head.reg_branches.0.4.weight"],
            "panoptic_fpn": ["semantic_head.lateral_convs.4.conv.weight",
                             "semantic_head.conv_logits.bias",
                             "roi_head.mask_head.conv_logits.weight"]}[name]
    assert set(want) <= set(report["loaded"])
    if name == "deformable_detr":
        assert not any(re.search(r"\.value_proj\.\d", k) for k in sd)


LACKS_TR = {
    "detr_post_norm": ("detr", "bbox_head.transformer.decoder.post_norm.weight", KeyError,
                       "DETR's decoder post_norm"),
    "channel_mapper_extra_level": ("deformable_detr", "neck.extra_convs.0.conv.weight", KeyError,
                                   "ChannelMapper's extra level for num_outs"),
    "channel_mapper_gn": ("deformable_detr", "neck.convs.0.gn.weight", KeyError,
                          "a GN in ChannelMapper"),
    "four_level_offsets": ("deformable_detr", None, ValueError,
                           "64 rows, 4 levels of 8 heads x points; the model's has 48, 3 levels"),
    "panoptic_fpn_head": ("panoptic_fpn", "semantic_head.conv_upsample_layers.0.conv.0.conv.weight",
                          KeyError, "PanopticFPNHead"),
}


@pytest.mark.parametrize("case", sorted(LACKS_TR))
def test_mmdet_checkpoint_names_the_transformer_parts_one_side_lacks(case):
    """mmdet's DETR has a decoder ``post_norm``, its Deformable DETR config a
    ChannelMapper with GNs and a 4th level (``extra_convs``) and so
    sampling offsets and weights for 4 levels, its PanopticFPN a
    PanopticFPNHead: a checkpoint with such a tensor raises naming it
    (``MMDET_ONLY``), one with 4 levels' offsets raises naming both level
    counts."""
    import torch
    import torch_detr_cases as dcases
    from oadg_tpu_torch.apis import init_detector
    from oadg_tpu_torch.utils.checkpoint import load_mmdet_checkpoint
    name, extra, error, match = LACKS_TR[case]
    model = init_detector({"model": dcases.torch_model(name)}, device="cpu", seed=1).model
    sd = dict(model.state_dict())
    if extra is None:
        key = "bbox_head.transformer.encoder.layers.0.attentions.0.sampling_offsets.weight"
        sd[key] = torch.zeros(64, 16)
    else:
        sd[extra] = torch.zeros(4)
    with pytest.raises(error, match=re.escape(match)):
        load_mmdet_checkpoint(model, {"state_dict": sd})


def test_detr_config_names_no_data_and_chip_smoke_gives_it_the_base():
    """The reference-side fact: the repo's DETR config has a model and its
    AdamW but no ``data``, ``lr_config`` or ``runner``; ``chip_smoke.py``'s
    ``transformer_cfg`` gives it the Cityscapes base's data and the
    Cityscapes config's warm-up, keeps the AdamW, and gives PanopticFPN
    mmdet's 14x14 mask RoI layer (its config names none)."""
    import chip_smoke
    cfg = load_config(osp.join(CFG_ROOT, "detr/detr_r50_8x2_150e_coco.py"))
    assert cfg.get("model") and cfg.optimizer["type"] == "AdamW"
    assert not any(cfg.get(k) for k in ("data", "lr_config", "runner"))
    cfg = chip_smoke.transformer_cfg("detr", "configs/detr/detr_r50_8x2_150e_coco.py")
    assert cfg.data.test.pipeline and cfg.img_norm_cfg and cfg.data.samples_per_gpu == 1
    assert cfg.optimizer == dict(type="AdamW", lr=1e-4, weight_decay=1e-4)
    assert cfg.lr_config["warmup"] == "linear"
    pan = chip_smoke.transformer_cfg("panoptic_fpn",
                                     "configs/panoptic_fpn/panoptic_fpn_r50_fpn_1x_coco.py")
    assert pan.model.roi_head.mask_roi_extractor.roi_layer.output_size == 14


BACKBONES_NECKS = {"yolo/yolov3_mobilenetv2_mstrain-416_300e_coco.py": "MobileNetV2",
       "regnet/faster_rcnn_regnetx-3.2GF_fpn_1x_coco.py": "RegNet",
       "res2net/faster_rcnn_r2_101_fpn_2x_coco.py": "Res2Net",
       "resnest/faster_rcnn_s50_fpn_syncbn-backbone+head_mstrain-range_1x_coco.py": "ResNeSt",
       "carafe/faster_rcnn_r50_fpn_carafe_1x_coco.py": "FPN_CARAFE",
       "fpg/faster_rcnn_r50_fpg_crop640_50e_coco.py": "FPG"}


@pytest.mark.parametrize("rel", sorted(BACKBONES_NECKS))
def test_backbone_and_neck_configs_build_their_modules(rel):
    """The six configs of A.2.9a at full width as given: RegNetX-3.2GF's
    stages of 96, 192, 432 and 1008 channels (groups of 48) with a stem of
    32 and no max-pool; Res2Net-101's 3x3 chunks of 26 channels in
    ``layer1`` (4 scales, 23 blocks in ``layer3``); ResNeSt-50's ``layer1``
    split conv from 4 to 8 channels (JAX's width rule, ``planes / 16``)
    with an ``fc1`` of 32; FPN-CARAFE's encoders of 100 outputs (4 phases
    of 5x5 taps) on 64 compressed channels; FPG's 9 stacks of 4 stride-2
    and 4 up convs with live BNs; MobileNetV2's outputs at 32, 96 and 320
    channels under the YOLOv3 neck."""
    det = _build(rel)
    kind = BACKBONES_NECKS[rel]
    bb, neck = det.backbone, det.neck
    assert kind in (type(bb).__name__, type(neck).__name__)
    if kind == "MobileNetV2":
        assert [getattr(bb, f"layer{i}")[-1].conv[2].conv.weight.shape[0]
                for i in (3, 5, 7)] == [32, 96, 320]
        assert bb.out_indices == (2, 4, 6) and not hasattr(bb, "conv2")
        assert bb.layer2[0].conv[1].conv.groups == 96 and type(bb.conv1.bn).__name__ == "BatchNorm"
        assert neck.detect1.conv1.conv.weight.shape[1] == 320
    if kind == "RegNet":
        assert bb.conv1.weight.shape == (32, 3, 3, 3)
        assert [getattr(bb, f"layer{i}")[0].conv1.weight.shape[0] for i in (1, 2, 3, 4)] == [
            96, 192, 432, 1008]
        assert [len(getattr(bb, f"layer{i}")) for i in (1, 2, 3, 4)] == [2, 6, 15, 2]
        assert [getattr(bb, f"layer{i}")[0].conv2.groups for i in (1, 2, 3, 4)] == [2, 4, 9, 21]
    if kind == "Res2Net":
        blk = bb.layer1[0]
        assert blk.width == 26 and len(blk.convs) == 3
        assert blk.convs[0].weight.shape == (26, 26, 3, 3)
        assert blk.conv1.weight.shape == (104, 64, 1, 1) and len(bb.layer3) == 23
        assert bb.stem[0].weight.shape == (32, 3, 3, 3)
        assert bb.stem[6].weight.shape == (64, 32, 3, 3)
        assert bb.layer2[0].downsample[1].weight.shape == (512, 256, 1, 1)
    if kind == "ResNeSt":
        sa = bb.layer1[0].conv2
        assert bb.layer1[0].conv1.weight.shape == (4, 64, 1, 1)
        assert sa.conv.weight.shape == (8, 2, 3, 3) and sa.conv.groups == 2
        assert sa.fc1.weight.shape == (32, 4, 1, 1) and sa.fc2.weight.shape == (8, 32, 1, 1)
        assert bb.layer4[0].conv1.weight.shape == (32, 1024, 1, 1)
        assert bb.layer2[0].avd_stride == 2 and bb.layer1[0].avd_stride == 1
    if kind == "FPN_CARAFE":
        assert len(neck.upsample_modules) == 3 and len(neck.fpn_convs) == 4
        up = neck.upsample_modules[0]
        assert up.channel_compressor.weight.shape == (64, 256, 1, 1)
        assert up.content_encoder.weight.shape == (100, 64, 3, 3)
    if kind == "FPG":
        assert len(neck.down_convs) == len(neck.up_convs) == 9
        assert [len(neck.down_convs[0]), len(neck.up_convs[0]), len(neck.out_convs)] == [4, 4, 5]
        assert neck.down_convs[8][3].conv.stride == (2, 2)
        assert type(neck.up_convs[0][0].bn).__name__ == "BatchNorm"
        assert sum(1 for m in neck.modules() if type(m).__name__ == "BatchNorm") == 77
    if kind != "MobileNetV2":
        assert det.roi_head.bbox_roi_extractor.output_size == 7
        assert det.neck.lateral_convs[3] is not None


def _backbones_sd(name, src):
    """The tiny model's ``state_dict`` under mmdet's names: a CARAFE
    encoder's outputs in mmcv's pixel-shuffle order."""
    from oadg_tpu_torch.utils.checkpoint import carafe_mmdet_order
    sd = dict(src.state_dict())
    for k in list(sd):
        if re.fullmatch(r"neck\.upsample_modules\.\d+\.content_encoder\.(weight|bias)", k):
            taps = sd[k].shape[0] // 4
            inverse = np.argsort([t * 4 + p for p in range(4) for t in range(taps)])
            sd[k] = sd[k][inverse]
            assert carafe_mmdet_order(sd[k]).equal(src.state_dict()[k])
    return sd


@pytest.mark.parametrize("name", ["mobilenet_v2", "regnet", "res2net", "resnest", "carafe",
                                  "fpg"])
def test_mmdet_checkpoint_carries_the_backbones_and_necks(name, tmp_path):
    """The six narrowed under mmdet's names (MobileNetV2's ``conv.{k}``
    ConvModules, RegNet's ``conv1`` / ``bn1`` stem, the deep stems'
    ``stem.{0..7}``, Bottle2neck's ``convs`` / ``bns``, the split
    attention's ``bn0`` / ``fc1`` / ``bn1`` / ``fc2``, the avg-down
    shortcuts' ``downsample.1`` / ``.2``, CARAFE's ``upsample_modules`` with
    the encoder in mmcv's pixel-shuffle order on file): every tensor loaded,
    the models equal. (A ResNeSt of the JAX widths; mmdet's own are refused
    below.)"""
    import torch
    import torch_backbone_cases as bcases
    from oadg_tpu_torch.apis import init_detector
    from oadg_tpu_torch.utils.checkpoint import load_mmdet_checkpoint
    model = bcases.torch_detector_model(name)
    src = init_detector({"model": model}, device="cpu", seed=1).model
    with torch.no_grad():
        for p in src.parameters():
            p.add_(0.01)
        for k, v in src.state_dict().items():
            if ".running_" in k:
                v.add_(0.5)
    path = tmp_path / "model.pth"
    torch.save({"state_dict": _backbones_sd(name, src), "meta": {}}, path)
    dst = init_detector({"model": model}, device="cpu", seed=2).model
    report = load_mmdet_checkpoint(dst, str(path))
    assert not report["missing"] and not report["skipped"]
    for k, v in src.state_dict().items():
        assert torch.equal(dst.state_dict()[k], v), k
    want = {"mobilenet_v2": ["backbone.conv1.conv.weight", "backbone.layer1.0.conv.1.bn.bias",
                             "backbone.layer7.0.conv.2.bn.running_var"],
            "regnet": ["backbone.conv1.weight", "backbone.bn1.weight",
                       "backbone.layer3.0.downsample.1.running_mean"],
            "res2net": ["backbone.stem.7.weight", "backbone.layer1.0.convs.2.weight",
                        "backbone.layer2.0.bns.0.running_var",
                        "backbone.layer2.0.downsample.2.bias"],
            "resnest": ["backbone.stem.4.running_mean", "backbone.layer1.0.conv2.bn0.weight",
                        "backbone.layer2.0.conv2.fc1.bias",
                        "backbone.layer2.0.downsample.1.weight"],
            "carafe": ["neck.upsample_modules.2.content_encoder.weight",
                       "neck.upsample_modules.0.channel_compressor.bias",
                       "neck.lateral_convs.3.conv.weight", "neck.fpn_convs.0.conv.bias"],
            "fpg": ["neck.down_convs.1.3.bn.running_var", "neck.up_convs.0.0.conv.weight",
                    "neck.out_convs.4.bn.weight", "neck.lateral_convs.2.bias"]}[name]
    assert set(want) <= set(report["loaded"])


LACKS_BB = {
    "carafe_extra_p6": ("carafe", ["neck.lateral_convs.4.conv.weight",
                                   "neck.upsample_modules.3.content_encoder.weight",
                                   "neck.fpn_convs.4.conv.weight"], KeyError,
                        "mmdet's FPN-CARAFE extra P6 path"),
    "fpg_mmdet": ("fpg", ["neck.lateral_trans.0.conv.weight",
                          "neck.fpn_transitions.0.1.same_up.conv.weight",
                          "neck.output_transition.0.conv.weight"], KeyError, "mmdet's FPG"),
    "resnest_widths": ("resnest", None, ValueError,
                       "mmdet's ResNeSt bottlenecks are planes wide where groups == 1"),
}


@pytest.mark.parametrize("case", sorted(LACKS_BB))
def test_mmdet_checkpoint_names_the_backbone_parts_one_side_lacks(case):
    """mmdet's FPN-CARAFE builds P6 with a stride-2 conv of C5, its own
    CARAFE and an output conv, mmdet's FPG another structure, and mmdet's
    ResNeSt bottlenecks ``planes`` wide: a checkpoint with such a tensor
    raises naming it (``MMDET_ONLY``), one of mmdet's ResNeSt widths raises
    naming the width rule."""
    import torch
    import torch_backbone_cases as bcases
    from oadg_tpu_torch.apis import init_detector
    from oadg_tpu_torch.utils.checkpoint import load_mmdet_checkpoint
    name, extra, error, match = LACKS_BB[case]
    if extra is None:           # the config's ResNeSt-50; mmdet's layer1 conv1 to 64, not 4
        model = _build("resnest/faster_rcnn_s50_fpn_syncbn-backbone+head_mstrain-range_1x_coco.py")
        sd = dict(model.state_dict())
        sd["backbone.layer1.0.conv1.weight"] = torch.zeros(64, 64, 1, 1)
        match = "has shape (64, 64, 1, 1), the model's (4, 64, 1, 1): " + match
    else:
        model = init_detector({"model": bcases.torch_detector_model(name)}, device="cpu",
                              seed=1).model
        sd = dict(model.state_dict(), **{k: torch.zeros(4) for k in extra})
    with pytest.raises(error, match=re.escape(match)):
        load_mmdet_checkpoint(model, {"state_dict": sd})
