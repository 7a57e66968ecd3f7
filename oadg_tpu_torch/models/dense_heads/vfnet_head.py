"""VFNet head and detector (port of ``oadg_tpu/models/dense_heads/vfnet_head.py:31-219``).

FCOS's points and GN towers (``cls_convs.i``, ``reg_convs.i``), then per
level:

- ``vfnet_reg`` on the box tower: initial distances ``exp(scales.i * x) *
  stride``, in float32 in either dtype;
- the star-shaped offsets (``_star_offsets``, ``:86-106``): the 3x3 taps of
  ``vfnet_reg_refine_dconv`` and ``vfnet_cls_dconv`` (DCNv1,
  ``layers.DeformConv``) moved onto the box's left / centre / right x top /
  centre / bottom points, in feature cells, through ``gradient_mul * d + (1
  - gradient_mul) * d.detach()``;
- ``vfnet_reg_refine`` after the refine DCN, its GN (``vfnet_reg_refine_gn``)
  and a ReLU: refined distances ``exp(scales_refine.i * x) * init.detach()``;
- ``vfnet_cls`` after the class DCN, its GN (``vfnet_cls_gn``) and a ReLU.

The two DCNs compute in float32 in a bfloat16 model too: their input is
GroupNorm's float32 output and the JAX layer casts its kernel to the
input's dtype. The two GNs after the DCNs are the JAX head's; mmdet's head
has none and has a GN conv ``vfnet_reg_conv`` before ``vfnet_reg`` instead
(``utils/checkpoint.py`` names both sides' extra tensors).

- ``loss`` (``:129-175``): ATSS assignment (``ATSSAssigner``) on squares of
  8 strides about each point (``:136-140``); the varifocal loss against the
  refined box's IoU with its gt at the gt's class (detached), GIoU of the
  initial and of the refined boxes on the positives, each over the
  positives' count.
- ``get_bboxes`` (``:177-214``): top ``nms_pre`` points a level by the
  largest class sigmoid, the refined boxes decoded and clipped,
  ``multiclass_nms`` (IoU 0.6 unless given).
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ...core.bbox.geometry import bbox_overlaps
from ...core.bbox.transforms import distance2bbox
from ...parallel import shard_sum
from ...utils.registry import DETECTORS, HEADS, LOSSES, build_from_cfg
from ..detectors.single_stage import SingleStageDetector
from ..layers import Conv, DeformConv, GroupNorm32, Scale
from .atss_head import atss_assigner
from .fcos_head import INF, gn_tower, level_points, towers
from .retina_head import _flatten, gather_rows, nms_detections, top_candidates

# the 3x3 taps, row-major: (row, column) offsets from the centre
_TAPS = [(-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 0), (0, 1), (1, -1), (1, 0), (1, 1)]


@HEADS.register_module()
class VFNetHead(nn.Module):

    def __init__(self, num_classes: int = 80, in_channels: int = 256,
                 feat_channels: int = 256, stacked_convs: int = 3,
                 strides: Sequence[int] = (8, 16, 32, 64, 128),
                 regress_ranges=((-1, 64), (64, 128), (128, 256), (256, 512), (512, INF)),
                 gradient_mul: float = 0.1, dcn_kernel: int = 3, loss_cls=None, loss_bbox=None,
                 loss_bbox_refine=None, train_cfg=None, test_cfg=None, num_views: int = 1,
                 device=None, dtype=None):
        super().__init__()
        if dcn_kernel != 3:
            raise ValueError(f"dcn_kernel={dcn_kernel}: the star offsets place 3x3 taps")
        self.num_classes = num_classes
        self.strides = tuple(strides)
        self.gradient_mul = gradient_mul
        self.train_cfg = dict(train_cfg or {})
        self.test_cfg = dict(test_cfg or {})
        self.assigner = atss_assigner(self.train_cfg)
        self.l_cls = build_from_cfg(dict(loss_cls or dict(
            type="VarifocalLoss", use_sigmoid=True, alpha=0.75, gamma=2.0, iou_weighted=True,
            loss_weight=1.0)), LOSSES)
        self.l_bbox = build_from_cfg(dict(loss_bbox or dict(type="GIoULoss", loss_weight=1.5)),
                                     LOSSES)
        self.l_bbox_ref = build_from_cfg(dict(loss_bbox_refine or dict(
            type="GIoULoss", loss_weight=2.0)), LOSSES)
        conv = dict(device=device, dtype=dtype)
        self.cls_convs = gn_tower(in_channels, feat_channels, stacked_convs, **conv)
        self.reg_convs = gn_tower(in_channels, feat_channels, stacked_convs, **conv)
        self.vfnet_reg = Conv(feat_channels, 4, 3, 1, 1, **conv)
        self.vfnet_reg_refine_dconv = DeformConv(feat_channels, feat_channels, 3, padding=1,
                                                 device=device)
        self.vfnet_reg_refine_gn = GroupNorm32(feat_channels, device=device)
        self.vfnet_reg_refine = Conv(feat_channels, 4, 3, 1, 1, **conv)
        self.vfnet_cls_dconv = DeformConv(feat_channels, feat_channels, 3, padding=1,
                                          device=device)
        self.vfnet_cls_gn = GroupNorm32(feat_channels, device=device)
        self.vfnet_cls = Conv(feat_channels, num_classes, 3, 1, 1, **conv)
        self.scales = nn.ModuleList(Scale(1.0, device=device) for _ in self.strides)
        self.scales_refine = nn.ModuleList(Scale(1.0, device=device) for _ in self.strides)

    def init_weights(self, gen: torch.Generator):
        """The model's default (``init_default_``: the DCNs He-normal), as
        the JAX head's."""

    def _star_offsets(self, init: torch.Tensor, stride: float) -> torch.Tensor:
        """(N, 4, H, W) initial distances in pixels -> (N, 18, H, W) DCN
        offsets, ``(dy, dx)`` a tap: each tap moved from its place in the
        3x3 grid onto the box's star point, in feature cells."""
        bp = self.gradient_mul * init + (1 - self.gradient_mul) * init.detach()
        bp = bp / stride
        l, t, r, b = bp.unbind(1)
        z = torch.zeros_like(l)
        ys = {-1: -t, 0: z, 1: b}
        xs = {-1: -l, 0: z, 1: r}
        offs = []
        for by, bx in _TAPS:
            offs += [ys[by] - by, xs[bx] - bx]
        return torch.stack(offs, 1)

    def forward(self, feats):
        """Per level: class logits (N, C, H, W), initial and refined float32
        distances (N, 4, H, W) in pixels."""
        cls_scores, bbox_preds, bbox_refined = [], [], []
        for li, x in enumerate(feats):
            c, r = towers(self, x)
            s = float(self.strides[li])
            init = torch.exp(self.scales[li](self.vfnet_reg(r))) * s
            off = self._star_offsets(init, s)
            r2 = torch.relu(self.vfnet_reg_refine_gn(self.vfnet_reg_refine_dconv(r, off)))
            refined = torch.exp(self.scales_refine[li](self.vfnet_reg_refine(r2))) * init.detach()
            c2 = torch.relu(self.vfnet_cls_gn(self.vfnet_cls_dconv(c, off)))
            cls_scores.append(self.vfnet_cls(c2))
            bbox_preds.append(init)
            bbox_refined.append(refined)
        return cls_scores, bbox_preds, bbox_refined

    def loss(self, outs, gt_bboxes, gt_valid, gt_labels, draws=None):
        """``loss_cls`` (varifocal), ``loss_bbox``, ``loss_bbox_rf`` of N
        images; ``draws`` is unused."""
        cls_scores, bbox_preds, bbox_refined = outs
        sizes = [tuple(s.shape[-2:]) for s in cls_scores]
        points, lvl = level_points(sizes, self.strides, cls_scores[0].device)
        half = torch.tensor(self.strides, dtype=torch.float32, device=points.device)[lvl] * 4.0
        anchors = torch.cat([points - half[:, None], points + half[:, None]], -1)
        cls = _flatten(cls_scores, self.num_classes).float()
        box_init = distance2bbox(points, _flatten(bbox_preds, 4))
        box_refi = distance2bbox(points, _flatten(bbox_refined, 4))
        with torch.no_grad():
            a = self.assigner.assign(anchors, [h * w for h, w in sizes], gt_bboxes, gt_valid,
                                     gt_labels)
            pos = a.gt_inds > 0
            gi = (a.gt_inds - 1).clamp(0, gt_bboxes.shape[1] - 1)
            labels = torch.where(pos, torch.gather(gt_labels.long(), 1, gi),
                                 torch.full_like(gi, self.num_classes))
            tgt = gather_rows(gt_bboxes, gi)
            posf = pos.float()
            iou = bbox_overlaps(box_refi, tgt, is_aligned=True)
            onehot = torch.zeros_like(cls).scatter_(-1, labels.clamp(max=self.num_classes - 1)
                                                    [..., None], 1.0)
            onehot = onehot * (labels < self.num_classes)[..., None]
            vf_tgt = onehot * (torch.clamp(iou, 0.0, 1.0) * posf)[..., None]
            num_pos = shard_sum(pos.sum()).clamp(min=1).float()
        return dict(
            loss_cls=self.l_cls(cls, vf_tgt, avg_factor=num_pos),
            loss_bbox=self.l_bbox(box_init.reshape(-1, 4), tgt.reshape(-1, 4),
                                  weight=posf.reshape(-1), avg_factor=num_pos),
            loss_bbox_rf=self.l_bbox_ref(box_refi.reshape(-1, 4), tgt.reshape(-1, 4),
                                         weight=posf.reshape(-1), avg_factor=num_pos))

    def get_bboxes(self, outs, img_shapes, scale_factors, rescale: bool = True, cfg=None):
        """Detections of N images from the refined boxes: dets (N,
        max_per_img, 5), labels, valid."""
        cls_scores, _, bbox_refined = outs
        cfg = dict(cfg or self.test_cfg)
        nms_pre = int(cfg.get("nms_pre", 1000))
        pts = [level_points([tuple(c.shape[-2:])], [s], c.device)[0]
               for c, s in zip(cls_scores, self.strides)]
        max_shape = (img_shapes[:, 0:1], img_shapes[:, 1:2])
        levels = [(torch.sigmoid(_flatten([c], self.num_classes).float()), _flatten([r], 4), None)
                  for c, r in zip(cls_scores, bbox_refined)]
        boxes, scores = top_candidates(levels, nms_pre, lambda li, ti, d: distance2bbox(
            pts[li][ti], d, max_shape=max_shape))
        return nms_detections(boxes, scores, scale_factors, rescale, cfg, self.num_classes, 0.6)


@DETECTORS.register_module()
class VFNet(SingleStageDetector):
    """``vfnet_head.py:217``."""
