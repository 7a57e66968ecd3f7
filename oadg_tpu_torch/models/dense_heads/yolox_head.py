"""YOLOX head, SimOTA and the detector (port of
``oadg_tpu/models/dense_heads/yolox_head.py``).

Per level (strides 8, 16, 32) a 1x1 ``stems.{i}``, two 3x3 towers
``multi_level_cls_convs.{i}`` / ``multi_level_reg_convs.{i}`` (live-BN
SiLU convs, ``ConvBNSiLU``), then the 1x1 ``multi_level_conv_cls``
(``C``), ``multi_level_conv_reg`` (4) and ``multi_level_conv_obj`` (1);
mmdet's names. A point's box is ``xy * stride + point`` and ``exp(clip(wh,
-10, 8)) * stride`` wide.

- ``simota_assign`` (``:26-50``): the (P, G) cost with every pair outside
  the centre prior (or of a padded gt) at 1e9; per gt ``dynamic_k`` = the
  sum of its 10 largest candidate IoUs truncated toward zero, at least 1;
  the points whose stable rank by cost is below it (ties to the lower
  index, as the JAX ``argsort``); a point taken by several gts keeps the
  one of least cost (the first on a tie).
- ``loss`` (``:117-197``): the cost is the BCE of ``sqrt(sigmoid(cls) *
  sigmoid(obj))`` against the gt's one-hot, plus 3 ``-log(IoU)``, plus 1e5
  outside the gt box and centre region both; the objectness BCE over every
  point, the class BCE of the positives against ``one_hot * IoU`` (the IoU
  keeps its gradient, as in the JAX head; mmdet detaches it), ``1 - IoU^2``
  of the positives and, with ``use_l1`` (``YOLOXModeSwitchHook`` sets it),
  the L1 of the raw outputs against the encoded gt; each over the sum of
  the images' positives (each image at least 1; every rank's under data
  parallel), the box loss times 5.
- ``get_bboxes`` (``:199-228``): every point's ``sigmoid(cls) *
  sigmoid(obj)`` and box, divided by the scale factor, ``multiclass_nms``
  (``score_thr`` 0.01, IoU 0.65).

``train_cfg.assigner`` is ``SimOTAAssigner`` (the config's; only its
``center_radius`` is read): the JAX package's standalone ``SimOTAAssigner``
has no caller.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...core.bbox.geometry import bbox_overlaps
from ...parallel import shard_sum
from ...utils.registry import DETECTORS, HEADS, cfg_args
from ..backbones.csp_darknet import ConvBNSiLU
from ..detectors.single_stage import SingleStageDetector
from ..layers import Conv, widen
from ..losses.common import binary_cross_entropy_with_logits
from .retina_head import nms_detections

BIG = 1e9


def stable_ranks(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Each entry's place in the stable ascending sort of ``x`` along
    ``dim`` (ties to the lower index)."""
    order = torch.sort(x, dim=dim, stable=True)[1]
    shape = [1] * x.dim()
    shape[dim] = x.shape[dim]
    ar = torch.arange(x.shape[dim], device=x.device).view(shape).expand_as(order)
    return torch.empty_like(order).scatter_(dim, order, ar)


def simota_assign(cost: torch.Tensor, ious: torch.Tensor, valid_candidate: torch.Tensor,
                  gt_valid: torch.Tensor, topk: int = 10) -> torch.Tensor:
    """(..., P, G) cost, IoUs and centre-prior candidates, (..., G) real
    gts -> (..., P) int64: 0 background, ``j + 1`` gt ``j``."""
    p = cost.shape[-2]
    ok = valid_candidate & gt_valid[..., None, :]
    cost = torch.where(ok, cost, torch.full_like(cost, BIG))
    iou_m = torch.where(ok, ious, torch.zeros_like(ious))
    top = torch.topk(iou_m, min(topk, p), dim=-2).values
    dynamic_k = top.sum(-2).to(torch.int32).clamp(1, p)                      # (..., G)
    selected = (stable_ranks(cost, -2) < dynamic_k[..., None, :]) & (cost < BIG)
    sel_cost = torch.where(selected, cost, torch.full_like(cost, BIG))
    best = sel_cost.argmin(-1)
    return torch.where(sel_cost.amin(-1) < BIG, best + 1, torch.zeros_like(best))


@HEADS.register_module()
class YOLOXHead(nn.Module):

    def __init__(self, num_classes: int = 80, in_channels: int = 256, feat_channels: int = 256,
                 stacked_convs: int = 2, strides: Sequence[int] = (8, 16, 32),
                 center_radius: float = 2.5, loss_weight_obj: float = 1.0,
                 loss_weight_cls: float = 1.0, loss_weight_bbox: float = 5.0,
                 loss_weight_l1: float = 1.0, use_l1: bool = False, train_cfg=None,
                 test_cfg=None, num_views: int = 1, device=None, dtype=None):
        super().__init__()
        cfg_args(dict(train_cfg or {}).get("assigner"), {}, "SimOTAAssigner")
        self.num_classes = num_classes
        self.strides = tuple(strides)
        self.center_radius = center_radius
        self.weights = dict(loss_obj=loss_weight_obj, loss_cls=loss_weight_cls,
                            loss_bbox=loss_weight_bbox, loss_l1=loss_weight_l1)
        self.use_l1 = use_l1
        self.test_cfg = dict(test_cfg or {})
        kw = dict(device=device, dtype=dtype)
        nl = len(self.strides)

        def tower():
            return nn.Sequential(*(ConvBNSiLU(feat_channels, feat_channels, 3, **kw)
                                   for _ in range(stacked_convs)))

        self.stems = nn.ModuleList(ConvBNSiLU(in_channels, feat_channels, 1, **kw)
                                   for _ in range(nl))
        self.multi_level_cls_convs = nn.ModuleList(tower() for _ in range(nl))
        self.multi_level_reg_convs = nn.ModuleList(tower() for _ in range(nl))
        self.multi_level_conv_cls = nn.ModuleList(Conv(feat_channels, num_classes, 1, **kw)
                                                  for _ in range(nl))
        self.multi_level_conv_reg = nn.ModuleList(Conv(feat_channels, 4, 1, **kw)
                                                  for _ in range(nl))
        self.multi_level_conv_obj = nn.ModuleList(Conv(feat_channels, 1, 1, **kw)
                                                  for _ in range(nl))

    def init_weights(self, gen: torch.Generator):
        """The model's default (``init_default_``), as the JAX head's: the
        class and objectness biases at 0 (mmdet's at the 0.01 prior)."""

    def forward(self, feats):
        """Per level: class logits (N, C, H, W), box outputs (N, 4, H, W),
        objectness (N, 1, H, W), in the compute dtype."""
        cls_scores, bbox_preds, objectnesses = [], [], []
        for i, x in enumerate(feats[:len(self.strides)]):
            x = self.stems[i](x)
            c, r = self.multi_level_cls_convs[i](x), self.multi_level_reg_convs[i](x)
            cls_scores.append(self.multi_level_conv_cls[i](c))
            bbox_preds.append(self.multi_level_conv_reg[i](r))
            objectnesses.append(self.multi_level_conv_obj[i](r))
        return cls_scores, bbox_preds, objectnesses

    def points(self, featmap_sizes, device):
        """(P, 2) cell centres ``(i + 0.5) * stride`` and (P,) strides."""
        pts, strides = [], []
        for (h, w), s in zip(featmap_sizes, self.strides):
            xs = (torch.arange(w, dtype=torch.float32, device=device) + 0.5) * s
            ys = (torch.arange(h, dtype=torch.float32, device=device) + 0.5) * s
            pts.append(torch.stack([xs[None, :].expand(h, w).reshape(-1),
                                    ys[:, None].expand(h, w).reshape(-1)], -1))
            strides.append(torch.full((h * w,), float(s), device=device))
        return torch.cat(pts), torch.cat(strides)

    @staticmethod
    def decode(reg, pts, strides):
        xy = reg[..., :2] * strides[:, None] + pts
        wh = torch.exp(reg[..., 2:].clamp(-10, 8)) * strides[:, None]
        return torch.cat([xy - wh / 2, xy + wh / 2], -1)

    def _flat(self, outs):
        cls_scores, bbox_preds, objectnesses = outs
        n = cls_scores[0].shape[0]
        pts, strides = self.points([tuple(s.shape[-2:]) for s in cls_scores],
                                   cls_scores[0].device)

        def cat(maps, c):
            return torch.cat([widen(m).permute(0, 2, 3, 1).reshape(n, -1, c) for m in maps], 1)

        return (pts, strides, cat(cls_scores, self.num_classes), cat(bbox_preds, 4),
                cat(objectnesses, 1)[..., 0])

    def assign(self, cls, obj, ious, pts, strides, gt, gt_valid, gt_labels):
        """SimOTA of N images: (N, P) gt indices + 1 (0 background)."""
        inside = ((pts[None, :, 0:1] >= gt[:, None, :, 0]) & (pts[None, :, 0:1] <= gt[:, None, :, 2])
                  & (pts[None, :, 1:2] >= gt[:, None, :, 1])
                  & (pts[None, :, 1:2] <= gt[:, None, :, 3]))                 # (N, P, G)
        cx = (gt[..., 0] + gt[..., 2]) / 2
        cy = (gt[..., 1] + gt[..., 3]) / 2
        r = self.center_radius * strides[:, None]
        in_center = (((pts[None, :, 0:1] - cx[:, None]).abs() < r)
                     & ((pts[None, :, 1:2] - cy[:, None]).abs() < r))
        pr = torch.sqrt(torch.clamp(torch.sigmoid(cls) * torch.sigmoid(obj)[..., None],
                                    1e-8, 1.0))
        neg_terms = torch.log(1 - pr + 1e-8)                                   # (N, P, C)
        lab = gt_labels.long().clamp(0, self.num_classes - 1)
        at = lambda t: torch.gather(t, 2, lab[:, None, :].expand(-1, t.shape[1], -1))  # noqa: E731
        cls_cost = -(neg_terms.sum(-1, keepdim=True) - at(neg_terms) + at(torch.log(pr)))
        iou_cost = -torch.log(torch.clamp(ious, 1e-8, 1.0))
        cost = cls_cost + 3.0 * iou_cost + 1e5 * (~(inside & in_center)).float()
        return simota_assign(cost, ious, inside | in_center, gt_valid)

    def loss(self, outs, gt_bboxes, gt_valid, gt_labels, draws=None):
        """``loss_obj``, ``loss_cls``, ``loss_bbox`` and, with ``use_l1``,
        ``loss_l1``; ``draws`` is unused."""
        pts, strides, cls, reg, obj = self._flat(outs)
        boxes = self.decode(reg, pts, strides)
        ious = bbox_overlaps(boxes, gt_bboxes)                                 # (N, P, G)
        with torch.no_grad():
            assigned = self.assign(cls, obj, ious, pts, strides, gt_bboxes, gt_valid, gt_labels)
            pos = assigned > 0
            posf = pos.float()
            matched = (assigned - 1).clamp(0, gt_bboxes.shape[1] - 1)
            tot = torch.clamp_min(shard_sum(torch.clamp_min(posf.sum(-1), 1.0).sum()), 1.0)
            mgt = torch.gather(gt_bboxes, 1, matched[..., None].expand(*matched.shape, 4))
            t_xy = ((mgt[..., :2] + mgt[..., 2:]) / 2 - pts) / strides[:, None]
            t_wh = torch.log(torch.clamp((mgt[..., 2:] - mgt[..., :2]) / strides[:, None],
                                         min=1e-8))
            onehot = F.one_hot(torch.gather(gt_labels.long(), 1, matched),
                               self.num_classes).float()
        iou_m = torch.gather(ious, 2, matched[..., None])[..., 0]
        losses = dict(
            loss_obj=binary_cross_entropy_with_logits(obj, posf).sum(),
            loss_cls=(binary_cross_entropy_with_logits(cls, onehot * iou_m[..., None]).sum(-1)
                      * posf).sum(),
            loss_bbox=((1.0 - iou_m ** 2) * posf).sum())
        if self.use_l1:
            losses["loss_l1"] = ((reg - torch.cat([t_xy, t_wh], -1)).abs().sum(-1) * posf).sum()
        return {k: self.weights[k] * v / tot for k, v in losses.items()}

    def get_bboxes(self, outs, img_shapes, scale_factors, rescale: bool = True, cfg=None):
        """Detections of N images: dets (N, max_per_img, 5), labels, valid."""
        cfg = {"score_thr": 0.01, **dict(cfg or self.test_cfg)}
        pts, strides, cls, reg, obj = self._flat(outs)
        scores = torch.sigmoid(cls) * torch.sigmoid(obj)[..., None]
        return nms_detections(self.decode(reg, pts, strides), scores, scale_factors, rescale,
                              cfg, self.num_classes, default_iou=0.65)


@DETECTORS.register_module()
class YOLOX(SingleStageDetector):
    """``oadg_tpu/models/dense_heads/yolox_head.py:233``."""
