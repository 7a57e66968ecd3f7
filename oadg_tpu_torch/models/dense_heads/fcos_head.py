"""FCOS head and detector (port of ``oadg_tpu/models/dense_heads/fcos_head.py:27-207``),
and ``level_points`` (``fovea_fsaf_heads.py:32``), the anchor-free heads'
points.

Per level two GN towers of ``stacked_convs`` 3x3 convs (``cls_convs.i``,
``reg_convs.i``: conv with a bias, ``GroupNorm32``, ReLU), then
``conv_cls`` (C sigmoid logits), ``conv_reg`` (4 distances,
``exp(scales.i * x)`` in float32, in pixels: the JAX head multiplies by no
stride) and ``conv_centerness`` (on the class tower, or on the box tower
with ``centerness_on_reg``). Every conv LeCun-normal with a zero bias, the
classifier's too (mmdet starts it at a 0.01 prior; ROADMAP C).

- ``loss`` (``:124-158``): a point is positive for the gt of smallest area
  (the first of equals) that holds it more than 0.01 inside and whose
  largest distance lies in the level's ``regress_range`` (both ends
  included); focal loss over every point, the IoU loss of the decoded
  boxes weighted by the positives' centerness targets
  ``sqrt(min(l, r) / max(l, r) * min(t, b) / max(t, b))``, and the
  centerness BCE on the positives. ``center_sampling`` and ``norm_on_bbox``
  are taken and not read, as in the JAX head (ROADMAP C).
- ``get_bboxes`` (``:160-200``): per image and level the top ``nms_pre``
  points by largest class sigmoid times centerness sigmoid (ties to the
  lower index), decoded and clipped to the image, their class scores times
  the centerness, then ``multiclass_nms``.

The maps stay NCHW; the loss and ``get_bboxes`` flatten them location-major
(``retina_head._flatten``), the JAX heads' NHWC order.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ...core.bbox.transforms import distance2bbox
from ...parallel import shard_sum
from ...utils.registry import DETECTORS, HEADS, LOSSES, build_from_cfg
from ..detectors.single_stage import SingleStageDetector
from ..layers import Conv, ConvGN, Scale
from .retina_head import _flatten, nms_detections, top_candidates

INF = 1e8


def level_points(featmap_sizes, strides, device=None, offset: float = 0.5):
    """Every level's points ``((arange + offset) * stride)``, location-major,
    concatenated -> (P, 2) float32 (x, y) and (P,) int64 level ids."""
    pts, ids = [], []
    for li, ((h, w), s) in enumerate(zip(featmap_sizes, strides)):
        xs = (torch.arange(w, dtype=torch.float32, device=device) + offset) * s
        ys = (torch.arange(h, dtype=torch.float32, device=device) + offset) * s
        pts.append(torch.stack([xs[None, :].expand(h, w).reshape(-1),
                                ys[:, None].expand(h, w).reshape(-1)], -1))
        ids.append(torch.full((h * w,), li, dtype=torch.long, device=device))
    return torch.cat(pts), torch.cat(ids)


def gn_tower(in_channels: int, feat_channels: int, stacked_convs: int, **kw) -> nn.ModuleList:
    """``stacked_convs`` x (3x3 conv, ``GroupNorm32``, ReLU)."""
    return nn.ModuleList(ConvGN(in_channels if i == 0 else feat_channels, feat_channels, **kw)
                         for i in range(stacked_convs))


def towers(head: nn.Module, x: torch.Tensor):
    """``head.cls_convs`` and ``head.reg_convs`` on one level's ``x`` ->
    (class features, box features)."""
    c = r = x
    for conv in head.cls_convs:
        c = conv(c)
    for conv in head.reg_convs:
        r = conv(r)
    return c, r


@HEADS.register_module()
class FCOSHead(nn.Module):

    def __init__(self, num_classes: int = 80, in_channels: int = 256,
                 feat_channels: int = 256, stacked_convs: int = 4,
                 strides: Sequence[int] = (8, 16, 32, 64, 128),
                 regress_ranges=((-1, 64), (64, 128), (128, 256), (256, 512), (512, INF)),
                 center_sampling: bool = False, norm_on_bbox: bool = False,
                 centerness_on_reg: bool = False, loss_cls=None, loss_bbox=None,
                 loss_centerness=None, train_cfg=None, test_cfg=None, num_views: int = 1,
                 device=None, dtype=None):
        super().__init__()
        self.num_classes = num_classes
        self.strides = tuple(strides)
        self.regress_ranges = tuple(tuple(float(v) for v in r) for r in regress_ranges)
        self.centerness_on_reg = centerness_on_reg
        self.train_cfg = dict(train_cfg or {})
        self.test_cfg = dict(test_cfg or {})
        self.l_cls = build_from_cfg(dict(loss_cls or dict(
            type="FocalLoss", use_sigmoid=True, gamma=2.0, alpha=0.25, loss_weight=1.0)), LOSSES)
        self.l_bbox = build_from_cfg(dict(loss_bbox or dict(type="IoULoss", loss_weight=1.0)),
                                     LOSSES)
        self.l_ctr = build_from_cfg(dict(loss_centerness or dict(
            type="CrossEntropyLoss", use_sigmoid=True, loss_weight=1.0)), LOSSES)
        conv = dict(device=device, dtype=dtype)
        self.cls_convs = gn_tower(in_channels, feat_channels, stacked_convs, **conv)
        self.reg_convs = gn_tower(in_channels, feat_channels, stacked_convs, **conv)
        self.conv_cls = Conv(feat_channels, num_classes, 3, 1, 1, **conv)
        self.conv_reg = Conv(feat_channels, 4, 3, 1, 1, **conv)
        self.conv_centerness = Conv(feat_channels, 1, 3, 1, 1, **conv)
        self.scales = nn.ModuleList(Scale(1.0, device=device) for _ in self.strides)

    def init_weights(self, gen: torch.Generator):
        """The JAX head's init is the model's default (``init_default_``:
        LeCun-normal convs, zero biases); GN and the scales start at 1."""

    def forward(self, feats):
        """Per level: class logits (N, C, H, W), float32 distances (N, 4, H,
        W), centerness logits (N, 1, H, W)."""
        cls_scores, bbox_preds, ctrs = [], [], []
        for li, x in enumerate(feats):
            c, r = towers(self, x)
            cls_scores.append(self.conv_cls(c))
            bbox_preds.append(torch.exp(self.scales[li](self.conv_reg(r))))
            ctrs.append(self.conv_centerness(r if self.centerness_on_reg else c))
        return cls_scores, bbox_preds, ctrs

    def _targets(self, points, ranges, gt, gt_valid, gt_labels):
        """(P, 2) points, (P, 2) their level's range, (N, G, 4) gts ->
        labels (N, P) (``num_classes`` for background), distances to the
        matched gt (N, P, 4), centerness targets (N, P), positives (N, P)."""
        px, py = points[:, 0, None], points[:, 1, None]
        ltrb = torch.stack([px - gt[:, None, :, 0], py - gt[:, None, :, 1],
                            gt[:, None, :, 2] - px, gt[:, None, :, 3] - py], -1)   # (N, P, G, 4)
        inside = ltrb.amin(-1) > 0.01
        maxd = ltrb.amax(-1)
        in_range = (maxd >= ranges[:, 0:1]) & (maxd <= ranges[:, 1:2])
        area = ((gt[..., 2] - gt[..., 0]) * (gt[..., 3] - gt[..., 1]))[:, None, :]
        cand = inside & in_range & gt_valid[:, None, :]
        area_m = torch.where(cand, area, area.new_full((), INF))
        gi = area_m.argmin(-1)                                           # the first of equals
        pos = area_m.amin(-1) < INF
        labels = torch.where(pos, torch.gather(gt_labels.long(), 1, gi),
                             torch.full_like(gi, self.num_classes))
        tgt = torch.gather(ltrb, 2, gi[..., None, None].expand(*gi.shape, 1, 4))[:, :, 0]
        lr, tb = tgt[..., [0, 2]], tgt[..., [1, 3]]
        eps = tgt.new_full((), 1e-6)
        ratio = (lr.amin(-1) / torch.maximum(lr.amax(-1), eps)) * (
            tb.amin(-1) / torch.maximum(tb.amax(-1), eps))
        ctr = torch.sqrt(torch.clamp(ratio, 0, 1))
        return labels, tgt, ctr, pos

    def loss(self, outs, gt_bboxes, gt_valid, gt_labels, draws=None):
        """``loss_cls``, ``loss_bbox``, ``loss_centerness`` of N images;
        ``draws`` is unused."""
        cls_scores, bbox_preds, ctrs = outs
        dev = cls_scores[0].device
        sizes = [tuple(s.shape[-2:]) for s in cls_scores]
        points, lvl = level_points(sizes, self.strides, dev)
        ranges = torch.tensor(self.regress_ranges, dtype=torch.float32, device=dev)[lvl]
        cls = _flatten(cls_scores, self.num_classes).float()
        reg = _flatten(bbox_preds, 4)
        ctr = _flatten(ctrs, 1)[..., 0].float()
        with torch.no_grad():
            labels, tgt, ctr_t, pos = self._targets(points, ranges, gt_bboxes, gt_valid,
                                                     gt_labels)
            num_pos = shard_sum(pos.sum()).clamp(min=1).float()
            w = pos.float() * torch.maximum(ctr_t, ctr_t.new_full((), 1e-6))
            denom = torch.maximum(shard_sum(w.sum()), w.new_full((), 1e-6))
        loss_cls = self.l_cls(cls.reshape(-1, self.num_classes), labels.reshape(-1),
                              avg_factor=num_pos)
        loss_bbox = self.l_bbox(distance2bbox(points, reg).reshape(-1, 4),
                                distance2bbox(points, tgt).reshape(-1, 4),
                                weight=w.reshape(-1), avg_factor=denom)
        loss_ctr = self.l_ctr(ctr.reshape(-1), ctr_t.reshape(-1),
                              weight=pos.float().reshape(-1), avg_factor=num_pos)
        return dict(loss_cls=loss_cls, loss_bbox=loss_bbox, loss_centerness=loss_ctr)

    def get_bboxes(self, outs, img_shapes, scale_factors, rescale: bool = True, cfg=None):
        """Detections of N images: dets (N, max_per_img, 5), labels, valid."""
        cls_scores, bbox_preds, ctrs = outs
        cfg = dict(cfg or self.test_cfg)
        nms_pre = int(cfg.get("nms_pre", 1000))
        pts = [level_points([tuple(c.shape[-2:])], [s], c.device)[0]
               for c, s in zip(cls_scores, self.strides)]
        max_shape = (img_shapes[:, 0:1], img_shapes[:, 1:2])
        # the class scores times the centerness, ranked by their largest (the
        # JAX head's largest score times the centerness: the same floats)
        levels = [(torch.sigmoid(_flatten([c], self.num_classes).float())
                   * torch.sigmoid(_flatten([t], 1).float()), _flatten([r], 4), None)
                  for c, r, t in zip(cls_scores, bbox_preds, ctrs)]
        boxes, scores = top_candidates(levels, nms_pre, lambda li, ti, d: distance2bbox(
            pts[li][ti], d, max_shape=max_shape))
        return nms_detections(boxes, scores, scale_factors, rescale, cfg, self.num_classes)


@DETECTORS.register_module()
class FCOS(SingleStageDetector):
    """``fcos_head.py:205``."""
