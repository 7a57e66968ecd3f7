"""FoveaBox and FSAF heads and detectors (port of
``oadg_tpu/models/dense_heads/fovea_fsaf_heads.py:46-371``).

Both heads run two towers of ``stacked_convs`` 3x3 convs with ReLU and no
norm (``cls_convs.i``, ``reg_convs.i``: mmcv ``ConvModule``s), then
``conv_cls`` (C sigmoid logits) and ``conv_reg`` (4 values) on every level
at strides 8-128; every conv LeCun-normal with a zero bias, the classifier's
too (mmdet starts it at a 0.01 prior; ROADMAP C). Points are
``fcos_head.level_points`` at offset 0.5; the targets are (N, P, G)
point-by-gt masks, as the JAX heads' per-image (P, G) ones.

``FoveaHead`` (``:46-192``):
- ``loss``: a point is a candidate of a gt when it lies in the gt's fovea
  (the box shrunk about its centre to ``sigma`` of its width and height,
  edges included) and the gt's ``sqrt(area)`` lies in the level's
  ``scale_ranges`` (ends included); it takes the candidate gt of smallest
  area (the first of equals). Its targets are ``log(clip(d / base_edge, 1 /
  16, 16))`` of its four edge distances, ``base_edge`` the level's
  ``base_edge_list`` entry. Focal loss (gamma 1.5, alpha 0.4 in the config)
  over every point over ``num_pos``, SmoothL1 (beta 0.11) of the
  positives' four targets over ``num_pos * 4``; ``num_pos`` counts every
  rank's positives under data parallel.
- ``get_bboxes``: per level the top ``nms_pre`` points by largest class
  sigmoid, the box ``exp(reg) * base_edge`` about the point, clipped to
  the image, then ``retina_head.nms_detections``.

``FSAFHead`` (``:195-359``): ``conv_reg``'s output is ``relu(x) + 1e-4``
(positive distances in units of ``4 * stride``).
- ``loss``: per gt an effective box (``effective_fraction`` 0.2 of the
  box about its centre) and an ignore box (0.5). Each point of a gt's
  effective box at each level costs ``-log p_gt - log IoU`` (the class
  sigmoid at the gt's label, the IoU of the decoded box with the gt, each
  clipped to [1e-6, 1]); per gt the level whose effective points give the
  lowest mean cost is selected (online feature selection, under
  ``no_grad``; a level without such points is never selected), per image.
  A point is positive for the smallest-area gt that selected its level and
  holds it in its effective box; a point of an ignore box that is not
  positive gets class weight 0. Focal loss over ``num_pos``, the IoU loss
  ``-log IoU`` of the positives over ``num_pos`` (every rank's under data
  parallel).
- ``get_bboxes``: per level the top ``nms_pre`` points, the distances times
  ``4 * stride``, ``distance2bbox`` clipped to the image.

mmdet's FSAF head is a RetinaHead and names its classifier and regressor
``retina_cls`` and ``retina_reg``; the port's (JAX's) ``conv_cls`` and
``conv_reg`` load them (``mmdet_names``).
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...core.bbox.geometry import bbox_overlaps
from ...core.bbox.transforms import distance2bbox
from ...parallel import shard_sum
from ...utils.registry import DETECTORS, HEADS, LOSSES, build_from_cfg
from ..detectors.single_stage import SingleStageDetector
from ..layers import Conv
from .autoassign_ld_heads import _clip
from .fcos_head import level_points
from .retina_head import _flatten, nms_detections, plain_tower, run_towers, top_candidates

INF = 1e8


def _gt_region(points, gt, frac: float):
    """(P, 2) points in the (N, G, 4) gts shrunk to ``frac`` of their width
    and height about their centres, edges included -> (N, P, G)."""
    px, py = points[:, 0, None], points[:, 1, None]
    g = gt[:, None]                                                     # (N, 1, G, 4)
    cx = (g[..., 0] + g[..., 2]) * 0.5
    cy = (g[..., 1] + g[..., 3]) * 0.5
    gw = g[..., 2] - g[..., 0]
    gh = g[..., 3] - g[..., 1]
    return ((px >= cx - 0.5 * frac * gw) & (px <= cx + 0.5 * frac * gw)
            & (py >= cy - 0.5 * frac * gh) & (py <= cy + 0.5 * frac * gh))


def _smallest_gt(cand, gt):
    """(N, P, G) candidate masks -> each point's candidate gt of smallest
    area (the first of equals; 0 where none) and whether it has one."""
    area = ((gt[..., 2] - gt[..., 0]) * (gt[..., 3] - gt[..., 1]))[:, None, :]
    area_m = torch.where(cand, area, area.new_full((), INF))
    return area_m.argmin(-1), area_m.amin(-1) < INF


class _PlainTowerHead(nn.Module):
    """The towers and the two output convs that FoveaHead and FSAFHead share."""

    def __init__(self, num_classes, in_channels, feat_channels, stacked_convs, strides,
                 train_cfg, test_cfg, device, dtype):
        super().__init__()
        self.num_classes = num_classes
        self.strides = tuple(strides)
        self.train_cfg = dict(train_cfg or {})
        self.test_cfg = dict(test_cfg or {})
        conv = dict(device=device, dtype=dtype)
        self.cls_convs = plain_tower(in_channels, feat_channels, stacked_convs, **conv)
        self.reg_convs = plain_tower(in_channels, feat_channels, stacked_convs, **conv)
        self.conv_cls = Conv(feat_channels, num_classes, 3, 1, 1, **conv)
        self.conv_reg = Conv(feat_channels, 4, 3, 1, 1, **conv)

    def init_weights(self, gen: torch.Generator):
        """The model's default (``init_default_``), as the JAX heads'."""

    def _towers(self, feats):
        for x in feats:
            c, r = run_towers(self, x)
            yield self.conv_cls(c), self.conv_reg(r)

    def _test_levels(self, outs, reg_fn):
        """Per level (class sigmoid, ``reg_fn`` of the float32 regression,
        None) and the level's points."""
        cls_scores, bbox_preds = outs
        pts = [level_points([tuple(c.shape[-2:])], [s], c.device)[0]
               for c, s in zip(cls_scores, self.strides)]
        levels = [(torch.sigmoid(_flatten([c], self.num_classes).float()),
                   reg_fn(_flatten([r], 4).float()), None)
                  for c, r in zip(cls_scores, bbox_preds)]
        return levels, pts


@HEADS.register_module()
class FoveaHead(_PlainTowerHead):

    def __init__(self, num_classes: int = 80, in_channels: int = 256,
                 feat_channels: int = 256, stacked_convs: int = 4,
                 strides: Sequence[int] = (8, 16, 32, 64, 128),
                 base_edge_list: Sequence[int] = (16, 32, 64, 128, 256),
                 scale_ranges=((1, 64), (32, 128), (64, 256), (128, 512), (256, 2048)),
                 sigma: float = 0.4, loss_cls=None, loss_bbox=None, train_cfg=None,
                 test_cfg=None, num_views: int = 1, device=None, dtype=None):
        super().__init__(num_classes, in_channels, feat_channels, stacked_convs, strides,
                         train_cfg, test_cfg, device, dtype)
        self.base_edge_list = tuple(float(b) for b in base_edge_list)
        self.scale_ranges = tuple(tuple(float(v) for v in r) for r in scale_ranges)
        self.sigma = sigma
        self.l_cls = build_from_cfg(dict(loss_cls or dict(
            type="FocalLoss", use_sigmoid=True, gamma=1.5, alpha=0.4, loss_weight=1.0)), LOSSES)
        self.l_bbox = build_from_cfg(dict(loss_bbox or dict(
            type="SmoothL1Loss", beta=0.11, loss_weight=1.0)), LOSSES)

    def forward(self, feats):
        """Per level: class logits (N, C, H, W), log-space edges (N, 4, H, W)."""
        cls_scores, bbox_preds = zip(*self._towers(feats))
        return list(cls_scores), list(bbox_preds)

    def targets(self, points, lvl, gt, gt_valid, gt_labels):
        """(P, 2) points, (P,) level ids, (N, G, 4) gts -> labels (N, P)
        (``num_classes`` for background), the log-space targets (N, P, 4)
        and the positives (N, P)."""
        dev = points.device
        base = torch.tensor(self.base_edge_list, dtype=torch.float32, device=dev)[lvl]
        ranges = torch.tensor(self.scale_ranges, dtype=torch.float32, device=dev)[lvl]
        gw = gt[..., 2] - gt[..., 0]
        gh = gt[..., 3] - gt[..., 1]
        scale = torch.sqrt(torch.clamp_min(gw * gh, 1e-6))[:, None, :]     # (N, 1, G)
        in_range = (scale >= ranges[:, 0, None]) & (scale <= ranges[:, 1, None])
        cand = _gt_region(points, gt, self.sigma) & in_range & gt_valid[:, None, :]
        gi, pos = _smallest_gt(cand, gt)
        labels = torch.where(pos, torch.gather(gt_labels.long(), 1, gi),
                             torch.full_like(gi, self.num_classes))
        g = torch.gather(gt, 1, gi[..., None].expand(*gi.shape, 4))          # (N, P, 4)
        px, py = points[:, 0], points[:, 1]
        tgt = torch.stack([px - g[..., 0], py - g[..., 1], g[..., 2] - px, g[..., 3] - py], -1)
        tgt = torch.log(torch.clamp(tgt / base[:, None], 1 / 16, 16))
        return labels, tgt, pos

    def loss(self, outs, gt_bboxes, gt_valid, gt_labels, draws=None):
        """``loss_cls`` (focal) and ``loss_bbox`` (SmoothL1) of N images;
        ``draws`` is unused."""
        cls_scores, bbox_preds = outs
        sizes = [tuple(s.shape[-2:]) for s in cls_scores]
        points, lvl = level_points(sizes, self.strides, cls_scores[0].device)
        cls = _flatten(cls_scores, self.num_classes).float()
        reg = _flatten(bbox_preds, 4).float()
        with torch.no_grad():
            labels, tgt, pos = self.targets(points, lvl, gt_bboxes, gt_valid, gt_labels)
            num_pos = shard_sum(pos.sum()).clamp(min=1).float()
            bw = pos.float()[..., None].expand(*pos.shape, 4)
        return dict(loss_cls=self.l_cls(cls.reshape(-1, self.num_classes), labels.reshape(-1),
                                        avg_factor=num_pos),
                    loss_bbox=self.l_bbox(reg, tgt, bw, avg_factor=num_pos * 4))

    def get_bboxes(self, outs, img_shapes, scale_factors, rescale: bool = True, cfg=None):
        """Detections of N images: dets (N, max_per_img, 5), labels, valid."""
        cfg = dict(cfg or self.test_cfg)
        levels, pts = self._test_levels(outs, torch.exp)
        h, w = img_shapes[:, 0:1].float(), img_shapes[:, 1:2].float()
        hi = torch.stack([w, h, w, h], -1)                                   # (N, 1, 4)

        def decode(li, ti, rg):
            p, d = pts[li][ti], rg * self.base_edge_list[li]
            boxes = torch.stack([p[..., 0] - d[..., 0], p[..., 1] - d[..., 1],
                                 p[..., 0] + d[..., 2], p[..., 1] + d[..., 3]], -1)
            return torch.minimum(torch.maximum(boxes, boxes.new_zeros(())), hi)

        boxes, scores = top_candidates(levels, int(cfg.get("nms_pre", 1000)), decode)
        return nms_detections(boxes, scores, scale_factors, rescale, cfg, self.num_classes)


@HEADS.register_module()
class FSAFHead(_PlainTowerHead):

    mmdet_names = {"conv_cls": "retina_cls", "conv_reg": "retina_reg"}

    def __init__(self, num_classes: int = 80, in_channels: int = 256,
                 feat_channels: int = 256, stacked_convs: int = 4,
                 strides: Sequence[int] = (8, 16, 32, 64, 128),
                 effective_fraction: float = 0.2, ignore_fraction: float = 0.5,
                 loss_cls=None, loss_bbox=None, train_cfg=None, test_cfg=None,
                 num_views: int = 1, device=None, dtype=None):
        super().__init__(num_classes, in_channels, feat_channels, stacked_convs, strides,
                         train_cfg, test_cfg, device, dtype)
        self.effective_fraction = effective_fraction
        self.ignore_fraction = ignore_fraction
        self.l_cls = build_from_cfg(dict(loss_cls or dict(
            type="FocalLoss", use_sigmoid=True, gamma=2.0, alpha=0.25, loss_weight=1.0)), LOSSES)
        self.l_bbox = build_from_cfg(dict(loss_bbox or dict(
            type="IoULoss", eps=1e-6, loss_weight=1.0)), LOSSES)

    def forward(self, feats):
        """Per level: class logits (N, C, H, W), distances ``relu(x) + 1e-4``
        in units of ``4 * stride`` (N, 4, H, W)."""
        cls_scores, bbox_preds = [], []
        for c, r in self._towers(feats):
            cls_scores.append(c)
            bbox_preds.append(F.relu(r) + 1e-4)
        return cls_scores, bbox_preds

    def targets(self, points, lvl, cls, ious, gt, gt_valid, gt_labels):
        """Online feature selection: (P, 2) points, (P,) level ids, (N, P,
        C) float32 class logits, (N, P, G) IoUs of the decoded boxes with
        the gts -> labels (N, P), positives (N, P), ignored points (N, P),
        each positive's gt (N, P) and each gt's selected level (N, G)."""
        eff = _gt_region(points, gt, self.effective_fraction) & gt_valid[:, None, :]
        ign = _gt_region(points, gt, self.ignore_fraction) & gt_valid[:, None, :]
        labels_all = gt_labels.long()[:, None, :].expand(-1, cls.shape[1], -1)
        pg = torch.gather(torch.sigmoid(cls), 2, labels_all.clamp(0, self.num_classes - 1))
        cost = -torch.log(_clip(pg, 1e-6, 1.0)) - torch.log(_clip(ious, 1e-6, 1.0))
        lvl_cost, has = [], []
        for li in range(len(self.strides)):
            m = eff & (lvl == li)[None, :, None]
            cnt = m.sum(1).clamp(min=1)
            lvl_cost.append(torch.where(m, cost, cost.new_zeros(())).sum(1) / cnt)
            has.append(m.any(1))
        lvl_cost = torch.stack(lvl_cost, 1)                                 # (N, L, G)
        sel = torch.where(torch.stack(has, 1), lvl_cost, lvl_cost.new_full((), INF)).argmin(1)
        eff_sel = eff & (lvl[None, :, None] == sel[:, None, :])
        gi, pos = _smallest_gt(eff_sel, gt)
        labels = torch.where(pos, torch.gather(gt_labels.long(), 1, gi),
                             torch.full_like(gi, self.num_classes))
        ignored = ign.any(-1) & ~pos
        return labels, pos, ignored, gi, sel

    def loss(self, outs, gt_bboxes, gt_valid, gt_labels, draws=None):
        """``loss_cls`` (focal) and ``loss_bbox`` (IoU) of N images;
        ``draws`` is unused."""
        cls_scores, bbox_preds = outs
        sizes = [tuple(s.shape[-2:]) for s in cls_scores]
        points, lvl = level_points(sizes, self.strides, cls_scores[0].device)
        strides = torch.tensor(self.strides, dtype=torch.float32, device=points.device)[lvl]
        cls = _flatten(cls_scores, self.num_classes).float()
        reg = _flatten(bbox_preds, 4).float()
        ious = bbox_overlaps(distance2bbox(points, reg * strides[:, None] * 4.0), gt_bboxes)
        with torch.no_grad():
            labels, pos, ignored, gi, _ = self.targets(points, lvl, cls, ious, gt_bboxes,
                                                       gt_valid, gt_labels)
            num_pos = shard_sum(pos.sum()).clamp(min=1).float()
        iou_pos = torch.gather(ious, 2, gi[..., None])[..., 0]
        loss_bbox = (-torch.log(_clip(iou_pos, 1e-6, 1.0)) * pos.float()).sum() / num_pos
        return dict(loss_cls=self.l_cls(cls.reshape(-1, self.num_classes), labels.reshape(-1),
                                        (~ignored).float().reshape(-1), avg_factor=num_pos),
                    loss_bbox=self.l_bbox.loss_weight * loss_bbox)

    def get_bboxes(self, outs, img_shapes, scale_factors, rescale: bool = True, cfg=None):
        """Detections of N images: dets (N, max_per_img, 5), labels, valid."""
        cfg = dict(cfg or self.test_cfg)
        levels, pts = self._test_levels(outs, lambda r: r)
        max_shape = (img_shapes[:, 0:1], img_shapes[:, 1:2])
        boxes, scores = top_candidates(levels, int(cfg.get("nms_pre", 1000)),
                                       lambda li, ti, d: distance2bbox(
                                           pts[li][ti], d * self.strides[li] * 4.0,
                                           max_shape=max_shape))
        return nms_detections(boxes, scores, scale_factors, rescale, cfg, self.num_classes)


@DETECTORS.register_module()
class FOVEA(SingleStageDetector):
    """``fovea_fsaf_heads.py:362``."""


@DETECTORS.register_module()
class FSAF(SingleStageDetector):
    """``fovea_fsaf_heads.py:368``."""
