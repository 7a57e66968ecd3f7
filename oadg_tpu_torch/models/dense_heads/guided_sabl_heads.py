"""Guided-anchoring RetinaNet and SABL RetinaNet heads (port of
``oadg_tpu/models/dense_heads/guided_sabl_heads.py:38-103,238-583``; its
``GARPNHead``, ``:107-236``, is not ported: no config of the repo names it).

``GARetinaHead`` (``:238-390``): per level ``RetinaHead``'s plain towers
(``cls_convs.i``, ``reg_convs.i``: 3x3 conv and ReLU, LeCun-normal as the
JAX head's), ``conv_loc`` (1x1, one logit: does a gt's centre lie here) on
the class tower, ``conv_shape`` (1x1, the guided anchor's log width and
height) on the box tower, then each tower through its ``FeatureAdaption``
(``:38-52``; ``feature_adaption_cls``, ``feature_adaption_reg``): a 1x1
``conv_offset`` turns the detached shape prediction into ``4 x 18``
float32 offsets for a 3x3 DCNv1 ``conv_adaption`` of 4 deform groups
(``layers.DeformConv``), then a ReLU; ``retina_cls`` and ``retina_reg``
(3x3) on the adapted maps. Every output is float32. A point's guided
anchor is centred on the point (``level_points``, offset 0.5) with
``8 * stride * exp(clip(shape, -4, 4))`` as its width and height.

- ``ga_targets`` (``:56-103``), dense over (N, P, G): each gt's level by
  its scale, ``round(log2(sqrt(area) / 8 / 8 + 1e-6)) + 2`` clipped to the
  levels (rounding half to even, as ``jnp.round``); the points of that
  level inside the gt's central 0.2 (``center_ratio``) are the loc
  positives, those inside its central 0.5 and no positive are ignored (loc
  weight 0); a positive point's shape target is the gt of least area among
  those whose centre region holds it (the first of equals).
- ``loss``: ``loss_ga_loc`` the focal BCE (alpha 0.25, gamma 2) of the loc
  logits over the loc positives; ``loss_ga_shape`` ``-log IoU`` (clipped to
  [1e-6, 1]) of each shape-positive point's guided anchor with its gt over
  their count; then ``MaxIoUAssigner`` (0.5 / 0.4 / 0) per image on the
  detached guided anchors: ``loss_cls`` the focal loss over the positives
  and negatives over ``npos``, ``loss_bbox`` SmoothL1 (beta 0.04) of the
  positives' deltas over ``npos * 4``. Each count is the batch's (every
  rank's under data parallel). The JAX head simplifies mmdet's: its shape
  targets are the matched gt's box, not the best of mmdet's 9 sampled
  shapes, and its loc targets carry no per-level ignore of the adjacent
  levels (its docstring, ``:8-15``; ROADMAP C).
- ``get_bboxes``: the class sigmoids gated by ``sigmoid(loc) > 0.01``, one
  top ``nms_pre`` over every level together by the largest gated score
  (ties to the lower index: gated-out points tie at 0), decoded from their
  guided anchors and clipped, then ``multiclass_nms``.

``SABLRetinaHead`` (``:393-583``): the same plain towers, ``retina_cls`` on
the class tower and ``retina_bbox_cls`` / ``retina_bbox_reg`` (mmdet's
names; JAX's ``bucket_cls`` / ``bucket_reg``) on the box tower, each of
``4 x num_buckets`` outputs: per side (left, right, top, bottom) a bucket
logit and an in-bucket offset. A location's square anchor
(``square_anchor_generator``: ratio 1, scale 4) spans ``scale_factor`` (3)
times its size in ``num_buckets`` (14) buckets each way (``_bucket_edges``:
the buckets' centres and widths).

- ``loss``: ``ApproxMaxIoUAssigner`` over the 9 approx anchors a location
  (``approx_anchor_generator``: RetinaNet's octave anchors); ``loss_cls``
  focal over ``npos``; per side the target bucket is the one whose centre
  lies nearest the matched gt's side (the first of equals), its offset the
  distance over the bucket width; ``loss_bbox_cls`` the buckets' softmax
  cross entropy and ``loss_bbox_reg`` SmoothL1 (beta 1/9) of the offset at
  the target bucket, each over the positives' ``npos * 4`` sides, times 1.5.
- ``get_bboxes``: one top ``nms_pre`` over every level by the largest class
  sigmoid, each side at its argmax bucket's centre plus its offset times
  the width, clipped to the image, then ``multiclass_nms``.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...core.bbox.assign_sample import ApproxMaxIoUAssigner, MaxIoUAssigner
from ...core.bbox.coder import DeltaXYWHBBoxCoder
from ...core.bbox.geometry import bbox_overlaps
from ...parallel import shard_sum
from ...utils.registry import HEADS, LOSSES, PRIOR_GENERATORS, build_from_cfg, cfg_args
from ..layers import Conv, DeformConv, widen
from .autoassign_ld_heads import _clip
from .fcos_head import level_points
from .retina_head import (_flatten, gather_rows, nms_detections, plain_tower, run_towers,
                          top_indices)

INF = 1e8


class FeatureAdaption(nn.Module):
    """``relu(DCNv1(x, conv_offset(shape.detach())))``: a 1x1 biased
    ``conv_offset`` of 2 -> ``deform_groups * 18`` channels (float32 out)
    and a 3x3 ``conv_adaption`` of ``deform_groups`` groups."""

    def __init__(self, channels: int, deform_groups: int = 4, device=None, dtype=None):
        super().__init__()
        self.conv_offset = Conv(2, deform_groups * 18, 1, 1, 0, device=device, dtype=dtype)
        self.conv_adaption = DeformConv(channels, channels, 3, padding=1,
                                        deform_groups=deform_groups, device=device)

    def forward(self, x, shape_pred):
        offset = widen(self.conv_offset(shape_pred.detach()))
        return F.relu(self.conv_adaption(x, offset))


def _focal_bce(logits, targets, weight):
    """Sum of the focal BCE (alpha 0.25, gamma 2) of float32 logits against
    0 / 1 targets, times ``weight`` (``:329-335``)."""
    p = torch.sigmoid(logits)
    pt = p * targets + (1 - p) * (1 - targets)
    a_t = 0.25 * targets + 0.75 * (1 - targets)
    ce = _clip(logits, 0.0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))
    return (a_t * (1 - pt) ** 2 * ce * weight).sum()


@HEADS.register_module()
class GARetinaHead(nn.Module):

    def __init__(self, num_classes: int = 80, in_channels: int = 256,
                 feat_channels: int = 256, stacked_convs: int = 4,
                 strides: Sequence[int] = (8, 16, 32, 64, 128), octave_base_scale: int = 8,
                 deform_groups: int = 4, loc_filter_thr: float = 0.01,
                 center_ratio: float = 0.2, ignore_ratio: float = 0.5, loss_cls=None,
                 loss_bbox=None, train_cfg=None, test_cfg=None, num_views: int = 1,
                 device=None, dtype=None):
        super().__init__()
        self.num_classes = num_classes
        self.strides = tuple(strides)
        self.octave_base_scale = octave_base_scale
        self.loc_filter_thr = loc_filter_thr
        self.center_ratio, self.ignore_ratio = center_ratio, ignore_ratio
        self.train_cfg = dict(train_cfg or {})
        self.test_cfg = dict(test_cfg or {})
        self.l_cls = build_from_cfg(dict(loss_cls or dict(
            type="FocalLoss", gamma=2.0, alpha=0.25, loss_weight=1.0)), LOSSES)
        self.l_bbox = build_from_cfg(dict(loss_bbox or dict(
            type="SmoothL1Loss", beta=0.04, loss_weight=1.0)), LOSSES)
        self.assigner = MaxIoUAssigner(**cfg_args(
            self.train_cfg.get("assigner"),
            dict(pos_iou_thr=0.5, neg_iou_thr=0.4, min_pos_iou=0.0), "MaxIoUAssigner"))
        self.bbox_coder = DeltaXYWHBBoxCoder()
        conv = dict(device=device, dtype=dtype)
        self.cls_convs = plain_tower(in_channels, feat_channels, stacked_convs, **conv)
        self.reg_convs = plain_tower(in_channels, feat_channels, stacked_convs, **conv)
        self.conv_loc = Conv(feat_channels, 1, 1, 1, 0, **conv)
        self.conv_shape = Conv(feat_channels, 2, 1, 1, 0, **conv)
        self.feature_adaption_cls = FeatureAdaption(feat_channels, deform_groups, **conv)
        self.feature_adaption_reg = FeatureAdaption(feat_channels, deform_groups, **conv)
        self.retina_cls = Conv(feat_channels, num_classes, 3, 1, 1, **conv)
        self.retina_reg = Conv(feat_channels, 4, 3, 1, 1, **conv)

    def init_weights(self, gen: torch.Generator):
        """The JAX head's init is the model's default (``init_default_``:
        LeCun-normal convs with zero biases, He-normal DCN weights)."""

    def forward(self, feats):
        """Per level, float32: class logits (N, C, H, W), deltas (N, 4, H,
        W), shapes (N, 2, H, W), loc logits (N, 1, H, W)."""
        cls_scores, bbox_preds, shapes, locs = [], [], [], []
        for x in feats:
            c, r = run_towers(self, x)
            loc = widen(self.conv_loc(c))
            shape = widen(self.conv_shape(r))
            cls_scores.append(widen(self.retina_cls(self.feature_adaption_cls(c, shape))))
            bbox_preds.append(widen(self.retina_reg(self.feature_adaption_reg(r, shape))))
            shapes.append(shape)
            locs.append(loc)
        return cls_scores, bbox_preds, shapes, locs

    def _points(self, maps):
        """Every level's points (P, 2) and their strides (P,)."""
        points, lvl = level_points([tuple(m.shape[-2:]) for m in maps], self.strides,
                                   maps[0].device)
        return points, lvl, torch.tensor(self.strides, dtype=torch.float32,
                                         device=points.device)[lvl]

    def guided_anchors(self, points, strides, shape):
        """(P, 2) points, their (P,) strides and (N, P, 2) shapes -> (N, P, 4)."""
        base = self.octave_base_scale * strides
        w = base * torch.exp(_clip(shape[..., 0], -4, 4))
        h = base * torch.exp(_clip(shape[..., 1], -4, 4))
        return torch.stack([points[:, 0] - w / 2, points[:, 1] - h / 2,
                            points[:, 0] + w / 2, points[:, 1] + h / 2], -1)

    @staticmethod
    def _region(points, gt, frac: float):
        """(P, 2) points inside the central ``frac`` of (N, G, 4) gts -> (N, P, G)."""
        px, py = points[:, 0, None], points[:, 1, None]
        cx = (gt[..., 0] + gt[..., 2]) * 0.5
        cy = (gt[..., 1] + gt[..., 3]) * 0.5
        gw = gt[..., 2] - gt[..., 0]
        gh = gt[..., 3] - gt[..., 1]
        hw, hh = (0.5 * frac * gw)[:, None, :], (0.5 * frac * gh)[:, None, :]
        cx, cy = cx[:, None, :], cy[:, None, :]
        return (px >= cx - hw) & (px <= cx + hw) & (py >= cy - hh) & (py <= cy + hh)

    def ga_targets(self, points, lvl, gt, gt_valid):
        """(P, 2) points, their (P,) level ids, (N, G, 4) gts -> loc targets
        (N, P), loc weights (N, P), the matched gt (N, P, 4), shape positives
        (N, P)."""
        area = (gt[..., 2] - gt[..., 0]) * (gt[..., 3] - gt[..., 1])       # (N, G)
        scale = torch.sqrt(torch.clamp_min(area, 1e-6))
        gt_lvl = _clip(torch.round(torch.log2(scale / self.octave_base_scale / 8.0 + 1e-6)) + 2,
                       0, len(self.strides) - 1).long()
        on = (lvl[None, :, None] == gt_lvl[:, None, :]) & gt_valid[:, None, :]
        center = self._region(points, gt, self.center_ratio) & on
        ignore = self._region(points, gt, self.ignore_ratio) & on
        loc_t = center.any(-1).float()
        loc_w = torch.where(ignore.any(-1) & (loc_t == 0), 0.0, 1.0)
        am = torch.where(center, area[:, None, :], area.new_full((), INF))
        gi = am.argmin(-1)                                                    # the first of equals
        shape_pos = am.amin(-1) < INF
        return loc_t, loc_w, gather_rows(gt, gi), shape_pos

    def loss(self, outs, gt_bboxes, gt_valid, gt_labels, draws=None):
        """``loss_ga_loc``, ``loss_ga_shape``, ``loss_cls``, ``loss_bbox`` of
        N images; ``draws`` is unused."""
        cls_scores, bbox_preds, shapes, locs = outs
        n, g = gt_labels.shape
        points, lvl, strides = self._points(cls_scores)
        loc = _flatten(locs, 1)[..., 0]
        shape = _flatten(shapes, 2)
        cls = _flatten(cls_scores, self.num_classes)
        reg = _flatten(bbox_preds, 4)
        anchors = self.guided_anchors(points, strides, shape)               # (N, P, 4)
        with torch.no_grad():
            loc_t, loc_w, mgt, shape_pos = self.ga_targets(points, lvl, gt_bboxes, gt_valid)
            fixed = anchors.detach()
            assign = self.assigner.assign(fixed, gt_bboxes, gt_valid, gt_labels=gt_labels)
            pos = assign.gt_inds > 0
            neg = assign.gt_inds == 0
            labels = torch.where(pos, assign.labels, torch.full_like(assign.labels,
                                                                     self.num_classes))
            tgt = gather_rows(gt_bboxes, (assign.gt_inds - 1).clamp(0, g - 1))
            deltas = self.bbox_coder.encode(fixed, tgt)
            nloc = _clip(shard_sum(loc_t.sum()), 1.0)
            nsp = _clip(shard_sum(shape_pos.float().sum()), 1.0)
            npos = _clip(shard_sum(pos.float().sum()), 1.0)
            cw = (pos | neg).float()
            bw = pos.float()[..., None].expand(n, -1, 4)
        iou = bbox_overlaps(anchors, mgt, is_aligned=True)
        loss_shape = (-torch.log(_clip(iou, 1e-6, 1.0)) * shape_pos.float()).sum() / nsp
        return dict(
            loss_ga_loc=_focal_bce(loc, loc_t, loc_w) / nloc,
            loss_ga_shape=loss_shape,
            loss_cls=self.l_cls(cls.reshape(-1, self.num_classes), labels.reshape(-1),
                                cw.reshape(-1), avg_factor=npos),
            loss_bbox=self.l_bbox(reg, deltas, bw, avg_factor=npos * 4))

    def get_bboxes(self, outs, img_shapes, scale_factors, rescale: bool = True, cfg=None):
        """Detections of N images: dets (N, max_per_img, 5), labels, valid."""
        cls_scores, bbox_preds, shapes, locs = outs
        cfg = dict(cfg or self.test_cfg)
        points, _, strides = self._points(cls_scores)
        anchors = self.guided_anchors(points, strides, _flatten(shapes, 2))
        gate = torch.sigmoid(_flatten(locs, 1)) > self.loc_filter_thr               # (N, P, 1)
        scores = torch.sigmoid(_flatten(cls_scores, self.num_classes)) * gate
        ti = top_indices(scores.amax(-1), int(cfg.get("nms_pre", 1000)))
        boxes = self.bbox_coder.decode(gather_rows(anchors, ti),
                                       gather_rows(_flatten(bbox_preds, 4), ti),
                                       max_shape=(img_shapes[:, 0:1], img_shapes[:, 1:2]))
        return nms_detections(boxes, gather_rows(scores, ti), scale_factors, rescale, cfg,
                              self.num_classes)


@HEADS.register_module()
class SABLRetinaHead(nn.Module):

    def __init__(self, num_classes: int = 80, in_channels: int = 256,
                 feat_channels: int = 256, stacked_convs: int = 4,
                 strides: Sequence[int] = (8, 16, 32, 64, 128), approx_anchor_generator=None,
                 square_anchor_generator=None, num_buckets: int = 14,
                 scale_factor: float = 3.0, loss_cls=None, loss_bbox_cls=None,
                 loss_bbox_reg=None, train_cfg=None, test_cfg=None, num_views: int = 1,
                 device=None, dtype=None):
        super().__init__()
        self.num_classes = num_classes
        self.num_buckets = num_buckets
        self.scale_factor = scale_factor
        self.train_cfg = dict(train_cfg or {})
        self.test_cfg = dict(test_cfg or {})
        self.square_gen = build_from_cfg(dict(square_anchor_generator or dict(
            ratios=[1.0], scales=[4], strides=list(strides)), type="AnchorGenerator"),
            PRIOR_GENERATORS)
        self.approx_gen = build_from_cfg(dict(approx_anchor_generator or dict(
            octave_base_scale=4, scales_per_octave=3, ratios=[0.5, 1.0, 2.0],
            strides=list(strides)), type="AnchorGenerator"), PRIOR_GENERATORS)
        self.approxs_per_octave = self.approx_gen.num_base_anchors[0]
        self.l_cls = build_from_cfg(dict(loss_cls or dict(
            type="FocalLoss", gamma=2.0, alpha=0.25, loss_weight=1.0)), LOSSES)
        self.assigner = ApproxMaxIoUAssigner(**cfg_args(
            self.train_cfg.get("assigner"),
            dict(pos_iou_thr=0.5, neg_iou_thr=0.4, min_pos_iou=0.0), "ApproxMaxIoUAssigner"))
        conv = dict(device=device, dtype=dtype)
        self.cls_convs = plain_tower(in_channels, feat_channels, stacked_convs, **conv)
        self.reg_convs = plain_tower(in_channels, feat_channels, stacked_convs, **conv)
        self.retina_cls = Conv(feat_channels, num_classes, 3, 1, 1, **conv)
        self.retina_bbox_cls = Conv(feat_channels, 4 * num_buckets, 3, 1, 1, **conv)
        self.retina_bbox_reg = Conv(feat_channels, 4 * num_buckets, 3, 1, 1, **conv)

    def init_weights(self, gen: torch.Generator):
        """The JAX head's init is the model's default (``init_default_``)."""

    def forward(self, feats):
        """Per level, float32: class logits (N, C, H, W), bucket logits and
        offsets (N, 4 * num_buckets, H, W) each."""
        cls_scores, bucket_cls, bucket_reg = [], [], []
        for x in feats:
            c, r = run_towers(self, x)
            cls_scores.append(widen(self.retina_cls(c)))
            bucket_cls.append(widen(self.retina_bbox_cls(r)))
            bucket_reg.append(widen(self.retina_bbox_reg(r)))
        return cls_scores, bucket_cls, bucket_reg

    def bucket_edges(self, squares):
        """(K, 4) squares -> the buckets' centres along x (K, B) and y (K, B)
        and their widths (K,) and heights (K,) (``_bucket_edges``): the side
        ``scale_factor`` times the square's in ``num_buckets`` buckets. The
        arithmetic is XLA's compiled form of JAX's, so that the targets agree
        bit for bit: the division by ``num_buckets`` becomes a product with
        its float32 reciprocal, folded with ``scale_factor`` into one float32
        constant (``fl(3 * fl(1 / 14))``, not ``fl(3 / 14)``), ``/ 2`` with it
        into ``1.5``, and the centre of bucket ``i`` ``(i + 0.5) * width +
        start`` is one fused multiply-add (emulated in float64: the product is
        exact there)."""
        sw = squares[:, 2] - squares[:, 0]
        sh = squares[:, 3] - squares[:, 1]
        cx = (squares[:, 0] + squares[:, 2]) * 0.5
        cy = (squares[:, 1] + squares[:, 3]) * 0.5
        per = torch.tensor(np.float32(self.scale_factor) * np.float32(1.0 / self.num_buckets))
        half = torch.tensor(np.float32(self.scale_factor) * np.float32(0.5))
        bw, bh = sw * per.to(sw.device), sh * per.to(sw.device)
        steps = torch.arange(self.num_buckets, dtype=torch.float64, device=squares.device) + 0.5

        def fma(width, start):
            return (steps[None] * width.double()[:, None] + start.double()[:, None]).float()

        return (fma(bw, cx - sw * half.to(sw.device)), fma(bh, cy - sh * half.to(sw.device)),
                bw, bh)

    def bucket_targets(self, squares, gt):
        """(K, 4) squares, (N, K, 4) matched gts -> each side's (left, right,
        top, bottom) target bucket (N, K, 4) and in-bucket offset (N, K, 4)."""
        left, top, bw, bh = self.bucket_edges(squares)

        def side(edges, coord, width):
            b = (edges - coord[..., None]).abs().argmin(-1)                 # the first of equals
            at = torch.gather(edges.expand(coord.shape[0], -1, -1), 2, b[..., None])[..., 0]
            return b, (coord - at) / torch.clamp_min(width, 1e-6)

        sides = [side(left, gt[..., 0], bw), side(left, gt[..., 2], bw),
                 side(top, gt[..., 1], bh), side(top, gt[..., 3], bh)]
        return (torch.stack([b for b, _ in sides], -1), torch.stack([o for _, o in sides], -1))

    def _flat(self, cls_scores, bucket_cls, bucket_reg):
        n, nb = cls_scores[0].shape[0], self.num_buckets
        return (_flatten(cls_scores, self.num_classes),
                _flatten(bucket_cls, 4 * nb).reshape(n, -1, 4, nb),
                _flatten(bucket_reg, 4 * nb).reshape(n, -1, 4, nb))

    def loss(self, outs, gt_bboxes, gt_valid, gt_labels, draws=None):
        """``loss_cls``, ``loss_bbox_cls``, ``loss_bbox_reg`` of N images;
        ``draws`` is unused."""
        sizes = [tuple(s.shape[-2:]) for s in outs[0]]
        dev = outs[0][0].device
        cls, bc, br = self._flat(*outs)
        g = gt_labels.shape[1]
        with torch.no_grad():
            squares = self.square_gen.grid_priors_cat(sizes, dev)
            assign = self.assigner.assign(self.approx_gen.grid_priors_cat(sizes, dev), squares,
                                          self.approxs_per_octave, gt_bboxes, gt_valid,
                                          gt_labels=gt_labels)
            pos = assign.gt_inds > 0
            neg = assign.gt_inds == 0
            labels = torch.where(pos, assign.labels, torch.full_like(assign.labels,
                                                                     self.num_classes))
            tgt = gather_rows(gt_bboxes, (assign.gt_inds - 1).clamp(0, g - 1))
            bidx, boff = self.bucket_targets(squares, tgt)
            npos = _clip(shard_sum(pos.float().sum()), 1.0)
            posf = pos.float()[..., None]
        loss_cls = self.l_cls(cls.reshape(-1, self.num_classes), labels.reshape(-1),
                              (pos | neg).float().reshape(-1), avg_factor=npos)
        nll = -torch.gather(F.log_softmax(bc, -1), 3, bidx[..., None])[..., 0]
        d = (torch.gather(br, 3, bidx[..., None])[..., 0] - boff).abs()
        sl1 = torch.where(d < 1.0 / 9.0, 4.5 * d * d, d - 1.0 / 18.0)
        return dict(loss_cls=loss_cls,
                    loss_bbox_cls=(nll * posf).sum() / (npos * 4) * 1.5,
                    loss_bbox_reg=(sl1 * posf).sum() / (npos * 4) * 1.5)

    def get_bboxes(self, outs, img_shapes, scale_factors, rescale: bool = True, cfg=None):
        """Detections of N images: dets (N, max_per_img, 5), labels, valid."""
        cfg = dict(cfg or self.test_cfg)
        sizes = [tuple(s.shape[-2:]) for s in outs[0]]
        cls, bc, br = self._flat(*outs)
        left, top, bw, bh = self.bucket_edges(self.square_gen.grid_priors_cat(
            sizes, cls.device))
        scores = torch.sigmoid(cls)
        ti = top_indices(scores.amax(-1), int(cfg.get("nms_pre", 1000)))      # (N, k)
        bsel = gather_rows(bc, ti).argmax(-1)                                    # (N, k, 4)
        off = torch.gather(gather_rows(br, ti), 3, bsel[..., None])[..., 0]
        lt, tp = left[ti], top[ti]                                               # (N, k, B)
        size = torch.stack([bw[ti], bh[ti]], -1)                                 # (N, k, 2)
        x1 = torch.gather(lt, 2, bsel[..., 0:1])[..., 0] + off[..., 0] * size[..., 0]
        x2 = torch.gather(lt, 2, bsel[..., 1:2])[..., 0] + off[..., 1] * size[..., 0]
        y1 = torch.gather(tp, 2, bsel[..., 2:3])[..., 0] + off[..., 2] * size[..., 1]
        y2 = torch.gather(tp, 2, bsel[..., 3:4])[..., 0] + off[..., 3] * size[..., 1]
        hi = torch.stack([img_shapes[:, 1], img_shapes[:, 0]] * 2, -1).float()[:, None, :]
        boxes = torch.minimum(torch.clamp_min(torch.stack([x1, y1, x2, y2], -1), 0), hi)
        return nms_detections(boxes, gather_rows(scores, ti), scale_factors, rescale, cfg,
                              self.num_classes)
