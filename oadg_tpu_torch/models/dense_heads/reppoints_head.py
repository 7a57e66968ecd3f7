"""RepPoints head and detector (port of
``oadg_tpu/models/dense_heads/reppoints_head.py``).

Per level two GN towers of ``stacked_convs`` 3x3 convs (``cls_convs.i``,
``reg_convs.i``: conv with a bias, ``GroupNorm32``, ReLU); on the box tower
``reppoints_pts_init_conv`` (3x3), a ReLU and ``reppoints_pts_init_out``
(1x1): nine initial points, ``(dy, dx)`` per point in feature cells,
float32. The points are the taps of two 3x3 DCNv1s (``layers.DeformConv``,
``ops.deform_conv.deform_conv2d``, whose offsets are ``(dy, dx)`` per tap
in the same row-major order): the offsets are ``0.1 * init + 0.9 *
init.detach()`` (``gradient_mul``, ``:127-129``) less the 3x3 base grid
(``:92-94``). ``reppoints_cls_conv`` on the class tower, then
``cls_gn_out``, a ReLU and ``reppoints_cls_out`` (1x1, C logits);
``reppoints_pts_refine_conv`` on the box tower, then ``pts_refine_gn``, a
ReLU and ``reppoints_pts_refine_out`` (1x1), plus ``init.detach()``: the
refined points. The GNs after the DCNs are the JAX head's (mmdet has none;
ROADMAP C). Every conv LeCun-normal with a zero bias, the classifier's too
(mmdet starts it at a 0.01 prior), the DCNs He-normal.

- ``points2bbox`` (``:96-116``): ``moment``: the points' mean +- their
  standard deviation (floored at 1e-6) times ``exp(moment_transfer)``, the
  parameter mixed ``0.01 * mt + 0.99 * mt.detach()`` (``:109-111``);
  ``minmax``: the points' extent. In image units a point set is scaled by
  its level's stride and moved to its point (``level_points``, offset 0.5:
  mmdet lays them at 0; ROADMAP C).
- ``loss`` (``:136-201``): the init stage's positives are, per gt, the point
  of its scale's level (``floor(log2(sqrt(w h) / point_base_scale + 1e-6) -
  1)``, clipped to the levels) nearest its centre by L1 distance (ties to
  the lowest point), a later gt winning a point that two pick; the refine
  stage's are ``MaxIoUAssigner`` (0.5 / 0.4 / 0) on the init boxes, every
  other point a negative (its ignored ones too, as in the JAX head).
  ``loss_cls`` the focal loss over the refine stage's positives,
  ``loss_pts_init`` and ``loss_pts_refine`` SmoothL1 (beta 0.11, weights
  0.5 and 1) of the boxes over ``point_base_scale * stride``, each over 4 x
  its stage's positives; the counts are the batch's (every rank's under
  data parallel).
- ``get_bboxes`` (``:203-246``): per image and level the top ``nms_pre``
  points by largest class sigmoid (ties to the lower index), the refined
  boxes clipped to the image, then ``multiclass_nms``.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ...core.bbox.assign_sample import MaxIoUAssigner
from ...parallel import shard_sum
from ...utils.registry import DETECTORS, HEADS, LOSSES, build_from_cfg, cfg_args
from ..detectors.single_stage import SingleStageDetector
from ..layers import Conv, DeformConv, GroupNorm32
from .fcos_head import gn_tower, level_points
from .retina_head import _flatten, nms_detections, top_candidates

INF = 1e8
# the 3x3 DCN's base grid, (dy, dx) per tap, row-major
_BASE = (-1, -1, -1, 0, -1, 1, 0, -1, 0, 0, 0, 1, 1, -1, 1, 0, 1, 1)


def first_argmin(d: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """The lowest index of the least value of ``d`` along ``dim``
    (``jnp.argmin``'s tie rule, written out)."""
    n = d.shape[dim]
    shape = [1] * d.dim()
    shape[dim] = n
    idx = torch.arange(n, device=d.device).view(shape)
    at_min = d == d.amin(dim, keepdim=True)
    return torch.where(at_min, idx, torch.full_like(idx, n)).amin(dim)


@HEADS.register_module()
class RepPointsHead(nn.Module):

    def __init__(self, num_classes: int = 80, in_channels: int = 256, feat_channels: int = 256,
                 point_feat_channels: int = 256, stacked_convs: int = 3, num_points: int = 9,
                 gradient_mul: float = 0.1,
                 point_strides: Sequence[int] = (8, 16, 32, 64, 128),
                 point_base_scale: int = 4, transform_method: str = "moment",
                 moment_mul: float = 0.01, loss_cls=None, loss_bbox_init=None, loss_bbox=None,
                 train_cfg=None, test_cfg=None, num_views: int = 1, device=None, dtype=None):
        super().__init__()
        if num_points != 9:
            raise ValueError("RepPointsHead: num_points must be 9 (a 3x3 DCN's taps)")
        if transform_method not in ("moment", "minmax"):
            raise NotImplementedError(f"RepPointsHead transform_method {transform_method}")
        self.num_classes = num_classes
        self.num_points = num_points
        self.gradient_mul = gradient_mul
        self.point_strides = tuple(point_strides)
        self.point_base_scale = point_base_scale
        self.transform_method = transform_method
        self.moment_mul = moment_mul
        self.test_cfg = dict(test_cfg or {})
        self.l_cls = build_from_cfg(dict(loss_cls or dict(
            type="FocalLoss", use_sigmoid=True, gamma=2.0, alpha=0.25, loss_weight=1.0)), LOSSES)
        self.l_init = build_from_cfg(dict(loss_bbox_init or dict(
            type="SmoothL1Loss", beta=0.11, loss_weight=0.5)), LOSSES)
        self.l_refine = build_from_cfg(dict(loss_bbox or dict(
            type="SmoothL1Loss", beta=0.11, loss_weight=1.0)), LOSSES)
        refine = dict(dict(train_cfg or {}).get("refine") or {})
        self.refine_assigner = MaxIoUAssigner(**cfg_args(
            refine.get("assigner"), dict(pos_iou_thr=0.5, neg_iou_thr=0.4, min_pos_iou=0),
            "MaxIoUAssigner"))
        conv = dict(device=device, dtype=dtype)
        pts = 2 * num_points
        self.cls_convs = gn_tower(in_channels, feat_channels, stacked_convs, **conv)
        self.reg_convs = gn_tower(in_channels, feat_channels, stacked_convs, **conv)
        self.reppoints_pts_init_conv = Conv(feat_channels, point_feat_channels, 3, 1, 1, **conv)
        self.reppoints_pts_init_out = Conv(point_feat_channels, pts, 1, 1, 0, **conv)
        self.reppoints_cls_conv = DeformConv(feat_channels, point_feat_channels, 3, padding=1,
                                             device=device)
        self.cls_gn_out = GroupNorm32(point_feat_channels, device=device)
        self.reppoints_cls_out = Conv(point_feat_channels, num_classes, 1, 1, 0, **conv)
        self.reppoints_pts_refine_conv = DeformConv(feat_channels, point_feat_channels, 3,
                                                    padding=1, device=device)
        self.pts_refine_gn = GroupNorm32(point_feat_channels, device=device)
        self.reppoints_pts_refine_out = Conv(point_feat_channels, pts, 1, 1, 0, **conv)
        self.moment_transfer = nn.Parameter(torch.zeros(2, device=device))

    def init_weights(self, gen: torch.Generator):
        """The model's default (``init_default_``), as the JAX head's; the
        moment transfer at 0."""

    def points2bbox(self, pts: torch.Tensor) -> torch.Tensor:
        """(..., 18) ``(dy, dx)`` interleaved points -> (..., 4) xyxy."""
        p = pts.reshape(*pts.shape[:-1], self.num_points, 2)
        y, x = p[..., 0], p[..., 1]
        if self.transform_method == "minmax":
            return torch.stack([x.amin(-1), y.amin(-1), x.amax(-1), y.amax(-1)], -1)
        mx, my = x.mean(-1), y.mean(-1)
        floor = x.new_full((), 1e-12)
        sx = torch.sqrt(torch.maximum(((x - mx[..., None]) ** 2).mean(-1), floor))
        sy = torch.sqrt(torch.maximum(((y - my[..., None]) ** 2).mean(-1), floor))
        mt = (self.moment_transfer * self.moment_mul
              + self.moment_transfer.detach() * (1 - self.moment_mul))
        hw = sx * torch.exp(mt[0])
        hh = sy * torch.exp(mt[1])
        return torch.stack([mx - hw, my - hh, mx + hw, my + hh], -1)

    def forward(self, feats):
        """Per level: class logits (N, C, H, W), initial and refined points
        (N, 18, H, W) float32."""
        base = torch.tensor(_BASE, dtype=torch.float32, device=feats[0].device)[:, None, None]
        cls_scores, pts_inits, pts_refines = [], [], []
        for x in feats:
            c = r = x
            for m in self.cls_convs:
                c = m(c)
            for m in self.reg_convs:
                r = m(r)
            init = self.reppoints_pts_init_out(
                torch.relu(self.reppoints_pts_init_conv(r))).float()
            off = (self.gradient_mul * init + (1 - self.gradient_mul) * init.detach()) - base
            c2 = torch.relu(self.cls_gn_out(self.reppoints_cls_conv(c, off)))
            cls_scores.append(self.reppoints_cls_out(c2))
            r2 = torch.relu(self.pts_refine_gn(self.reppoints_pts_refine_conv(r, off)))
            pts_refines.append(self.reppoints_pts_refine_out(r2).float() + init.detach())
            pts_inits.append(init)
        return cls_scores, pts_inits, pts_refines

    def init_targets(self, points, lvl, gt, gt_valid):
        """The init stage's assignment: (P, 2) points, (P,) level ids, (N,
        G, 4) gts -> each point's gt (N, P) (0 where none) and the positives
        (N, P)."""
        nl = len(self.point_strides)
        gw = gt[..., 2] - gt[..., 0]
        gh = gt[..., 3] - gt[..., 1]
        scale = torch.sqrt(torch.clamp_min(gw * gh, 1e-6))
        glvl = torch.clamp(torch.floor(torch.log2(scale / self.point_base_scale + 1e-6) - 1),
                           0, nl - 1).long()                                # (N, G)
        gcx = (gt[..., 0] + gt[..., 2]) * 0.5
        gcy = (gt[..., 1] + gt[..., 3]) * 0.5
        d = ((points[None, :, 0, None] - gcx[:, None]).abs()
             + (points[None, :, 1, None] - gcy[:, None]).abs())           # (N, P, G)
        on = (lvl[None, :, None] == glvl[:, None]) & gt_valid[:, None]
        nearest = first_argmin(torch.where(on, d, d.new_full((), INF)), 1)  # (N, G)
        p = points.shape[0]
        sel = ((torch.arange(p, device=gt.device)[None, :, None] == nearest[:, None])
               & gt_valid[:, None])                                         # (N, P, G)
        pos = sel.any(-1)
        # a later gt wins a point that two pick (mmdet assigns in gt order)
        order = torch.arange(1, gt.shape[1] + 1, device=gt.device)
        gi = ((sel * order).amax(-1) - 1).clamp(min=0)
        return gi, pos

    def loss(self, outs, gt_bboxes, gt_valid, gt_labels, draws=None):
        """``loss_cls``, ``loss_pts_init`` and ``loss_pts_refine`` of N
        images; ``draws`` is unused."""
        cls_scores, pts_inits, pts_refines = outs
        n = cls_scores[0].shape[0]
        sizes = [tuple(s.shape[-2:]) for s in cls_scores]
        points, lvl = level_points(sizes, self.point_strides, cls_scores[0].device)
        strides = torch.tensor(self.point_strides, dtype=torch.float32,
                               device=points.device)[lvl]
        cls = _flatten(cls_scores, self.num_classes).float()
        ctr = torch.cat([points, points], -1)

        def to_boxes(pts_maps):
            return (self.points2bbox(_flatten(pts_maps, 2 * self.num_points))
                    * strides[:, None] + ctr)

        box_init = to_boxes(pts_inits)
        box_refine = to_boxes(pts_refines)
        g = gt_bboxes.shape[1]
        with torch.no_grad():
            gi_i, pos_i = self.init_targets(points, lvl, gt_bboxes, gt_valid)
            a = self.refine_assigner.assign(box_init.detach(), gt_bboxes, gt_valid,
                                            gt_labels=gt_labels)
            pos_r = a.gt_inds > 0
            gi_r = (a.gt_inds - 1).clamp(0, g - 1)
            labels = torch.where(pos_r, torch.gather(gt_labels.long(), 1, gi_r),
                                 torch.full_like(gi_r, self.num_classes))
            norm = (self.point_base_scale * strides)[None, :, None]
            tgt_i = torch.gather(gt_bboxes, 1, gi_i[..., None].expand(n, -1, 4))
            tgt_r = torch.gather(gt_bboxes, 1, gi_r[..., None].expand(n, -1, 4))
            np_i = torch.clamp_min(shard_sum(pos_i.float().sum()), 1.0)
            np_r = torch.clamp_min(shard_sum(pos_r.float().sum()), 1.0)
            wi = pos_i.float()[..., None].expand(n, -1, 4)
            wr = pos_r.float()[..., None].expand(n, -1, 4)
        return dict(
            loss_cls=self.l_cls(cls.reshape(-1, self.num_classes), labels.reshape(-1),
                                avg_factor=np_r),
            loss_pts_init=self.l_init(box_init / norm, tgt_i / norm, wi, avg_factor=np_i * 4),
            loss_pts_refine=self.l_refine(box_refine / norm, tgt_r / norm, wr,
                                          avg_factor=np_r * 4))

    def get_bboxes(self, outs, img_shapes, scale_factors, rescale: bool = True, cfg=None):
        """Detections of N images: dets (N, max_per_img, 5), labels, valid."""
        cls_scores, _, pts_refines = outs
        cfg = dict(cfg or self.test_cfg)
        pts = [level_points([tuple(c.shape[-2:])], [s], c.device)[0]
               for c, s in zip(cls_scores, self.point_strides)]
        levels = [(torch.sigmoid(_flatten([c], self.num_classes).float()),
                   _flatten([p], 2 * self.num_points), None)
                  for c, p in zip(cls_scores, pts_refines)]
        h, w = img_shapes[:, 0:1].float(), img_shapes[:, 1:2].float()
        hi = torch.stack([w, h, w, h], -1)                                   # (N, 1, 4)

        def decode(li, ti, p):
            pp = pts[li][ti]
            boxes = (self.points2bbox(p) * float(self.point_strides[li])
                     + torch.cat([pp, pp], -1))
            return torch.minimum(torch.maximum(boxes, boxes.new_zeros(())), hi)

        boxes, scores = top_candidates(levels, int(cfg.get("nms_pre", 1000)), decode)
        return nms_detections(boxes, scores, scale_factors, rescale, cfg, self.num_classes)


@DETECTORS.register_module()
class RepPointsDetector(SingleStageDetector):
    """``oadg_tpu/models/dense_heads/reppoints_head.py:254``."""
