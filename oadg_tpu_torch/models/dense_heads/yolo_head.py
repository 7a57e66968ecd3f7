"""YOLOv3 head and its OA-DG contrastive variant (port of
``oadg_tpu/models/dense_heads/yolo_head.py:73-388``).

``YOLOV3Head``: per level a 3x3 ``ConvModule`` bridge with BN and
LeakyReLU(0.1) (``convs_bridge.{i}``) and a 1x1 prediction conv
(``convs_pred.{i}``, Normal(0.01) init) of ``A * (5 + C)`` channels: per
prior x, y, w, h, the objectness and C class logits. Maps stay NCHW; the
loss and ``get_bboxes`` flatten them location-major with the priors
innermost, the order of ``YOLOAnchorGenerator.grid_priors``.

- ``loss`` (``:140-213``): ``GridAssigner`` targets per image (encoded by
  ``YOLOBBoxCoder``, one-hot classes), then the sigmoid cross entropy of
  the classes and the x, y offsets on the positives, of the objectness on
  positives and negatives (``pos_and_neg`` clamped to [0, 1]), and the MSE
  of w, h on the positives, each with the config's reduction, in float32;
- ``get_bboxes`` (``:220-269``): per image and level the top ``nms_pre``
  priors by objectness (ties to the lower index, as ``jax.lax.top_k``),
  scores ``sigmoid(cls) * objectness``, zeroed where the objectness is not
  above ``conf_thr``, boxes divided by the scale factor, then
  ``multiclass_nms``.

``YOLOV3HeadCont`` (``:272-388``) adds per level a 3x3 ``ConvModule`` of
``cont_cfg['dim']`` channels on the neck's output. The port names it
``convs_cont.{i}``: no published checkpoint fixes that name. On a
views-major batch of V > 1 views its loss takes the supervised terms on
view 1 only (``:316-321``), and adds

- ``loss_csconf``: ``jsd_conf_weight`` x the JSD across views of the
  objectness logits (sigmoid pairs), batchmean over the b images a view;
- ``loss_cscls``: ``jsd_cls_weight`` x the JSD of the class logits, each
  row's multiplied by its own positive mask unless ``wo_pos``;
- ``loss_cont``: ``cont_cfg['loss_weight']`` x ``supcontrast`` at
  ``cont_cfg['temperature']`` over ``max_cont_anchors`` rows an image and
  view (the cont map of each prior's cell), the positives first and the
  rest by ``rank = (not pos) + 0.1 u``, one set of rows for all views, so
  that row i of one view pairs with row i of another (layout
  ``(max_cont_anchors * b, V, 0)``). ``u`` comes from the step's
  ``UniformDraws`` as ``"cont"``, shape (b, priors).

Under data parallel (``parallel/dist.py``) each rank returns its share of
the global batch's losses: the JSD terms divide by every rank's images,
a ``mean`` reduction by every rank's weights (``_share``; the configs' are
sums), the cont rows are gathered from every rank (``supcontrast``), and
the live BNs compute the global batch's statistics (``layers.BatchNorm``).
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ...core.bbox.assign_sample import GridAssigner
from ...core.post_processing.nms import multiclass_nms, sort_desc
from ...parallel import batch_is_sharded, shard_sum
from ...utils.registry import (BBOX_CODERS, HEADS, LOSSES, PRIOR_GENERATORS,
                               build_from_cfg, cfg_args)
from ..layers import Conv, ConvModule, normal_, widen
from ..losses.oadg import jsd_consistency, supcontrast

_BASE_SIZES = [[(116, 90), (156, 198), (373, 326)], [(30, 61), (62, 45), (59, 119)],
               [(10, 13), (16, 30), (33, 23)]]


def _flatten(maps: Sequence[torch.Tensor], attrib: int) -> torch.Tensor:
    """Per level (N, A * attrib, H, W) -> all levels (N, sum H W A, attrib)."""
    n = maps[0].shape[0]
    return torch.cat([m.permute(0, 2, 3, 1).reshape(n, -1, attrib) for m in maps], dim=1)


def _share(loss_fn, pred, target, weight):
    """``loss_fn(pred, target, weight=weight)``. On a rank's shard of the
    global batch a ``mean`` reduction divides by the weight summed over
    every rank (a ``sum`` needs nothing: the ranks' sums add up to the
    global one)."""
    if getattr(loss_fn, "reduction", "mean") == "mean" and batch_is_sharded():
        return loss_fn(pred, target, weight=weight,
                       avg_factor=torch.clamp_min(shard_sum(weight.sum()), 1e-12))
    return loss_fn(pred, target, weight=weight)


@HEADS.register_module()
class YOLOV3Head(nn.Module):

    def __init__(self, num_classes: int = 80, in_channels: Sequence[int] = (512, 256, 128),
                 out_channels: Sequence[int] = (1024, 512, 256), anchor_generator=None,
                 bbox_coder=None, featmap_strides: Sequence[int] = (32, 16, 8),
                 one_hot_smoother: float = 0.0, loss_cls=None, loss_conf=None,
                 loss_xy=None, loss_wh=None, train_cfg=None, test_cfg=None,
                 num_views: int = 1, norm_cfg=None, act_cfg=None, init_cfg=None,
                 device=None, dtype=None):
        super().__init__()
        self.num_classes = num_classes
        self.in_channels = list(in_channels)
        self.featmap_strides = list(featmap_strides)
        self.one_hot_smoother = float(one_hot_smoother)
        self.num_views = num_views
        self.test_cfg = dict(test_cfg or {})
        self.prior_generator = build_from_cfg(
            dict(anchor_generator or dict(base_sizes=_BASE_SIZES, strides=[32, 16, 8]),
                 type="YOLOAnchorGenerator"), PRIOR_GENERATORS)
        self.bbox_coder = build_from_cfg(dict(bbox_coder or {}, type="YOLOBBoxCoder"),
                                         BBOX_CODERS)
        sig = dict(type="CrossEntropyLoss", use_sigmoid=True, loss_weight=1.0)
        self.loss_cls = build_from_cfg(dict(loss_cls or sig), LOSSES)
        self.loss_conf = build_from_cfg(dict(loss_conf or sig), LOSSES)
        self.loss_xy = build_from_cfg(dict(loss_xy or dict(sig, loss_weight=2.0,
                                                           reduction="sum")), LOSSES)
        self.loss_wh = build_from_cfg(dict(loss_wh or dict(type="MSELoss", loss_weight=2.0,
                                                           reduction="sum")), LOSSES)
        self.assigner = GridAssigner(**cfg_args(
            dict(train_cfg or {}).get("assigner"),
            dict(pos_iou_thr=0.5, neg_iou_thr=0.5, min_pos_iou=0.0), "GridAssigner"))
        self.norm_cfg = dict(norm_cfg or dict(type="BN"))
        na = self.prior_generator.num_base_priors[0]
        kw = dict(device=device, dtype=dtype)
        self.convs_bridge = nn.ModuleList(
            ConvModule(cin, cout, 3, 1, 1, norm_cfg=self.norm_cfg, act="leaky_relu", **kw)
            for cin, cout in zip(in_channels, out_channels))
        self.convs_pred = nn.ModuleList(Conv(cout, na * self.num_attrib, 1, **kw)
                                        for cout in out_channels)

    @property
    def num_attrib(self) -> int:
        return 5 + self.num_classes

    def init_weights(self, gen: torch.Generator):
        """Normal(std=0.01) prediction convs with zero biases (mmdet's
        ``init_cfg``); the ``ConvModule``s keep the model's default."""
        for conv in self.convs_pred:
            normal_(conv.weight, 0.01, gen)
            nn.init.zeros_(conv.bias)

    def forward(self, feats):
        """-> ``(maps,)``: per level (N, A * (5 + C), H, W)."""
        return ([pred(bridge(x)) for x, bridge, pred
                 in zip(feats, self.convs_bridge, self.convs_pred)],)

    # ---------------- targets and loss ----------------

    def _priors(self, maps):
        """All levels' priors (K, 4) and their strides (K,)."""
        sizes = [tuple(m.shape[-2:]) for m in maps]
        priors = self.prior_generator.grid_priors(sizes, device=maps[0].device)
        strides = torch.cat([torch.full((len(p),), float(s), device=maps[0].device)
                             for p, s in zip(priors, self.featmap_strides)])
        return torch.cat(priors), strides

    def get_targets(self, maps, gt_bboxes, gt_valid, gt_labels):
        """-> targets (N, K, 5 + C) (encoded box, 1, one-hot classes on the
        positives; zeros elsewhere) and negatives (N, K) bool."""
        priors, strides = self._priors(maps)
        pos, of, neg = self.assigner.assign(priors, strides, gt_bboxes, gt_valid)
        matched = torch.gather(gt_bboxes, 1, of[..., None].expand(*of.shape, 4))
        deltas = self.bbox_coder.encode(priors, matched, strides)
        labels = torch.gather(gt_labels.long(), 1, of)
        onehot = torch.zeros(*of.shape, self.num_classes, device=of.device)
        onehot.scatter_(-1, labels.clamp(0, self.num_classes - 1)[..., None], 1.0)
        onehot = onehot * ((labels >= 0) & (labels < self.num_classes))[..., None]
        if self.one_hot_smoother:
            onehot = (onehot * (1 - self.one_hot_smoother)
                      + self.one_hot_smoother / self.num_classes)
        target = torch.cat([deltas, pos[..., None].float(), onehot], dim=-1)
        return torch.where(pos[..., None], target, torch.zeros_like(target)), neg

    def loss(self, outs, gt_bboxes, gt_valid, gt_labels, draws=None):
        """The four supervised terms of ``outs`` (``(maps,)``) against the
        batch's gts, in float32 (float64 for a float64 model); under data
        parallel this rank's share of the global batch's (``_share``)."""
        maps = outs[0]
        target, neg = self.get_targets(maps, gt_bboxes, gt_valid, gt_labels)
        pred = widen(_flatten(maps, self.num_attrib))
        pos = target[..., 4]
        pos_and_neg = (pos + neg.float()).clamp(0, 1)
        w = pos[..., None]
        return dict(
            loss_cls=_share(self.loss_cls, pred[..., 5:], target[..., 5:], w),
            loss_conf=_share(self.loss_conf, pred[..., 4], target[..., 4], pos_and_neg),
            loss_xy=_share(self.loss_xy, pred[..., :2], target[..., :2], w),
            loss_wh=_share(self.loss_wh, pred[..., 2:4], target[..., 2:4], w))

    # ---------------- inference ----------------

    def get_bboxes(self, outs, img_shapes, scale_factors, rescale: bool = True, cfg=None):
        """-> dets (N, max_per_img, 5), labels (N, max_per_img), valid."""
        maps = outs[0]
        cfg = dict(cfg or self.test_cfg)
        nms_pre = int(cfg.get("nms_pre", 1000))
        conf_thr = float(cfg.get("conf_thr", 0.005))
        score_thr = float(cfg.get("score_thr", 0.05))
        iou_thr = float(dict(cfg.get("nms") or {}).get("iou_threshold", 0.45))
        max_per_img = int(cfg.get("max_per_img", 100))
        n = maps[0].shape[0]
        priors = self.prior_generator.grid_priors([tuple(m.shape[-2:]) for m in maps],
                                                  device=maps[0].device)
        boxes, scores, valid = [], [], []
        for m, anchors, stride in zip(maps, priors, self.featmap_strides):
            p = m.permute(0, 2, 3, 1).reshape(n, -1, self.num_attrib).float()
            conf = torch.sigmoid(p[..., 4])
            decoded = self.bbox_coder.decode(
                anchors, torch.cat([torch.sigmoid(p[..., :2]), p[..., 2:4]], -1),
                torch.full(p.shape[:2], float(stride), device=p.device))
            top_conf, ti = sort_desc(conf, min(nms_pre, p.shape[1]))
            boxes.append(torch.gather(decoded, 1, ti[..., None].expand(*ti.shape, 4)))
            cls = torch.gather(torch.sigmoid(p[..., 5:]), 1,
                               ti[..., None].expand(*ti.shape, self.num_classes))
            scores.append(cls * top_conf[..., None])
            valid.append(top_conf > conf_thr)
        boxes, scores, valid = (torch.cat(x, 1) for x in (boxes, scores, valid))
        if rescale:
            boxes = boxes / scale_factors.float().reshape(n, -1)[:, None, :4]
        scores = torch.where(valid[..., None], scores, torch.zeros_like(scores))
        scores = torch.cat([scores, scores.new_zeros(*scores.shape[:2], 1)], -1)
        return multiclass_nms(boxes, scores, score_thr, iou_thr, max_per_img,
                              self.num_classes)


@HEADS.register_module()
class YOLOV3HeadCont(YOLOV3Head):

    def __init__(self, cont_feat_channels: int = 256, jsd_conf_weight: float = 1.0,
                 jsd_cls_weight: float = 1.0, cont_loss_weight: float = 0.1,
                 temperature: float = 0.07, max_cont_anchors: int = 512,
                 wo_pos: bool = False, cont_cfg=None, **kwargs):
        super().__init__(**kwargs)
        cc = dict(cont_cfg or {})
        self.cont_w = float(cc.get("loss_weight", cont_loss_weight))
        self.cont_dim = int(cc.get("dim", cont_feat_channels))
        self.cont_temper = float(cc.get("temperature", temperature))
        self.jsd_conf_weight = float(jsd_conf_weight)
        self.jsd_cls_weight = float(jsd_cls_weight)
        self.max_cont_anchors = int(max_cont_anchors)
        self.wo_pos = bool(wo_pos)
        self.convs_cont = nn.ModuleList(
            ConvModule(cin, self.cont_dim, 3, 1, 1, norm_cfg=self.norm_cfg, act="leaky_relu",
                       device=kwargs.get("device"), dtype=kwargs.get("dtype"))
            for cin in self.in_channels)

    def forward(self, feats):
        """-> ``(maps, conts)``: per level the prediction maps and the
        (N, dim, H, W) cont maps."""
        (maps,) = super().forward(feats)
        return maps, [conv(x) for x, conv in zip(feats, self.convs_cont)]

    def loss(self, outs, gt_bboxes, gt_valid, gt_labels, draws=None):
        maps, conts = outs
        n = maps[0].shape[0]
        v = self.num_views
        b = n // max(v, 1)
        if v == 1:
            return super().loss((maps,), gt_bboxes, gt_valid, gt_labels)
        losses = super().loss(([m[:b] for m in maps],), gt_bboxes[:b], gt_valid[:b],
                              gt_labels[:b])
        images = float(b)
        if batch_is_sharded():                      # a view's images, every rank's
            images = shard_sum(torch.full((), images, device=maps[0].device))
        pred = widen(_flatten(maps, self.num_attrib))
        target, _ = self.get_targets(maps, gt_bboxes, gt_valid, gt_labels)
        if self.jsd_conf_weight:
            losses["loss_csconf"] = self.jsd_conf_weight * jsd_consistency(
                pred[..., 4:5], v, images)
        if self.jsd_cls_weight:
            cls = pred[..., 5:] if self.wo_pos else pred[..., 5:] * target[..., 4:5]
            losses["loss_cscls"] = self.jsd_cls_weight * jsd_consistency(cls, v, images)
        if self.cont_w and draws is not None:
            reps = self.prior_generator.num_base_priors
            cont = torch.cat([c.permute(0, 2, 3, 1).reshape(n, -1, self.cont_dim)
                              .repeat_interleave(r, dim=1) for c, r in zip(conts, reps)], 1)
            pos = target[..., 4] > 0                                       # (N, K)
            m = self.max_cont_anchors
            u = draws("cont", pos[:b].shape, pos.device)
            rank = torch.where(pos[:b], 0.0, 1.0) + u * 0.1
            sel = torch.argsort(rank, dim=1, stable=True)[:, :m]           # (b, m)
            labels = torch.where(pos, target[..., 5:].argmax(-1),
                                 torch.full_like(pos, self.num_classes, dtype=torch.long))
            feats = widen(torch.cat([torch.gather(cont[i * b:(i + 1) * b], 1,
                                            sel[..., None].expand(*sel.shape, self.cont_dim))
                               .reshape(-1, self.cont_dim) for i in range(v)]))
            lab = torch.cat([torch.gather(labels[i * b:(i + 1) * b], 1, sel).reshape(-1)
                             for i in range(v)])
            losses["loss_cont"] = self.cont_w * supcontrast(
                feats, lab, torch.ones_like(lab, dtype=torch.bool), (m * b, v, 0),
                temper=self.cont_temper)
        return losses
