"""RetinaNet head (port of ``oadg_tpu/models/dense_heads/retina_head.py:25-160``).

Per level a tower of ``stacked_convs`` 3x3 ``ConvModule``s with ReLU for the
classes (``cls_convs.i``) and one for the boxes (``reg_convs.i``), then
``retina_cls`` (``A * C`` sigmoid logits) and ``retina_reg`` (``A * 4``
deltas); every conv Normal(0.01), ``retina_cls``'s bias at a prior of 0.01
(``bias_prob``). Maps stay NCHW; the loss and ``get_bboxes`` flatten them
location-major with the anchors innermost (``AnchorGenerator`` with
RetinaNet's octave scales).

- ``loss`` (``:97-126``): every anchor of every level is assigned by
  ``MaxIoUAssigner`` with the gt labels and none is sampled (mmdet's
  ``PseudoSampler``): the focal loss over the positives' and negatives'
  rows (background label ``C``, an all-zero one-hot row) and the L1 loss
  of the positives' encoded deltas, both over ``max(positives, 1)`` of the
  whole batch (of every rank under data parallel, as the box head's rows
  are);
- ``get_bboxes`` (``:128-160``): per image and level the top ``nms_pre``
  anchors by their largest class sigmoid (ties to the lower index, as
  ``jax.lax.top_k``), decoded and clipped, divided by the scale factor,
  then ``multiclass_nms`` over every level's candidates at once (5 x 1000 x
  80 = 400,000 at the config's; the tiled NMS runs only the tiles above
  ``score_thr``).

The convs compute in ``dtype``; the loss and the scores take the logits
cast to float32 and the deltas are decoded in float32.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ...core.bbox.assign_sample import MaxIoUAssigner
from ...core.post_processing.nms import multiclass_nms, sort_desc
from ...parallel import shard_sum
from ...utils.registry import (BBOX_CODERS, HEADS, LOSSES, PRIOR_GENERATORS,
                               build_from_cfg, cfg_args)
from ..layers import Conv, ConvModule, normal_


def _flatten(maps, attrib: int) -> torch.Tensor:
    """Per level (N, A * attrib, H, W) -> all levels (N, sum H W A, attrib)."""
    n = maps[0].shape[0]
    return torch.cat([m.permute(0, 2, 3, 1).reshape(n, -1, attrib) for m in maps], dim=1)


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x`` (N, K, ...) rows picked by ``idx`` (N, k) -> (N, k, ...)."""
    return torch.gather(x, 1, idx.reshape(*idx.shape, *([1] * (x.dim() - 2))).expand(
        *idx.shape, *x.shape[2:]))


def top_indices(x: torch.Tensor, nms_pre: int) -> torch.Tensor:
    """Indices of the top ``min(nms_pre, K)`` of (N, K) ``x``, descending,
    ties to the lower index (``jax.lax.top_k``)."""
    return sort_desc(x, min(nms_pre, x.shape[-1]))[1]


def top_candidates(levels, nms_pre: int, decode):
    """Per level ``(scores, regs, rank)``: (N, K, C) class scores, (N, K,
    R) box regressions and an (N, K) ranking (``None``: the largest class
    score) -> the top ``nms_pre`` points of each level by rank
    (``top_indices``), their boxes ``decode(level, indices, their regs)``
    (N, k, 4) and their scores, concatenated over the levels: (N, M, 4),
    (N, M, C)."""
    boxes, scores = [], []
    for li, (sc, reg, rank) in enumerate(levels):
        ti = top_indices(sc.amax(-1) if rank is None else rank, nms_pre)
        boxes.append(decode(li, ti, gather_rows(reg, ti)))
        scores.append(gather_rows(sc, ti))
    return torch.cat(boxes, 1), torch.cat(scores, 1)


def nms_detections(boxes, scores, scale_factors, rescale, cfg, num_classes,
                   default_iou: float = 0.5):
    """A dense head's concatenated per-level candidates (N, M, 4) and (N, M,
    C) -> boxes divided by the scale factors (``rescale``), a zero
    background column, ``multiclass_nms`` with the test config's
    ``score_thr`` (0.05), ``nms.iou_threshold`` (``default_iou``) and
    ``max_per_img`` (100): dets, labels, valid."""
    if rescale:
        boxes = boxes / scale_factors.float()[:, None, :4]
    scores = F.pad(scores, (0, 1))                                     # background column
    return multiclass_nms(boxes, scores, float(cfg.get("score_thr", 0.05)),
                          float(dict(cfg.get("nms", {})).get("iou_threshold", default_iou)),
                          int(cfg.get("max_per_img", 100)), num_classes)


def plain_tower(in_channels: int, feat_channels: int, stacked_convs: int, **conv):
    """``stacked_convs`` plain 3x3 convs with a bias (``ConvModule`` without
    a norm; a ReLU after each in ``run_towers``)."""
    return nn.ModuleList(ConvModule(in_channels if i == 0 else feat_channels, feat_channels,
                                    3, 1, 1, **conv) for i in range(stacked_convs))


def run_towers(head: nn.Module, x: torch.Tensor):
    """``head.cls_convs`` and ``head.reg_convs``, each conv followed by a
    ReLU, on one level's ``x`` -> (class features, box features)."""
    c = r = x
    for conv in head.cls_convs:
        c = F.relu(conv(c))
    for conv in head.reg_convs:
        r = F.relu(conv(r))
    return c, r


@HEADS.register_module()
class RetinaHead(nn.Module):

    def __init__(self, num_classes: int = 80, in_channels: int = 256,
                 feat_channels: int = 256, stacked_convs: int = 4,
                 anchor_generator=None, bbox_coder=None, loss_cls=None,
                 loss_bbox=None, train_cfg=None, test_cfg=None, num_views: int = 1,
                 device=None, dtype=None):
        super().__init__()
        self.num_classes = num_classes
        self.prior_generator = build_from_cfg(dict(anchor_generator or dict(
            type="AnchorGenerator", octave_base_scale=4, scales_per_octave=3,
            ratios=[0.5, 1.0, 2.0], strides=[8, 16, 32, 64, 128])), PRIOR_GENERATORS)
        self.bbox_coder = build_from_cfg(dict(bbox_coder or dict(
            type="DeltaXYWHBBoxCoder", target_means=(0., 0., 0., 0.),
            target_stds=(1., 1., 1., 1.))), BBOX_CODERS)
        self.loss_cls_cfg = dict(loss_cls or dict(type="FocalLoss", use_sigmoid=True,
                                                  gamma=2.0, alpha=0.25))
        self.loss_bbox_cfg = dict(loss_bbox or dict(type="L1Loss"))
        self.train_cfg = dict(train_cfg or {})
        self.test_cfg = dict(test_cfg or {})
        self.assigner = MaxIoUAssigner(**cfg_args(
            self.train_cfg.get("assigner"),
            dict(pos_iou_thr=0.5, neg_iou_thr=0.4, min_pos_iou=0), "MaxIoUAssigner"))
        sampler = self.train_cfg.get("sampler")
        if sampler is not None:
            cfg_args(sampler, {}, "PseudoSampler")
        na = self.prior_generator.num_base_anchors[0]
        conv = dict(device=device, dtype=dtype)
        self.cls_convs = plain_tower(in_channels, feat_channels, stacked_convs, **conv)
        self.reg_convs = plain_tower(in_channels, feat_channels, stacked_convs, **conv)
        self.retina_cls = Conv(feat_channels, na * num_classes, 3, 1, 1, **conv)
        self.retina_reg = Conv(feat_channels, na * 4, 3, 1, 1, **conv)

    def init_weights(self, gen: torch.Generator):
        """Normal(0.01) convs with zero biases; ``retina_cls``'s bias
        ``-log((1 - 0.01) / 0.01)`` (mmdet's ``bias_prob=0.01``)."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                normal_(m.weight, 0.01, gen)
                nn.init.zeros_(m.bias)
        nn.init.constant_(self.retina_cls.bias, -math.log((1 - 0.01) / 0.01))

    def forward(self, feats):
        """Per level: class logits (N, A * C, H, W), deltas (N, A * 4, H, W)."""
        cls_scores, bbox_preds = [], []
        for x in feats:
            c, r = run_towers(self, x)
            cls_scores.append(self.retina_cls(c))
            bbox_preds.append(self.retina_reg(r))
        return cls_scores, bbox_preds

    def loss(self, outs, gt_bboxes, gt_valid, gt_labels, draws=None):
        """``loss_cls`` (focal) and ``loss_bbox`` (L1) of N images; ``draws``
        is unused (nothing is sampled)."""
        cls_scores, bbox_preds = outs
        n = cls_scores[0].shape[0]
        dev = cls_scores[0].device
        anchors = self.prior_generator.grid_priors_cat(
            [tuple(s.shape[-2:]) for s in cls_scores], dev)          # (K, 4)
        k = anchors.shape[0]
        cls = _flatten(cls_scores, self.num_classes)
        reg = _flatten(bbox_preds, 4)
        with torch.no_grad():
            assign = self.assigner.assign(anchors, gt_bboxes, gt_valid,
                                          gt_labels=gt_labels)         # (N, K)
            pos = assign.gt_inds > 0
            neg = assign.gt_inds == 0
            labels = torch.where(pos, assign.labels, torch.full_like(assign.labels,
                                                                     self.num_classes))
            matched = (assign.gt_inds - 1).clamp(0, gt_bboxes.shape[1] - 1)
            matched_gt = torch.gather(gt_bboxes, 1, matched[..., None].expand(n, k, 4))
            deltas = self.bbox_coder.encode(anchors.expand(n, k, 4), matched_gt)
            num_pos = shard_sum(pos.sum()).clamp(min=1).float()
            label_w = (pos | neg).float()
            bbox_w = pos.float()[..., None].expand(n, k, 4)
        loss_cls = build_from_cfg(self.loss_cls_cfg, LOSSES)
        loss_bbox = build_from_cfg(self.loss_bbox_cfg, LOSSES)
        return dict(
            loss_cls=loss_cls(cls.reshape(-1, self.num_classes).float(), labels.reshape(-1),
                              label_w.reshape(-1), avg_factor=num_pos),
            loss_bbox=loss_bbox(reg.float(), deltas, bbox_w, avg_factor=num_pos))

    def get_bboxes(self, outs, img_shapes, scale_factors, rescale: bool = True,
                   cfg=None):
        """Detections of N images: dets (N, max_per_img, 5), labels
        (N, max_per_img) (-1 where invalid) and valid (N, max_per_img)."""
        cls_scores, bbox_preds = outs
        cfg = dict(cfg or self.test_cfg)
        nms_pre = int(cfg.get("nms_pre", 1000))
        anchors = self.prior_generator.grid_priors(
            [tuple(s.shape[-2:]) for s in cls_scores], cls_scores[0].device)
        max_shape = (img_shapes[:, 0:1], img_shapes[:, 1:2])
        levels = [(torch.sigmoid(_flatten([sc], self.num_classes).float()), _flatten([dl], 4),
                   None) for sc, dl in zip(cls_scores, bbox_preds)]
        boxes, scores = top_candidates(levels, nms_pre, lambda li, ti, d: self.bbox_coder.decode(
            anchors[li][ti], d, max_shape=max_shape))
        return nms_detections(boxes, scores, scale_factors, rescale, cfg, self.num_classes)
