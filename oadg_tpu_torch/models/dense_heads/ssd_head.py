"""SSD head and detector (port of ``oadg_tpu/models/dense_heads/ssd_head.py``).

Per level of SSDVGG's six maps a 3x3 ``cls_convs.{i}`` (``A * (C + 1)``
softmax logits, background last) and ``reg_convs.{i}`` (``A * 4`` deltas)
over ``SSDAnchorGenerator``'s 4 / 6 / 6 / 6 / 4 / 4 anchors a cell (8,732
at 300x300); mmdet's names.

- ``loss`` (``:70-110``): ``MaxIoUAssigner`` (0.5 / 0.5, the config's
  ``gt_max_assign_all=False``) over every anchor; per image the CE of the
  positives and of the ``int(neg_pos_ratio * positives)`` negatives of the
  largest CE (ranked by a stable descending sort: ties to the lower index,
  as the JAX ``argsort``), SmoothL1 (``smoothl1_beta``) of the positives'
  encoded deltas; both summed over the batch and divided by its positives
  (every rank's under data parallel).
- ``get_bboxes`` (``:112-140``): the softmax's class columns, every anchor
  decoded and clipped, divided by the scale factor, ``multiclass_nms``
  (``score_thr`` 0.02, IoU 0.45, 200 a image unless the config says).
"""
from __future__ import annotations

import torch
from torch import nn

from ...core.bbox.assign_sample import MaxIoUAssigner
from ...core.post_processing.nms import sort_desc
from ...parallel import shard_sum
from ...utils.registry import (BBOX_CODERS, DETECTORS, HEADS, PRIOR_GENERATORS,
                               build_from_cfg, cfg_args)
from ..detectors.single_stage import SingleStageDetector
from ..layers import Conv, widen
from ..losses.common import smooth_l1
from .retina_head import _flatten, nms_detections


@HEADS.register_module()
class SSDHead(nn.Module):

    def __init__(self, num_classes: int = 80, in_channels=(512, 1024, 512, 256, 256, 256),
                 anchor_generator=None, bbox_coder=None, train_cfg=None, test_cfg=None,
                 num_views: int = 1, device=None, dtype=None):
        super().__init__()
        self.num_classes = num_classes
        self.prior_generator = build_from_cfg(dict(anchor_generator or dict(
            type="SSDAnchorGenerator", input_size=300, basesize_ratio_range=(0.15, 0.9),
            strides=[8, 16, 32, 64, 100, 300],
            ratios=[[2], [2, 3], [2, 3], [2, 3], [2], [2]])), PRIOR_GENERATORS)
        self.bbox_coder = build_from_cfg(dict(bbox_coder or dict(
            type="DeltaXYWHBBoxCoder", target_means=(0., 0., 0., 0.),
            target_stds=(.1, .1, .2, .2))), BBOX_CODERS)
        tc = dict(train_cfg or {})
        self.test_cfg = dict(test_cfg or {})
        self.assigner = MaxIoUAssigner(**cfg_args(tc.get("assigner"), dict(
            pos_iou_thr=0.5, neg_iou_thr=0.5, min_pos_iou=0.0, gt_max_assign_all=False),
            "MaxIoUAssigner"))
        self.neg_pos_ratio = float(tc.get("neg_pos_ratio", 3))
        self.smoothl1_beta = float(tc.get("smoothl1_beta", 1.0))
        nb = self.prior_generator.num_base_anchors
        kw = dict(device=device, dtype=dtype)
        self.cls_convs = nn.ModuleList(Conv(c, a * (num_classes + 1), 3, 1, 1, **kw)
                                       for c, a in zip(in_channels, nb))
        self.reg_convs = nn.ModuleList(Conv(c, a * 4, 3, 1, 1, **kw)
                                       for c, a in zip(in_channels, nb))

    def init_weights(self, gen: torch.Generator):
        """The model's default (``init_default_``), as the JAX head's."""

    def forward(self, feats):
        """Per level: logits (N, A * (C + 1), H, W), deltas (N, A * 4, H, W)."""
        return ([conv(x) for conv, x in zip(self.cls_convs, feats)],
                [conv(x) for conv, x in zip(self.reg_convs, feats)])

    def _flat(self, outs):
        cls_scores, bbox_preds = outs
        anchors = self.prior_generator.grid_priors_cat(
            [tuple(s.shape[-2:]) for s in cls_scores], cls_scores[0].device)
        return (anchors, widen(_flatten(cls_scores, self.num_classes + 1)),
                widen(_flatten(bbox_preds, 4)))

    def hard_negatives(self, ce: torch.Tensor, pos: torch.Tensor, neg: torch.Tensor):
        """(N, K) CE, positives and negatives -> the negatives among the
        ``int(neg_pos_ratio * positives)`` of each image's largest CE."""
        k = torch.minimum((self.neg_pos_ratio * pos.sum(-1)).long(), neg.sum(-1))
        order = sort_desc(torch.where(neg, ce, torch.full_like(ce, -1.0)))[1]
        rank = torch.empty_like(order).scatter_(
            -1, order, torch.arange(order.shape[-1], device=ce.device).expand_as(order))
        return neg & (rank < k[:, None])

    def loss(self, outs, gt_bboxes, gt_valid, gt_labels, draws=None):
        """``loss_cls`` and ``loss_bbox``; ``draws`` is unused."""
        anchors, cls, reg = self._flat(outs)
        n, k = reg.shape[:2]
        with torch.no_grad():
            assign = self.assigner.assign(anchors, gt_bboxes, gt_valid, gt_labels=gt_labels)
            pos = assign.gt_inds > 0
            neg = assign.gt_inds == 0
            labels = torch.where(pos, assign.labels, torch.full_like(assign.labels,
                                                                     self.num_classes))
            matched = (assign.gt_inds - 1).clamp(0, gt_bboxes.shape[1] - 1)
            deltas = self.bbox_coder.encode(anchors.expand(n, k, 4), torch.gather(
                gt_bboxes, 1, matched[..., None].expand(n, k, 4)))
        ce = -torch.gather(torch.log_softmax(cls, -1), -1, labels[..., None])[..., 0]
        with torch.no_grad():
            cls_w = (pos | self.hard_negatives(ce, pos, neg)).float()
            total = torch.clamp_min(shard_sum(pos.sum()).float(), 1.0)
        loss_bbox = (smooth_l1(reg, deltas, self.smoothl1_beta) * pos[..., None]).sum()
        return dict(loss_cls=(ce * cls_w).sum() / total, loss_bbox=loss_bbox / total)

    def get_bboxes(self, outs, img_shapes, scale_factors, rescale: bool = True, cfg=None):
        """Detections of N images: dets (N, max_per_img, 5), labels, valid."""
        cfg = {"score_thr": 0.02, "max_per_img": 200, **dict(cfg or self.test_cfg)}
        anchors, cls, reg = self._flat(outs)
        scores = torch.softmax(cls, -1)[..., :self.num_classes]
        boxes = self.bbox_coder.decode(anchors, reg,
                                       max_shape=(img_shapes[:, 0:1], img_shapes[:, 1:2]))
        return nms_detections(boxes, scores, scale_factors, rescale, cfg, self.num_classes,
                              default_iou=0.45)


@DETECTORS.register_module()
class SSD(SingleStageDetector):
    """``oadg_tpu/models/dense_heads/ssd_head.py:146``."""
