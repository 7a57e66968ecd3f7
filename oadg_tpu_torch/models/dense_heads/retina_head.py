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
        self.cls_convs = nn.ModuleList(
            ConvModule(in_channels if i == 0 else feat_channels, feat_channels, 3, 1, 1, **conv)
            for i in range(stacked_convs))
        self.reg_convs = nn.ModuleList(
            ConvModule(in_channels if i == 0 else feat_channels, feat_channels, 3, 1, 1, **conv)
            for i in range(stacked_convs))
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
            c = r = x
            for conv in self.cls_convs:
                c = F.relu(conv(c))
            for conv in self.reg_convs:
                r = F.relu(conv(r))
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
        n = cls_scores[0].shape[0]
        dev = cls_scores[0].device
        anchors = self.prior_generator.grid_priors(
            [tuple(s.shape[-2:]) for s in cls_scores], dev)
        max_shape = (img_shapes[:, 0:1], img_shapes[:, 1:2])
        boxes_l, scores_l = [], []
        for sc, dl, anch in zip(cls_scores, bbox_preds, anchors):
            sc = torch.sigmoid(sc.permute(0, 2, 3, 1).reshape(n, -1, self.num_classes).float())
            dl = dl.permute(0, 2, 3, 1).reshape(n, -1, 4)
            top = min(nms_pre, sc.shape[1])
            _, ti = sort_desc(sc.max(dim=-1).values, top)
            boxes_l.append(self.bbox_coder.decode(
                anch[ti], torch.gather(dl, 1, ti[..., None].expand(n, top, 4)),
                max_shape=max_shape))
            scores_l.append(torch.gather(sc, 1, ti[..., None].expand(n, top, self.num_classes)))
        boxes = torch.cat(boxes_l, 1)
        scores = torch.cat(scores_l, 1)
        if rescale:
            boxes = boxes / scale_factors.float()[:, None, :4]
        scores = F.pad(scores, (0, 1))                                # background column
        return multiclass_nms(boxes, scores, float(cfg.get("score_thr", 0.05)),
                              float(dict(cfg.get("nms", {})).get("iou_threshold", 0.5)),
                              int(cfg.get("max_per_img", 100)), self.num_classes)
