"""ATSS head and detector (port of ``oadg_tpu/models/dense_heads/atss_head.py:27-200``).

One anchor a location (``AnchorGenerator`` with ``octave_base_scale`` 8),
two GN towers (``cls_convs.i``, ``reg_convs.i``), ``atss_cls``,
``atss_reg`` (deltas times the level's learned ``scales.i``, in float32) and
``atss_centerness`` on the box tower; every conv LeCun-normal with a zero
bias (ROADMAP C: mmdet starts ``atss_cls`` at a 0.01 prior).

- ``loss`` (``:108-152``): ``ATSSAssigner``; focal loss over every anchor,
  GIoU of the decoded boxes weighted by the positives' centerness targets
  (``_centerness_target``, ``:93-106``, about the anchor centre) over their
  sum, and the centerness BCE on the positives over their count; the BCE
  computes in the model's dtype, as the JAX head's does.
- ``get_bboxes`` (``:154-194``): per image and level the top ``nms_pre``
  anchors by their largest class sigmoid times the centerness sigmoid,
  decoded and clipped, then ``multiclass_nms`` (IoU 0.6 unless given).
"""
from __future__ import annotations

import torch
from torch import nn

from ...core.bbox.assign_sample import ATSSAssigner
from ...parallel import shard_sum
from ...utils.registry import (BBOX_CODERS, DETECTORS, HEADS, LOSSES, PRIOR_GENERATORS,
                               build_from_cfg, cfg_args)
from ..detectors.single_stage import SingleStageDetector
from ..layers import Conv, Scale
from .fcos_head import gn_tower, towers
from .retina_head import _flatten, gather_rows, nms_detections, top_candidates

ATSS_ANCHORS = dict(type="AnchorGenerator", octave_base_scale=8, scales_per_octave=1,
                    ratios=[1.0], strides=[8, 16, 32, 64, 128])
ATSS_CODER = dict(type="DeltaXYWHBBoxCoder", target_means=(0., 0., 0., 0.),
                  target_stds=(.1, .1, .2, .2))


def atss_assigner(train_cfg) -> ATSSAssigner:
    """The train config's ``assigner`` (``ATSSAssigner``, top 9 by
    default); another assigner type raises."""
    return ATSSAssigner(**cfg_args(dict(train_cfg or {}).get("assigner"), dict(topk=9),
                                   "ATSSAssigner"))


def centerness_target(anchors: torch.Tensor, gts: torch.Tensor) -> torch.Tensor:
    """``sqrt(max(min(l, r), 0) / max(l, r) * max(min(t, b), 0) / max(t, b))``
    of the anchor centres in their (..., K, 4) matched gts, each max floored
    at 1e-6."""
    ax = (anchors[:, 0] + anchors[:, 2]) * 0.5
    ay = (anchors[:, 1] + anchors[:, 3]) * 0.5
    l, t = ax - gts[..., 0], ay - gts[..., 1]
    r, b = gts[..., 2] - ax, gts[..., 3] - ay
    eps = gts.new_full((), 1e-6)
    lr = torch.clamp(torch.minimum(l, r), min=0) / torch.maximum(torch.maximum(l, r), eps)
    tb = torch.clamp(torch.minimum(t, b), min=0) / torch.maximum(torch.maximum(t, b), eps)
    return torch.sqrt(torch.clamp(lr * tb, 0, 1))


@HEADS.register_module()
class ATSSHead(nn.Module):

    def __init__(self, num_classes: int = 80, in_channels: int = 256,
                 feat_channels: int = 256, stacked_convs: int = 4, anchor_generator=None,
                 bbox_coder=None, loss_cls=None, loss_bbox=None, loss_centerness=None,
                 train_cfg=None, test_cfg=None, num_views: int = 1, device=None, dtype=None):
        super().__init__()
        self.num_classes = num_classes
        self.prior_generator = build_from_cfg(
            {"type": "AnchorGenerator", **dict(anchor_generator or ATSS_ANCHORS)},
            PRIOR_GENERATORS)
        self.bbox_coder = build_from_cfg({"type": "DeltaXYWHBBoxCoder",
                                          **dict(bbox_coder or ATSS_CODER)}, BBOX_CODERS)
        self.train_cfg = dict(train_cfg or {})
        self.test_cfg = dict(test_cfg or {})
        self.assigner = atss_assigner(self.train_cfg)
        self.cls_loss = build_from_cfg(dict(loss_cls or dict(
            type="FocalLoss", use_sigmoid=True, gamma=2.0, alpha=0.25, loss_weight=1.0)), LOSSES)
        self.reg_loss = build_from_cfg(dict(loss_bbox or dict(type="GIoULoss", loss_weight=2.0)),
                                       LOSSES)
        conv = dict(device=device, dtype=dtype)
        self.cls_convs = gn_tower(in_channels, feat_channels, stacked_convs, **conv)
        self.reg_convs = gn_tower(in_channels, feat_channels, stacked_convs, **conv)
        self.atss_cls = Conv(feat_channels, num_classes, 3, 1, 1, **conv)
        self.atss_reg = Conv(feat_channels, 4, 3, 1, 1, **conv)
        self.atss_centerness = Conv(feat_channels, 1, 3, 1, 1, **conv)
        self.scales = nn.ModuleList(Scale(1.0, device=device)
                                    for _ in self.prior_generator.strides)

    def init_weights(self, gen: torch.Generator):
        """The model's default (``init_default_``), as the JAX head's."""

    def forward(self, feats):
        """Per level: class logits (N, C, H, W), float32 deltas (N, 4, H, W),
        centerness logits (N, 1, H, W)."""
        cls_scores, bbox_preds, ctrs = [], [], []
        for li, x in enumerate(feats):
            c, r = towers(self, x)
            cls_scores.append(self.atss_cls(c))
            bbox_preds.append(self.scales[li](self.atss_reg(r)))
            ctrs.append(self.atss_centerness(r))
        return cls_scores, bbox_preds, ctrs

    def loss(self, outs, gt_bboxes, gt_valid, gt_labels, draws=None):
        """``loss_cls``, ``loss_bbox``, ``loss_centerness`` of N images;
        ``draws`` is unused."""
        cls_scores, bbox_preds, ctrs = outs
        n = cls_scores[0].shape[0]
        per_level = self.prior_generator.grid_priors([tuple(s.shape[-2:]) for s in cls_scores],
                                                     cls_scores[0].device)
        anchors = torch.cat(per_level)
        k = anchors.shape[0]
        cls = _flatten(cls_scores, self.num_classes)
        reg = _flatten(bbox_preds, 4).float()
        ctr = _flatten(ctrs, 1)[..., 0]
        with torch.no_grad():
            assign = self.assigner.assign(anchors, [len(a) for a in per_level], gt_bboxes,
                                          gt_valid, gt_labels)
            pos = assign.gt_inds > 0
            labels = torch.where(pos, assign.labels,
                                 torch.full_like(assign.labels, self.num_classes))
            mgt = gather_rows(gt_bboxes, (assign.gt_inds - 1).clamp(0, gt_bboxes.shape[1] - 1))
            posf = pos.float()
            ctr_t = torch.where(pos, centerness_target(anchors, mgt), posf.new_zeros(()))
            num_pos = shard_sum(pos.sum()).clamp(min=1).float()
            ctr_sum = torch.maximum(shard_sum(ctr_t.sum()), ctr_t.new_full((), 1e-6))
        loss_cls = self.cls_loss(cls.reshape(-1, self.num_classes).float(), labels.reshape(-1),
                                 torch.ones(labels.numel(), device=cls.device),
                                 avg_factor=num_pos)
        dec = self.bbox_coder.decode(anchors.expand(n, k, 4), reg)
        loss_bbox = self.reg_loss(dec.reshape(-1, 4), mgt.reshape(-1, 4), ctr_t.reshape(-1),
                                  avg_factor=ctr_sum)
        bce = (torch.maximum(ctr, ctr.new_zeros(())) - ctr * ctr_t
               + torch.log1p(torch.exp(-ctr.abs())))
        return dict(loss_cls=loss_cls, loss_bbox=loss_bbox,
                    loss_centerness=(bce * posf).sum() / num_pos)

    def get_bboxes(self, outs, img_shapes, scale_factors, rescale: bool = True, cfg=None):
        """Detections of N images: dets (N, max_per_img, 5), labels, valid."""
        cls_scores, bbox_preds, ctrs = outs
        cfg = dict(cfg or self.test_cfg)
        nms_pre = int(cfg.get("nms_pre", 1000))
        anchors = self.prior_generator.grid_priors([tuple(s.shape[-2:]) for s in cls_scores],
                                                   cls_scores[0].device)
        max_shape = (img_shapes[:, 0:1], img_shapes[:, 1:2])
        levels = [(torch.sigmoid(_flatten([c], self.num_classes).float())
                   * torch.sigmoid(_flatten([t], 1).float()), _flatten([r], 4), None)
                  for c, r, t in zip(cls_scores, bbox_preds, ctrs)]
        boxes, scores = top_candidates(levels, nms_pre, lambda li, ti, d: self.bbox_coder.decode(
            anchors[li][ti], d, max_shape=max_shape))
        return nms_detections(boxes, scores, scale_factors, rescale, cfg, self.num_classes, 0.6)


@DETECTORS.register_module()
class ATSS(SingleStageDetector):
    """``atss_head.py:198``."""
