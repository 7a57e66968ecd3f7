"""GFL head and detector (port of ``oadg_tpu/models/dense_heads/gfl_head.py:24-198``).

ATSS's anchors, assigner and GN towers; ``gfl_cls`` (C joint
class-and-quality logits) and ``gfl_reg`` (``4 * (reg_max + 1)`` bin logits
a side, times the level's ``scales.i``, in float32); every conv LeCun-normal
with a zero bias (ROADMAP C).

- ``_integral``: a side's distance is the expectation of its softmax over
  the bins ``0 .. reg_max``, in strides, about the anchor centre.
- ``loss`` (``:98-146``), per image then averaged over the images (the JAX
  head vmaps and takes the mean): QFL against (label, IoU of the decoded
  box with its gt) over the image's positives, GIoU weighted by that IoU
  over its sum, DFL of each side's bins against its distance in strides
  (clipped to ``[0, reg_max - 0.01]``) weighted by the IoU over its sum.
  The IoU keeps its gradient, as in the JAX head (mmdet detaches it).
- ``get_bboxes`` (``:148-192``): top ``nms_pre`` anchors a level by their
  largest class sigmoid, decoded, clipped to the image, ``multiclass_nms``
  (IoU 0.6 unless given).
"""
from __future__ import annotations

import torch
from torch import nn

from ...core.bbox.geometry import bbox_overlaps
from ...parallel import shard_sum
from ...utils.registry import DETECTORS, HEADS, LOSSES, PRIOR_GENERATORS, build_from_cfg
from ..detectors.single_stage import SingleStageDetector
from ..layers import Conv, Scale
from .atss_head import ATSS_ANCHORS, atss_assigner
from .fcos_head import gn_tower, towers
from .retina_head import _flatten, gather_rows, nms_detections, top_candidates


@HEADS.register_module()
class GFLHead(nn.Module):

    def __init__(self, num_classes: int = 80, in_channels: int = 256,
                 feat_channels: int = 256, stacked_convs: int = 4, reg_max: int = 16,
                 anchor_generator=None, loss_cls=None, loss_bbox=None, loss_dfl=None,
                 train_cfg=None, test_cfg=None, num_views: int = 1, device=None, dtype=None):
        super().__init__()
        self.num_classes = num_classes
        self.reg_max = reg_max
        self.prior_generator = build_from_cfg(
            {"type": "AnchorGenerator", **dict(anchor_generator or ATSS_ANCHORS)},
            PRIOR_GENERATORS)
        self.strides = tuple(s if isinstance(s, int) else s[0]
                             for s in self.prior_generator.strides)
        self.train_cfg = dict(train_cfg or {})
        self.test_cfg = dict(test_cfg or {})
        self.assigner = atss_assigner(self.train_cfg)
        self.qfl = build_from_cfg(dict(loss_cls or dict(
            type="QualityFocalLoss", beta=2.0, loss_weight=1.0)), LOSSES)
        self.giou = build_from_cfg(dict(loss_bbox or dict(type="GIoULoss", loss_weight=2.0)),
                                   LOSSES)
        self.dfl = build_from_cfg(dict(loss_dfl or dict(
            type="DistributionFocalLoss", loss_weight=0.25)), LOSSES)
        conv = dict(device=device, dtype=dtype)
        self.cls_convs = gn_tower(in_channels, feat_channels, stacked_convs, **conv)
        self.reg_convs = gn_tower(in_channels, feat_channels, stacked_convs, **conv)
        self.gfl_cls = Conv(feat_channels, num_classes, 3, 1, 1, **conv)
        self.gfl_reg = Conv(feat_channels, 4 * (reg_max + 1), 3, 1, 1, **conv)
        self.scales = nn.ModuleList(Scale(1.0, device=device) for _ in self.strides)

    def init_weights(self, gen: torch.Generator):
        """The model's default (``init_default_``), as the JAX head's."""

    def forward(self, feats):
        """Per level: class logits (N, C, H, W), float32 bin logits
        (N, 4 (reg_max + 1), H, W)."""
        cls_scores, bbox_preds = [], []
        for li, x in enumerate(feats):
            c, r = towers(self, x)
            cls_scores.append(self.gfl_cls(c))
            bbox_preds.append(self.scales[li](self.gfl_reg(r)))
        return cls_scores, bbox_preds

    def _integral(self, reg: torch.Tensor) -> torch.Tensor:
        """(..., 4 (reg_max + 1)) logits -> (..., 4) expected bins."""
        nb = self.reg_max + 1
        p = torch.softmax(reg.reshape(*reg.shape[:-1], 4, nb), dim=-1)
        return (p * torch.arange(nb, dtype=torch.float32, device=reg.device)).sum(-1)

    @staticmethod
    def _decode(centers, dists, strides):
        d = dists * strides[..., None]
        return torch.stack([centers[..., 0] - d[..., 0], centers[..., 1] - d[..., 1],
                            centers[..., 0] + d[..., 2], centers[..., 1] + d[..., 3]], -1)

    def loss(self, outs, gt_bboxes, gt_valid, gt_labels, draws=None):
        """``loss_cls`` (QFL), ``loss_bbox`` (GIoU), ``loss_dfl`` of N
        images; ``draws`` is unused."""
        cls_scores, bbox_preds = outs
        n = cls_scores[0].shape[0]
        nb = self.reg_max + 1
        per_level = self.prior_generator.grid_priors([tuple(s.shape[-2:]) for s in cls_scores],
                                                     cls_scores[0].device)
        anchors = torch.cat(per_level)
        centers = (anchors[:, :2] + anchors[:, 2:]) * 0.5
        strides = torch.cat([anchors.new_full((len(a),), float(s))
                             for a, s in zip(per_level, self.strides)])
        cls = _flatten(cls_scores, self.num_classes).float()
        reg = _flatten(bbox_preds, 4 * nb).float()
        with torch.no_grad():
            assign = self.assigner.assign(anchors, [len(a) for a in per_level], gt_bboxes,
                                          gt_valid, gt_labels)
            pos = assign.gt_inds > 0
            posf = pos.float()
            mgt = gather_rows(gt_bboxes, (assign.gt_inds - 1).clamp(0, gt_bboxes.shape[1] - 1))
            labels = torch.where(pos, assign.labels,
                                 torch.full_like(assign.labels, self.num_classes))
            tgt = torch.stack([centers[:, 0] - mgt[..., 0], centers[:, 1] - mgt[..., 1],
                               mgt[..., 2] - centers[:, 0], mgt[..., 3] - centers[:, 1]],
                              -1) / strides[:, None]
            tgt = torch.clamp(tgt, 0.0, self.reg_max - 0.01)
        dec = self._decode(centers, self._integral(reg), strides)
        score = torch.where(pos, bbox_overlaps(dec, mgt, is_aligned=True), posf.new_zeros(()))
        w = score * posf                                                     # (N, K)
        qfl = self.qfl(cls, (labels, score), torch.ones_like(posf), reduction_override="none")
        loss_qfl = qfl.sum(-1) / torch.clamp(posf.sum(-1), min=1.0)
        loss_giou = self.giou(dec, mgt, w, reduction_override="none").sum(-1) / torch.maximum(
            w.sum(-1), w.new_full((), 1e-6))
        w_dfl = w.repeat_interleave(4, dim=-1)
        dfl = self.dfl(reg.reshape(n, -1, nb), tgt.reshape(n, -1), w_dfl,
                       reduction_override="none")
        loss_dfl = dfl.sum(-1) / torch.maximum(w_dfl.sum(-1), w.new_full((), 1e-6))
        images = shard_sum(posf.new_tensor(float(n)))
        return dict(loss_cls=loss_qfl.sum() / images, loss_bbox=loss_giou.sum() / images,
                    loss_dfl=loss_dfl.sum() / images)

    def get_bboxes(self, outs, img_shapes, scale_factors, rescale: bool = True, cfg=None):
        """Detections of N images: dets (N, max_per_img, 5), labels, valid."""
        cls_scores, bbox_preds = outs
        cfg = dict(cfg or self.test_cfg)
        nms_pre = int(cfg.get("nms_pre", 1000))
        anchors = self.prior_generator.grid_priors([tuple(s.shape[-2:]) for s in cls_scores],
                                                   cls_scores[0].device)
        h, w = img_shapes[:, 0:1].float(), img_shapes[:, 1:2].float()
        hi = torch.stack([w, h, w, h], -1)                                   # (N, 1, 4)

        def decode(li, ti, bins):
            a = anchors[li][ti]
            ctr = (a[..., :2] + a[..., 2:]) * 0.5
            d = self._integral(bins) * self.strides[li]
            boxes = torch.stack([ctr[..., 0] - d[..., 0], ctr[..., 1] - d[..., 1],
                                 ctr[..., 0] + d[..., 2], ctr[..., 1] + d[..., 3]], -1)
            return torch.minimum(torch.maximum(boxes, boxes.new_zeros(())), hi)

        levels = [(torch.sigmoid(_flatten([c], self.num_classes).float()),
                   _flatten([r], 4 * (self.reg_max + 1)).float(), None)
                  for c, r in zip(cls_scores, bbox_preds)]
        boxes, scores = top_candidates(levels, nms_pre, decode)
        return nms_detections(boxes, scores, scale_factors, rescale, cfg, self.num_classes, 0.6)


@DETECTORS.register_module()
class GFL(SingleStageDetector):
    """``gfl_head.py:196``."""
