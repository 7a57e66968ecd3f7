"""YOLOF head and detector (port of ``oadg_tpu/models/dense_heads/yolof_head.py``).

One map (the DilatedEncoder's, stride 32) through ``cls_subnet`` (2) and
``bbox_subnet`` (4) towers of a biased 3x3 conv, a live BN and a ReLU
(mmdet's names; mmdet's convs have no bias), then ``cls_score`` (``A * C``),
``bbox_pred`` (``A * 4``) and ``object_pred`` (``A``) over 5 anchors a cell.
The class logits are fused with the implicit objectness (``:96-100``):
``cls + obj - log(1 + min(exp(cls), 1e8) + min(exp(obj), 1e8))``.

- ``loss`` (``:102-152``): the uniform matching as the JAX head writes it:
  per gt, the anchors whose anchor centre or decoded centre is within the
  ``match_times``-th smallest L1 centre distance (``<=``: the 5 anchors of
  a cell share a centre, so the nearest cell alone gives 5 candidates);
  a candidate whose anchor IoU is below ``pos_ignore_thr`` is dropped (and
  its anchor ignored unless another gt takes it); each anchor goes to its
  candidate gt of the largest anchor IoU (the first on a tie); a negative
  whose decoded box overlaps a gt above ``neg_ignore_thr`` is ignored. Focal
  loss and GIoU of the decoded boxes, over the batch's positives (every
  rank's).
- ``get_bboxes`` (``:154-185``): the top ``nms_pre`` anchors by their
  largest sigmoid, decoded with the centre clamp and clipped, divided by
  the scale factor, ``multiclass_nms`` (IoU 0.6).

``train_cfg.assigner`` is ``UniformAssigner`` (the config's), read here: the
JAX package's standalone ``UniformAssigner`` has no caller.
"""
from __future__ import annotations

import torch
from torch import nn

from ...core.bbox.geometry import bbox_overlaps
from ...parallel import shard_sum
from ...utils.registry import (BBOX_CODERS, DETECTORS, HEADS, LOSSES, PRIOR_GENERATORS,
                               build_from_cfg, cfg_args)
from ..detectors.single_stage import SingleStageDetector
from ..layers import Conv, ConvModule, widen
from .retina_head import _flatten, nms_detections, top_candidates

INF = 1e8


@HEADS.register_module()
class YOLOFHead(nn.Module):

    def __init__(self, num_classes: int = 80, in_channels: int = 512, num_cls_convs: int = 2,
                 num_reg_convs: int = 4, anchor_generator=None, bbox_coder=None, loss_cls=None,
                 loss_bbox=None, norm_cfg=None, train_cfg=None, test_cfg=None,
                 num_views: int = 1, device=None, dtype=None):
        super().__init__()
        self.num_classes = num_classes
        self.prior_generator = build_from_cfg(dict(anchor_generator or dict(
            type="AnchorGenerator", ratios=[1.0], scales=[1, 2, 4, 8, 16], strides=[32])),
            PRIOR_GENERATORS)
        self.bbox_coder = build_from_cfg(dict(bbox_coder or dict(
            type="DeltaXYWHBBoxCoder", target_means=[0., 0., 0., 0.],
            target_stds=[1., 1., 1., 1.], add_ctr_clamp=True, ctr_clamp=32)), BBOX_CODERS)
        self.loss_cls = build_from_cfg(dict(loss_cls or dict(
            type="FocalLoss", use_sigmoid=True, gamma=2.0, alpha=0.25)), LOSSES)
        self.loss_bbox = build_from_cfg(dict(loss_bbox or dict(type="GIoULoss")), LOSSES)
        asn = cfg_args(dict(train_cfg or {}).get("assigner"), {}, "UniformAssigner")
        self.match_times = int(asn.get("match_times", 4))
        self.pos_ignore_thr = float(asn.get("pos_ignore_thr", 0.15))
        self.neg_ignore_thr = float(asn.get("neg_ignore_thr", 0.7))
        self.test_cfg = dict(test_cfg or {})
        self.na = self.prior_generator.num_base_anchors[0]
        kw = dict(device=device, dtype=dtype)
        tower = dict(norm_cfg=dict(type="BN"), act="relu", bias=True, **kw)
        self.cls_subnet = nn.Sequential(*(ConvModule(in_channels, in_channels, 3, 1, 1, **tower)
                                          for _ in range(num_cls_convs)))
        self.bbox_subnet = nn.Sequential(*(ConvModule(in_channels, in_channels, 3, 1, 1, **tower)
                                           for _ in range(num_reg_convs)))
        self.cls_score = Conv(in_channels, self.na * num_classes, 3, 1, 1, **kw)
        self.bbox_pred = Conv(in_channels, self.na * 4, 3, 1, 1, **kw)
        self.object_pred = Conv(in_channels, self.na, 3, 1, 1, **kw)

    def init_weights(self, gen: torch.Generator):
        """The model's default (``init_default_``), as the JAX head's: the
        classifier's bias at 0 (mmdet's at the 0.01 prior)."""

    def forward(self, feats):
        """-> ([fused class logits (N, A * C, H, W)], [deltas (N, A * 4, H,
        W)]), float32."""
        x = feats[0]
        c, r = self.cls_subnet(x), self.bbox_subnet(x)
        cls = widen(self.cls_score(c))
        reg = widen(self.bbox_pred(r))
        obj = widen(self.object_pred(r))
        n, _, h, w = cls.shape
        cls = cls.view(n, self.na, self.num_classes, h, w)
        obj = obj.view(n, self.na, 1, h, w)
        norm = cls + obj - torch.log(1.0 + torch.clamp(torch.exp(cls), max=INF)
                                     + torch.clamp(torch.exp(obj), max=INF))
        return [norm.reshape(n, -1, h, w)], [reg]

    def candidates(self, anchors, decoded, gt, gt_valid):
        """(K, 4) anchors, (N, K, 4) decoded boxes, (N, G, 4) gts -> (N, K,
        G): the anchors within each gt's ``match_times``-th smallest L1
        centre distance, of the anchor's centre or of its decoded box's."""
        def centre(b):
            return (b[..., 0] + b[..., 2]) * 0.5, (b[..., 1] + b[..., 3]) * 0.5

        acx, acy = centre(anchors)
        pcx, pcy = centre(decoded)
        gcx, gcy = centre(gt)
        cost_a = (acx[None, :, None] - gcx[:, None]).abs() + (acy[None, :, None]
                                                              - gcy[:, None]).abs()
        cost_p = (pcx[..., None] - gcx[:, None]).abs() + (pcy[..., None] - gcy[:, None]).abs()
        k = self.match_times
        thr_a = cost_a.topk(k, dim=1, largest=False).values[:, -1:]           # (N, 1, G)
        thr_p = cost_p.topk(k, dim=1, largest=False).values[:, -1:]
        return ((cost_a <= thr_a) | (cost_p <= thr_p)) & gt_valid[:, None]

    def targets(self, anchors, decoded, gt, gt_valid, gt_labels):
        """(K, 4) anchors, (N, K, 4) decoded boxes, (N, G, ...) gts -> labels
        (N, K) (``C`` background), positives, class weights and each
        anchor's gt box (N, K, 4)."""
        cand = self.candidates(anchors, decoded, gt, gt_valid)
        iou_a = bbox_overlaps(anchors, gt)                                     # (N, K, G)
        iou_p = torch.where(gt_valid[:, None], bbox_overlaps(decoded, gt),
                            decoded.new_zeros(()))
        neg_ignore = iou_p.amax(-1) > self.neg_ignore_thr
        pos_cand = cand & (iou_a >= self.pos_ignore_thr)
        sel = torch.where(pos_cand, iou_a, torch.full_like(iou_a, -1.0))
        gi = sel.argmax(-1)
        pos = sel.amax(-1) > -0.5
        ignored = (cand & ~pos_cand).any(-1) & ~pos
        labels = torch.where(pos, torch.gather(gt_labels.long(), 1, gi),
                             torch.full_like(gi, self.num_classes))
        cw = (~(ignored | (neg_ignore & ~pos))).float()
        tgt = torch.gather(gt, 1, gi[..., None].expand(*gi.shape, 4))
        return labels, pos, cw, tgt

    def loss(self, outs, gt_bboxes, gt_valid, gt_labels, draws=None):
        """``loss_cls`` (focal) and ``loss_bbox`` (GIoU); ``draws`` is unused."""
        cls_scores, bbox_preds = outs
        anchors = self.prior_generator.grid_priors_cat(
            [tuple(s.shape[-2:]) for s in cls_scores], cls_scores[0].device)
        cls = _flatten(cls_scores, self.num_classes)
        decoded = self.bbox_coder.decode(anchors[None], _flatten(bbox_preds, 4))
        with torch.no_grad():
            labels, pos, cw, tgt = self.targets(anchors, decoded.detach(), gt_bboxes, gt_valid,
                                                gt_labels)
            num_pos = torch.clamp_min(shard_sum(pos.sum()).float(), 1.0)
        return dict(
            loss_cls=self.loss_cls(cls.reshape(-1, self.num_classes), labels.reshape(-1),
                                   cw.reshape(-1), avg_factor=num_pos),
            loss_bbox=self.loss_bbox(decoded.reshape(-1, 4), tgt.reshape(-1, 4),
                                     weight=pos.float().reshape(-1), avg_factor=num_pos))

    def get_bboxes(self, outs, img_shapes, scale_factors, rescale: bool = True, cfg=None):
        """Detections of N images: dets (N, max_per_img, 5), labels, valid."""
        cls_scores, bbox_preds = outs
        cfg = dict(cfg or self.test_cfg)
        anchors = self.prior_generator.grid_priors(
            [tuple(s.shape[-2:]) for s in cls_scores], cls_scores[0].device)
        max_shape = (img_shapes[:, 0:1], img_shapes[:, 1:2])
        levels = [(torch.sigmoid(_flatten(cls_scores, self.num_classes)),
                   _flatten(bbox_preds, 4), None)]
        boxes, scores = top_candidates(levels, int(cfg.get("nms_pre", 1000)),
                                       lambda li, ti, d: self.bbox_coder.decode(
                                           anchors[li][ti], d, max_shape=max_shape))
        return nms_detections(boxes, scores, scale_factors, rescale, cfg, self.num_classes,
                              default_iou=0.6)


@DETECTORS.register_module()
class YOLOF(SingleStageDetector):
    """``oadg_tpu/models/dense_heads/yolof_head.py:188``."""
