"""RPN head (port of ``oadg_tpu/models/dense_heads/rpn_head.py:43``): a 3x3
conv tower and 1x1 objectness / delta convs per level (``forward``), the
all-level training loss (``loss``, ``:104-167``: assign every anchor, sample
with the given draws, encode the matched gt), and static-shape proposals
(``get_proposals``, ``:171-239``): per level the top ``nms_pre`` anchors by
objectness, decode and clip, NMS per level, then the top ``max_per_img``
over all levels, padded, with a validity mask.

Outputs stay NCHW as mmdet's; proposals permute them to NHWC before
flattening, so anchors (H, W, A) and deltas (A * 4, 4 fastest) line up.

Dtypes, as the JAX package's: the convs compute in ``dtype`` and return it;
the loss takes the outputs cast to float32 (``:161,165``); proposals select
and sort the objectness in its own dtype (bfloat16 logits tie often; ties go
to the lower index, as ``jax.lax.top_k``), take its sigmoid in that dtype
(``:206,213``; ``sigmoid``) and run NMS and the final selection on those
scores; the deltas are decoded in float32 (``core/bbox/coder.py``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...core.bbox.assign_sample import MaxIoUAssigner, RandomSampler
from ...core.post_processing.nms import nms_padded, sort_desc
from ...parallel import shard_sum
from ...utils.registry import (BBOX_CODERS, HEADS, LOSSES, PRIOR_GENERATORS,
                               build_from_cfg, cfg_args)
from ..layers import Conv, normal_


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid`` of the proposals' scores. Float32: ``torch.sigmoid``.
    A narrower dtype: ``1 / (1 + exp(-x))`` with each operation rounded to
    it, the form XLA expands ``logistic`` into (``torch.sigmoid`` rounds
    once, and a bfloat16 step apart reorders near-tied proposals)."""
    if x.dtype == torch.float32:
        return torch.sigmoid(x)
    return torch.reciprocal(torch.exp(-x) + 1)


@HEADS.register_module()
class RPNHead(nn.Module):

    def __init__(self, in_channels: int = 256, feat_channels: int = 256,
                 anchor_generator=None, bbox_coder=None, loss_cls=None,
                 loss_bbox=None, train_cfg=None, test_cfg=None, device=None,
                 dtype=None):
        super().__init__()
        self.prior_generator = build_from_cfg(dict(anchor_generator),
                                              PRIOR_GENERATORS)
        self.bbox_coder = build_from_cfg(dict(bbox_coder), BBOX_CODERS)
        self.test_cfg = dict(test_cfg or {})
        self.train_cfg = dict(train_cfg or {})
        self.loss_cls_cfg = dict(loss_cls or dict(type="CrossEntropyLoss",
                                                  use_sigmoid=True))
        self.loss_bbox_cfg = dict(loss_bbox or dict(type="L1Loss"))
        self.assigner = MaxIoUAssigner(**cfg_args(
            self.train_cfg.get("assigner"),
            dict(pos_iou_thr=0.7, neg_iou_thr=0.3, min_pos_iou=0.3), "MaxIoUAssigner"))
        self.sampler = RandomSampler(**cfg_args(
            self.train_cfg.get("sampler"), dict(num=256, pos_fraction=0.5), "RandomSampler"))
        na = self.prior_generator.num_base_anchors[0]
        conv = dict(device=device, dtype=dtype)
        self.rpn_conv = Conv(in_channels, feat_channels, 3, padding=1, **conv)
        self.rpn_cls = Conv(feat_channels, na, 1, **conv)
        self.rpn_reg = Conv(feat_channels, na * 4, 1, **conv)

    def init_weights(self, gen: torch.Generator):
        """Normal(std=0.01) convs, zero biases (mmdet RPNHead init_cfg)."""
        for conv in (self.rpn_conv, self.rpn_cls, self.rpn_reg):
            normal_(conv.weight, 0.01, gen)
            nn.init.zeros_(conv.bias)

    def forward(self, feats):
        """Per level: objectness (N, A, H, W), deltas (N, A * 4, H, W)."""
        cls_scores, bbox_preds = [], []
        for x in feats:
            t = F.relu(self.rpn_conv(x))
            cls_scores.append(self.rpn_cls(t))
            bbox_preds.append(self.rpn_reg(t))
        return cls_scores, bbox_preds

    def loss(self, cls_scores, bbox_preds, gt_bboxes, gt_valid, draws,
             img_shapes=None):
        """All-level RPN loss over views-major images.

        Args:
            cls_scores / bbox_preds: per-level head outputs, N images.
            gt_bboxes: (N, G, 4); gt_valid: (N, G) bool.
            draws: a ``utils.draws.UniformDraws``; takes ``rpn.pos`` and
                ``rpn.neg``, (N, anchors) each.
            img_shapes: (N, 2) valid (h, w); needed only when
                ``train_cfg.allowed_border >= 0`` (anchors crossing the
                border are then ignored).

        Returns ``loss_rpn_cls`` and ``loss_rpn_bbox``; under data parallel
        this rank's share of them (its anchors' terms over the sampled
        anchors of every rank).
        """
        n = cls_scores[0].shape[0]
        dev = cls_scores[0].device
        anchors = self.prior_generator.grid_priors_cat(
            [tuple(s.shape[-2:]) for s in cls_scores], dev)      # (K, 4)
        k = anchors.shape[0]
        cls = torch.cat([s.permute(0, 2, 3, 1).reshape(n, -1) for s in cls_scores], 1)
        reg = torch.cat([b.permute(0, 2, 3, 1).reshape(n, -1, 4) for b in bbox_preds], 1)
        box_valid = None
        ab = float(self.train_cfg.get("allowed_border", -1))
        if ab >= 0:
            if img_shapes is None:
                raise ValueError("allowed_border >= 0 needs img_shapes")
            h, w = img_shapes[:, 0:1], img_shapes[:, 1:2]
            box_valid = ((anchors[:, 0] >= -ab) & (anchors[:, 1] >= -ab)
                         & (anchors[:, 2] < w + ab) & (anchors[:, 3] < h + ab))
        with torch.no_grad():
            assign = self.assigner.assign(anchors, gt_bboxes, gt_valid,
                                          box_valid=box_valid)    # (N, K)
            pos, neg = self.sampler.sample_masks(
                assign, draws("rpn.pos", (n, k), dev), draws("rpn.neg", (n, k), dev))
            labels = torch.where(pos, 0, 1)                   # foreground is 0
            label_w = (pos | neg).float()
            matched = (assign.gt_inds - 1).clamp(0, gt_bboxes.shape[1] - 1)
            matched_gt = torch.gather(gt_bboxes, 1, matched[..., None].expand(n, k, 4))
            deltas = self.bbox_coder.encode(anchors.expand(n, k, 4), matched_gt)
            bbox_w = pos.float()[..., None].expand(n, k, 4)
            # over the global batch under data parallel (this rank's share)
            num_total = shard_sum(pos.sum() + neg.sum()).clamp(min=1).float()
        loss_cls = build_from_cfg(self.loss_cls_cfg, LOSSES)
        loss_bbox = build_from_cfg(self.loss_bbox_cfg, LOSSES)
        return dict(
            loss_rpn_cls=loss_cls(cls.reshape(-1, 1).float(), labels.reshape(-1),
                                  label_w.reshape(-1), avg_factor=num_total),
            loss_rpn_bbox=loss_bbox(reg.reshape(-1, 4).float(),
                                    deltas.reshape(-1, 4), bbox_w.reshape(-1, 4),
                                    avg_factor=num_total))

    def get_proposals(self, cls_scores, bbox_preds, img_shapes, cfg=None):
        """Args: per-level head outputs; img_shapes (N, 2) float (h, w) of the
        valid region; ``cfg`` (default ``test_cfg``; training passes
        ``train_cfg.rpn_proposal``) gives nms_pre, max_per_img,
        nms.iou_threshold and min_bbox_size.

        Returns boxes (N, max_per_img, 4), scores (N, max_per_img), valid
        (N, max_per_img) bool, detached: proposals are data for the RoI head,
        not a gradient path.
        """
        cfg = self.test_cfg if cfg is None else dict(cfg)
        nms_pre = int(cfg.get("nms_pre", 1000))
        max_per_img = int(cfg.get("max_per_img", 1000))
        iou_thr = float(dict(cfg.get("nms", {})).get("iou_threshold", 0.7))
        min_size = float(cfg.get("min_bbox_size", 0))
        n = cls_scores[0].shape[0]
        dev = cls_scores[0].device
        anchors = self.prior_generator.grid_priors(
            [tuple(s.shape[-2:]) for s in cls_scores], dev)
        max_shape = (img_shapes[:, 0:1], img_shapes[:, 1:2])    # (N, 1) each

        boxes_l, scores_l, valid_l = [], [], []
        for sc, dl, anch in zip(cls_scores, bbox_preds, anchors):
            sc = sc.permute(0, 2, 3, 1).reshape(n, -1)             # (N, HWA)
            dl = dl.permute(0, 2, 3, 1).reshape(n, -1, 4)
            top = min(nms_pre, sc.shape[1])
            ts, ti = sort_desc(sc, top)
            boxes = self.bbox_coder.decode(
                anch[ti], torch.gather(dl, 1, ti[..., None].expand(n, top, 4)),
                max_shape=max_shape)
            pad = nms_pre - top
            boxes_l.append(F.pad(boxes, (0, 0, 0, pad)))
            scores_l.append(F.pad(sigmoid(ts), (0, pad)))
            valid_l.append((torch.arange(nms_pre, device=dev) < top).expand(n, nms_pre))
        boxes = torch.stack(boxes_l, 1)                            # (N, L, P, 4)
        scores = torch.stack(scores_l, 1)
        valid = torch.stack(valid_l, 1)
        if min_size > 0:
            valid = (valid & (boxes[..., 2] - boxes[..., 0] > min_size)
                     & (boxes[..., 3] - boxes[..., 1] > min_size))
        # levels never suppress each other (mmdet batched_nms by level), so
        # NMS runs per (image, level)
        keep = nms_padded(boxes, scores, iou_thr, valid).reshape(n, -1)
        boxes = boxes.reshape(n, -1, 4)
        scores = torch.where(keep, scores.reshape(n, -1),
                             torch.full_like(keep, float("-inf"), dtype=scores.dtype))
        top_s, top_i = sort_desc(scores, max_per_img)
        out_valid = top_s > float("-inf")
        out_boxes = torch.gather(boxes, 1, top_i[..., None].expand(n, max_per_img, 4))
        out_boxes = torch.where(out_valid[..., None], out_boxes,
                                torch.zeros_like(out_boxes))
        out_scores = torch.where(out_valid, top_s, torch.zeros_like(top_s))
        return out_boxes.detach(), out_scores.detach(), out_valid
