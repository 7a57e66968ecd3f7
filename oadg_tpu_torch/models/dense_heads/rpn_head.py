"""RPN head (port of ``oadg_tpu/models/dense_heads/rpn_head.py:43``): a 3x3
conv tower and 1x1 objectness / delta convs per level (``forward``), and
static-shape proposals (``get_proposals``, ``:171-239``): per level the top
``nms_pre`` anchors by objectness, decode and clip, NMS per level, then the
top ``max_per_img`` over all levels, padded, with a validity mask.

Outputs stay NCHW as mmdet's; proposals permute them to NHWC before
flattening, so anchors (H, W, A) and deltas (A * 4, 4 fastest) line up.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...core.post_processing.nms import nms_padded, sort_desc
from ...utils.registry import BBOX_CODERS, HEADS, PRIOR_GENERATORS, build_from_cfg
from ..layers import Conv, normal_


@HEADS.register_module()
class RPNHead(nn.Module):

    def __init__(self, in_channels: int = 256, feat_channels: int = 256,
                 anchor_generator=None, bbox_coder=None, loss_cls=None,
                 loss_bbox=None, train_cfg=None, test_cfg=None, device=None):
        super().__init__()
        self.prior_generator = build_from_cfg(dict(anchor_generator),
                                              PRIOR_GENERATORS)
        self.bbox_coder = build_from_cfg(dict(bbox_coder), BBOX_CODERS)
        self.test_cfg = dict(test_cfg or {})
        na = self.prior_generator.num_base_anchors[0]
        self.rpn_conv = Conv(in_channels, feat_channels, 3, padding=1, device=device)
        self.rpn_cls = Conv(feat_channels, na, 1, device=device)
        self.rpn_reg = Conv(feat_channels, na * 4, 1, device=device)

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

    def get_proposals(self, cls_scores, bbox_preds, img_shapes):
        """Args: per-level head outputs; img_shapes (N, 2) float (h, w) of the
        valid region. ``test_cfg`` gives nms_pre, max_per_img,
        nms.iou_threshold and min_bbox_size.

        Returns boxes (N, max_per_img, 4), scores (N, max_per_img), valid
        (N, max_per_img) bool.
        """
        cfg = self.test_cfg
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
            scores_l.append(F.pad(torch.sigmoid(ts), (0, pad)))
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
        return out_boxes, torch.where(out_valid, top_s, torch.zeros_like(top_s)), out_valid
