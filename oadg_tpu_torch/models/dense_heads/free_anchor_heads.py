"""FreeAnchor's RetinaNet head (port of
``oadg_tpu/models/dense_heads/free_anchor_heads.py:27-93``).

``RetinaHead``'s towers, anchors and outputs; the loss is FreeAnchor's
detection-customized likelihood over anchor bags instead of an assignment:

- negative: each anchor's probability of being an object of class c,
  ``box_prob`` (N, C), is the largest over the gts of class c of the
  gt's IoU with the anchor saturated between ``bbox_thr`` (0.6) and the
  gt's best IoU (``clip((IoU - t1) / (t2 - t1), 0, 1)``); the focal-style
  ``p' ** gamma * -log(1 - p')`` of ``p' = p * (1 - box_prob)`` over every
  anchor and class. The JAX head forms it as the maximum over a (G, N, C)
  product of the saturated IoUs and each gt's one-hot class (4.02 GB in
  float32 at 392,832 anchors, 32 gts and 80 classes); every factor of that
  product is 0 or 1 at the class axis, so the port scatters each gt's row
  into its class's column with ``scatter_reduce(amax)`` from zeros
  (``box_prob``: the same values, an (N, C) map of 126 MB). It carries no
  gradient (IoUs only).
- positive: per gt a bag of its ``pre_anchor_topk`` (50) anchors of
  highest IoU (ties to the lower index, as ``jax.lax.top_k``); each
  anchor's likelihood is its class probability at the gt's label times
  ``exp(-loss_weight * sum SmoothL1(beta))`` of its deltas against the
  gt's encoded ones, clipped to [0, 1 - 1e-6]; the bag's probability is
  the mean-max ``sum(w m)`` with ``w = m / (1 - m)`` normalized over the
  bag; ``-log`` of it per valid gt.
- ``positive_bag_loss = alpha * sum / num_gts`` and ``negative_bag_loss =
  (1 - alpha) * sum / (num_gts * k)`` (floored at 1), ``num_gts`` the valid
  gts of the batch (of every rank under data parallel).

``RetinaSepBNHead`` (``:97-121``, NAS-FPN's head): ``RetinaHead``'s towers
with each conv shared by the levels and followed by a live BN of each
level's own (``layers.BatchNorm``: the batch's statistics in train mode,
SyncBN under data parallel), then the ReLU; the convs keep their bias, as
the JAX head's ``Conv``s do (mmdet's, a ``ConvModule`` with a norm, has
none). mmdet's keys: ``cls_convs.{level}.{i}.conv`` (one shared tensor under
every level) and ``cls_convs.{level}.{i}.bn``; the same for ``reg_convs``.
"""
from __future__ import annotations

import torch
from torch import nn

from ...core.bbox.geometry import bbox_overlaps
from ...core.post_processing.nms import sort_desc
from ...parallel import shard_sum
from ...utils.registry import HEADS, LOSSES, build_from_cfg
from ..layers import BatchNorm
from .autoassign_ld_heads import _clip
from .retina_head import RetinaHead, _flatten, gather_rows


def box_prob(ious, gt_valid, gt_labels, num_classes: int, bbox_thr: float):
    """(N, G, K) IoUs of the gts with the anchors -> (N, K, C) the largest
    saturated IoU of each anchor with a valid gt of each class (0 where
    none)."""
    t2 = _clip(ious.amax(-1, keepdim=True), bbox_thr + 1e-12)
    obj = _clip((ious - bbox_thr) / (t2 - bbox_thr), 0.0, 1.0)
    obj = torch.where(gt_valid[..., None], obj, obj.new_zeros(()))          # (N, G, K)
    n, g, k = obj.shape
    index = gt_labels.long().clamp(0, num_classes - 1)[:, None, :].expand(n, k, g)
    return obj.new_zeros((n, k, num_classes)).scatter_reduce(
        2, index, obj.transpose(1, 2), reduce="amax", include_self=True)


@HEADS.register_module()
class FreeAnchorRetinaHead(RetinaHead):

    def __init__(self, pre_anchor_topk: int = 50, bbox_thr: float = 0.6, gamma: float = 2.0,
                 alpha: float = 0.5, **kwargs):
        super().__init__(**kwargs)
        self.pre_anchor_topk = pre_anchor_topk
        self.bbox_thr = bbox_thr
        self.gamma = gamma
        self.alpha = alpha
        self.reg_loss = build_from_cfg(self.loss_bbox_cfg, LOSSES)

    def loss(self, outs, gt_bboxes, gt_valid, gt_labels, draws=None):
        """``positive_bag_loss`` and ``negative_bag_loss`` of N images;
        ``draws`` is unused (nothing is sampled)."""
        cls_scores, bbox_preds = outs
        anchors = self.prior_generator.grid_priors_cat(
            [tuple(s.shape[-2:]) for s in cls_scores], cls_scores[0].device)    # (K, 4)
        prob = torch.sigmoid(_flatten(cls_scores, self.num_classes).float())  # (N, K, C)
        reg = _flatten(bbox_preds, 4).float()
        k = self.pre_anchor_topk
        n, g = gt_labels.shape
        with torch.no_grad():
            ious = bbox_overlaps(gt_bboxes, anchors)                          # (N, G, K)
            ious = torch.where(gt_valid[..., None], ious, ious.new_zeros(()))
            keep = 1 - box_prob(ious, gt_valid, gt_labels, self.num_classes, self.bbox_thr)
            bag = sort_desc(ious, k)[1]                                       # (N, G, k)
            flat = bag.reshape(n, g * k)
            tgt = self.bbox_coder.encode(anchors[bag], gt_bboxes[:, :, None, :])
            num_gts = _clip(shard_sum(gt_valid.float().sum()), 1.0)
        neg_prob = prob * keep
        neg = (neg_prob ** self.gamma * -torch.log(_clip(1 - neg_prob, 1e-12, 1.0))).sum()
        labels = gt_labels.long().clamp(0, self.num_classes - 1)
        m_cls = torch.gather(gather_rows(prob, flat).reshape(n, g, k, -1), 3,
                             labels[:, :, None, None].expand(n, g, k, 1))[..., 0]
        pred = gather_rows(reg, flat).reshape(n, g, k, 4)
        beta = getattr(self.reg_loss, "beta", 0.11)
        d = (pred - tgt).abs()
        sl1 = torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta)
        m_box = torch.exp(-self.reg_loss.loss_weight * sl1.sum(-1))
        m = _clip(m_cls * m_box, 0.0, 1.0 - 1e-6)                              # (N, G, k)
        w = m / _clip(1 - m, 1e-12)
        w = w / _clip(w.sum(-1, keepdim=True), 1e-12)
        bag_prob = (w * m).sum(-1)
        pos = (-torch.log(_clip(bag_prob, 1e-12, 1.0)) * gt_valid.float()).sum()
        return dict(positive_bag_loss=self.alpha * pos / num_gts,
                    negative_bag_loss=(1 - self.alpha) * neg / _clip(num_gts * k, 1.0))


class ConvBN(nn.Module):
    """``relu(bn(conv(x)))`` with a given (shared) ``conv`` and a live BN of
    its own."""

    def __init__(self, conv: nn.Module, channels: int, device=None):
        super().__init__()
        self.conv = conv
        self.bn = BatchNorm(channels, device=device)

    def forward(self, x):
        return torch.relu(self.bn(self.conv(x)))


@HEADS.register_module()
class RetinaSepBNHead(RetinaHead):

    def __init__(self, num_levels: int = 5, **kwargs):
        super().__init__(**kwargs)
        self.num_levels = num_levels
        feat, dev = kwargs.get("feat_channels", 256), kwargs.get("device")
        cls_convs = [m.conv for m in self.cls_convs]
        reg_convs = [m.conv for m in self.reg_convs]
        self.cls_convs = nn.ModuleList(nn.ModuleList(ConvBN(c, feat, dev) for c in cls_convs)
                                       for _ in range(num_levels))
        self.reg_convs = nn.ModuleList(nn.ModuleList(ConvBN(c, feat, dev) for c in reg_convs)
                                       for _ in range(num_levels))

    def forward(self, feats):
        """Per level: class logits (N, A * C, H, W), deltas (N, A * 4, H, W)."""
        if len(feats) != self.num_levels:
            raise ValueError(f"RetinaSepBNHead has {self.num_levels} levels' BNs, given "
                             f"{len(feats)} maps")
        cls_scores, bbox_preds = [], []
        for x, cls_convs, reg_convs in zip(feats, self.cls_convs, self.reg_convs):
            c = r = x
            for m in cls_convs:
                c = m(c)
            for m in reg_convs:
                r = m(r)
            cls_scores.append(self.retina_cls(c))
            bbox_preds.append(self.retina_reg(r))
        return cls_scores, bbox_preds
