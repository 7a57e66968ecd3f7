"""The varifocal loss, LD's knowledge-distillation KL and CornerNet's
associative embedding loss (port of ``oadg_tpu/models/losses/extra.py:19-70,
123-148``): VFNet's classification loss, LD's ``loss_ld`` and CornerNet's
``loss_pull`` / ``loss_push``."""
from __future__ import annotations

import torch

from ...utils.registry import LOSSES
from .common import binary_cross_entropy_with_logits, weight_reduce_loss


@LOSSES.register_module()
class VarifocalLoss:
    """IoU-aware classification: ``target`` (..., C) holds the IoU at the
    gt class of a positive and 0 elsewhere. A positive element (target > 0)
    is weighted by its target (``iou_weighted``) or by 1, a negative one by
    ``alpha * |sigmoid - target| ** gamma``; the BCE against the target
    times that weight. A per-row weight is broadcast over the classes."""

    def __init__(self, use_sigmoid: bool = True, alpha: float = 0.75, gamma: float = 2.0,
                 iou_weighted: bool = True, reduction: str = "mean",
                 loss_weight: float = 1.0, **kw):
        if not use_sigmoid:
            raise NotImplementedError("VarifocalLoss takes use_sigmoid=True only")
        self.alpha, self.gamma = alpha, gamma
        self.iou_weighted = iou_weighted
        self.reduction = reduction
        self.loss_weight = loss_weight

    def __call__(self, pred, target, weight=None, avg_factor=None,
                 reduction_override=None, **kw):
        p = torch.sigmoid(pred)
        pos = (target > 0).to(pred.dtype)
        neg = self.alpha * (p - target).abs() ** self.gamma * (1 - pos)
        focal = (target * pos if self.iou_weighted else pos) + neg
        loss = binary_cross_entropy_with_logits(pred, target) * focal
        if weight is not None and weight.dim() + 1 == loss.dim():
            weight = weight[..., None]
        return self.loss_weight * weight_reduce_loss(
            loss, weight, reduction_override or self.reduction, avg_factor)


@LOSSES.register_module()
class KnowledgeDistillationKLDivLoss:
    """LD's soft-label KL (``extra.py:53-70``): with ``q = softmax(soft_label
    / T)``, ``T ** 2 * sum_bins q (log max(q, 1e-12) - log_softmax(pred /
    T))`` per row, through ``weight_reduce_loss``."""

    def __init__(self, reduction: str = "mean", loss_weight: float = 1.0, T: float = 10, **kw):
        self.reduction = reduction
        self.loss_weight = loss_weight
        self.T = T

    def __call__(self, pred, soft_label, weight=None, avg_factor=None,
                 reduction_override=None, **kw):
        t = self.T
        q = torch.softmax(soft_label / t, dim=-1)
        logp = torch.log_softmax(pred / t, dim=-1)
        kd = (q * (torch.log(torch.clamp_min(q, 1e-12)) - logp)).sum(-1) * (t * t)
        return self.loss_weight * weight_reduce_loss(
            kd, weight, reduction_override or self.reduction, avg_factor)


@LOSSES.register_module()
class AssociativeEmbeddingLoss:
    """CornerNet's pull and push losses (``:123-148``) on dense per-gt
    corner embeddings with a validity mask (mmdet's are ragged per-image
    lists): over the ``n`` valid gts, pull the mean of both corners'
    squared distances to their mean, push ``max(1 - |m_i - m_j|, 0)`` over
    the ordered pairs ``i != j`` divided by ``n (n - 1)``; each times its
    weight (0.25)."""

    def __init__(self, pull_weight: float = 0.25, push_weight: float = 0.25, **kw):
        self.pull_weight = pull_weight
        self.push_weight = push_weight

    def __call__(self, tl_emb, br_emb, valid, **kw):
        """``tl_emb``, ``br_emb``: (..., G) corner embeddings a gt;
        ``valid`` (..., G) bool. -> (pull, push), each (...) (one value an
        image)."""
        v = valid.to(tl_emb.dtype)
        n = torch.clamp_min(v.sum(-1), 1.0)
        mean = (tl_emb + br_emb) * 0.5
        pull = (((tl_emb - mean) ** 2 + (br_emb - mean) ** 2) * v).sum(-1) / n
        d = (mean[..., :, None] - mean[..., None, :]).abs()
        eye = torch.eye(v.shape[-1], dtype=v.dtype, device=v.device)
        pair = v[..., :, None] * v[..., None, :] * (1 - eye)
        push = ((torch.maximum(1 - d, torch.zeros_like(d)) * pair).sum((-2, -1))
                / torch.clamp_min(n * (n - 1), 1.0))
        return self.pull_weight * pull, self.push_weight * push
