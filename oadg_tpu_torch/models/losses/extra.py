"""The varifocal loss (port of ``oadg_tpu/models/losses/extra.py:19-52``),
VFNet's classification loss."""
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
