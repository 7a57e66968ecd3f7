"""Loss primitives and the stock losses (port of
``oadg_tpu/models/losses/common.py:22-136``): ``CrossEntropyLoss``,
``SmoothL1Loss`` and ``L1Loss``, registered in ``LOSSES``, are the plain
Faster R-CNN's; ``MSELoss`` (``:248-258``) is YOLOv3's, beside the sigmoid
elementwise ``CrossEntropyLoss`` on soft targets.

Static-shape and mask-weighted like the JAX package: ragged indexing
(``pred[pos_inds]``) is a weight of 0. ``maximum`` and ``minimum`` are taken
with ``torch.maximum`` / ``torch.minimum``, which split the gradient of a tie
evenly as JAX does, where ``clamp`` and ``relu`` would not.
"""
from __future__ import annotations

from typing import Optional

import torch

from ...utils.registry import LOSSES


def weight_reduce_loss(loss: torch.Tensor, weight: Optional[torch.Tensor] = None,
                       reduction: str = "mean", avg_factor=None) -> torch.Tensor:
    """mmdet's contract: ``loss * weight``, then none / sum / mean, the mean
    divided by ``avg_factor`` when one is given."""
    if weight is not None:
        loss = loss * weight
    if reduction == "none":
        return loss
    if reduction == "sum":
        return loss.sum()
    if avg_factor is None:
        if weight is None:
            return loss.mean()
        return loss.sum() / torch.clamp_min(weight.sum(), 1e-12)
    return loss.sum() / avg_factor


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          ignore_index: int = -100) -> torch.Tensor:
    """Per-row CE with integer labels; rows labelled ``ignore_index`` give 0."""
    valid = labels != ignore_index
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None].long())[..., 0]
    return torch.where(valid, nll, torch.zeros_like(nll))


def binary_cross_entropy_with_logits(logits: torch.Tensor,
                                     targets: torch.Tensor) -> torch.Tensor:
    """Elementwise, stable: ``max(x, 0) - x t + log1p(exp(-|x|))``."""
    return (torch.maximum(logits, torch.zeros_like(logits)) - logits * targets
            + torch.log1p(torch.exp(-logits.abs())))


def smooth_l1(pred: torch.Tensor, target: torch.Tensor,
              beta: float = 1.0) -> torch.Tensor:
    diff = (pred - target).abs()
    return torch.where(diff < beta, 0.5 * diff * diff / beta, diff - 0.5 * beta)


def l1(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return (pred - target).abs()


def accuracy(logits: torch.Tensor, labels: torch.Tensor,
             mask: Optional[torch.Tensor] = None, avg_factor=None) -> torch.Tensor:
    """Top-1 accuracy in percent over the rows where ``mask`` is set, or
    their correct count over ``avg_factor`` (data parallel: the rows of
    every rank, so that the ranks' values sum to the global accuracy)."""
    correct = (logits.argmax(dim=-1) == labels).float()
    if mask is not None:
        denom = torch.clamp_min(mask.sum(), 1.0) if avg_factor is None else avg_factor
        return 100.0 * (correct * mask).sum() / denom
    return 100.0 * correct.mean()


@LOSSES.register_module()
class CrossEntropyLoss:
    """Stock CE / BCE (port of ``oadg_tpu/models/losses/common.py:81``):
    softmax CE with ``ignore_index``; with ``use_sigmoid``, BCE on one-hot
    targets when ``cls_score`` has one more dimension than ``label`` (a
    label outside [0, C) gives an all-zero row, a negative or ignored one a
    weight of 0), elementwise BCE otherwise. ``class_weight`` is accepted
    and unused, as in the JAX package."""

    def __init__(self, use_sigmoid: bool = False, use_mask: bool = False,
                 reduction: str = "mean", class_weight=None, ignore_index=None,
                 loss_weight: float = 1.0, **kw):
        self.use_sigmoid = use_sigmoid
        self.reduction = reduction
        self.loss_weight = loss_weight
        self.ignore_index = -100 if ignore_index is None else ignore_index

    def __call__(self, cls_score, label, weight=None, avg_factor=None,
                 reduction_override=None, **kw):
        red = reduction_override or self.reduction
        if not self.use_sigmoid:
            loss = softmax_cross_entropy(cls_score, label, self.ignore_index)
        elif cls_score.dim() != label.dim():
            nc = cls_score.shape[-1]
            onehot = torch.zeros_like(cls_score).scatter_(
                -1, label.clamp(0, nc - 1)[..., None].long(), 1.0)
            onehot = onehot * ((label >= 0) & (label < nc))[..., None]
            w = ((label >= 0) & (label != self.ignore_index))[..., None].float()
            if weight is not None:
                w = w * weight[..., None]
            return self.loss_weight * weight_reduce_loss(
                binary_cross_entropy_with_logits(cls_score, onehot), w, red, avg_factor)
        else:
            loss = binary_cross_entropy_with_logits(cls_score, label.float())
        return self.loss_weight * weight_reduce_loss(loss, weight, red, avg_factor)


@LOSSES.register_module()
class SmoothL1Loss:
    """Port of ``oadg_tpu/models/losses/common.py:111``."""

    def __init__(self, beta: float = 1.0, reduction: str = "mean",
                 loss_weight: float = 1.0, **kw):
        self.beta = beta
        self.reduction = reduction
        self.loss_weight = loss_weight

    def __call__(self, pred, target, weight=None, avg_factor=None,
                 reduction_override=None, **kw):
        return self.loss_weight * weight_reduce_loss(
            smooth_l1(pred, target, self.beta), weight,
            reduction_override or self.reduction, avg_factor)


@LOSSES.register_module()
class L1Loss:
    """Port of ``oadg_tpu/models/losses/common.py:125``."""

    def __init__(self, reduction: str = "mean", loss_weight: float = 1.0, **kw):
        self.reduction = reduction
        self.loss_weight = loss_weight

    def __call__(self, pred, target, weight=None, avg_factor=None,
                 reduction_override=None, **kw):
        return self.loss_weight * weight_reduce_loss(
            l1(pred, target), weight, reduction_override or self.reduction, avg_factor)


@LOSSES.register_module()
class MSELoss:
    """Port of ``oadg_tpu/models/losses/common.py:248``: ``(pred - target)^2``."""

    def __init__(self, reduction: str = "mean", loss_weight: float = 1.0, **kw):
        self.reduction = reduction
        self.loss_weight = loss_weight

    def __call__(self, pred, target, weight=None, avg_factor=None,
                 reduction_override=None, **kw):
        return self.loss_weight * weight_reduce_loss(
            (pred - target) ** 2, weight, reduction_override or self.reduction, avg_factor)
