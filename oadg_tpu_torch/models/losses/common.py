"""Loss primitives (port of ``oadg_tpu/models/losses/common.py:22-80``).

Static-shape and mask-weighted like the JAX package: ragged indexing
(``pred[pos_inds]``) is a weight of 0. ``maximum`` and ``minimum`` are taken
with ``torch.maximum`` / ``torch.minimum``, which split the gradient of a tie
evenly as JAX does, where ``clamp`` and ``relu`` would not.
"""
from __future__ import annotations

from typing import Optional

import torch


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
             mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Top-1 accuracy in percent over the rows where ``mask`` is set."""
    correct = (logits.argmax(dim=-1) == labels).float()
    if mask is not None:
        return 100.0 * (correct * mask).sum() / torch.clamp_min(mask.sum(), 1.0)
    return 100.0 * correct.mean()
