"""Loss primitives and the stock losses (port of
``oadg_tpu/models/losses/common.py:22-136``): ``CrossEntropyLoss``,
``SmoothL1Loss`` and ``L1Loss``, registered in ``LOSSES``, are the plain
Faster R-CNN's; ``MSELoss`` (``:248-258``) is YOLOv3's, beside the sigmoid
elementwise ``CrossEntropyLoss`` on soft targets; ``FocalLoss``
(``:62-69``, ``:138-155``) is RetinaNet's; ``IoULoss``, ``BoundedIoULoss``,
``GIoULoss``, ``DIoULoss`` and ``CIoULoss`` (``:158-245``, ``:466-523``)
regress decoded boxes (``reg_decoded_bbox``): their ``(R, 4)`` box weights
are cut to ``[..., 0]``, as in the JAX package. ``QualityFocalLoss`` and
``DistributionFocalLoss`` (``:387-437``) are GFL's and TOOD's;
``GaussianFocalLoss`` (``:444-464``) is CenterNet's and CornerNet's.

Static-shape and mask-weighted like the JAX package: ragged indexing
(``pred[pos_inds]``) is a weight of 0. ``maximum`` and ``minimum`` are taken
with ``torch.maximum`` / ``torch.minimum``, which split the gradient of a tie
evenly as JAX does, where ``clamp`` and ``relu`` would not.
"""
from __future__ import annotations

from typing import Optional

import math

import torch

from ...core.bbox.geometry import bbox_overlaps
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


def sigmoid_focal_loss(logits: torch.Tensor, targets: torch.Tensor,
                       gamma: float = 2.0, alpha: float = 0.25) -> torch.Tensor:
    """Elementwise focal loss on one-hot ``targets`` (``:62-69``):
    ``a_t * bce * (1 - p_t) ** gamma``."""
    p = torch.sigmoid(logits)
    ce = binary_cross_entropy_with_logits(logits, targets)
    p_t = p * targets + (1 - p) * (1 - targets)
    a_t = alpha * targets + (1 - alpha) * (1 - targets)
    return a_t * ce * (1 - p_t) ** gamma


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


def _box_weight(weight, loss):
    """A 4-wide box weight cut to its first column (the JAX package's)."""
    if weight is not None and weight.dim() > loss.dim():
        return weight[..., 0]
    return weight


@LOSSES.register_module()
class FocalLoss:
    """Sigmoid focal loss (``:138-155``): the label ``num_classes``
    (background) and any label outside [0, C) become an all-zero one-hot
    row; a per-row weight is broadcast over the classes."""

    def __init__(self, use_sigmoid: bool = True, gamma: float = 2.0,
                 alpha: float = 0.25, reduction: str = "mean",
                 loss_weight: float = 1.0, **kw):
        if not use_sigmoid:
            raise NotImplementedError("FocalLoss takes use_sigmoid=True only")
        self.gamma, self.alpha = gamma, alpha
        self.reduction = reduction
        self.loss_weight = loss_weight

    def __call__(self, pred, target, weight=None, avg_factor=None,
                 reduction_override=None, **kw):
        nc = pred.shape[-1]
        inside = (target >= 0) & (target < nc)
        onehot = torch.zeros_like(pred).scatter_(
            -1, target.clamp(0, nc - 1)[..., None].long(), 1.0) * inside[..., None]
        loss = sigmoid_focal_loss(pred, onehot, self.gamma, self.alpha)
        if weight is not None and weight.dim() + 1 == loss.dim():
            weight = weight[..., None]
        return self.loss_weight * weight_reduce_loss(
            loss, weight, reduction_override or self.reduction, avg_factor)


@LOSSES.register_module()
class IoULoss:
    """``:158-182``: ``-log(iou)`` (``mode='log'``), ``1 - iou``
    (``linear``) or ``1 - iou ** 2`` (``square``), the IoU floored at
    ``eps``."""

    def __init__(self, mode: str = "log", eps: float = 1e-6, reduction: str = "mean",
                 loss_weight: float = 1.0, linear: bool = False, **kw):
        self.mode = "linear" if linear else mode
        if self.mode not in ("log", "linear", "square"):
            raise ValueError(f"IoULoss mode {self.mode!r}: log, linear or square")
        self.eps = eps
        self.reduction = reduction
        self.loss_weight = loss_weight

    def __call__(self, pred, target, weight=None, avg_factor=None,
                 reduction_override=None, **kw):
        ious = bbox_overlaps(pred, target, is_aligned=True)
        ious = torch.maximum(ious, ious.new_full((), self.eps))
        if self.mode == "linear":
            loss = 1 - ious
        elif self.mode == "square":
            loss = 1 - ious ** 2
        else:
            loss = -torch.log(ious)
        return self.loss_weight * weight_reduce_loss(
            loss, _box_weight(weight, loss), reduction_override or self.reduction,
            avg_factor)


@LOSSES.register_module()
class BoundedIoULoss:
    """Bounded IoU (``:185-229``): per-side bounds on the centre offsets and
    the size ratios against the detached target, each through a smooth-L1
    step at ``beta``, summed."""

    def __init__(self, beta: float = 0.2, eps: float = 1e-3, reduction: str = "mean",
                 loss_weight: float = 1.0, **kw):
        self.beta = beta
        self.eps = eps
        self.reduction = reduction
        self.loss_weight = loss_weight

    def __call__(self, pred, target, weight=None, avg_factor=None,
                 reduction_override=None, **kw):
        eps = self.eps
        zero = pred.new_zeros(())
        pcx = (pred[:, 0] + pred[:, 2]) * 0.5
        pcy = (pred[:, 1] + pred[:, 3]) * 0.5
        pw = pred[:, 2] - pred[:, 0]
        ph = pred[:, 3] - pred[:, 1]
        t = target.detach()
        tcx = (t[:, 0] + t[:, 2]) * 0.5
        tcy = (t[:, 1] + t[:, 3]) * 0.5
        tw = t[:, 2] - t[:, 0]
        th = t[:, 3] - t[:, 1]
        dx = (tcx - pcx).abs()
        dy = (tcy - pcy).abs()
        loss_dx = 1 - torch.maximum((tw - 2 * dx) / (tw + 2 * dx + eps), zero)
        loss_dy = 1 - torch.maximum((th - 2 * dy) / (th + 2 * dy + eps), zero)
        loss_dw = 1 - torch.minimum(tw / (pw + eps), pw / (tw + eps))
        loss_dh = 1 - torch.minimum(th / (ph + eps), ph / (th + eps))
        comb = torch.stack([loss_dx, loss_dy, loss_dw, loss_dh], dim=-1)
        loss = torch.where(comb < self.beta, 0.5 * comb * comb / self.beta,
                           comb - 0.5 * self.beta).sum(dim=-1)
        return self.loss_weight * weight_reduce_loss(
            loss, _box_weight(weight, loss), reduction_override or self.reduction,
            avg_factor)


@LOSSES.register_module()
class GIoULoss:
    """``:232-245``: ``1 - giou``."""

    def __init__(self, eps: float = 1e-6, reduction: str = "mean",
                 loss_weight: float = 1.0, **kw):
        self.eps = eps
        self.reduction = reduction
        self.loss_weight = loss_weight

    def __call__(self, pred, target, weight=None, avg_factor=None,
                 reduction_override=None, **kw):
        loss = 1 - bbox_overlaps(pred, target, mode="giou", is_aligned=True)
        return self.loss_weight * weight_reduce_loss(
            loss, _box_weight(weight, loss), reduction_override or self.reduction,
            avg_factor)


@LOSSES.register_module()
class QualityFocalLoss:
    """GFL's quality focal loss (``:387-417``): ``pred`` (..., C) logits,
    ``target`` the pair (labels (...,), scores (...,)). Every class column
    is a negative (target 0, modulated by ``sigmoid ** beta``) but the
    positive's label column (label in [0, C)), whose target is its score,
    modulated by ``|score - sigmoid| ** beta``; summed over the classes. The
    scores keep their gradient (the JAX heads pass them undetached)."""

    def __init__(self, use_sigmoid: bool = True, beta: float = 2.0,
                 reduction: str = "mean", loss_weight: float = 1.0, **kw):
        if not use_sigmoid:
            raise NotImplementedError("QualityFocalLoss takes use_sigmoid=True only")
        self.beta = beta
        self.reduction = reduction
        self.loss_weight = loss_weight

    def __call__(self, pred, target, weight=None, avg_factor=None,
                 reduction_override=None, **kw):
        labels, scores = target
        nc = pred.shape[-1]
        sig = torch.sigmoid(pred)
        loss = binary_cross_entropy_with_logits(pred, torch.zeros_like(pred)) * sig ** self.beta
        pos = labels < nc
        col = torch.where(pos, labels, torch.zeros_like(labels)).long()
        onehot = torch.zeros_like(pred).scatter_(-1, col.clamp(0, nc - 1)[..., None], 1.0)
        onehot = onehot * (col >= 0)[..., None]
        soft = onehot * scores[..., None]
        pos_loss = binary_cross_entropy_with_logits(pred, soft) * (soft - sig).abs() ** self.beta
        loss = torch.where((onehot > 0) & pos[..., None], pos_loss, loss).sum(dim=-1)
        return self.loss_weight * weight_reduce_loss(
            loss, weight, reduction_override or self.reduction, avg_factor)


@LOSSES.register_module()
class DistributionFocalLoss:
    """GFL's distribution focal loss (``:420-437``): cross entropy of the
    (..., n) bin logits against the two integer bins ``floor(t)`` and
    ``floor(t) + 1`` bracketing the continuous target ``t``, weighted by
    their distances to it, each bin index clipped to [0, n - 1]."""

    def __init__(self, reduction: str = "mean", loss_weight: float = 1.0, **kw):
        self.reduction = reduction
        self.loss_weight = loss_weight

    def __call__(self, pred, label, weight=None, avg_factor=None,
                 reduction_override=None, **kw):
        nc = pred.shape[-1]
        dl = torch.floor(label).long()
        dr = dl + 1
        wl = dr.to(pred.dtype) - label
        wr = label - dl.to(pred.dtype)
        logp = torch.log_softmax(pred, dim=-1)
        ll = -torch.gather(logp, -1, dl.clamp(0, nc - 1)[..., None])[..., 0]
        lr = -torch.gather(logp, -1, dr.clamp(0, nc - 1)[..., None])[..., 0]
        return self.loss_weight * weight_reduce_loss(
            ll * wl + lr * wr, weight, reduction_override or self.reduction, avg_factor)


def _center_dist2_and_enclose(pred, target):
    """Squared centre distance and the enclosing box's squared diagonal
    (floored at 1e-6), ``:466-478``."""
    px = (pred[..., 0] + pred[..., 2]) * 0.5
    py = (pred[..., 1] + pred[..., 3]) * 0.5
    tx = (target[..., 0] + target[..., 2]) * 0.5
    ty = (target[..., 1] + target[..., 3]) * 0.5
    rho2 = (px - tx) ** 2 + (py - ty) ** 2
    ex1 = torch.minimum(pred[..., 0], target[..., 0])
    ey1 = torch.minimum(pred[..., 1], target[..., 1])
    ex2 = torch.maximum(pred[..., 2], target[..., 2])
    ey2 = torch.maximum(pred[..., 3], target[..., 3])
    c2 = (ex2 - ex1) ** 2 + (ey2 - ey1) ** 2
    return rho2, torch.maximum(c2, c2.new_full((), 1e-6))


@LOSSES.register_module()
class DIoULoss:
    """Distance-IoU (``:481-500``): ``1 - iou + rho^2 / c^2``."""

    def __init__(self, eps: float = 1e-6, reduction: str = "mean",
                 loss_weight: float = 1.0, **kw):
        self.eps = eps
        self.reduction = reduction
        self.loss_weight = loss_weight

    def _loss(self, pred, target, ious):
        rho2, c2 = _center_dist2_and_enclose(pred, target)
        return 1 - ious + rho2 / c2

    def __call__(self, pred, target, weight=None, avg_factor=None,
                 reduction_override=None, **kw):
        loss = self._loss(pred, target, bbox_overlaps(pred, target, is_aligned=True))
        return self.loss_weight * weight_reduce_loss(
            loss, _box_weight(weight, loss), reduction_override or self.reduction,
            avg_factor)


@LOSSES.register_module()
class CIoULoss(DIoULoss):
    """Complete-IoU (``:503-523``): DIoU plus ``alpha * v``, the aspect
    term ``v`` with its weight ``alpha`` detached."""

    def _loss(self, pred, target, ious):
        floor = pred.new_full((), 1e-6)
        pw = torch.maximum(pred[..., 2] - pred[..., 0], floor)
        ph = torch.maximum(pred[..., 3] - pred[..., 1], floor)
        tw = torch.maximum(target[..., 2] - target[..., 0], floor)
        th = torch.maximum(target[..., 3] - target[..., 1], floor)
        v = (4 / math.pi ** 2) * (torch.atan(tw / th) - torch.atan(pw / ph)) ** 2
        alpha = v / torch.maximum(1 - ious + v, floor)
        return super()._loss(pred, target, ious) + alpha.detach() * v


@LOSSES.register_module()
class GaussianFocalLoss:
    """The focal loss on gaussian heatmaps (``:444-464``): ``pred`` holds
    probabilities; a cell is positive only where its target is exactly 1,
    ``-log(p + eps) (1 - p)^alpha``; every other cell
    ``-log(1 - p + eps) p^alpha (1 - t)^gamma``; eps 1e-12."""

    def __init__(self, alpha: float = 2.0, gamma: float = 4.0, reduction: str = "mean",
                 loss_weight: float = 1.0, **kw):
        self.alpha, self.gamma = alpha, gamma
        self.reduction = reduction
        self.loss_weight = loss_weight

    def __call__(self, pred, gaussian_target, weight=None, avg_factor=None,
                 reduction_override=None, **kw):
        eps = 1e-12
        pos = (gaussian_target == 1).to(pred.dtype)
        neg_w = (1 - gaussian_target) ** self.gamma
        loss = (-torch.log(pred + eps) * (1 - pred) ** self.alpha * pos
                - torch.log(1 - pred + eps) * pred ** self.alpha * neg_w * (1 - pos))
        return self.loss_weight * weight_reduce_loss(
            loss, weight, reduction_override or self.reduction, avg_factor)
