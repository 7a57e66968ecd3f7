"""OA-Loss (port of ``oadg_tpu/models/losses/oadg.py:37-230``): supervised
losses on the first view's chunk, JSD consistency across views and the
supervised-contrastive loss.

Rules held to the JAX package:
- rows are views-major ``[view 1; view 2; ...]``; CE, SmoothL1 and L1 take
  the first chunk, and the given ``avg_factor`` (counted over all views) is
  used as it is;
- JSD runs over every row, unweighted: sigmoid -> (p, 1 - p) for one-logit
  RPN scores, softmax otherwise; the mixture is clamped to [1e-7, 1]; the
  summed mean KL is divided by ``avg_factor``;
- ``supcontrast``: anchor pairs are same-class foreground pairs (not self)
  and same-instance background pairs across views; contrast pairs are all
  valid pairs but self; the row max is detached; the loss is 0 unless there
  are more than ``min_samples`` foreground rows.
Every shape is static: "too few foregrounds" is a ``torch.where``.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from ...parallel import batch_is_sharded, gather_rows, get_dist_info
from ...utils.registry import LOSSES
from .common import (binary_cross_entropy_with_logits, l1, smooth_l1,
                     softmax_cross_entropy, weight_reduce_loss)

__all__ = ["jsd_consistency", "supcontrast", "CrossEntropyLossPlus",
           "SmoothL1LossPlus", "L1LossPlus", "ContrastiveLossPlus"]


def _view1(x: Optional[torch.Tensor], num_views: int):
    """First chunk of a views-major tensor."""
    if x is None:
        return None
    return x[: x.shape[0] // num_views]


def _clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip``: max then min, ties splitting the gradient."""
    return torch.minimum(torch.maximum(x, x.new_tensor(lo)), x.new_tensor(hi))


def jsd_consistency(pred: torch.Tensor, num_views: int, avg_factor) -> torch.Tensor:
    """Mean KL of each view to the clamped mixture, summed over rows and
    classes, divided by ``avg_factor``."""
    chunks = torch.chunk(pred, num_views, dim=0)
    if pred.shape[-1] == 1:
        ps = [torch.cat([torch.sigmoid(c), 1 - torch.sigmoid(c)], dim=-1)
              for c in chunks]
    else:
        ps = [torch.softmax(c, dim=-1) for c in chunks]
    mix = sum(ps) / num_views
    log_mix = torch.log(_clip(mix, 1e-7, 1.0))
    kl = sum(p * (torch.log(_clip(p, 1e-12, 1.0)) - log_mix) for p in ps) / num_views
    return kl.sum() / avg_factor


@LOSSES.register_module()
class CrossEntropyLossPlus:
    """CE on the first view + ``lambda_weight`` x JSD across views."""

    def __init__(self, use_sigmoid: bool = False, reduction: str = "mean",
                 ignore_index=None, loss_weight: float = 1.0,
                 additional_loss: str = "jsd", lambda_weight: float = 0.0001,
                 num_views: int = 3, avg: str = "1.0", **kw):
        self.use_sigmoid = use_sigmoid
        self.reduction = reduction
        self.loss_weight = loss_weight
        self.ignore_index = -100 if ignore_index is None else ignore_index
        self.additional_loss = additional_loss
        self.lambda_weight = lambda_weight
        self.num_views = num_views
        self.avg = avg

    def __call__(self, cls_score, label, weight=None, avg_factor=None,
                 reduction_override=None):
        red = reduction_override or self.reduction
        v = self.num_views
        pred1, label1, weight1 = (_view1(cls_score, v), _view1(label, v),
                                  _view1(weight, v))
        af = avg_factor / v if self.avg == "1.1" else avg_factor
        if self.use_sigmoid:
            if cls_score.dim() != label.dim():
                nc = cls_score.shape[-1]
                valid = (label1 >= 0) & (label1 != self.ignore_index)
                onehot = torch.zeros_like(pred1).scatter_(
                    -1, label1.clamp(0, nc - 1)[..., None].long(), 1.0)
                onehot = onehot * ((label1 >= 0) & (label1 < nc))[..., None]
                w = valid[..., None].float()
                if weight1 is not None:
                    w = w * weight1[..., None]
                loss_cls = weight_reduce_loss(
                    binary_cross_entropy_with_logits(pred1, onehot), w, red, af)
            else:
                loss_cls = weight_reduce_loss(
                    binary_cross_entropy_with_logits(pred1, label1.float()),
                    weight1, red, af)
        else:
            loss_cls = weight_reduce_loss(
                softmax_cross_entropy(pred1, label1, self.ignore_index),
                weight1, red, af)
        loss = self.loss_weight * loss_cls
        if self.additional_loss in ("jsdv1_3", "jsdv1_3_2aug", "jsd"):
            loss = loss + self.lambda_weight * jsd_consistency(
                cls_score, v, avg_factor)
        return loss


class _RegPlusBase:
    def __init__(self, reduction: str = "mean", loss_weight: float = 1.0,
                 num_views: int = 3, **kw):
        self.reduction = reduction
        self.loss_weight = loss_weight
        self.num_views = num_views

    def _elementwise(self, pred, target):
        raise NotImplementedError

    def __call__(self, pred, target, weight=None, avg_factor=None,
                 reduction_override=None):
        v = self.num_views
        loss = self._elementwise(_view1(pred, v), _view1(target, v))
        return self.loss_weight * weight_reduce_loss(
            loss, _view1(weight, v), reduction_override or self.reduction,
            avg_factor)


@LOSSES.register_module()
class SmoothL1LossPlus(_RegPlusBase):
    def __init__(self, beta: float = 1.0, **kw):
        super().__init__(**kw)
        self.beta = beta

    def _elementwise(self, pred, target):
        return smooth_l1(pred, target, self.beta)


@LOSSES.register_module()
class L1LossPlus(_RegPlusBase):
    def _elementwise(self, pred, target):
        return l1(pred, target)


def _global_rows(layouts: Sequence[Sequence[int]], rank: int, device) -> torch.Tensor:
    """The positions of rank ``rank``'s rows (layout ``layouts[rank] = (R,
    V, P)``) in the global layout ``(sum R, V, sum P)`` of every rank's
    ``layouts``: each block views-major, the ranks in order inside each
    view."""
    big_r = sum(lay[0] for lay in layouts)
    big_p = sum(lay[2] for lay in layouts)
    r, v, p = layouts[rank]
    r0 = sum(lay[0] for lay in layouts[:rank])
    p0 = sum(lay[2] for lay in layouts[:rank])
    views = torch.arange(v, device=device)[:, None]
    roi = views * big_r + r0 + torch.arange(r, device=device)[None, :]
    rnd = v * big_r + views * big_p + p0 + torch.arange(p, device=device)[None, :]
    return torch.cat([roi.reshape(-1), rnd.reshape(-1)])


def supcontrast(feats: torch.Tensor, labels: torch.Tensor, valid: torch.Tensor,
                layout: Sequence[int], temper: float = 0.07,
                min_samples: int = 10) -> torch.Tensor:
    """Supervised contrastive loss over L2-normalized rows.

    Args:
        feats: (N, D), rows ``[R roi rows x V views; P random rows x V views]``
            with ``layout = (R, V, P)``.
        labels: (N,) int; background is the largest valid label.
        valid: (N,) bool; padding rows are in no pair.

    On a rank's shard of the global batch (``parallel.batch_is_sharded``)
    each rank passes its own rows: they are gathered from every rank
    (``parallel.gather_rows``) into the global batch's layout ``(sum R, V,
    sum P)`` of the ranks' layouts (one ``all_gather`` of the layouts; the
    ranks' ``V`` must agree), the background label, the ``min_samples``
    gate and the valid-row divisor are the global batch's, and the rank
    returns its share of the global loss (its own rows' terms, each against
    every gathered row).
    """
    r, v, p = layout
    n = feats.shape[0]
    if n != r * v + p * v:
        raise ValueError(f"{n} rows do not match the layout {tuple(layout)}")
    dev = feats.device
    rows = torch.arange(n, device=dev)           # this rank's rows in the layout
    if batch_is_sharded():
        rank, world = get_dist_info()
        layouts = [(r, v, p)]
        if world > 1:
            layouts = [tuple(lay) for lay in gather_rows(
                torch.tensor([[r, v, p]], device=dev), [1] * world).tolist()]
            if any(lay[1] != v for lay in layouts):
                raise ValueError(f"supcontrast: the ranks' layouts {layouts} differ in views")
        sizes = [(lay[0] + lay[2]) * v for lay in layouts]
        feats = gather_rows(feats, sizes)
        tags = gather_rows(torch.stack([labels.long(), valid.long()], 1), sizes)
        labels, valid = tags[:, 0], tags[:, 1] > 0
        if world > 1:
            # the gathered rows are rank-major: put them in the global layout
            src = torch.cat([_global_rows(layouts, k, dev) for k in range(world)])
            lo = sum(sizes[:rank])
            rows = src[lo:lo + n]
            n = feats.shape[0]
            order = torch.empty_like(src)
            order[src] = torch.arange(n, device=dev)
            feats, labels, valid = feats[order], labels[order], valid[order]
            r, p = sum(lay[0] for lay in layouts), sum(lay[2] for lay in layouts)
    norm = feats.norm(dim=1, keepdim=True)
    x = feats / torch.maximum(norm, norm.new_tensor(1e-12))

    bg_label = torch.where(valid, labels, torch.full_like(labels, -1)).max()
    fg = (labels != bg_label) & valid
    bgm = (labels == bg_label) & valid

    idx = torch.arange(n, device=dev)

    def geometry(i):
        block = (i >= r * v).long()                     # 0 roi rows, 1 random rows
        within = torch.where(block == 0, i, i - r * v)
        size = torch.where(block == 0, torch.full_like(i, max(r, 1)),
                           torch.full_like(i, max(p, 1)))
        return block, within % size, within // size

    block, inst, view = geometry(idx)
    rblock, rinst, rview = geometry(rows)
    same_inst = ((rblock[:, None] == block[None, :]) & (rinst[:, None] == inst[None, :])
                 & (rview[:, None] != view[None, :]))
    rvalid, rlabels, rfg, rbgm = valid[rows], labels[rows], fg[rows], bgm[rows]
    mask_anchor_bg = same_inst & rbgm[:, None] & bgm[None, :]
    eye = rows[:, None] == idx[None, :]
    pair_valid = rvalid[:, None] & valid[None, :]
    same_label = (rlabels[:, None] == labels[None, :]) & pair_valid
    mask_anchor_fg = same_label & ~eye & rfg[:, None] & fg[None, :]
    mask_anchor = (mask_anchor_fg | mask_anchor_bg).float()
    mask_contrast = ~eye & pair_valid

    logits = (x[rows] @ x.t()) / temper
    logits = logits.masked_fill(~mask_contrast, float("-inf"))
    row_max = logits.max(dim=1, keepdim=True).values
    row_max = torch.where(torch.isfinite(row_max), row_max, torch.zeros_like(row_max))
    z = logits - row_max.detach()
    exp_z = torch.where(mask_contrast, torch.exp(z), torch.zeros_like(z))
    denom = exp_z.sum(1, keepdim=True)
    log_prob = z - torch.log(torch.maximum(denom, denom.new_tensor(1e-12)))
    log_prob = torch.where(mask_contrast, log_prob, torch.zeros_like(log_prob))
    per_row = -(mask_anchor * log_prob).sum(1) / (mask_anchor.sum(1) + 1e-8)
    loss = (torch.where(rvalid, per_row, torch.zeros_like(per_row)).sum()
            / torch.clamp_min(valid.sum(), 1))
    return torch.where(fg.sum() > min_samples, loss, torch.zeros_like(loss))


@LOSSES.register_module()
class ContrastiveLossPlus:
    """``loss_weight`` x ``supcontrast`` at ``temperature``."""

    def __init__(self, loss_weight: float = 1.0, temperature: float = 0.07,
                 num_views: int = 2, min_samples: int = 10, **kw):
        self.loss_weight = loss_weight
        self.temperature = temperature
        self.num_views = num_views
        self.min_samples = min_samples

    def __call__(self, cont_feats, labels, valid, layout):
        return self.loss_weight * supcontrast(
            cont_feats, labels, valid, layout, temper=self.temperature,
            min_samples=self.min_samples)
