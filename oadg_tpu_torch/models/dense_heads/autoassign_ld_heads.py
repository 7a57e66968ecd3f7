"""AutoAssign head and detector (port of the AutoAssign part of
``oadg_tpu/models/dense_heads/autoassign_ld_heads.py:32-114,217``; its LD,
LAD, NAS-FCOS and PISA heads are not ported).

``FCOSHead``'s towers and outputs (the centerness conv is the objectness),
plus ``center_prior``: a learned per-class Gaussian centre prior, ``mean``
(C, 2) at 0 and ``sigma`` (C, 2) at 1 (mmdet's ``CenterPrior`` keys).

- ``loss`` (``:51-114``), fully differentiable, per image: the prior
  ``g = exp(-((d / stride - mean) / sigma) ** 2 / 2)`` of each point inside
  a gt (``|sigma|`` floored at 0.01), the positive confidence
  ``p_cls * exp(-5 (1 - IoU))`` with ``p = sigmoid(cls) * sigmoid(obj)``,
  the bag weights ``g * exp(confidence / temperature)`` normalized over the
  gt's points; ``loss_pos`` the bag's ``-log`` per gt, ``loss_neg`` the
  focal-style ``p^2 -log(1 - p)`` of every class of every point, ``p``
  discounted by the point's best IoU inside a gt (``1 - (1 / (1 - IoU) -
  1) / (max - 1)``), ``loss_center`` the ``-log`` of each gt's mean prior;
  each over the batch's gts, times 0.25, 0.75 and 0.75.
- ``get_bboxes``: ``FCOSHead``'s, the objectness as the centerness.
"""
from __future__ import annotations

import torch
from torch import nn

from ...core.bbox.geometry import bbox_overlaps
from ...core.bbox.transforms import distance2bbox
from ...parallel import shard_sum
from ...utils.registry import DETECTORS, HEADS
from ..detectors.single_stage import SingleStageDetector
from .fcos_head import FCOSHead, level_points
from .retina_head import _flatten


def _clip(x: torch.Tensor, lo=None, hi=None) -> torch.Tensor:
    """``jnp.clip``: ``minimum(maximum(x, lo), hi)`` (ties split the
    gradient, as in JAX)."""
    if lo is not None:
        x = torch.maximum(x, x.new_full((), lo))
    if hi is not None:
        x = torch.minimum(x, x.new_full((), hi))
    return x


class CenterPrior(nn.Module):
    """Per-class Gaussian centre prior: ``mean`` and ``sigma`` (C, 2)."""

    def __init__(self, num_classes: int, device=None):
        super().__init__()
        self.mean = nn.Parameter(torch.zeros(num_classes, 2, device=device))
        self.sigma = nn.Parameter(torch.ones(num_classes, 2, device=device))


@HEADS.register_module()
class AutoAssignHead(FCOSHead):

    def __init__(self, pos_loss_weight: float = 0.25, neg_loss_weight: float = 0.75,
                 center_loss_weight: float = 0.75, temperature: float = 1.0 / 3.0, **kwargs):
        super().__init__(**kwargs)
        self.pos_loss_weight = pos_loss_weight
        self.neg_loss_weight = neg_loss_weight
        self.center_loss_weight = center_loss_weight
        self.temperature = temperature
        self.center_prior = CenterPrior(self.num_classes, kwargs.get("device"))

    def loss(self, outs, gt_bboxes, gt_valid, gt_labels, draws=None):
        """``loss_pos``, ``loss_neg``, ``loss_center`` of N images; ``draws``
        is unused."""
        cls_scores, bbox_preds, objs = outs
        sizes = [tuple(s.shape[-2:]) for s in cls_scores]
        points, lvl = level_points(sizes, self.strides, cls_scores[0].device)
        strides = torch.tensor(self.strides, dtype=torch.float32, device=points.device)[lvl]
        cls = _flatten(cls_scores, self.num_classes).float()
        boxes = distance2bbox(points, _flatten(bbox_preds, 4))
        obj = _flatten(objs, 1)[..., 0].float()
        prob = torch.sigmoid(cls) * torch.sigmoid(obj)[..., None]               # (N, P, C)
        valid = gt_valid[:, None, :]
        gt = gt_bboxes[:, None]                                               # (N, 1, G, 4)
        px, py = points[:, 0, None], points[:, 1, None]
        inside = ((px >= gt[..., 0]) & (px <= gt[..., 2]) & (py >= gt[..., 1])
                  & (py <= gt[..., 3])) & valid                               # (N, P, G)
        zero = cls.new_zeros(())
        labels = gt_labels.long().clamp(0, self.num_classes - 1)              # padded gts: any
        mu = self.center_prior.mean[labels][:, None]                         # (N, 1, G, 2)
        sig = _clip(self.center_prior.sigma[labels].abs(), 1e-2)[:, None]
        dx = (px - (gt[..., 0] + gt[..., 2]) * 0.5) / strides[:, None] - mu[..., 0]
        dy = (py - (gt[..., 1] + gt[..., 3]) * 0.5) / strides[:, None] - mu[..., 1]
        g = torch.where(inside, torch.exp(-0.5 * ((dx / sig[..., 0]) ** 2
                                                  + (dy / sig[..., 1]) ** 2)), zero)
        ious = bbox_overlaps(boxes, gt_bboxes)                                # (N, P, G)
        p_pos = (torch.gather(prob, 2, labels[:, None, :].expand(-1, prob.shape[1], -1))
                 * torch.exp(-5.0 * (1 - ious)))
        w = torch.where(inside, g * torch.exp(p_pos / self.temperature), zero)
        w = w / _clip(w.sum(1, keepdim=True), 1e-12)
        bag = (w * p_pos).sum(1)                                              # (N, G)
        gv = gt_valid.float()
        pos_loss = (-torch.log(_clip(bag, 1e-12, 1.0)) * gv).sum()
        fiou = torch.where(inside, ious, zero).amax(-1)                       # (N, P)
        disc = _clip(1.0 / (1 - _clip(fiou, 0.0, 0.99)), 1.0)
        wneg = _clip(1 - (disc - 1) / _clip(disc.amax(-1, keepdim=True) - 1, 1e-6), 0.0, 1.0)
        neg_p = prob * wneg[..., None]
        neg_loss = (neg_p ** 2 * -torch.log(_clip(1 - neg_p, 1e-12, 1.0))).sum()
        ctr = (-torch.log(_clip(g.sum(1) / _clip(inside.sum(1).float(), 1.0), 1e-12, 1.0))
               * gv).sum()
        num_gts = _clip(shard_sum(gv.sum()), 1.0)
        return dict(loss_pos=self.pos_loss_weight * pos_loss / num_gts,
                    loss_neg=self.neg_loss_weight * neg_loss / num_gts,
                    loss_center=self.center_loss_weight * ctr / num_gts)


@DETECTORS.register_module()
class AutoAssign(SingleStageDetector):
    """``autoassign_ld_heads.py:217``."""
