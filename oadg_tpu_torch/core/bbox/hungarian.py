"""Hungarian assignment of set-prediction heads (port of
``oadg_tpu/core/bbox/hungarian.py``; mmdet's ``hungarian_assigner.py`` and
``match_costs``).

The cost is built on the device: ``cls_w * -prob[gt] + reg_w * L1`` of the
normalized cxcywh boxes ``+ iou_w * -GIoU`` of the absolute ones (``:187-202``);
padded gts cost 1e6 and are cut by the valid count. The matching itself is
exact ``scipy.optimize.linear_sum_assignment`` on the host, on the CPU and on
the card alike (one device-to-host copy of the (B, Q, G) cost a call): the
JAX package runs scipy only on the CPU (a host callback, ``:208-212``) and
an auction on the TPU, whose backend has no host callbacks; CUDA has them,
so the port keeps mmdet's exact semantics everywhere. Matches to padded gts
are dropped (``:219-222``).

``auction_assign`` (``:61``), the JAX package's TPU matcher, is here in
plain tensor ops, off the main path: its ``while_loop`` becomes a Python
loop with one host read of the "any gt unassigned" flag a sweep.
"""
from __future__ import annotations

import numpy as np
import torch

from ...utils.registry import BBOX_ASSIGNERS
from .geometry import bbox_overlaps


def lsa_host(cost: np.ndarray, num_valid: int) -> np.ndarray:
    """``_lsa_host`` (``:21``): cost (Q, G), the valid gts in front ->
    assigned (Q,) int32: 0 unmatched, j + 1 matched to gt j."""
    from scipy.optimize import linear_sum_assignment
    out = np.zeros((cost.shape[0],), np.int32)
    if num_valid > 0:
        rows, cols = linear_sum_assignment(np.asarray(cost[:, :num_valid], np.float64))
        out[rows] = cols.astype(np.int32) + 1
    return out


def auction_assign(cost: torch.Tensor, gt_valid: torch.Tensor, eps_rel: float = 2e-4,
                   max_sweeps: int = 30000) -> torch.Tensor:
    """Bertsekas' forward auction with Jacobi bidding (``:61-162``): cost
    (Q, G) float32, gt_valid (G,) bool -> (Q,) int64 codes (0 unmatched, j +
    1 matched to gt j), within ``n_valid * eps`` of the optimal total. Every
    unassigned valid gt bids for its best row each sweep; a row goes to its
    highest bid. The loop's condition is read on the host once a sweep (the
    JAX ``while_loop`` keeps it on the device); a greedy completion makes
    the result feasible if ``max_sweeps`` is hit."""
    q, g = cost.shape
    dev = cost.device
    neg = -1e9
    valid = gt_valid.bool()
    b = torch.where(valid[None, :], -cost.float(), torch.full_like(cost, neg, dtype=torch.float32))
    scale = torch.clamp(torch.where(valid[None, :], cost.abs(), torch.zeros_like(cost)).max(),
                        min=1e-3).float()
    eps = eps_rel * scale
    rows = torch.arange(q, device=dev)
    cols = torch.arange(g, device=dev)
    p = torch.zeros(q, device=dev)
    owner_row = torch.full((q,), -1, dtype=torch.long, device=dev)
    row_of = torch.full((g,), -1, dtype=torch.long, device=dev)
    for _ in range(max_sweeps):
        unass = valid & (row_of < 0)
        if not bool(unass.any()):
            break
        vals = b - p[:, None]
        w1, i_star = vals.max(0)
        vals2 = vals.clone()
        vals2[i_star, cols] = neg
        w2 = vals2.max(0).values
        w2 = torch.where(w2 > neg / 2, w2, w1 - scale)
        bid = p[i_star] + (w1 - w2) + eps
        bid_mat = torch.where((rows[:, None] == i_star[None, :]) & unass[None, :],
                              bid[None, :], torch.full_like(vals, neg))
        win_bid, win_gt = bid_mat.max(1)
        won = win_bid > neg / 2
        loser = torch.where(won & (owner_row >= 0), owner_row, torch.full_like(owner_row, g))
        row_of = torch.cat([row_of, row_of.new_zeros(1)])
        row_of[loser] = -1
        row_of = row_of[:g]
        owner_row = torch.where(won, win_gt, owner_row)
        p = torch.where(won, win_bid, p)
        tgt = torch.where(won, win_gt, torch.full_like(win_gt, g))
        row_of = torch.cat([row_of, row_of.new_zeros(1)])
        row_of[tgt] = rows
        row_of = row_of[:g]
    taken = torch.zeros(q + 1, dtype=torch.bool, device=dev)
    taken[torch.where(row_of >= 0, row_of, torch.full_like(row_of, q))] = True
    taken = taken[:q]
    for j in range(g):                       # greedy completion (a no-op when converged)
        if bool(valid[j]) and int(row_of[j]) < 0:
            i = int(torch.argmin(torch.where(taken, torch.full_like(cost[:, j], 1e9),
                                             cost[:, j])))
            row_of[j] = i
            taken[i] = True
    assigned = torch.zeros(q + 1, dtype=torch.long, device=dev)
    assigned[torch.where(valid & (row_of >= 0), row_of, torch.full_like(row_of, q))] = cols + 1
    return assigned[:q]


def cxcywh_to_xyxy(b: torch.Tensor) -> torch.Tensor:
    cx, cy, w, h = b.unbind(-1)
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)


def xyxy_to_cxcywh(b: torch.Tensor) -> torch.Tensor:
    x1, y1, x2, y2 = b.unbind(-1)
    return torch.stack([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1], -1)


@BBOX_ASSIGNERS.register_module()
class HungarianAssigner:
    """``cls_cost``: -prob[gt]; ``reg_cost``: L1 of the normalized cxcywh
    boxes; ``iou_cost``: -GIoU; weights 1, 5, 2 unless given (``:176-185``)."""

    def __init__(self, cls_cost=None, reg_cost=None, iou_cost=None, **kw):
        def w(c, default):
            return float(dict(c or {}).get("weight", default))
        self.cls_w = w(cls_cost, 1.0)
        self.reg_w = w(reg_cost, 5.0)
        self.iou_w = w(iou_cost, 2.0)

    def cost(self, cls_prob, bbox_cxcywh_norm, gt_bboxes, gt_valid, gt_labels, factor):
        """(B, Q, C + 1) probabilities, (B, Q, 4) normalized cxcywh boxes,
        (B, G, 4) absolute xyxy gts, their (B, G) validity and labels, (B,
        4) ``[w, h, w, h]`` -> (B, Q, G) float32 costs, padded gts at 1e6."""
        f = factor[:, None, :]
        gt_norm = xyxy_to_cxcywh(gt_bboxes / f)
        lab = gt_labels.long().clamp(0, cls_prob.shape[-1] - 1)
        cls_cost = -torch.gather(cls_prob, 2, lab[:, None, :].expand(-1, cls_prob.shape[1], -1))
        reg_cost = (bbox_cxcywh_norm[:, :, None] - gt_norm[:, None]).abs().sum(-1)
        pred_xyxy = cxcywh_to_xyxy(bbox_cxcywh_norm) * f
        iou_cost = -bbox_overlaps(pred_xyxy, gt_bboxes, mode="giou")
        cost = self.cls_w * cls_cost + self.reg_w * reg_cost + self.iou_w * iou_cost
        return torch.where(gt_valid[:, None, :], cost, torch.full_like(cost, 1e6)).float()

    def assign(self, cls_prob, bbox_cxcywh_norm, gt_bboxes, gt_valid, gt_labels, factor):
        """``cost``'s arguments -> (B, Q) int64 codes (0 negative, j + 1
        matched to gt j): scipy's exact assignment of each image's cost
        over its valid gts, in one copy to the host and one back."""
        with torch.no_grad():
            cost = self.cost(cls_prob, bbox_cxcywh_norm, gt_bboxes, gt_valid, gt_labels, factor)
            host = cost.cpu().numpy()
            counts = gt_valid.sum(-1).cpu().numpy()
            assigned = torch.from_numpy(np.stack([lsa_host(c, int(n))
                                                  for c, n in zip(host, counts)])).long()
            assigned = assigned.to(cost.device)
            g = gt_bboxes.shape[1]
            matched = (assigned - 1).clamp(0, g - 1)
            keep = (assigned > 0) & torch.gather(gt_valid, 1, matched)
            return torch.where(keep, assigned, torch.zeros_like(assigned))
