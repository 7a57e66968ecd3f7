"""Assigner and sampler as static-shape masked tensor ops (port of
``oadg_tpu/core/bbox/assign_sample.py``: ``MaxIoUAssigner`` ``:85-172``,
``RandomSampler`` ``:219-305``, ``_random_rank`` ``:175``).

Every function takes leading batch dimensions where the JAX package vmaps
over images. Assignment codes match mmdet: -1 ignore, 0 negative, j + 1
matched gt j. The samplers draw nothing themselves: they take uniform
[0, 1) draws (``utils/draws.py``), so that a test can hand them the numbers
``jax.random.uniform`` drew. ``topk_large`` (``:22``), a TPU decomposition
of top-k, is ``torch.topk``; argsorts are stable, as ``jnp.argsort`` is.

``GridAssigner`` (``:444-454``, the config's entry) carries YOLOv3's grid
assignment, which the JAX package computes in its head
(``oadg_tpu/models/dense_heads/yolo_head.py:140-183``), as ``assign``.

``ApproxMaxIoUAssigner`` (``:758-779``) is SABL's: the IoU of a location
is the largest of its approx anchors'.

``ATSSAssigner`` (``:371-441``) and ``TaskAlignedAssigner`` (``:477-520``,
with ``_per_gt_topk_mask`` and ``_rank_matrix_desc``, ``:456-474``) are the
one-stage family's. Their candidate sets are masks against a k-th value
(ATSS's ``d <= kth distance``), never top-k indices: anchor centres on a
regular grid tie exactly, and ``torch.topk`` promises no order among ties
on the card. Ranks come from a stable sort (ties to the lower index, as
``jnp.argsort``), a row's gt from ``argmax`` (the first maximum).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ...utils.registry import BBOX_ASSIGNERS, BBOX_SAMPLERS
from .geometry import bbox_overlaps


class AssignResult(NamedTuple):
    gt_inds: torch.Tensor       # (..., N) int64: -1 ignore / 0 neg / j + 1 pos
    max_overlaps: torch.Tensor  # (..., N) float32
    labels: torch.Tensor        # (..., N) int64 label of the match, -1 otherwise


class SamplingResult(NamedTuple):
    """``num`` sampled candidates per image: positives first, then
    negatives, then arbitrary rows that ``valid`` masks."""
    inds: torch.Tensor          # (..., num) indices into the candidates
    is_pos: torch.Tensor        # (..., num) bool
    valid: torch.Tensor         # (..., num) bool
    gt_inds: torch.Tensor       # (..., num) assignment code of each row
    labels: torch.Tensor        # (..., num) matched gt label of each row


def _gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[..., idx]`` along the last dim, batched."""
    return torch.gather(x, -1, idx)


@BBOX_ASSIGNERS.register_module()
class MaxIoUAssigner:
    """Static-shape MaxIoU assignment; arguments as the config names them."""

    def __init__(self, pos_iou_thr: float, neg_iou_thr, min_pos_iou: float = .0,
                 gt_max_assign_all: bool = True, ignore_iof_thr: float = -1,
                 ignore_wrt_candidates: bool = True,
                 match_low_quality: bool = True, gpu_assign_thr: int = -1,
                 iou_calculator=None):
        self.pos_iou_thr = pos_iou_thr
        self.neg_iou_thr = neg_iou_thr
        self.min_pos_iou = min_pos_iou
        self.gt_max_assign_all = gt_max_assign_all
        self.match_low_quality = match_low_quality

    def assign(self, bboxes: torch.Tensor, gt_bboxes: torch.Tensor,
               gt_valid: torch.Tensor, gt_labels: Optional[torch.Tensor] = None,
               box_valid: Optional[torch.Tensor] = None,
               thr: Optional[torch.Tensor] = None) -> AssignResult:
        """Assign (..., N, 4) candidates to (..., G, 4) padded gts.

        ``gt_valid`` (..., G) marks real gts (a padded gt overlaps nothing,
        so an image without gts is all negative); ``box_valid`` (..., N)
        marks real candidates (the rest are ignored). ``thr``, where given,
        stands for all three thresholds (``pos_iou_thr``, ``neg_iou_thr``,
        ``min_pos_iou``) in this call only: Dynamic R-CNN's threshold, a
        tensor computed in the step."""
        ious = bbox_overlaps(bboxes, gt_bboxes)                 # (..., N, G)
        ious = torch.where(gt_valid[..., None, :], ious, torch.zeros_like(ious))
        return self.assign_from_ious(ious, gt_valid, gt_labels, box_valid, thr)

    def assign_from_ious(self, ious: torch.Tensor, gt_valid: torch.Tensor,
                         gt_labels: Optional[torch.Tensor] = None,
                         box_valid: Optional[torch.Tensor] = None,
                         thr: Optional[torch.Tensor] = None) -> AssignResult:
        n, g = ious.shape[-2:]
        pos_thr, neg_thr, min_pos = ((self.pos_iou_thr, self.neg_iou_thr, self.min_pos_iou)
                                     if thr is None else (thr, thr, thr))
        max_overlaps = ious.max(dim=-1).values
        argmax = ious.argmax(dim=-1)                            # first maximum
        assigned = torch.full_like(argmax, -1)
        if isinstance(neg_thr, (tuple, list)):
            lo, hi = neg_thr
            neg = (max_overlaps >= lo) & (max_overlaps < hi)
        else:
            neg = (max_overlaps >= 0) & (max_overlaps < neg_thr)
        assigned = torch.where(neg, torch.zeros_like(assigned), assigned)
        assigned = torch.where(max_overlaps >= pos_thr, argmax + 1, assigned)
        if self.match_low_quality:
            # every candidate at a gt's maximum IoU goes to that gt; the
            # reference loops over gts in order, so the highest index wins
            gt_max = ious.max(dim=-2, keepdim=True).values      # (..., 1, G)
            cond = ((ious == gt_max) & gt_valid[..., None, :]
                    & (gt_max >= min_pos) & (gt_max > 0))
            if not self.gt_max_assign_all:
                rows = torch.arange(n, device=ious.device)[:, None]
                cond = cond & (rows == ious.argmax(dim=-2, keepdim=True))
            gt_ids = torch.arange(1, g + 1, device=ious.device)
            override = torch.where(cond, gt_ids, torch.zeros_like(gt_ids)).max(dim=-1).values
            assigned = torch.where(override > 0, override, assigned)
        if box_valid is not None:
            assigned = torch.where(box_valid, assigned, torch.full_like(assigned, -1))
        if gt_labels is not None:
            matched = (assigned - 1).clamp(0, g - 1)
            labels = torch.where(assigned > 0, _gather(gt_labels.long(), matched),
                                 torch.full_like(assigned, -1))
        else:
            labels = torch.full_like(assigned, -1)
        return AssignResult(assigned, max_overlaps, labels)


@BBOX_ASSIGNERS.register_module()
class ApproxMaxIoUAssigner(MaxIoUAssigner):
    """SABL's assignment (``:758-779``): each location owns
    ``approxs_per_octave`` approx anchors; its IoU with a gt is the largest
    over its group, and thresholds and the low-quality match then follow
    ``MaxIoUAssigner.assign_from_ious`` on that (K, G) matrix."""

    def assign(self, approxs: torch.Tensor, squares: torch.Tensor, approxs_per_octave: int,
               gt_bboxes: torch.Tensor, gt_valid: torch.Tensor,
               gt_labels: Optional[torch.Tensor] = None,
               box_valid: Optional[torch.Tensor] = None) -> AssignResult:
        """(K * A, 4) approxs, location-major with a location's A innermost,
        and the (K, 4) squares (only their count is read), (..., G, 4)
        padded gts -> the (..., K) assignment."""
        k = squares.shape[0]
        lead = gt_bboxes.shape[:-2]
        ious = bbox_overlaps(approxs.expand(*lead, *approxs.shape), gt_bboxes)   # (..., K A, G)
        ious = ious.reshape(*lead, k, int(approxs_per_octave), -1).amax(dim=-2)
        zero = ious.new_zeros(())
        ious = torch.where(gt_valid[..., None, :], ious, zero)
        if box_valid is not None:
            ious = torch.where(box_valid[..., :, None], ious, zero)
        return self.assign_from_ious(ious, gt_valid, gt_labels, box_valid)


def _random_rank(u: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Rank (0-based) of each True element in the random order the draws
    ``u`` give; False elements rank after every True one."""
    scores = u + torch.where(mask, 0.0, 2.0)
    order = torch.argsort(scores, dim=-1, stable=True)
    ar = torch.arange(u.shape[-1], device=u.device).expand_as(order)
    return torch.empty_like(order).scatter_(-1, order, ar)


@BBOX_SAMPLERS.register_module()
class RandomSampler:
    """Up to ``num * pos_fraction`` random positives, the rest random
    negatives. ``add_gt_as_proposals`` is the caller's (the RoI head puts
    the gts in front of the candidates)."""

    def __init__(self, num: int, pos_fraction: float, neg_pos_ub: int = -1,
                 add_gt_as_proposals: bool = True, **kwargs):
        self.num = num
        self.pos_fraction = pos_fraction
        self.neg_pos_ub = neg_pos_ub
        self.add_gt_as_proposals = add_gt_as_proposals

    @property
    def max_pos(self) -> int:
        return int(round(self.num * self.pos_fraction))

    def sample(self, assign: AssignResult, u_pos: torch.Tensor,
               u_neg: torch.Tensor) -> SamplingResult:
        """Fixed-size sample; ``u_pos``, ``u_neg`` (..., N) uniform draws
        order the positives and the negatives."""
        is_pos_all = assign.gt_inds > 0
        is_neg_all = assign.gt_inds == 0
        pos_rank = _random_rank(u_pos, is_pos_all)
        pos_sel = is_pos_all & (pos_rank < self.max_pos)
        num_pos = pos_sel.sum(dim=-1, keepdim=True)
        neg_needed = self.num - num_pos
        if self.neg_pos_ub >= 0:
            neg_needed = torch.minimum(neg_needed,
                                       self.neg_pos_ub * num_pos.clamp(min=1))
        neg_rank = _random_rank(u_neg, is_neg_all)
        neg_sel = is_neg_all & (neg_rank < neg_needed)
        n = assign.gt_inds.shape[-1]
        rest = 1e8 + torch.arange(n, dtype=torch.float32, device=u_pos.device)
        sort_key = torch.where(pos_sel, pos_rank.float(),
                               torch.where(neg_sel, 1e4 + neg_rank.float(), rest))
        inds = torch.argsort(sort_key, dim=-1, stable=True)[..., :self.num]
        return SamplingResult(inds=inds, is_pos=_gather(pos_sel, inds),
                              valid=_gather(pos_sel | neg_sel, inds),
                              gt_inds=_gather(assign.gt_inds, inds),
                              labels=_gather(assign.labels, inds))

    def sample_masks(self, assign: AssignResult, u_pos: torch.Tensor,
                     u_neg: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Mask-only sample for dense heads: (pos, neg) masks over all
        candidates, each a top-k of the draws over its candidates."""
        is_pos_all = assign.gt_inds > 0
        is_neg_all = assign.gt_inds == 0
        n = is_pos_all.shape[-1]

        def pick(u, mask, k, cutoff):
            k = min(k, n)
            vals, idx = torch.topk(u + torch.where(mask, 0.0, -2.0), k, dim=-1)
            keep = (vals > -1.0) & (torch.arange(k, device=u.device) < cutoff)
            return torch.zeros_like(mask).scatter_(-1, idx, keep)

        pos_sel = pick(u_pos, is_pos_all, self.max_pos, self.max_pos)
        neg_needed = self.num - pos_sel.sum(dim=-1, keepdim=True)
        neg_sel = pick(u_neg, is_neg_all, self.num, neg_needed)
        return pos_sel, neg_sel


@BBOX_ASSIGNERS.register_module()
class GridAssigner:
    """YOLOv3's grid assignment, as the JAX head's ``_targets_single``:

    - the responsible priors of a gt are those whose cell (at their own
      level's stride) holds the gt's centre;
    - each valid gt goes to its responsible prior of largest IoU (the first
      of equals) when that IoU exceeds ``min_pos_iou``; a prior that several
      gts pick keeps the largest gt index;
    - a prior is negative where its largest IoU with a valid gt is below
      ``neg_iou_thr`` and it is not positive.

    ``pos_iou_thr`` is read and unused, as in the JAX package (mmdet's
    ``GridAssigner`` also makes positive every responsible prior above it).
    """

    def __init__(self, pos_iou_thr=0.5, neg_iou_thr=0.5, min_pos_iou=0.0,
                 gt_max_assign_all=True, **kwargs):
        self.pos_iou_thr = float(pos_iou_thr)
        self.neg_iou_thr = float(neg_iou_thr)
        self.min_pos_iou = float(min_pos_iou)

    def assign(self, priors: torch.Tensor, strides: torch.Tensor, gt: torch.Tensor,
               gt_valid: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(K, 4) priors of all levels, (K,) their strides, (N, G, 4) gts and
        (N, G) validity -> positive (N, K) bool, the gt index of each prior
        (N, K) int64 (0 where not positive), negative (N, K) bool."""
        n, g = gt.shape[:2]
        k = priors.shape[0]
        ious = bbox_overlaps(priors.expand(n, k, 4), gt)              # (N, K, G)
        ious = torch.where(gt_valid[:, None, :], ious, torch.full_like(ious, -1.0))
        max_iou = ious.max(dim=2).values
        neg = (max_iou < self.neg_iou_thr) & (max_iou >= 0)
        cx = (gt[..., 0] + gt[..., 2]) / 2
        cy = (gt[..., 1] + gt[..., 3]) / 2
        s = strides[None, :, None]
        gx = torch.floor(cx[:, None, :] / s)
        gy = torch.floor(cy[:, None, :] / s)
        px = torch.floor(((priors[:, 0] + priors[:, 2]) / 2)[None, :, None] / s)
        py = torch.floor(((priors[:, 1] + priors[:, 3]) / 2)[None, :, None] / s)
        responsible = (gx == px) & (gy == py) & gt_valid[:, None, :]
        r_ious = torch.where(responsible, ious, torch.full_like(ious, -1.0))
        best_iou = r_ious.max(dim=1).values                           # (N, G)
        best = r_ious.argmax(dim=1)                                   # the first of equals
        sel = gt_valid & (best_iou > self.min_pos_iou)
        zeros = torch.zeros((n, k), dtype=torch.int64, device=gt.device)
        pos = zeros.scatter_reduce(1, best, sel.long(), "amax") > 0
        gt_idx = torch.arange(g, device=gt.device).expand(n, g)
        of = zeros.scatter_reduce(1, best, torch.where(sel, gt_idx, 0), "amax")
        return pos, of, neg & ~pos


@BBOX_ASSIGNERS.register_module()
class ATSSAssigner:
    """Adaptive training sample selection, static-shape: per gt and level the
    ``topk`` anchors nearest by centre distance (every anchor at the k-th
    distance included), the candidates' IoU mean plus standard deviation as
    the gt's threshold, positives the candidates at or above it whose centre
    lies inside the gt (edges included); an anchor positive for several gts
    takes the one of largest IoU (the first of equals)."""

    def __init__(self, topk: int = 9, ignore_iof_thr: float = -1, **kwargs):
        self.topk = topk

    def assign(self, bboxes: torch.Tensor, num_level_bboxes, gt_bboxes: torch.Tensor,
               gt_valid: torch.Tensor, gt_labels: Optional[torch.Tensor] = None,
               box_valid: Optional[torch.Tensor] = None) -> AssignResult:
        """(N, 4) anchors of every level (``num_level_bboxes``: a list of
        per-level counts summing to N), (..., G, 4) gts with their (..., G)
        validity -> the (..., N) assignment."""
        lead = gt_bboxes.shape[:-2]
        n, g = bboxes.shape[0], gt_bboxes.shape[-2]
        ious = bbox_overlaps(bboxes.expand(*lead, n, 4), gt_bboxes)        # (..., N, G)
        zero = ious.new_zeros(())
        ious = torch.where(gt_valid[..., None, :], ious, zero)
        if box_valid is not None:
            ious = torch.where(box_valid[..., :, None], ious, zero)
        acx = (bboxes[:, 0] + bboxes[:, 2]) * 0.5
        acy = (bboxes[:, 1] + bboxes[:, 3]) * 0.5
        gcx = (gt_bboxes[..., 0] + gt_bboxes[..., 2]) * 0.5
        gcy = (gt_bboxes[..., 1] + gt_bboxes[..., 3]) * 0.5
        dist = torch.sqrt((acx[:, None] - gcx[..., None, :]) ** 2
                          + (acy[:, None] - gcy[..., None, :]) ** 2)          # (..., N, G)
        if box_valid is not None:
            dist = torch.where(box_valid[..., :, None], dist, dist.new_full((), float("inf")))
        cand, start = [], 0
        for nl in num_level_bboxes:
            d = dist[..., start:start + nl, :]
            k = min(self.topk, nl)
            kth = torch.topk(d, k, dim=-2, largest=False).values.amax(dim=-2, keepdim=True)
            cand.append(d <= kth)
            start += nl
        cand = torch.cat(cand, dim=-2)
        cnt = cand.sum(dim=-2).clamp(min=1)                                 # (..., G)
        mean = torch.where(cand, ious, zero).sum(dim=-2) / cnt
        var = torch.where(cand, (ious - mean[..., None, :]) ** 2, zero).sum(dim=-2) / cnt
        thr = mean + torch.sqrt(var)
        inside = ((acx[:, None] >= gt_bboxes[..., None, :, 0])
                  & (acx[:, None] <= gt_bboxes[..., None, :, 2])
                  & (acy[:, None] >= gt_bboxes[..., None, :, 1])
                  & (acy[:, None] <= gt_bboxes[..., None, :, 3]))
        pos = cand & inside & (ious >= thr[..., None, :]) & gt_valid[..., None, :]
        pos_ious = torch.where(pos, ious, ious.new_full((), -1.0))
        best = pos_ious.argmax(dim=-1)                                      # the first maximum
        has = pos_ious.amax(dim=-1) > -0.5
        assigned = torch.where(has, best + 1, torch.zeros_like(best))
        if box_valid is not None:
            assigned = torch.where(box_valid, assigned, torch.full_like(assigned, -1))
        max_overlaps = torch.where(gt_valid[..., None, :], ious,
                                   ious.new_full((), -1.0)).amax(dim=-1)
        if gt_labels is not None:
            matched = (assigned - 1).clamp(0, g - 1)
            labels = torch.where(assigned > 0, _gather(gt_labels.long(), matched),
                                 torch.full_like(assigned, -1))
        else:
            labels = torch.full_like(assigned, -1)
        return AssignResult(assigned, max_overlaps, labels)


def _rank_matrix_desc(values: torch.Tensor) -> torch.Tensor:
    """Per column (dim -2), the 0-based rank of each row in descending
    order, ties to the lower row (a stable sort, as ``jnp.argsort``)."""
    order = torch.argsort(-values, dim=-2, stable=True)
    ar = torch.arange(values.shape[-2], device=values.device)[:, None].expand_as(order)
    return torch.empty_like(order).scatter_(-2, order, ar)


def _per_gt_topk_mask(values: torch.Tensor, k: int, valid_cols: torch.Tensor) -> torch.Tensor:
    """(..., N, G) scores -> a bool mask of each column's k largest rows
    (by ``_rank_matrix_desc``); an invalid column is all False."""
    k = min(k, values.shape[-2])
    return (_rank_matrix_desc(values) < k) & valid_cols[..., None, :]


@BBOX_ASSIGNERS.register_module()
class TaskAlignedAssigner:
    """Task-aligned assignment, static-shape: the alignment
    ``score[gt label] ** alpha * IoU(decoded, gt) ** beta`` (0 for an
    invalid gt), per gt the ``topk`` anchors of largest alignment whose
    centre lies more than 0.01 inside the gt and whose alignment is above
    0; an anchor claimed by several gts takes the one of largest IoU.
    ``assign`` returns (AssignResult, the assigned alignment). The TOOD head
    computes its own targets (``dense_heads/tood_head.py``), as the JAX one
    does."""

    def __init__(self, topk: int = 13, alpha: float = 1.0, beta: float = 6.0, **kw):
        self.topk = topk
        self.alpha = alpha
        self.beta = beta

    def assign(self, pred_scores: torch.Tensor, decode_bboxes: torch.Tensor,
               anchors: torch.Tensor, gt_bboxes: torch.Tensor, gt_valid: torch.Tensor,
               gt_labels: torch.Tensor, alpha=None, beta=None):
        """(..., N, C) scores, (..., N, 4) decoded boxes, (N, 4) anchors,
        (..., G, 4) gts, their validity and labels."""
        alpha = self.alpha if alpha is None else alpha
        beta = self.beta if beta is None else beta
        g = gt_bboxes.shape[-2]
        overlaps = bbox_overlaps(decode_bboxes, gt_bboxes)                  # (..., N, G)
        cls = gt_labels.long().clamp(0, pred_scores.shape[-1] - 1)
        scores = torch.gather(pred_scores, -1, cls[..., None, :].expand(
            *pred_scores.shape[:-1], g))
        metrics = scores ** alpha * overlaps ** beta
        metrics = torch.where(gt_valid[..., None, :], metrics, metrics.new_zeros(()))
        topk_mask = _per_gt_topk_mask(metrics, int(self.topk), gt_valid)
        acx = ((anchors[:, 0] + anchors[:, 2]) * 0.5)[:, None]
        acy = ((anchors[:, 1] + anchors[:, 3]) * 0.5)[:, None]
        gx1, gy1, gx2, gy2 = (gt_bboxes[..., None, :, i] for i in range(4))
        inside = ((acx - gx1 > 0.01) & (acy - gy1 > 0.01)
                  & (gx2 - acx > 0.01) & (gy2 - acy > 0.01))
        is_pos = topk_mask & inside & (metrics > 0)
        pos_ious = torch.where(is_pos, overlaps, overlaps.new_full((), float("-inf")))
        best = pos_ious.argmax(dim=-1)
        has = torch.isfinite(pos_ious.amax(dim=-1))
        assigned = torch.where(has, best + 1, torch.zeros_like(best))
        zero = overlaps.new_zeros(())
        max_overlaps = torch.where(has, _gather(overlaps, best[..., None])[..., 0], zero)
        assign_metrics = torch.where(has, _gather(metrics, best[..., None])[..., 0], zero)
        matched = (assigned - 1).clamp(0, g - 1)
        labels = torch.where(assigned > 0, _gather(gt_labels.long(), matched),
                             torch.full_like(assigned, -1))
        return AssignResult(assigned, max_overlaps, labels), assign_metrics
