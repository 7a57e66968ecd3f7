"""Exact greedy NMS on padded, fixed-size inputs (port of
``oadg_tpu/core/post_processing/nms.py``), in plain tensor ops.

``nms_padded`` (``:33``) sorts by score and resolves greedy suppression with
the JAX package's fixpoint: in the matrix of "earlier box suppresses later
box" edges, a box with no incoming edge is a certain survivor, and a box an
edge from a certain survivor reaches is certainly suppressed, so its outgoing
edges are removed; repeat until nothing changes. What remains is the greedy
keep set. As in the JAX package it runs per 256-box tile of the sorted set,
each tile first cut by the boxes kept before it, batched over any leading
dimensions; the fixpoint reads back one flag an iteration (``torch.equal``),
and the tiles past the last valid row are not run. Memory goes with 256 x
the valid rows, not with the square of the candidates (RetinaNet's
``multiclass_nms`` takes 400,000). Every function keeps the JAX
package's tie order: a stable descending sort, lower index first. Scores
keep their dtype: the proposals of a bfloat16 model sort and suppress on
bfloat16 scores, where ties are common, as ``jax.lax.top_k`` and the JAX
package's stable ``argsort`` do.

``soft_nms_padded`` (``:117-170``) decays the scores of the boxes that
overlap each pick instead of dropping them (``linear``: ``1 - iou`` above the
threshold; ``gaussian``: ``exp(-iou ** 2 / sigma)``) in a fixed number of
picks, each a tensor op on the device with no host sync. ``multiclass_nms``
takes it with ``nms_type="soft_nms"`` (``:177-215``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..bbox.geometry import bbox_overlaps


def sort_desc(x: torch.Tensor, k: Optional[int] = None):
    """``jax.lax.top_k`` along the last dim: values and indices, descending,
    ties to the lower index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return (vals, idx) if k is None else (vals[..., :k], idx[..., :k])


def _resolve_tile(boxes: torch.Tensor, alive: torch.Tensor,
                  iou_threshold: float) -> torch.Tensor:
    """Greedy keep set of (..., t, 4) score-sorted boxes, of which only the
    ``alive`` (..., t) ones take part: the suppression fixpoint."""
    t = boxes.shape[-2]
    iou = bbox_overlaps(boxes, boxes)
    earlier = torch.ones(t, t, dtype=torch.bool, device=boxes.device).triu(1)
    edges = (earlier & alive[..., :, None] & alive[..., None, :]
             & (iou > iou_threshold))                   # row suppresses column
    while True:
        survivor = ~edges.any(dim=-2)
        suppressed = (edges & survivor[..., :, None]).any(dim=-2)
        pruned = edges & ~suppressed[..., :, None]
        if torch.equal(pruned, edges):
            break
        edges = pruned
    return alive & ~edges.any(dim=-2)


def nms_padded(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
               valid: Optional[torch.Tensor] = None,
               tile_size: Optional[int] = 256) -> torch.Tensor:
    """Greedy NMS over (..., N, 4) boxes and (..., N) scores; ``valid`` marks
    real rows (padding is never kept and never suppresses).

    The sorted boxes are resolved in tiles of ``tile_size`` (``:33-100``):
    a tile's boxes that a kept box of an earlier tile overlaps are dropped
    (one (t, start) IoU block), then the tile's own fixpoint runs. Tiles
    past the last valid row of every leading index are skipped (one host
    read of that row), so the work follows the real candidates, not the
    padded count. ``tile_size=None`` (or one >= N) resolves the whole set
    as one tile; every tiling gives the same keep set, the exact greedy one.

    Returns keep (..., N) bool in input order.
    """
    if valid is None:
        valid = torch.ones(scores.shape, dtype=torch.bool, device=scores.device)
    n = scores.shape[-1]
    scores_m = torch.where(valid, scores, torch.full_like(scores, float("-inf")))
    _, order = sort_desc(scores_m)
    boxes_s = torch.gather(boxes, -2, order[..., None].expand(*order.shape, 4))
    valid_s = torch.gather(valid, -1, order)
    if tile_size is None or tile_size >= n:
        keep_s = _resolve_tile(boxes_s, valid_s, iou_threshold)
    else:
        lead = valid_s.shape[:-1]
        bs, vs = boxes_s.reshape(-1, n, 4), valid_s.reshape(-1, n)
        rows = torch.arange(1, n + 1, device=vs.device)
        last = int(torch.where(vs, rows, torch.zeros_like(rows)).max()) if vs.numel() else 0
        keep_s = torch.zeros_like(vs)
        for start in range(0, last, tile_size):
            stop = min(start + tile_size, n)
            alive = vs[:, start:stop]
            if start:
                iou = bbox_overlaps(bs[:, start:stop], bs[:, :start])     # (B, t, start)
                alive = alive & ~(keep_s[:, None, :start] & (iou > iou_threshold)).any(-1)
            keep_s[:, start:stop] = _resolve_tile(bs[:, start:stop], alive, iou_threshold)
        keep_s = keep_s.view(*lead, n)
    return torch.zeros_like(keep_s).scatter(-1, order, keep_s)


def batched_nms_padded(boxes: torch.Tensor, scores: torch.Tensor,
                       idxs: torch.Tensor, iou_threshold: float,
                       valid: Optional[torch.Tensor] = None,
                       tile_size: Optional[int] = 256) -> torch.Tensor:
    """NMS within each ``idxs`` group (``:103``): boxes of different groups
    are moved apart by ``idx * (max_coord + 1)`` so they never overlap."""
    if valid is None:
        valid = torch.ones(scores.shape, dtype=torch.bool, device=scores.device)
    coords = torch.where(valid[..., None], boxes, torch.zeros_like(boxes))
    max_coord = coords.amax(dim=(-2, -1), keepdim=True)     # (..., 1, 1)
    offsets = idxs.to(boxes.dtype)[..., None] * (max_coord + 1.0)
    return nms_padded(boxes + offsets, scores, iou_threshold, valid, tile_size)


def soft_nms_padded(boxes: torch.Tensor, scores: torch.Tensor,
                    iou_threshold: float = 0.3, sigma: float = 0.5,
                    min_score: float = 1e-3, method: str = "linear",
                    max_out: Optional[int] = None,
                    valid: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Soft-NMS over (..., N, 4) boxes and (..., N) scores: ``max_out``
    (default N) picks of the highest live score (ties to the lower index),
    each decaying the live scores of the boxes that overlap it. A pick at or
    below ``min_score`` keeps nothing and decays nothing. The (N, N) IoU
    matrix is built once, in float32.

    Returns new_scores (..., N) float32 (each kept box's score when it was
    picked, 0 elsewhere) and keep (..., N) bool, in input order.

    Once every score is spent (-inf), a pick changes nothing; the JAX
    package's picks then land on index 0 and zero its score even where it
    was kept (ROADMAP C).
    """
    if method not in ("linear", "gaussian"):
        raise ValueError(f"soft-NMS method {method!r}: linear or gaussian")
    n = scores.shape[-1]
    rounds = n if max_out is None else min(int(max_out), n)
    if valid is None:
        valid = torch.ones(scores.shape, dtype=torch.bool, device=scores.device)
    iou = bbox_overlaps(boxes.float(), boxes.float())
    neg_inf = torch.full((), float("-inf"), device=scores.device)   # a fill, not a copy
    cur = torch.where(valid, scores.float(), neg_inf)
    out = torch.zeros_like(cur)
    keep = torch.zeros_like(valid)
    rows = (*iou.shape[:-2], 1, n)
    for _ in range(rounds):
        m = cur.argmax(-1, keepdim=True)                       # (..., 1)
        ms = cur.gather(-1, m)
        ok = ms > min_score
        out.scatter_(-1, m, torch.where(ok, ms, out.gather(-1, m)))
        keep.scatter_(-1, m, keep.gather(-1, m) | ok)
        row = iou.gather(-2, m[..., None].expand(rows)).squeeze(-2)
        if method == "gaussian":
            decay = torch.exp(-(row * row) / sigma)
        else:
            decay = torch.where(row > iou_threshold, 1.0 - row, torch.ones_like(row))
        # a spent (-inf) score stays spent: -inf * 0 at IoU 1 would be NaN
        cur = torch.where(ok & (cur > neg_inf), cur * decay, cur)
        cur.scatter_(-1, m, neg_inf.expand_as(m))
    return out, keep


NMS_TYPES = {"nms": "nms", "soft_nms": "linear", "soft_nms_linear": "linear",
             "soft_nms_gaussian": "gaussian"}


def multiclass_nms(multi_bboxes: torch.Tensor, multi_scores: torch.Tensor,
                   score_thr: float, iou_threshold: float, max_per_img: int,
                   num_classes: int, nms_type: str = "nms", sigma: float = 0.5,
                   min_score: float = 1e-3
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-class NMS (``:170``), batched over images: hard (``nms``) or
    soft (``soft_nms`` / ``soft_nms_linear``, ``soft_nms_gaussian``; classes
    kept apart by the coordinate offset of ``batched_nms_padded``, at most
    ``min(4 * max_per_img, N * C)`` picks, kept scores decayed).

    Args:
        multi_bboxes: (B, N, C*4) or (B, N, 4); multi_scores: (B, N, C+1),
            the last column background (dropped).

    Returns:
        dets (B, max_per_img, 5) [x1, y1, x2, y2, score], labels
        (B, max_per_img) int64 (-1 where invalid), valid (B, max_per_img).
    """
    b, n = multi_scores.shape[:2]
    c = num_classes
    if n * c < max_per_img:
        raise ValueError(f"{n * c} candidates cannot fill max_per_img={max_per_img}")
    scores = multi_scores[..., :c].reshape(b, n * c)
    if multi_bboxes.shape[-1] > 4:
        bboxes = multi_bboxes.reshape(b, n * c, 4)
    else:
        bboxes = multi_bboxes[:, :, None, :].expand(b, n, c, 4).reshape(b, n * c, 4)
    labels = torch.arange(c, device=scores.device).repeat(n).expand(b, n * c)
    valid = scores > score_thr
    if NMS_TYPES[nms_type] == "nms":
        keep = batched_nms_padded(bboxes, scores, labels, iou_threshold, valid)
    else:
        coords = torch.where(valid[..., None], bboxes, torch.zeros_like(bboxes))
        max_coord = coords.amax(dim=(-2, -1), keepdim=True)
        scores, keep = soft_nms_padded(
            bboxes + labels.to(bboxes.dtype)[..., None] * (max_coord + 1.0), scores,
            iou_threshold=iou_threshold, sigma=sigma, min_score=min_score,
            method=NMS_TYPES[nms_type], max_out=min(4 * max_per_img, n * c), valid=valid)
    final = torch.where(keep, scores, torch.full_like(scores, float("-inf")))
    top_s, top_i = sort_desc(final, max_per_img)
    out_valid = top_s > float("-inf")
    top_boxes = torch.gather(bboxes, 1, top_i[..., None].expand(b, max_per_img, 4))
    dets = torch.cat([top_boxes, top_s[..., None]], dim=-1)
    dets = torch.where(out_valid[..., None], dets, torch.zeros_like(dets))
    out_labels = torch.where(out_valid, torch.gather(labels, 1, top_i),
                             torch.full_like(top_i, -1))
    return dets, out_labels, out_valid
