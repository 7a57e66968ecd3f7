"""Exact greedy NMS on padded, fixed-size inputs (port of
``oadg_tpu/core/post_processing/nms.py``), in plain tensor ops.

``nms_padded`` (``:33``) sorts by score and resolves greedy suppression with
the JAX package's fixpoint: in the matrix of "earlier box suppresses later
box" edges, a box with no incoming edge is a certain survivor, and a box an
edge from a certain survivor reaches is certainly suppressed, so its outgoing
edges are removed; repeat until nothing changes. What remains is the greedy
keep set. The JAX package runs this per 256-box tile; here the whole set is
one tile, batched over any leading dimensions. Every function keeps the JAX
package's tie order: a stable descending sort, lower index first.
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


def nms_padded(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
               valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Greedy NMS over (..., N, 4) boxes and (..., N) scores; ``valid`` marks
    real rows (padding is never kept and never suppresses).

    Returns keep (..., N) bool in input order.
    """
    if valid is None:
        valid = torch.ones(scores.shape, dtype=torch.bool, device=scores.device)
    n = scores.shape[-1]
    scores_m = torch.where(valid, scores, torch.full_like(scores, float("-inf")))
    _, order = sort_desc(scores_m)
    boxes_s = torch.gather(boxes, -2, order[..., None].expand(*order.shape, 4))
    valid_s = torch.gather(valid, -1, order)
    iou = bbox_overlaps(boxes_s, boxes_s)
    earlier = torch.ones(n, n, dtype=torch.bool, device=boxes.device).triu(1)
    edges = (earlier & valid_s[..., :, None] & valid_s[..., None, :]
             & (iou > iou_threshold))                   # row suppresses column
    while True:
        survivor = ~edges.any(dim=-2)
        suppressed = (edges & survivor[..., :, None]).any(dim=-2)
        pruned = edges & ~suppressed[..., :, None]
        if torch.equal(pruned, edges):
            break
        edges = pruned
    keep_s = valid_s & ~edges.any(dim=-2)
    return torch.zeros_like(keep_s).scatter(-1, order, keep_s)


def batched_nms_padded(boxes: torch.Tensor, scores: torch.Tensor,
                       idxs: torch.Tensor, iou_threshold: float,
                       valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """NMS within each ``idxs`` group (``:103``): boxes of different groups
    are moved apart by ``idx * (max_coord + 1)`` so they never overlap."""
    if valid is None:
        valid = torch.ones(scores.shape, dtype=torch.bool, device=scores.device)
    coords = torch.where(valid[..., None], boxes, torch.zeros_like(boxes))
    max_coord = coords.amax(dim=(-2, -1), keepdim=True)     # (..., 1, 1)
    offsets = idxs.to(boxes.dtype)[..., None] * (max_coord + 1.0)
    return nms_padded(boxes + offsets, scores, iou_threshold, valid)


def multiclass_nms(multi_bboxes: torch.Tensor, multi_scores: torch.Tensor,
                   score_thr: float, iou_threshold: float, max_per_img: int,
                   num_classes: int
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-class hard NMS (``:170``), batched over images.

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
    keep = batched_nms_padded(bboxes, scores, labels, iou_threshold, valid)
    final = torch.where(keep, scores, torch.full_like(scores, float("-inf")))
    top_s, top_i = sort_desc(final, max_per_img)
    out_valid = top_s > float("-inf")
    top_boxes = torch.gather(bboxes, 1, top_i[..., None].expand(b, max_per_img, 4))
    dets = torch.cat([top_boxes, top_s[..., None]], dim=-1)
    dets = torch.where(out_valid[..., None], dets, torch.zeros_like(dets))
    out_labels = torch.where(out_valid, torch.gather(labels, 1, top_i),
                             torch.full_like(top_i, -1))
    return dets, out_labels, out_valid
