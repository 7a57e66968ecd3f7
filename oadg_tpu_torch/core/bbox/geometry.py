"""Box overlaps (port of ``oadg_tpu/core/bbox/geometry.py``): IoU, IoF and
GIoU of torch boxes, pairwise or aligned (``:17``), and the evaluators' numpy IoU / IoF
(``bbox_overlaps_np``, ``:67``)."""
from __future__ import annotations

import numpy as np
import torch


def bbox_overlaps(bboxes1: torch.Tensor, bboxes2: torch.Tensor,
                  mode: str = "iou", is_aligned: bool = False,
                  eps: float = 1e-6) -> torch.Tensor:
    """Overlaps of (..., M, 4) and (..., N, 4) [x1, y1, x2, y2] boxes ->
    (..., M, N), or (..., M) elementwise with ``is_aligned`` (M == N).
    ``mode`` is ``iou``, ``iof`` (over the first box's area) or ``giou``
    (IoU minus the enclosing box's share not in the union, ``:17-64``);
    widths are ``x2 - x1``, the union and the enclosing area are floored at
    ``eps``. ``torch.maximum`` / ``torch.minimum`` split the gradient of a
    tie evenly, as ``jnp.maximum`` does."""
    if mode not in ("iou", "iof", "giou"):
        raise ValueError(f"mode {mode!r}: iou, iof or giou")
    area1 = (bboxes1[..., 2] - bboxes1[..., 0]) * (bboxes1[..., 3] - bboxes1[..., 1])
    area2 = (bboxes2[..., 2] - bboxes2[..., 0]) * (bboxes2[..., 3] - bboxes2[..., 1])
    if is_aligned:
        a, b = bboxes1, bboxes2
    else:
        a, b = bboxes1[..., :, None, :], bboxes2[..., None, :, :]
        area1, area2 = area1[..., :, None], area2[..., None, :]
    lt = torch.maximum(a[..., :2], b[..., :2])
    rb = torch.minimum(a[..., 2:4], b[..., 2:4])
    wh = torch.maximum(rb - lt, rb.new_zeros(()))
    overlap = wh[..., 0] * wh[..., 1]
    union = area1 if mode == "iof" else area1 + area2 - overlap
    union = torch.maximum(union, union.new_full((), eps))
    ious = overlap / union
    if mode != "giou":
        return ious
    ewh = torch.maximum(a[..., 2:4], b[..., 2:4]) - torch.minimum(a[..., :2], b[..., :2])
    ewh = torch.maximum(ewh, ewh.new_zeros(()))
    enclose = ewh[..., 0] * ewh[..., 1]
    enclose = torch.maximum(enclose, enclose.new_full((), eps))
    return ious - (enclose - union) / enclose


def bbox_overlaps_np(bboxes1: np.ndarray, bboxes2: np.ndarray, mode: str = "iou",
                     use_legacy_coordinate: bool = False) -> np.ndarray:
    """numpy IoU (or IoF) of (M, 4) and (N, 4) xyxy boxes -> (M, N)
    float32; ``use_legacy_coordinate=True`` adds the VOC +1 to widths and
    heights (the DWD evaluation)."""
    if mode not in ("iou", "iof"):
        raise ValueError(f"mode {mode!r}: iou or iof")
    extra = 1.0 if use_legacy_coordinate else 0.0
    bboxes1 = bboxes1.astype(np.float32).reshape(-1, 4)
    bboxes2 = bboxes2.astype(np.float32).reshape(-1, 4)
    rows, cols = bboxes1.shape[0], bboxes2.shape[0]
    ious = np.zeros((rows, cols), dtype=np.float32)
    if rows * cols == 0:
        return ious
    exchange = False
    if rows > cols:
        bboxes1, bboxes2 = bboxes2, bboxes1
        ious = np.zeros((cols, rows), dtype=np.float32)
        exchange = True
    area1 = (bboxes1[:, 2] - bboxes1[:, 0] + extra) * (bboxes1[:, 3] - bboxes1[:, 1] + extra)
    area2 = (bboxes2[:, 2] - bboxes2[:, 0] + extra) * (bboxes2[:, 3] - bboxes2[:, 1] + extra)
    for i in range(bboxes1.shape[0]):
        x_start = np.maximum(bboxes1[i, 0], bboxes2[:, 0])
        y_start = np.maximum(bboxes1[i, 1], bboxes2[:, 1])
        x_end = np.minimum(bboxes1[i, 2], bboxes2[:, 2])
        y_end = np.minimum(bboxes1[i, 3], bboxes2[:, 3])
        overlap = np.maximum(x_end - x_start + extra, 0) * np.maximum(y_end - y_start + extra, 0)
        if mode == "iou":
            union = area1[i] + area2 - overlap
        else:
            union = area1[i] if not exchange else area2
        union = np.maximum(union, np.finfo(np.float32).eps)
        ious[i, :] = overlap / union
    if exchange:
        ious = ious.T
    return ious
