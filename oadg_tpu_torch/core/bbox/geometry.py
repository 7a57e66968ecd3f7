"""Box overlaps (port of ``oadg_tpu/core/bbox/geometry.py:17``, IoU mode)."""
from __future__ import annotations

import torch


def bbox_overlaps(bboxes1: torch.Tensor, bboxes2: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    """Pairwise IoU of (..., M, 4) and (..., N, 4) [x1, y1, x2, y2] boxes
    -> (..., M, N); widths are ``x2 - x1``, the union is floored at ``eps``."""
    area1 = (bboxes1[..., 2] - bboxes1[..., 0]) * (bboxes1[..., 3] - bboxes1[..., 1])
    area2 = (bboxes2[..., 2] - bboxes2[..., 0]) * (bboxes2[..., 3] - bboxes2[..., 1])
    lt = torch.maximum(bboxes1[..., :, None, :2], bboxes2[..., None, :, :2])
    rb = torch.minimum(bboxes1[..., :, None, 2:4], bboxes2[..., None, :, 2:4])
    wh = (rb - lt).clamp(min=0)
    overlap = wh[..., 0] * wh[..., 1]
    union = area1[..., :, None] + area2[..., None, :] - overlap
    return overlap / union.clamp(min=eps)
