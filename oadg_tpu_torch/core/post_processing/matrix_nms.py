"""Matrix NMS (SOLO) and Fast NMS (YOLACT) (port of
``oadg_tpu/core/post_processing/matrix_nms.py``): padded static-shape rows,
as the JAX functions compute them in XLA; plain torch ops on either device.

- ``mask_matrix_nms`` (``:21-97``): rows sorted by score (stable: ties to
  the lower index, as the JAX ``argsort``), the mask IoUs from the
  intersection counts ``flat @ flat.T`` (a float32 product of 0/1 masks:
  exact below 2^24 pixels, so TF32 must be off, as ``build_detector`` sets
  it), each row decayed by its largest same-class IoU with a higher row
  against that row's own largest (``gaussian`` or ``linear``), the decayed
  scores filtered at ``filter_thr`` and sorted again, ``max_num`` rows
  out; ``valid`` marks the real ones.
- ``fast_nms`` (``:100-156``): per class its ``top_k`` rows (ties to the
  lower index), each dropped where a higher row of its class (kept or not)
  overlaps it above ``iou_thr`` or its score is at most ``score_thr``, then
  the ``max_num`` best of every class's kept rows.
"""
from __future__ import annotations

from typing import Optional

import torch

from .nms import sort_desc


def mask_matrix_nms(masks: torch.Tensor, labels: torch.Tensor, scores: torch.Tensor,
                    valid: Optional[torch.Tensor] = None, filter_thr: float = -1.0,
                    max_num: int = -1, kernel: str = "gaussian", sigma: float = 2.0,
                    mask_area: Optional[torch.Tensor] = None):
    """(N, H, W) masks (bool or float 0/1), (N,) labels, scores and
    ``valid`` -> (scores, labels, masks, keep_inds, valid) of the
    ``max_num`` (N where <= 0) rows of largest decayed score, padded rows'
    scores 0."""
    n = masks.shape[0]
    if valid is None:
        valid = torch.ones(n, dtype=torch.bool, device=masks.device)
    flat = masks.reshape(n, -1).float()
    if mask_area is None:
        mask_area = flat.sum(1)
    scores = torch.where(valid, scores.float(), torch.full_like(scores.float(), float("-inf")))
    scores, order = sort_desc(scores)
    labels, flat, mask_area, valid_s = labels[order], flat[order], mask_area[order], valid[order]
    inter = flat @ flat.T
    union = mask_area[:, None] + mask_area[None, :] - inter
    iou = torch.where(union > 0, inter / torch.clamp_min(union, 1e-12), torch.zeros_like(inter))
    edge = (torch.ones(n, n, dtype=torch.bool, device=masks.device).triu(1)
            & (labels[:, None] == labels[None, :]) & valid_s[:, None] & valid_s[None, :])
    decay_iou = torch.where(edge, iou, torch.zeros_like(iou))
    comp = decay_iou.amax(0)[:, None].expand(n, n)
    if kernel == "gaussian":
        decay = torch.exp(-sigma * decay_iou ** 2) / torch.exp(-sigma * comp ** 2)
    elif kernel == "linear":
        decay = (1 - decay_iou) / torch.clamp_min(1 - comp, 1e-12)
    else:
        raise NotImplementedError(kernel)
    coeff = torch.where(edge, decay, torch.ones_like(decay)).amin(0)
    ninf = torch.full_like(scores, float("-inf"))
    new_scores = torch.where(valid_s, scores * coeff, ninf)
    if filter_thr > 0:
        valid_s = valid_s & (new_scores >= filter_thr)
        new_scores = torch.where(valid_s, new_scores, ninf)
    m = n if max_num is None or max_num <= 0 else min(int(max_num), n)
    out_scores, order2 = sort_desc(new_scores, m)
    keep_inds = order[order2]
    out_valid = valid_s[order2] & torch.isfinite(out_scores)
    return (torch.where(out_valid, out_scores, torch.zeros_like(out_scores)), labels[order2],
            masks[keep_inds], keep_inds, out_valid)


def fast_nms(multi_bboxes: torch.Tensor, multi_scores: torch.Tensor,
             multi_coeffs: torch.Tensor, score_thr: float, iou_thr: float, top_k: int,
             max_num: int = -1):
    """(N, 4) or (N, C * 4) boxes, (N, C + 1) scores (background last) and
    (N, D) coefficients -> dets (M, 5), labels (M,),
    coefficients (M, D) and valid (M,)."""
    n, c1 = multi_scores.shape
    c = c1 - 1
    k = min(int(top_k), n)
    top_scores, idx = sort_desc(multi_scores[:, :c].T, k)                   # (C, k)
    if multi_bboxes.shape[-1] > 4:
        boxes = torch.gather(multi_bboxes.reshape(n, c, 4).transpose(0, 1), 1,
                             idx[..., None].expand(c, k, 4))
    else:
        boxes = multi_bboxes[idx.reshape(-1)].reshape(c, k, 4)
    d = multi_coeffs.shape[-1]
    coeffs = multi_coeffs[idx.reshape(-1)].reshape(c, k, d)
    x1 = torch.maximum(boxes[:, :, None, 0], boxes[:, None, :, 0])
    y1 = torch.maximum(boxes[:, :, None, 1], boxes[:, None, :, 1])
    x2 = torch.minimum(boxes[:, :, None, 2], boxes[:, None, :, 2])
    y2 = torch.minimum(boxes[:, :, None, 3], boxes[:, None, :, 3])
    inter = torch.clamp_min(x2 - x1, 0) * torch.clamp_min(y2 - y1, 0)
    area = (boxes[:, :, 2] - boxes[:, :, 0]) * (boxes[:, :, 3] - boxes[:, :, 1])
    union = area[:, :, None] + area[:, None, :] - inter
    iou = torch.where(union > 0, inter / torch.clamp_min(union, 1e-12), torch.zeros_like(inter))
    tri = torch.ones(k, k, dtype=torch.bool, device=iou.device).triu(1)
    iou_max = torch.where(tri, iou, torch.zeros_like(iou)).amax(1)            # (C, k)
    keep = (iou_max <= iou_thr) & (top_scores > score_thr)
    flat_scores = torch.where(keep, top_scores, torch.full_like(top_scores, float("-inf")))
    flat_labels = torch.arange(c, device=iou.device)[:, None].expand(c, k).reshape(-1)
    m = c * k if max_num is None or max_num <= 0 else min(int(max_num), c * k)
    out_scores, oi = sort_desc(flat_scores.reshape(-1), m)
    valid = torch.isfinite(out_scores)
    dets = torch.cat([boxes.reshape(-1, 4)[oi],
                      torch.where(valid, out_scores, torch.zeros_like(out_scores))[:, None]], -1)
    return dets, flat_labels[oi], coeffs.reshape(-1, d)[oi], valid
