"""Box format helpers of the test path (port of
``oadg_tpu/core/bbox/transforms.py:20-64``): numpy on the host, and
``flip_boxes``, the batched ``bbox_flip`` of the test-time augmentation on
the device; ``distance2bbox`` (``:65``), the point-and-distances decoding of
the anchor-free heads."""
from __future__ import annotations

from typing import List

import numpy as np
import torch


def roi2bbox(rois: np.ndarray) -> List[np.ndarray]:
    """(N, 5) rois with the image index in column 0 -> per-image (n, 4)
    boxes, one entry per image index present, in ascending order."""
    bbox_list = []
    img_ids = np.unique(rois[:, 0].astype(np.int64))
    for img_id in img_ids:
        bbox_list.append(rois[rois[:, 0] == img_id, 1:])
    return bbox_list


def bbox2result(bboxes: np.ndarray, labels: np.ndarray,
                num_classes: int) -> List[np.ndarray]:
    """Detections (n, 5) [x1, y1, x2, y2, score] and their labels -> a list
    of ``num_classes`` float32 (n_c, 5) arrays, one per class."""
    bboxes = np.asarray(bboxes)
    labels = np.asarray(labels)
    if bboxes.shape[0] == 0:
        return [np.zeros((0, 5), dtype=np.float32) for _ in range(num_classes)]
    return [bboxes[labels == i, :].astype(np.float32) for i in range(num_classes)]


def bbox_flip(bboxes: np.ndarray, img_shape, direction: str = "horizontal"):
    """Flip [x1, y1, x2, y2] (+ extra columns) boxes within ``img_shape``
    (h, w, ...)."""
    h, w = img_shape[0], img_shape[1]
    if direction == "horizontal":
        out = np.concatenate([w - bboxes[..., 2:3], bboxes[..., 1:2],
                              w - bboxes[..., 0:1], bboxes[..., 3:4]], axis=-1)
    elif direction == "vertical":
        out = np.concatenate([bboxes[..., 0:1], h - bboxes[..., 3:4],
                              bboxes[..., 2:3], h - bboxes[..., 1:2]], axis=-1)
    else:
        raise ValueError(direction)
    if bboxes.shape[-1] > 4:
        out = np.concatenate([out, bboxes[..., 4:]], axis=-1)
    return out


def bbox_mapping_back(bboxes: np.ndarray, img_shape, scale_factor, flip: bool,
                      flip_direction: str = "horizontal") -> np.ndarray:
    """Boxes of the transformed image -> boxes of the original one: undo the
    flip, then divide by the (4,) scale factor."""
    new_bboxes = bbox_flip(bboxes, img_shape, flip_direction) if flip else bboxes
    sf = np.asarray(scale_factor, dtype=np.float32).reshape(-1)[:4]
    return new_bboxes[..., :4] / sf


def flip_boxes(boxes: torch.Tensor, img_shapes: torch.Tensor,
               direction: str = "horizontal") -> torch.Tensor:
    """``bbox_flip`` of (N, ..., 4) boxes, image by image, within
    ``img_shapes`` (N, 2) (h, w)."""
    view = (-1,) + (1,) * (boxes.dim() - 1)
    h, w = img_shapes[:, 0].reshape(view), img_shapes[:, 1].reshape(view)
    x1, y1, x2, y2 = boxes[..., 0:1], boxes[..., 1:2], boxes[..., 2:3], boxes[..., 3:4]
    if direction == "horizontal":
        return torch.cat([w - x2, y1, w - x1, y2], -1)
    if direction == "vertical":
        return torch.cat([x1, h - y2, x2, h - y1], -1)
    raise ValueError(direction)


def distance2bbox(points: torch.Tensor, distance: torch.Tensor,
                  max_shape=None) -> torch.Tensor:
    """(..., 2) points and (..., 4) (left, top, right, bottom) distances ->
    (..., 4) boxes; with ``max_shape`` (h, w), numbers or tensors that
    broadcast against the boxes' leading dims, each coordinate clipped to
    [0, w] or [0, h] (``jnp.clip``: ``minimum(maximum(x, 0), hi)``)."""
    x1 = points[..., 0] - distance[..., 0]
    y1 = points[..., 1] - distance[..., 1]
    x2 = points[..., 0] + distance[..., 2]
    y2 = points[..., 1] + distance[..., 3]
    if max_shape is not None:
        h, w = (torch.as_tensor(v, dtype=x1.dtype, device=x1.device) for v in max_shape[:2])
        zero = x1.new_zeros(())
        x1, x2 = (torch.minimum(torch.maximum(v, zero), w) for v in (x1, x2))
        y1, y2 = (torch.minimum(torch.maximum(v, zero), h) for v in (y1, y2))
    return torch.stack([x1, y1, x2, y2], -1)
