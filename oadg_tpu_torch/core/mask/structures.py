"""Instance masks on the host (port of ``oadg_tpu/core/mask/structures.py``;
mmdet's ``core/mask/structures.py``): ``BitmapMasks``, ``PolygonMasks``, the
even-odd polygon fill ``_fill_polygon`` (pycocotools' ``frPyObjects`` +
``decode`` without pycocotools) and ``paste_masks``. numpy, as in the JAX
package, whose results these equal bit for bit.

Device format: each gt instance travels **cropped to its box** at a fixed
``M0 x M0`` (``BitmapMasks.to_box_cropped``, M0 = 56), so a batch holds
(B, G, M0, M0) float32 masks; the mask head's targets are resampled from them
on the card (``models/roi_heads/mask_heads.py``).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np


def _clip(v, lo, hi):
    return max(lo, min(hi, v))


class BitmapMasks:
    """(N, H, W) uint8 full-image bitmaps (host side)."""

    def __init__(self, masks, height: int, width: int):
        self.height, self.width = height, width
        if len(masks) == 0:
            self.masks = np.zeros((0, height, width), np.uint8)
        else:
            self.masks = np.asarray(masks, np.uint8).reshape(-1, height, width)

    def __len__(self):
        return len(self.masks)

    def __getitem__(self, idx):
        return BitmapMasks(self.masks[idx], self.height, self.width)

    @property
    def areas(self):
        return self.masks.sum((1, 2)).astype(np.float64)

    def rescale(self, scale, interpolation="nearest"):
        if isinstance(scale, (int, float)):
            new_h, new_w = int(self.height * scale + 0.5), int(self.width * scale + 0.5)
        else:
            new_w, new_h = scale
        return self.resize((new_h, new_w))

    def resize(self, out_shape):
        new_h, new_w = out_shape
        if len(self) == 0:
            return BitmapMasks([], new_h, new_w)
        ys = (np.arange(new_h) * self.height / new_h).astype(np.int64)
        xs = (np.arange(new_w) * self.width / new_w).astype(np.int64)
        return BitmapMasks(self.masks[:, ys][:, :, xs], new_h, new_w)

    def flip(self, direction="horizontal"):
        axis = {"horizontal": 2, "vertical": 1}[direction]
        return BitmapMasks(np.flip(self.masks, axis=axis), self.height,
                           self.width)

    def pad(self, out_shape, pad_val=0):
        new_h, new_w = out_shape
        out = np.full((len(self), new_h, new_w), pad_val, np.uint8)
        out[:, :self.height, :self.width] = self.masks
        return BitmapMasks(out, new_h, new_w)

    def crop(self, bbox):
        x1, y1, x2, y2 = [int(round(v)) for v in bbox]
        x1, x2 = _clip(x1, 0, self.width), _clip(x2, 0, self.width)
        y1, y2 = _clip(y1, 0, self.height), _clip(y2, 0, self.height)
        return BitmapMasks(self.masks[:, y1:y2, x1:x2], max(y2 - y1, 0),
                           max(x2 - x1, 0))

    def to_ndarray(self):
        return self.masks

    def get_bboxes(self):
        boxes = np.zeros((len(self), 4), np.float32)
        for i, m in enumerate(self.masks):
            ys, xs = np.nonzero(m)
            if len(xs):
                boxes[i] = [xs.min(), ys.min(), xs.max() + 1, ys.max() + 1]
        return boxes

    def to_box_cropped(self, boxes, m0: int = 56):
        """(N, 4) boxes -> (N, m0, m0) float32 box-cropped device masks."""
        out = np.zeros((len(self), m0, m0), np.float32)
        for i, (m, b) in enumerate(zip(self.masks, boxes)):
            x1, y1, x2, y2 = b
            w, h = max(x2 - x1, 1e-3), max(y2 - y1, 1e-3)
            xs = np.clip((x1 + (np.arange(m0) + 0.5) / m0 * w).astype(np.int64),
                         0, self.width - 1)
            ys = np.clip((y1 + (np.arange(m0) + 0.5) / m0 * h).astype(np.int64),
                         0, self.height - 1)
            out[i] = m[ys][:, xs]
        return out


class PolygonMasks:
    """Per-instance polygon lists (reference structures.py:430)."""

    def __init__(self, masks: Sequence[Sequence[np.ndarray]], height: int,
                 width: int):
        self.masks = [[np.asarray(p, np.float64) for p in inst]
                      for inst in masks]
        self.height, self.width = height, width

    def __len__(self):
        return len(self.masks)

    def __getitem__(self, idx):
        if isinstance(idx, (int, np.integer)):
            return PolygonMasks([self.masks[idx]], self.height, self.width)
        return PolygonMasks([self.masks[i] for i in idx], self.height,
                            self.width)

    def rescale(self, scale):
        if isinstance(scale, (int, float)):
            sx = sy = scale
        else:
            sx, sy = scale[0] / self.width, scale[1] / self.height
        masks = [[p.reshape(-1, 2) * [sx, sy] for p in inst]
                 for inst in self.masks]
        return PolygonMasks([[p.reshape(-1) for p in inst] for inst in masks],
                            int(self.height * sy), int(self.width * sx))

    def flip(self, direction="horizontal"):
        out = []
        for inst in self.masks:
            ps = []
            for p in inst:
                p = p.reshape(-1, 2).copy()
                if direction == "horizontal":
                    p[:, 0] = self.width - p[:, 0]
                else:
                    p[:, 1] = self.height - p[:, 1]
                ps.append(p.reshape(-1))
            out.append(ps)
        return PolygonMasks(out, self.height, self.width)

    def to_bitmap(self) -> BitmapMasks:
        """Scanline polygon fill (replaces pycocotools frPyObjects+decode)."""
        bitmaps = np.zeros((len(self.masks), self.height, self.width),
                           np.uint8)
        for i, inst in enumerate(self.masks):
            for poly in inst:
                bitmaps[i] |= _fill_polygon(poly.reshape(-1, 2), self.height,
                                            self.width)
        return BitmapMasks(bitmaps, self.height, self.width)

    def to_ndarray(self):
        return self.to_bitmap().masks


def _fill_polygon(pts: np.ndarray, h: int, w: int) -> np.ndarray:
    """Even-odd scanline rasterization of one polygon (numpy)."""
    mask = np.zeros((h, w), np.uint8)
    if len(pts) < 3:
        return mask
    x, y = pts[:, 0], pts[:, 1]
    x2, y2 = np.roll(x, -1), np.roll(y, -1)
    rows = np.arange(h) + 0.5
    # for each edge, x-intersections with each scanline (h, E)
    with np.errstate(divide="ignore", invalid="ignore"):
        t = (rows[:, None] - y[None, :]) / (y2 - y)[None, :]
    hit = (t >= 0) & (t < 1)
    xi = np.where(hit, x[None, :] + t * (x2 - x)[None, :], np.inf)
    xi.sort(axis=1)
    for r in range(h):
        row = xi[r]
        row = row[np.isfinite(row)]
        for a, b in zip(row[0::2], row[1::2]):
            mask[r, _clip(int(np.ceil(a - 0.5)), 0, w):
                 _clip(int(np.ceil(b - 0.5)), 0, w)] = 1
    return mask


def paste_masks(mask_probs: np.ndarray, boxes: np.ndarray, img_h: int,
                img_w: int, thr: float = 0.5) -> np.ndarray:
    """Paste (D, m, m) mask probs into (D, img_h, img_w) binary masks
    (host-side analog of reference fcn_mask_head.py _do_paste_mask)."""
    d, m, _ = mask_probs.shape
    out = np.zeros((d, img_h, img_w), np.uint8)
    for i in range(d):
        x1, y1, x2, y2 = boxes[i, :4]
        w = max(int(round(x2 - x1)), 1)
        h = max(int(round(y2 - y1)), 1)
        ys = np.clip(((np.arange(h) + 0.5) / h * m).astype(np.int64), 0, m - 1)
        xs = np.clip(((np.arange(w) + 0.5) / w * m).astype(np.int64), 0, m - 1)
        patch = (mask_probs[i][ys][:, xs] >= thr).astype(np.uint8)
        ox, oy = int(round(x1)), int(round(y1))
        x_lo, y_lo = max(ox, 0), max(oy, 0)
        x_hi, y_hi = min(ox + w, img_w), min(oy + h, img_h)
        if x_hi > x_lo and y_hi > y_lo:
            out[i, y_lo:y_hi, x_lo:x_hi] = patch[y_lo - oy:y_hi - oy,
                                                 x_lo - ox:x_hi - ox]
    return out
