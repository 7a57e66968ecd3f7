"""Anchor generation (port of ``oadg_tpu/core/anchor/anchor_generator.py:26``).

Base anchors per level from ratios x scales (or RetinaNet's
``octave_base_scale x 2 ** (i / scales_per_octave)``) around a stride-sized
cell (ratio-major), computed in numpy float32 exactly as the JAX package does;
``grid_priors`` (``:89``) lays them out location-major with the anchors
innermost, the (H, W, A) order of the head's NHWC-flattened outputs, and
``grid_priors_cat`` (``:97``) concatenates the levels.

``SSDAnchorGenerator`` (port of ``:137-190``): per level a base size
``min_size`` and ``max_size`` from ``basesize_ratio_range`` over
``input_size`` (COCO's 0.15 start puts a 7%-15% level first), the anchors
``min`` and ``sqrt(min * max)`` at 1:1, then ``min`` at each ratio ``r`` and
``1 / r``, centred on ``stride / 2``, formed in numpy float64 and rounded to
float32 once, as the JAX package does; laid out by ``grid_priors``.

``YOLOAnchorGenerator`` (port of ``oadg_tpu/models/dense_heads/yolo_head.py:29-65``):
per level a list of (w, h) base sizes centred on each cell's centre
``(i + 0.5) * stride``, location-major with the anchors innermost.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from ...utils.registry import PRIOR_GENERATORS


@PRIOR_GENERATORS.register_module()
class AnchorGenerator:

    def __init__(self, strides: Sequence[int], ratios: Sequence[float],
                 scales: Sequence[float] = None, octave_base_scale: int = None,
                 scales_per_octave: int = None):
        self.strides = list(strides)
        if octave_base_scale is not None and scales_per_octave is not None:
            # RetinaNet's octave scales, in float64 as the JAX package forms
            # them (``:37-43``; the base anchors round to float32 once)
            self.scales = np.array([2 ** (i / scales_per_octave)
                                    for i in range(scales_per_octave)]) * octave_base_scale
        elif scales is None:
            raise ValueError("AnchorGenerator needs scales or octave_base_scale and "
                             "scales_per_octave")
        else:
            self.scales = np.asarray(scales, dtype=np.float32)
        self.ratios = np.asarray(ratios, dtype=np.float32)
        self.base_anchors = [self._base_anchors(s) for s in self.strides]

    @property
    def num_base_anchors(self) -> List[int]:
        return [a.shape[0] for a in self.base_anchors]

    def _base_anchors(self, base_size) -> np.ndarray:
        """Anchors centered on (0, 0) for one level, (A, 4)."""
        w = h = float(base_size)
        xc = yc = 0.0
        h_ratios = np.sqrt(self.ratios)
        w_ratios = 1 / h_ratios
        ws = (w * w_ratios[:, None] * self.scales[None, :]).reshape(-1)
        hs = (h * h_ratios[:, None] * self.scales[None, :]).reshape(-1)
        return np.stack([xc - 0.5 * ws, yc - 0.5 * hs,
                         xc + 0.5 * ws, yc + 0.5 * hs], axis=-1).astype(np.float32)

    def grid_priors(self, featmap_sizes: Sequence[Tuple[int, int]],
                    device=None) -> List[torch.Tensor]:
        """Per level, anchors (H * W * A, 4) float32 on ``device``."""
        if len(featmap_sizes) != len(self.strides):
            raise ValueError(f"{len(featmap_sizes)} feature maps for "
                             f"{len(self.strides)} anchor levels")
        out = []
        for (fh, fw), stride, base in zip(featmap_sizes, self.strides,
                                          self.base_anchors):
            sx = torch.arange(fw, dtype=torch.float32, device=device) * stride
            sy = torch.arange(fh, dtype=torch.float32, device=device) * stride
            yy, xx = torch.meshgrid(sy, sx, indexing="ij")
            shifts = torch.stack([xx, yy, xx, yy], dim=-1)        # (H, W, 4)
            anchors = (torch.from_numpy(base).to(device)[None, None]
                       + shifts[:, :, None, :])
            out.append(anchors.reshape(-1, 4))
        return out

    def grid_priors_cat(self, featmap_sizes: Sequence[Tuple[int, int]],
                        device=None) -> torch.Tensor:
        """All levels' anchors concatenated, (sum H * W * A, 4)."""
        return torch.cat(self.grid_priors(featmap_sizes, device))


@PRIOR_GENERATORS.register_module()
class SSDAnchorGenerator(AnchorGenerator):

    def __init__(self, strides: Sequence[int], ratios, input_size: int = 300,
                 basesize_ratio_range=(0.15, 0.9), scale_major: bool = False):
        self.strides = list(strides)
        self.input_size = input_size
        min_ratio, max_ratio = (int(r * 100) for r in basesize_ratio_range)
        step = int(np.floor(max_ratio - min_ratio) / (len(strides) - 2))
        min_sizes, max_sizes = [], []
        for ratio in range(min_ratio, max_ratio + 1, step):
            min_sizes.append(int(input_size * ratio / 100))
            max_sizes.append(int(input_size * (ratio + step) / 100))
        if basesize_ratio_range[0] == 0.15:      # SSD300 on COCO
            min_sizes.insert(0, int(input_size * 7 / 100))
            max_sizes.insert(0, int(input_size * 15 / 100))
        elif basesize_ratio_range[0] == 0.2:     # SSD300 on VOC
            min_sizes.insert(0, int(input_size * 10 / 100))
            max_sizes.insert(0, int(input_size * 20 / 100))
        self.min_sizes = min_sizes[:len(strides)]
        self.max_sizes = max_sizes[:len(strides)]
        self.base_anchors = []
        for k, s in enumerate(self.strides):
            mn, mx = float(self.min_sizes[k]), float(self.max_sizes[k])
            c = s / 2.0
            sizes = [(mn, mn), (np.sqrt(mn * mx), np.sqrt(mn * mx))]
            for r in np.asarray(ratios[k], np.float32):
                sr = np.sqrt(r)
                sizes += [(mn * sr, mn / sr), (mn / sr, mn * sr)]
            self.base_anchors.append(np.asarray(
                [[c - w / 2, c - h / 2, c + w / 2, c + h / 2] for w, h in sizes], np.float32))


@PRIOR_GENERATORS.register_module()
class YOLOAnchorGenerator:
    """``base_sizes``: per level a list of (w, h); ``strides``: per level a
    number or (w, h)."""

    def __init__(self, base_sizes, strides):
        self.base_sizes = [[tuple(s) for s in level] for level in base_sizes]
        self.strides = [tuple(s) if isinstance(s, (tuple, list)) else (s, s)
                        for s in strides]

    @property
    def num_base_priors(self) -> List[int]:
        return [len(b) for b in self.base_sizes]

    def grid_priors(self, featmap_sizes: Sequence[Tuple[int, int]],
                    device=None) -> List[torch.Tensor]:
        """Per level, priors (H * W * A, 4) float32 on ``device``: the cell
        centres ``(arange + 0.5) * stride`` in float32, minus and plus half
        of each base size."""
        out = []
        for (h, w), sizes, (sw, sh) in zip(featmap_sizes, self.base_sizes, self.strides):
            cx = (torch.arange(w, dtype=torch.float32, device=device) + 0.5) * sw
            cy = (torch.arange(h, dtype=torch.float32, device=device) + 0.5) * sh
            cxx = cx[None, :].expand(h, w).reshape(-1)
            cyy = cy[:, None].expand(h, w).reshape(-1)
            anchors = [torch.stack([cxx - bw / 2, cyy - bh / 2, cxx + bw / 2, cyy + bh / 2], -1)
                       for bw, bh in sizes]
            out.append(torch.stack(anchors, dim=1).reshape(-1, 4))
        return out
