"""Gaussian heatmap targets (port of ``oadg_tpu/models/utils/misc.py:104-136``)
and the helpers the CenterNet and corner heads share.

- ``gaussian_radius`` (``:104``) is mmdet's ``gaussian_radius``: the
  smallest of the three roots ``(b + sqrt(b^2 - 4ac)) / 2``, as CenterNet's
  targets take it; CornerNet's head keeps its own (``corner_heads.py``).
- ``gen_gaussian_target`` (``:124``) evaluates one gaussian of sigma
  ``(2 r + 1) / 6`` over the whole (H, W) map (no window), zeroes values
  below float32's eps and takes the max with the map.
- ``class_planes`` max-composes per-gt maps into their class planes with an
  ``amax`` scatter; ``images_mean`` is a loss's mean over the images.

``torch.exp`` and ``torch.sqrt`` round otherwise than XLA's CPU backend by
an ulp or a few: the targets equal the JAX package's within a few float32
ulp, and exactly at a gaussian's centre (1) and below the cut-off (0).
"""
from __future__ import annotations

import torch

from ...parallel import shard_sum

_EPS = torch.finfo(torch.float32).eps


def radius_cases(height, width, min_overlap: float):
    """The three quadratics of mmdet's ``gaussian_radius``: per case ``(b,
    b^2 - 4ac)``."""
    o = min_overlap
    b1 = height + width
    c1 = width * height * (1 - o) / (1 + o)
    b2 = 2 * (height + width)
    c2 = (1 - o) * width * height
    a3 = 4 * o
    b3 = -2 * o * (height + width)
    c3 = (o - 1) * width * height
    return (b1, b1 ** 2 - 4 * c1), (b2, b2 ** 2 - 16 * c2), (b3, b3 ** 2 - 4 * a3 * c3)


def gaussian_radius(det_size, min_overlap: float = 0.7) -> torch.Tensor:
    """mmdet's ``gaussian_radius`` of (height, width): the least of its
    three cases' roots ``(b + sqrt(b^2 - 4ac)) / 2``."""
    (b1, d1), (b2, d2), (b3, d3) = radius_cases(*det_size, min_overlap)
    r1 = (b1 + torch.sqrt(d1)) / 2
    r2 = (b2 + torch.sqrt(d2)) / 2
    r3 = (b3 + torch.sqrt(d3)) / 2
    return torch.minimum(torch.minimum(r1, r2), r3)


def gaussian_maps(cx: torch.Tensor, cy: torch.Tensor, sigma: torch.Tensor, h: int,
                  w: int) -> torch.Tensor:
    """One gaussian a centre over an (H, W) grid: (...,) ``cx``, ``cy`` and
    ``sigma`` -> (..., H, W) ``exp(-((x - cx)^2 + (y - cy)^2) / (2
    sigma^2))``."""
    dev = cx.device
    dx = (torch.arange(w, dtype=torch.float32, device=dev) - cx[..., None])[..., None, :]
    dy = (torch.arange(h, dtype=torch.float32, device=dev) - cy[..., None])[..., :, None]
    return torch.exp(-((dx ** 2 + dy ** 2) / (2 * sigma ** 2)[..., None, None]))


def gen_gaussian_target(heatmap: torch.Tensor, center, radius) -> torch.Tensor:
    """``heatmap`` (H, W) and one gaussian of ``radius`` centred on
    ``center`` (x, y), evaluated over the whole map, zero below float32's
    eps -> their elementwise max."""
    cx, cy = (torch.as_tensor(c, dtype=torch.float32, device=heatmap.device) for c in center)
    sigma = (2 * torch.as_tensor(radius, device=heatmap.device) + 1) / 6
    g = gaussian_maps(cx, cy, sigma, *heatmap.shape)
    g = torch.where(g < _EPS, torch.zeros_like(g), g)
    return torch.maximum(heatmap, g)


def class_planes(g: torch.Tensor, labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    """(N, G, H, W) per-gt maps >= 0 and their (N, G) labels -> (N, C, H, W)
    each class plane the max of its gts' maps (0 where it has none)."""
    n, gts, h, w = g.shape
    idx = labels.long().clamp(0, num_classes - 1)[..., None].expand(n, gts, h * w)
    out = g.new_zeros(n, num_classes, h * w)
    return out.scatter_reduce_(1, idx, g.reshape(n, gts, h * w), "amax").view(n, num_classes, h, w)


def images_mean(per_image: torch.Tensor) -> torch.Tensor:
    """The mean over the images of an (N,) per-image loss (over the global
    batch's images under data parallel: this rank's share)."""
    return per_image.sum() / shard_sum(per_image.new_tensor(float(per_image.shape[0])))
