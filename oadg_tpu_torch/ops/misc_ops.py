"""Point sampling (port of ``oadg_tpu/ops/misc_ops.py:37``
``point_sample`` and ``oadg_tpu/ops/deform_conv.py:30`` ``bilinear_gather``),
on the port's ``deform_conv._bilinear_taps``, CornerNet's corner pooling
(``corner_pool``, ``misc_ops.py:20-35``) and CARAFE's reassembly
(``carafe``, ``:91``). The JAX package computes these
in XLA, not Pallas, so there is no kernel to write.

``corner_pool`` is a running max (``torch.cummax``) toward one border of an
NCHW map. Its gradient at a tie differs from the JAX package's: torch sends
all of it to the latest index of the running maximum, as mmcv's
``CornerPool`` does (on ``[1, 3, 3, 2, 3]`` the gradient of
``sum(cummax)`` is ``[1, 1, 2, 0, 1]``), where JAX differentiates an
associative scan of ``max`` and splits it (``[1, 2.25, 1.25, 0, 0.5]``).
The port keeps mmcv's rule (ROADMAP C); the values are equal.

``carafe`` is CARAFE's content-aware reassembly on an NCHW map. JAX
stacks the k*k shifted maps and repeats them 2x2 to the output's size
(``:107-114``), a (B, 2H, 2W, k*k, C) tensor (3.36 GB in float32 for
FPN-CARAFE's P3-to-P2 upsample at 1024x2048, kept for the backward). The
port pads the source once at its own size and adds, tap by tap, the shifted
source broadcast over the 2x2 phases times that tap's weights into one
output: neither the repeated taps nor a k*k unfold of the source (0.84 GB
at that level) is formed, and the backward keeps views alone.

``point_sample`` and ``bilinear_gather`` take channels-last maps, as the JAX
functions do: (B, H, W, C). A corner outside its image reads 0 (mmcv's zero
padding), so a sample whose four corners are all outside gives exactly 0.
The weights and the corners combine in the map's dtype; gradients reach the
map through autograd.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .deform_conv import _bilinear_taps

__all__ = ["bilinear_gather", "carafe", "corner_pool", "point_sample"]


def carafe(x: torch.Tensor, masks: torch.Tensor, kernel_size: int = 5, group_size: int = 1,
           scale_factor: int = 2) -> torch.Tensor:
    """CARAFE on NCHW ``x`` (B, C, H, W) with the normalized kernels
    ``masks`` (B, G * k * k, s * H, s * W), channel ``g * k * k + t`` the
    weight of tap ``t = dy * k + dx`` of group ``g``: output pixel (Y, X)
    is, per group of C / G channels, the weighted sum of the k x k
    neighbourhood of source pixel (Y // s, X // s), zero outside the map.

    One zero-padded copy of ``x`` at its own size, in float32 at least;
    each tap adds its shifted view, broadcast over the s x s phases, times
    its mask into one output of that dtype (``addcmul_``, which keeps only
    views for the backward). No tap map of the output's size, nor a k * k
    unfold of the source, is ever formed. The result is cast to ``x``'s
    dtype."""
    b, c, h, w = x.shape
    k, g, s, p = kernel_size, group_size, scale_factor, kernel_size // 2
    dt = torch.promote_types(x.dtype, torch.float32)
    xp = F.pad(x.to(dt), (p, p, p, p)).view(b, g, c // g, h + 2 * p, w + 2 * p)
    m = masks.to(dt).view(b, g, 1, k * k, h, s, w, s)
    out = x.new_zeros((b, g, c // g, h, s, w, s), dtype=dt)
    for t in range(k * k):
        dy, dx = divmod(t, k)
        out.addcmul_(xp[:, :, :, dy:dy + h, None, dx:dx + w, None], m[:, :, :, t])
    return out.view(b, c, h * s, w * s).to(x.dtype)


def corner_pool(x: torch.Tensor, direction: str) -> torch.Tensor:
    """mmcv's ``CornerPool`` on an NCHW map: ``top`` ``out[i] = max(x[i:])``
    over the rows, ``bottom`` ``max(x[:i + 1])``, ``left`` and ``right``
    the same over the columns."""
    dim, flip = {"top": (2, True), "bottom": (2, False), "left": (3, True),
                 "right": (3, False)}[direction]
    if flip:
        return torch.cummax(x.flip(dim), dim).values.flip(dim)
    return torch.cummax(x, dim).values


def bilinear_gather(feats: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor,
                    image: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sample (B, H, W, C) ``feats`` at fractional pixel positions ``ys``,
    ``xs`` (R, ...) -> (R, ..., C). Row ``r`` of the positions reads image
    ``r`` (R = B), or image ``image[r]`` where ``image`` (R,) is given: each
    row then samples its own image alone, zero outside it (mmcv's
    ``point_sample`` on one image's map)."""
    b, h, w, c = feats.shape
    r, tail = ys.shape[0], ys.shape[1:]
    ys, xs = ys.reshape(r, -1).float(), xs.reshape(r, -1).float()
    table = feats.reshape(b * h * w, c)
    out = _bilinear_taps(table, r, h, w, ys, xs, None, image=image)
    return out.view(r, *tail, c)


def point_sample(feats: torch.Tensor, points: torch.Tensor,
                 align_corners: bool = False) -> torch.Tensor:
    """mmcv's ``point_sample`` on channels-last maps: (B, H, W, C) sampled at
    (B, P, 2) normalized ``(x, y)`` points in [0, 1] -> (B, P, C); pixel
    ``p * size - 0.5`` (``F.grid_sample``'s ``align_corners=False``), or
    ``p * (size - 1)`` with ``align_corners``."""
    _, h, w, _ = feats.shape
    if align_corners:
        xs, ys = points[..., 0] * (w - 1), points[..., 1] * (h - 1)
    else:
        xs, ys = points[..., 0] * w - 0.5, points[..., 1] * h - 0.5
    return bilinear_gather(feats, ys, xs)
