"""Deformable convolution, DCNv1 (``deform_conv2d``) and DCNv2
(``modulated_deform_conv2d``) (port of ``oadg_tpu/ops/deform_conv.py:30-178``),
in tensor ops: the JAX package computes them in XLA, not Pallas, so there is
no kernel to write.

Per output pixel and tap ``k`` of the ``kh x kw`` window, the input is
sampled bilinearly at the tap's grid position plus its learned offset
``(dy, dx)`` (mmcv's channel order ``deform_groups x K x (dy, dx)``) and, in
DCNv2, scaled by the tap's modulation scalar; a corner outside the map reads 0, so
a tap whose four corners are all outside gives exactly 0. The K taps of
every pixel are gathered into a ``(B * Ho * Wo, K * C)`` table (one gather
of the four corners from the channels-last input, combined by a batched
``(1, 4) x (4, C)`` product with the corner weights times the modulation)
and contracted with the weight in one matmul. Offsets, corner weights and
modulation come in float32; the table and the product run in the input's
dtype (flax's cast points: a bfloat16 model samples bfloat16 values with
its weights rounded to bfloat16, and the matmul accumulates in float32).
Gradients reach the input, the offsets, the modulation and the weight
through autograd.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

__all__ = ["deform_conv2d", "modulated_deform_conv2d"]


def _pair(v) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def _bilinear_taps(table: torch.Tensor, b: int, h: int, w: int, ys: torch.Tensor,
                   xs: torch.Tensor, mask: Optional[torch.Tensor],
                   image: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sample a (B * H * W, C) channels-last table at (B, P) float32
    positions, each sample times its (B, P) modulation (none where ``mask``
    is None) -> (B * P, C). Row
    ``i`` of the positions reads image ``i`` of the table, or image
    ``image[i]`` where ``image`` (B,) is given (then the table may hold
    another number of images)."""
    dt = table.dtype
    y0, x0 = torch.floor(ys), torch.floor(xs)
    wy, wx = (ys - y0).to(dt), (xs - x0).to(dt)
    y0i, x0i = y0.long(), x0.long()
    if image is None:
        image = torch.arange(b, device=table.device)
    base = (image.long() * (h * w))[:, None]
    idx, wgt = [], []
    for dy, dx, cw in ((0, 0, (1 - wy) * (1 - wx)), (0, 1, (1 - wy) * wx),
                       (1, 0, wy * (1 - wx)), (1, 1, wy * wx)):
        yi, xi = y0i + dy, x0i + dx
        inside = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        idx.append(base + yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1))
        wgt.append(cw * inside.to(dt))
    p = ys.shape[1]
    corners = table.index_select(0, torch.stack(idx, -1).reshape(-1))
    wgt = torch.stack(wgt, -1)                                         # (B, P, 4)
    if mask is not None:
        wgt = wgt * mask.to(dt)[..., None]
    return torch.bmm(wgt.reshape(b * p, 1, 4),
                     corners.view(b * p, 4, table.shape[1])).view(b * p, -1)


def deform_conv2d(x: torch.Tensor, offset: torch.Tensor, weight: torch.Tensor,
                  stride: Union[int, Tuple[int, int]] = 1,
                  padding: Union[int, Tuple[int, int]] = 0,
                  dilation: Union[int, Tuple[int, int]] = 1,
                  deform_groups: int = 1,
                  bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """DCNv1 (``mmcv.ops.deform_conv2d``, groups 1): ``modulated_deform_conv2d``
    without the modulation.

    Args:
        x: (B, C, H, W) input in the compute dtype.
        offset: (B, deform_groups * K * 2, Ho, Wo), ``(dy, dx)`` per tap.
        weight: (C_out, C, kh, kw) in the compute dtype.

    Returns (B, C_out, Ho, Wo) in ``x``'s dtype (channels-last memory).
    """
    return _deform_conv(x, offset, None, weight, stride, padding, dilation, deform_groups, bias)


def modulated_deform_conv2d(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
                            weight: torch.Tensor,
                            stride: Union[int, Tuple[int, int]] = 1,
                            padding: Union[int, Tuple[int, int]] = 0,
                            dilation: Union[int, Tuple[int, int]] = 1,
                            deform_groups: int = 1,
                            bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """DCNv2 (``mmcv.ops.modulated_deform_conv2d``, groups 1).

    Args:
        x: (B, C, H, W) input in the compute dtype.
        offset: (B, deform_groups * K * 2, Ho, Wo), ``(dy, dx)`` per tap.
        mask: (B, deform_groups * K, Ho, Wo), already through the sigmoid.
        weight: (C_out, C, kh, kw) in the compute dtype.

    Returns (B, C_out, Ho, Wo) in ``x``'s dtype (channels-last memory).
    """
    return _deform_conv(x, offset, mask, weight, stride, padding, dilation, deform_groups, bias)


def _deform_conv(x, offset, mask, weight, stride, padding, dilation, deform_groups, bias):
    b, c, h, w = x.shape
    cout, cin, kh, kw = weight.shape
    if cin != c:
        raise ValueError(f"weight takes {cin} input channels, x has {c} (groups=1 only)")
    dg = deform_groups
    if c % dg:
        raise ValueError(f"{c} channels do not split into {dg} deform groups")
    sh, sw = _pair(stride)
    ph, pw = _pair(padding)
    dh, dw = _pair(dilation)
    k = kh * kw
    ho, wo = offset.shape[-2:]
    dev = x.device
    off = offset.float().view(b, dg, k, 2, ho, wo)
    m = None if mask is None else mask.float().view(b, dg, k, ho, wo)
    ky = (torch.arange(kh, device=dev, dtype=torch.float32) * dh).repeat_interleave(kw)
    kx = (torch.arange(kw, device=dev, dtype=torch.float32) * dw).repeat(kh)
    gy = (torch.arange(ho, device=dev, dtype=torch.float32) * sh - ph)[None, :, None] + ky[:, None, None]
    gx = (torch.arange(wo, device=dev, dtype=torch.float32) * sw - pw)[None, None, :] + kx[:, None, None]

    def per_pixel(t):                   # (B, K, Ho, Wo) -> (B, Ho * Wo * K)
        return t.permute(0, 2, 3, 1).reshape(b, -1)

    table = x.permute(0, 2, 3, 1).reshape(b * h * w, c)
    cg = c // dg
    taps = [_bilinear_taps(table[:, g * cg:(g + 1) * cg] if dg > 1 else table, b, h, w,
                           per_pixel(gy + off[:, g, :, 0]), per_pixel(gx + off[:, g, :, 1]),
                           None if m is None else per_pixel(m[:, g]))
            for g in range(dg)]
    taps = taps[0] if dg == 1 else torch.cat(
        [t.view(b * ho * wo, k, cg) for t in taps], -1)
    out = torch.matmul(taps.reshape(b * ho * wo, k * c),
                       weight.permute(2, 3, 1, 0).reshape(k * c, cout))
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out.view(b, ho, wo, cout).permute(0, 3, 1, 2)
