"""Spectral-residual saliency of OA-Mix's foreground boxes (port of
``oadg_tpu/ops/saliency.py:40-119``).

OpenCV-contrib's StaticSaliencySpectralResidual as the JAX package pins it:
grayscale crop resized to 64x64, ``log1p`` of the FFT amplitude minus its
3x3 box blur, recombined with the phase, ``|ifft|``, Gaussian blur (5 taps,
sigma 8) *before* squaring, division by the max (no min subtracted). A box
scores ``mean(floor(map * 255))``; boxes smaller than ``min_size`` score -1.

The JAX package ``vmap``s over boxes; here the G boxes are a leading
dimension of every tensor.
"""
from __future__ import annotations

import torch

from .image_ops import _sep_conv, box_blur3, gaussian_kernel1d

__all__ = ["crop_resize_gray", "spectral_residual_saliency", "saliency_score"]

_SIZE = 64


def crop_resize_gray(img: torch.Tensor, boxes: torch.Tensor,
                     bgr: bool = True) -> torch.Tensor:
    """(H, W, 3) float32 image and (G, 4) integer-valued boxes -> (G, 64, 64)
    grayscale crops: the 64x64 half-pixel-centre grid of each box, clamped
    to the box, sampled bilinearly (rows first, then columns, as the JAX
    package does)."""
    coef = [0.114, 0.587, 0.299] if bgr else [0.299, 0.587, 0.114]
    gray = img[..., 0] * coef[0] + img[..., 1] * coef[1] + img[..., 2] * coef[2]
    h, w = gray.shape
    boxes = boxes.float()
    x1, y1, x2, y2 = (boxes[:, i:i + 1] for i in range(4))               # (G, 1)
    sx = torch.clamp(x2 - x1, min=1.0) / _SIZE
    sy = torch.clamp(y2 - y1, min=1.0) / _SIZE
    grid = torch.arange(_SIZE, dtype=torch.float32, device=img.device) + 0.5
    u = torch.minimum(torch.maximum(grid * sx - 0.5 + x1, x1), x2 - 1)   # (G, 64)
    v = torch.minimum(torch.maximum(grid * sy - 0.5 + y1, y1), y2 - 1)
    u0, v0 = torch.floor(u), torch.floor(v)
    fu, fv = u - u0, v - v0
    u0i = u0.long().clamp(0, w - 1)
    u1i = (u0i + 1).clamp(0, w - 1)
    v0i = v0.long().clamp(0, h - 1)
    v1i = (v0i + 1).clamp(0, h - 1)
    rows = gray[v0i] * (1 - fv)[..., None] + gray[v1i] * fv[..., None]  # (G, 64, W)
    rows_t = rows.transpose(1, 2)                                       # (G, W, 64)
    take = lambda idx: torch.gather(rows_t, 1, idx[..., None].expand(-1, -1, _SIZE))
    out_t = take(u0i) * (1 - fu)[..., None] + take(u1i) * fu[..., None]  # (G, 64u, 64v)
    return out_t.transpose(1, 2)


def spectral_residual_saliency(gray64: torch.Tensor) -> torch.Tensor:
    """(..., 64, 64) grayscale -> (..., 64, 64) saliency maps in [0, 1]."""
    f = torch.fft.fft2(gray64.float())
    log_amp = torch.log1p(torch.abs(f))
    residual = log_amp - box_blur3(log_amp[..., None])[..., 0]
    sal = torch.abs(torch.fft.ifft2(torch.polar(torch.exp(residual), torch.angle(f))))
    k = gaussian_kernel1d(8.0, 5)
    sal = _sep_conv(sal[..., None], k, k)[..., 0]
    sal = sal * sal
    peak = sal.amax(dim=(-2, -1), keepdim=True)
    return sal / torch.clamp(peak, min=1e-30)


def saliency_score(img: torch.Tensor, boxes: torch.Tensor, min_size: int = 4,
                   bgr: bool = True) -> torch.Tensor:
    """OA-Mix score of each box (G, 4) on the (H, W, 3) float32 image: (G,)
    ``mean(floor(map * 255))``, or -1 where a side of the box (truncated to
    integers) is below ``min_size``."""
    boxi = boxes.to(torch.int32)
    sal = spectral_residual_saliency(crop_resize_gray(img, boxi, bgr=bgr))
    score = torch.floor(sal * 255.0).mean(dim=(-2, -1))
    too_small = ((boxi[:, 2] - boxi[:, 0]) < min_size) | ((boxi[:, 3] - boxi[:, 1]) < min_size)
    return torch.where(too_small, torch.full_like(score, -1.0), score)
