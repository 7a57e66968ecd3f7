"""PIL-exact photometric ops of OA-Mix (port of ``oadg_tpu/ops/photometric.py:34-219``).

Pillow's ``ImageOps.autocontrast/equalize/posterize/solarize/invert`` and
``ImageEnhance.Color/Contrast/Brightness/Sharpness`` with its integer
arithmetic: truncation, the 16-bit fixed-point L conversion (``>> 16``) and
``floor(mean + 0.5)``. Images are (H, W, C) holding uint8 values, as
float32 or uint8; every op returns float32 integer values in [0, 255].

``equalize`` takes its histogram from ``hist.image_hist256`` (kernel B6 on
the card) and applies its LUT by indexing; the JAX package's nibble-matmul
LUT (``apply_lut_nibble``) was a TPU gather workaround with identical values.
Level arguments (bits, threshold, factor) are host numbers: OA-Mix draws
them on the host.
"""
from __future__ import annotations

import numpy as np
import torch

from .hist import image_hist256
from .warp import fma

__all__ = ["autocontrast", "equalize_lut_from_hist", "equalize", "posterize",
           "solarize", "invert", "grayscale_l", "blend", "color_degenerate",
           "contrast_degenerate", "sharpness_degenerate", "enhance_color",
           "enhance_contrast", "enhance_brightness", "enhance_sharpness"]


def _clip(img: torch.Tensor) -> torch.Tensor:
    return torch.clamp(img.float(), 0, 255)


def autocontrast(img: torch.Tensor) -> torch.Tensor:
    """LUT ``clip(trunc(i * scale - lo * scale))`` from each channel's
    extremes (PIL, cutoff 0), identity where a channel is flat. The
    multiply-subtract is rounded once, as XLA compiles it in the JAX
    package's jitted chain (run op by op, JAX rounds the product first and
    lands one level lower on about a tenth of the values of a channel whose
    range is not the full 255)."""
    xi = torch.trunc(_clip(img))
    lo = xi.amin(dim=(0, 1))
    hi = xi.amax(dim=(0, 1))
    span = hi - lo
    # a true division (``255.0 / tensor`` would multiply by a reciprocal)
    scale = torch.full_like(span, 255.0) / torch.where(span > 0, span, torch.ones_like(span))
    out = torch.clamp(torch.trunc(fma(xi, scale, -(lo * scale))), 0, 255)
    return torch.where(span > 0, out, xi)


def equalize_lut_from_hist(hist: torch.Tensor) -> torch.Tensor:
    """PIL equalize LUTs (C, 256) float32 from (C, 256) histograms:
    ``(step // 2 + cumsum_{j<i} h[j]) // step`` with ``step = (total -
    h[last non-zero]) // 255``; identity for a channel with one value."""
    hist = hist.long()
    idx = torch.arange(256, device=hist.device)
    nz = hist > 0
    last = torch.where(nz, idx, torch.full_like(idx, -1)).amax(dim=1)
    h_last = torch.gather(hist, 1, last.clamp(min=0)[:, None])[:, 0]
    step = (hist.sum(dim=1) - h_last) // 255
    cum_before = torch.cumsum(hist, dim=1) - hist
    step_safe = torch.where(step > 0, step, torch.ones_like(step))[:, None]
    lut = torch.clamp((step_safe // 2 + cum_before) // step_safe, 0, 255)
    ident = (nz.sum(dim=1) <= 1) | (step == 0)
    return torch.where(ident[:, None], idx[None, :], lut).float()


def equalize(img: torch.Tensor) -> torch.Tensor:
    """PIL ImageOps.equalize: per-channel histogram (B6 on the card), LUT,
    table lookup."""
    x = _clip(img).to(torch.uint8) if img.dtype != torch.uint8 else img
    c = x.shape[-1]
    lut = equalize_lut_from_hist(image_hist256(x))               # (C, 256)
    flat = x.long() + 256 * torch.arange(c, device=x.device)
    return lut.reshape(-1)[flat]


def posterize(img: torch.Tensor, bits: int) -> torch.Tensor:
    """Keep the ``bits`` high bits of each value."""
    mask = (255 << (8 - int(bits))) & 255
    return (_clip(img).to(torch.int32) & mask).float()


def solarize(img: torch.Tensor, threshold) -> torch.Tensor:
    """Invert values at or above ``threshold``."""
    x = _clip(img)
    return torch.where(x < threshold, x, 255.0 - x)


def invert(img: torch.Tensor) -> torch.Tensor:
    return 255.0 - _clip(img)


def grayscale_l(img: torch.Tensor) -> torch.Tensor:
    """PIL 'L': ``(c0 * 19595 + c1 * 38470 + c2 * 7471 + 0x8000) >> 16``
    -> (H, W) float32 (channel 0 is taken as red, as the JAX package does)."""
    x = _clip(img).to(torch.int32)
    lum = (x[..., 0] * 19595 + x[..., 1] * 38470 + x[..., 2] * 7471 + 0x8000) >> 16
    return lum.float()


def blend(degenerate: torch.Tensor, img: torch.Tensor, factor) -> torch.Tensor:
    """PIL ``Image.blend``: ``trunc(degenerate + factor * (img - degenerate))``
    clipped to [0, 255]; ``factor`` is a host number or a float32 tensor
    that broadcasts against the image (one factor per pixel)."""
    f = factor if isinstance(factor, torch.Tensor) else float(np.float32(factor))
    return torch.clamp(torch.trunc(degenerate + f * (img - degenerate)), 0, 255)


def color_degenerate(x: torch.Tensor) -> torch.Tensor:
    """The gray image, on every channel."""
    return grayscale_l(x)[..., None].expand_as(x)


def contrast_degenerate(x: torch.Tensor) -> torch.Tensor:
    """The mean gray level, ``floor(mean + 0.5)``, everywhere; the sum of the
    integer gray levels and the mean are taken in float64 (exact sum, one
    division on the CPU and the card alike)."""
    gray = grayscale_l(x)
    mean = torch.floor((gray.double().sum() / gray.numel()).float() + 0.5)
    return mean.expand_as(x)


_SMOOTH = np.array([[1, 1, 1], [1, 5, 1], [1, 1, 1]], np.float32) / 13.0


def sharpness_degenerate(x: torch.Tensor) -> torch.Tensor:
    """PIL's SMOOTH filter (3x3 taps 1/13 and 5/13, ``floor(v + 0.5)``),
    whose 1-pixel border is the source image. The taps are summed
    elementwise in float32: the sums sit at least 1/26 from a rounding
    boundary, so their order does not matter."""
    h, w, _ = x.shape
    sm = sum(float(_SMOOTH[i, j]) * x[i:i + h - 2, j:j + w - 2]
             for i in range(3) for j in range(3))
    degenerate = x.clone()
    degenerate[1:-1, 1:-1] = torch.clamp(torch.floor(sm + 0.5), 0, 255)
    return degenerate


def enhance_color(img: torch.Tensor, factor) -> torch.Tensor:
    x = _clip(img)
    return blend(color_degenerate(x), x, factor)


def enhance_contrast(img: torch.Tensor, factor) -> torch.Tensor:
    x = _clip(img)
    return blend(contrast_degenerate(x), x, factor)


def enhance_brightness(img: torch.Tensor, factor) -> torch.Tensor:
    x = _clip(img)
    return blend(torch.zeros_like(x), x, factor)


def enhance_sharpness(img: torch.Tensor, factor) -> torch.Tensor:
    x = _clip(img)
    return blend(sharpness_degenerate(x), x, factor)
