"""The image filters saliency needs (port of ``oadg_tpu/ops/image_ops.py:120-173``):
cv2's Gaussian kernel, separable filtering with the REFLECT_101 border, and
the 3x3 box blur. Images are (..., H, W, C), the JAX package's layout, with
any leading batch dimensions.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["gaussian_kernel1d", "box_blur3"]


def gaussian_kernel1d(sigma: float, ksize: int) -> np.ndarray:
    """cv2.getGaussianKernel for ``ksize`` taps of ``sigma`` (float32)."""
    half = (ksize - 1) / 2.0
    x = np.arange(ksize, dtype=np.float64) - half
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def _sep_conv(img: torch.Tensor, ky: np.ndarray, kx: np.ndarray) -> torch.Tensor:
    """Separable filtering of (..., H, W, C): REFLECT_101 pad (numpy's
    'reflect'), then the y taps, then the x taps, as valid correlations
    summed tap by tap in float32 (elementwise, so no TF32 convolution can
    stand in for it on the card)."""
    ry, rx = len(ky) // 2, len(kx) // 2
    *lead, h, w, c = img.shape
    x = img.reshape(-1, h, w, c).permute(0, 3, 1, 2)
    x = F.pad(x, (rx, rx, ry, ry), mode="reflect")
    x = sum(float(k) * x[:, :, i:i + h, :] for i, k in enumerate(ky))
    x = sum(float(k) * x[:, :, :, i:i + w] for i, k in enumerate(kx))
    return x.permute(0, 2, 3, 1).reshape(*lead, h, w, c)


def box_blur3(img: torch.Tensor) -> torch.Tensor:
    """cv2.blur(ksize=(3, 3)) with its default REFLECT_101 border."""
    k = np.ones(3, np.float32) / 3.0
    return _sep_conv(img, k, k)
