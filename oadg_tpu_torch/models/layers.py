"""Shared layers (port of ``oadg_tpu/models/layers.py``).

Counterparts:
- ``Conv`` <- ``Conv`` (``:46``): ``nn.Conv2d`` with symmetric padding, which
  is PyTorch's own padding; the JAX package's ``_S2DStemConv`` (``:133``, an
  exact refactoring of the 7x7/s2 stem, ``tests/test_s2d_stem.py:21``) is the
  plain conv here, and ``_AffineFoldConv`` (``:91``) is the conv followed by
  ``FrozenBN``.
- ``FrozenBN`` <- ``FrozenBN`` (``:202``) in its frozen mode
  (``norm_eval=True``): ``y = x * w + b`` with ``w = weight / sqrt(var + eps)``
  and ``b = bias - mean * w``, as the JAX package folds it. The statistics
  never update; ``weight`` and ``bias`` are trainable unless the config's
  ``norm_cfg.requires_grad`` is False (``oadg_tpu/engine/optim.py:35-62``).
- ``ConvModule`` <- mmcv's ConvModule without norm or activation, the form
  FPN uses, so ``state_dict`` keys read ``....conv.weight``.
- ``max_pool_3x3_s2`` <- ``max_pool_3x3_s2`` (``:426``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def Conv(in_channels: int, out_channels: int, kernel_size: int,
         stride: int = 1, padding: int = 0, dilation: int = 1,
         bias: bool = True, device=None) -> nn.Conv2d:
    """``nn.Conv2d`` with symmetric ``padding`` on ``device``; weights come
    from the model's ``init_weights`` or a loaded ``state_dict``."""
    return nn.Conv2d(in_channels, out_channels, kernel_size, stride=stride,
                     padding=padding, dilation=dilation, bias=bias,
                     device=device)


class ConvModule(nn.Module):
    """mmcv ConvModule with neither norm nor activation: ``self.conv``."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, device=None):
        super().__init__()
        self.conv = Conv(in_channels, out_channels, kernel_size, stride,
                         padding, device=device)

    def forward(self, x):
        return self.conv(x)


class FrozenBN(nn.Module):
    """BatchNorm with stored statistics that never update (mmdet
    ``norm_eval=True``) and an affine ``weight`` / ``bias`` that trains when
    ``requires_grad``; the keys match ``nn.BatchNorm2d`` without
    ``num_batches_tracked``."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 requires_grad: bool = True, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features, device=device),
                                   requires_grad=requires_grad)
        self.bias = nn.Parameter(torch.zeros(num_features, device=device),
                                 requires_grad=requires_grad)
        self.register_buffer("running_mean", torch.zeros(num_features, device=device))
        self.register_buffer("running_var", torch.ones(num_features, device=device))

    def forward(self, x):
        w = self.weight * torch.rsqrt(self.running_var + self.eps)
        b = self.bias - self.running_mean * w
        return x * w[None, :, None, None] + b[None, :, None, None]


def max_pool_3x3_s2(x):
    """``MaxPool2d(kernel_size=3, stride=2, padding=1)``."""
    return F.max_pool2d(x, 3, stride=2, padding=1)


def normal_(t: torch.Tensor, std: float, gen: torch.Generator):
    """Fill ``t`` with N(0, std^2) drawn on the CPU from ``gen`` (so a seed
    gives the same weights on every device)."""
    with torch.no_grad():
        t.copy_(torch.randn(t.shape, generator=gen) * std)


def lecun_normal_(t: torch.Tensor, gen: torch.Generator):
    """N(0, 1/fan_in): the JAX package's default conv and dense init."""
    fan_in = t[0].numel() if t.dim() > 1 else t.numel()
    normal_(t, 1.0 / math.sqrt(fan_in), gen)


def xavier_uniform_(t: torch.Tensor, gen: torch.Generator):
    """U(-a, a), a = sqrt(6 / (fan_in + fan_out)), for a Linear weight."""
    fan_out, fan_in = t.shape
    a = math.sqrt(6.0 / (fan_in + fan_out))
    with torch.no_grad():
        t.copy_((torch.rand(t.shape, generator=gen) * 2 - 1) * a)


def init_default_(module: nn.Module, gen: torch.Generator):
    """LeCun-normal weights and zero biases for every Conv2d / Linear under
    ``module``; frozen BN stays identity."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            lecun_normal_(m.weight, gen)
            if m.bias is not None:
                with torch.no_grad():
                    m.bias.zero_()
