"""Shared layers (port of ``oadg_tpu/models/layers.py``).

Counterparts:
- ``Conv`` <- ``Conv`` (``:46``): ``nn.Conv2d`` with symmetric padding, which
  is PyTorch's own padding; the JAX package's ``_S2DStemConv`` (``:133``, an
  exact refactoring of the 7x7/s2 stem, ``tests/test_s2d_stem.py:21``) is the
  plain conv here.
- ``conv_frozen_bn`` <- ``Conv(..., out_scale, out_bias)``, i.e.
  ``_AffineFoldConv`` (``:91``), as ``conv_norm`` calls it
  (``backbones/resnet.py:30-50``): the frozen-BN affine ``(w, b)`` folded
  into the conv, ``conv(x, K * w) + (bias * w + b)``.
- ``FrozenBN`` <- ``FrozenBN`` (``:202``) in its frozen mode
  (``norm_eval=True``): ``y = x * w + b`` with ``w = weight / sqrt(var + eps)``
  and ``b = bias - mean * w``, as the JAX package folds it. The statistics
  never update; ``weight`` and ``bias`` are trainable unless the config's
  ``norm_cfg.requires_grad`` is False (``oadg_tpu/engine/optim.py:35-62``).
- ``Linear`` <- ``flax.linen.Dense``.
- ``ConvModule`` <- mmcv's ConvModule without norm or activation, the form
  FPN uses, so ``state_dict`` keys read ``....conv.weight``.
- ``max_pool_3x3_s2`` <- ``max_pool_3x3_s2`` (``:426``).

Compute dtype (flax's ``dtype=``): parameters stay float32 and only the
compute is cast. With ``dtype=torch.bfloat16`` a conv or dense layer casts its
input and its kernel to bfloat16, computes in bfloat16 and adds its bias cast
to bfloat16 (``promote_dtype`` in flax); the folded conv forms ``K * w`` and
``bias * w + b`` in float32 and casts each once. ``dtype=None`` or float32 is
the float32 path: ``Conv`` and ``Linear`` are then ``nn.Conv2d`` and
``nn.Linear`` unchanged.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def _reduced(dtype) -> bool:
    return dtype is not None and dtype != torch.float32


class Conv(nn.Conv2d):
    """``nn.Conv2d`` with symmetric ``padding`` on ``device``, float32
    parameters and the compute dtype ``dtype``; weights come from the model's
    ``init_weights`` or a loaded ``state_dict``."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, dilation: int = 1,
                 bias: bool = True, device=None, dtype=None):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride,
                         padding=padding, dilation=dilation, bias=bias,
                         device=device)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        if not _reduced(dt):
            return super().forward(x)
        y = F.conv2d(x.to(dt), self.weight.to(dt), None, self.stride,
                     self.padding, self.dilation)
        return y if self.bias is None else y + self.bias.to(dt)[:, None, None]


class Linear(nn.Linear):
    """``nn.Linear`` with float32 parameters and the compute dtype ``dtype``
    (``flax.linen.Dense(dtype=...)``)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 device=None, dtype=None):
        super().__init__(in_features, out_features, bias=bias, device=device)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        if not _reduced(dt):
            return super().forward(x)
        y = F.linear(x.to(dt), self.weight.to(dt))
        return y if self.bias is None else y + self.bias.to(dt)


class ConvModule(nn.Module):
    """mmcv ConvModule with neither norm nor activation: ``self.conv``."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, device=None, dtype=None):
        super().__init__()
        self.conv = Conv(in_channels, out_channels, kernel_size, stride,
                         padding, device=device, dtype=dtype)

    def forward(self, x):
        return self.conv(x)


class FrozenBN(nn.Module):
    """BatchNorm with stored statistics that never update (mmdet
    ``norm_eval=True``) and an affine ``weight`` / ``bias`` that trains when
    ``requires_grad``; the keys match ``nn.BatchNorm2d`` without
    ``num_batches_tracked``. Unfolded, it computes in its input's dtype with
    ``w`` and ``b`` cast to it (``layers.py:278-281``)."""

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

    def affine(self):
        """The float32 per-channel ``(w, b)`` with ``y = x * w + b``
        (``FrozenBN(affine_only=True)``, ``layers.py:247-256``)."""
        w = self.weight * torch.rsqrt(self.running_var + self.eps)
        return w, self.bias - self.running_mean * w

    def forward(self, x):
        w, b = (t.to(x.dtype)[None, :, None, None] for t in self.affine())
        return x * w + b


def conv_frozen_bn(conv: Conv, bn: FrozenBN, x):
    """``bn(conv(x))`` with the frozen affine folded into the conv, in the
    conv's compute dtype: the kernel ``(K * w)`` and the bias
    ``conv.bias * w + b`` are formed in float32 and cast once, the bias
    added after the convolution in the compute dtype (``_AffineFoldConv``,
    ``layers.py:115-130``). The same math in float32."""
    dt = conv.compute_dtype if _reduced(conv.compute_dtype) else torch.float32
    w, b = bn.affine()
    if conv.bias is not None:
        b = b + conv.bias * w
    y = F.conv2d(x.to(dt), (conv.weight * w[:, None, None, None]).to(dt), None,
                 conv.stride, conv.padding, conv.dilation)
    return y + b.to(dt)[:, None, None]


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
