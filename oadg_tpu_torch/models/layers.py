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
- ``ConvModule`` <- ``ConvModule`` (``:335-360``): mmcv's conv -> norm ->
  activation. Without ``norm_cfg`` and ``act`` it is the plain conv FPN
  uses (keys ``....conv.weight``, ``....conv.bias``); with a BN ``norm_cfg``
  the conv has no bias and the norm is ``self.bn`` (keys
  ``....bn.{weight,bias,running_mean,running_var}``), the activation
  ``leaky_relu`` (slope 0.1), ``relu`` or ``relu6``; ``groups`` groups the
  conv (MobileNetV2's depthwise 3x3s).
- ``BatchNorm`` <- ``FrozenBN`` (``:202-281``) applied unfolded, as
  ``build_norm`` (``:298-324``) builds it for a ``ConvModule``: in train
  mode the live statistics of ``FrozenBN(frozen=False)``, in eval mode (or
  under a backbone's ``norm_eval``, which puts its BNs in eval mode) the
  stored ones.
- ``ModulatedDeformConv`` <- ``ModulatedDeformConv`` (``:390-423``), the
  DCNv2 layer of ``dcn=dict(type='DCNv2')`` backbones; ``DeformConv`` <-
  ``DeformConv`` (``:363-387``), the DCNv1 layer with offsets from outside
  (VFNet's star convs).
- ``Scale``: mmcv's per-level scalar, one entry of the JAX heads'
  ``scales`` parameter; ``ConvGN``: a conv, its ``GroupNorm32`` and a ReLU
  (the GN towers).
- ``GroupNorm32`` <- ``GroupNorm32`` (``:285-293``): flax's ``GroupNorm``
  with its epsilon 1e-6 (torch's default is 1e-5), the group count lowered
  to the largest divisor of the channels not above the one asked for (36
  for 576 channels); it normalizes in float32 and returns float32, as flax
  promotes a bfloat16 input against its float32 scale and bias.
- ``build_norm`` <- ``build_norm`` (``:298-324``): ``BN`` (the live
  ``BatchNorm`` of a ``ConvModule``) or ``GN`` (``GroupNorm32``).
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

from ..parallel import all_reduce_sum_grad, batch_is_sharded


def _reduced(dtype) -> bool:
    return dtype is not None and dtype != torch.float32


class Conv(nn.Conv2d):
    """``nn.Conv2d`` with symmetric ``padding`` on ``device``, float32
    parameters and the compute dtype ``dtype``; weights come from the model's
    ``init_weights`` or a loaded ``state_dict``."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, dilation: int = 1,
                 bias: bool = True, groups: int = 1, device=None, dtype=None):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride,
                         padding=padding, dilation=dilation, bias=bias,
                         groups=groups, device=device)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        if not _reduced(dt):
            return super().forward(x)
        y = F.conv2d(x.to(dt), self.weight.to(dt), None, self.stride,
                     self.padding, self.dilation, self.groups)
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


def widen(x: torch.Tensor) -> torch.Tensor:
    """``x`` in float32, or as it is if it is wider (a float64 copy of a
    model, ``model.double()``, then computes its statistics and losses in
    float64: the reference the card's float32 step is held to)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def leaky_relu(x: torch.Tensor, slope: float = 0.1) -> torch.Tensor:
    """``flax.linen.leaky_relu``: ``where(x >= 0, x, slope * x)`` with the
    slope in ``x``'s dtype (bfloat16's 0.1 is 0.10009765625), the product
    rounded to it; in float32 ``F.leaky_relu``."""
    if x.dtype == torch.float32:
        return F.leaky_relu(x, slope)
    return torch.where(x >= 0, x, x * torch.tensor(slope, dtype=x.dtype, device=x.device))


class BatchNorm(nn.Module):
    """BatchNorm over the channels of an NCHW tensor, the JAX package's
    ``FrozenBN`` unfolded (``layers.py:258-281``), keys as
    ``nn.BatchNorm2d``'s without ``num_batches_tracked``.

    In train mode (live BN) the batch statistics are formed in float32 (in
    float64 for a float64 input) as
    ``E[x] and max(E[x^2] - E[x]^2, 0)``, and the stored ones move by the
    torch ``momentum``: ``mom * stored + (1 - mom) * batch`` with ``mom = 1 -
    momentum``, the variance's batch term ``(1 - mom) * var * n / (n - 1)``
    (torch stores the unbiased estimate). In eval mode the stored statistics
    are used. On a rank's shard of the global batch
    (``parallel.batch_is_sharded``, which the data-parallel train step
    sets) the train-mode statistics are the global batch's: the
    per-channel sums, sums of squares and pixel counts are all-reduced,
    with their gradient (SyncBN, as the JAX mesh computes them and mmcv's
    ``SyncBatchNorm`` in the reference), so the stored ones agree on every
    rank. Either way ``w = weight * rsqrt(var +
    eps)`` and ``b = bias - mean * weight * rsqrt(var + eps)`` are formed in
    float32, cast to the input's dtype, and ``y = x * w + b`` computes in
    it. (``nn.BatchNorm2d`` forms its variance otherwise.)"""

    def __init__(self, num_features: int, eps: float = 1e-5, momentum: float = 0.1,
                 device=None):
        super().__init__()
        self.eps = float(eps)
        self.momentum = float(momentum)
        self.weight = nn.Parameter(torch.ones(num_features, device=device))
        self.bias = nn.Parameter(torch.zeros(num_features, device=device))
        self.register_buffer("running_mean", torch.zeros(num_features, device=device))
        self.register_buffer("running_var", torch.ones(num_features, device=device))

    def forward(self, x):
        if self.training:
            xf = widen(x)
            n = x.numel() // x.shape[1]
            if batch_is_sharded():        # SyncBN: the global batch's statistics
                c = x.shape[1]
                sums = all_reduce_sum_grad(torch.cat([xf.sum(dim=(0, 2, 3)),
                                                      (xf * xf).sum(dim=(0, 2, 3)),
                                                      xf.new_full((1,), n)]))
                n = sums[2 * c]           # every rank's pixels
                m = sums[:c] / n
                v = sums[c:2 * c] / n - m * m
                corr = n / torch.clamp_min(n - 1, 1)
            else:
                m = xf.mean(dim=(0, 2, 3))
                v = (xf * xf).mean(dim=(0, 2, 3)) - m * m
                corr = n / max(n - 1, 1)
            v = torch.maximum(v, torch.zeros_like(v))
            mom = 1.0 - self.momentum
            with torch.no_grad():
                self.running_mean.copy_(mom * self.running_mean + (1.0 - mom) * m)
                self.running_var.copy_(mom * self.running_var + (1.0 - mom) * v * corr)
        else:
            m, v = self.running_mean, self.running_var
        inv = torch.rsqrt(v + self.eps)
        w = (self.weight * inv).to(x.dtype)
        b = (self.bias - m * self.weight * inv).to(x.dtype)
        return x * w[:, None, None] + b[:, None, None]


class GroupNorm32(nn.Module):
    """flax ``GroupNorm`` over the channels of an NCHW tensor (keys
    ``weight``, ``bias``): ``num_groups`` lowered to the largest divisor of
    ``num_channels`` not above it, epsilon 1e-6; float32 out (float64 for
    a float64 input). A group of one value (one channel a group on a 1x1
    map: a one-stage head's top level at narrow widths) normalizes to its
    bias (up to float32 rounding), as flax's does; ``F.group_norm`` would
    refuse it, so the ATen op is called directly."""

    def __init__(self, num_channels: int, num_groups: int = 32, device=None):
        super().__init__()
        ng = min(num_groups, num_channels)
        while num_channels % ng:
            ng -= 1
        self.num_groups = ng
        self.weight = nn.Parameter(torch.ones(num_channels, device=device))
        self.bias = nn.Parameter(torch.zeros(num_channels, device=device))

    def forward(self, x):
        x = widen(x)
        return torch.group_norm(x, self.num_groups, self.weight.to(x.dtype),
                                self.bias.to(x.dtype), 1e-6, torch.backends.cudnn.enabled)


def build_norm(norm_cfg: dict, num_channels: int, device=None) -> nn.Module:
    """An mmdet ``norm_cfg`` -> its module over ``num_channels``: ``BN`` the
    live ``BatchNorm`` (its ``eps`` and torch ``momentum`` honoured), ``GN``
    ``GroupNorm32`` of its ``num_groups`` (32 unless given)."""
    kind = norm_cfg.get("type", "BN")
    if kind == "BN":
        return BatchNorm(num_channels, eps=norm_cfg.get("eps", 1e-5),
                         momentum=norm_cfg.get("momentum", 0.1), device=device)
    if kind == "GN":
        return GroupNorm32(num_channels, int(norm_cfg.get("num_groups", 32)), device=device)
    raise NotImplementedError(f"norm {kind}: the port builds BN and GN")


class ConvGN(nn.Module):
    """A conv (with a bias, as the JAX package's ``Conv``), its
    ``GroupNorm32`` and a ReLU: keys ``conv.*`` and ``gn.*`` (mmcv's
    ``ConvModule`` with a GN ``norm_cfg`` has no conv bias). The GN towers
    of Grid R-CNN and the one-stage heads; float32 out."""

    def __init__(self, in_channels: int, out_channels: int, num_groups: int = 32,
                 kernel_size: int = 3, padding: int = 1, device=None, dtype=None):
        super().__init__()
        self.conv = Conv(in_channels, out_channels, kernel_size, 1, padding, device=device,
                         dtype=dtype)
        self.gn = build_norm(dict(type="GN", num_groups=num_groups), out_channels, device)

    def forward(self, x):
        return torch.relu(self.gn(self.conv(x)))


class Scale(nn.Module):
    """mmcv ``Scale``: one learned float32 scalar (key ``scale``), a level's
    entry of the JAX heads' per-level ``scales`` vector. ``forward`` scales
    ``x`` cast to float32 (as the JAX heads cast a bfloat16 conv output
    before the product)."""

    def __init__(self, scale: float = 1.0, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.tensor(float(scale), device=device))

    def forward(self, x):
        return self.scale * widen(x)


class ConvModule(nn.Module):
    """mmcv ConvModule: ``self.conv``, then ``self.bn`` with a BN
    ``norm_cfg`` (its ``eps`` and torch ``momentum`` honoured; the conv then
    has no bias unless ``bias`` says so, as the JAX ``Conv`` before a live
    BN of YOLOF's head and neck has), then ``act`` (``"leaky_relu"``, slope 0.1,
    ``"relu"`` or ``"relu6"``). With neither it is the plain conv FPN uses."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, norm_cfg=None, act=None,
                 dilation: int = 1, bias=None, groups: int = 1, device=None, dtype=None):
        super().__init__()
        if norm_cfg is not None and norm_cfg.get("type", "BN") != "BN":
            raise NotImplementedError(f"ConvModule norm {norm_cfg['type']}")
        if act not in (None, "leaky_relu", "relu", "relu6"):
            raise NotImplementedError(f"ConvModule activation {act}")
        self.conv = Conv(in_channels, out_channels, kernel_size, stride, padding,
                         dilation=dilation, bias=norm_cfg is None if bias is None else bias,
                         groups=groups, device=device, dtype=dtype)
        self.bn = None if norm_cfg is None else build_norm(norm_cfg, out_channels, device)
        self.act = act

    def forward(self, x):
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x)
        if self.act == "relu":
            return torch.relu(x)
        if self.act == "relu6":
            return F.relu6(x)
        return leaky_relu(x) if self.act == "leaky_relu" else x


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
                 conv.stride, conv.padding, conv.dilation, conv.groups)
    return y + b.to(dt)[:, None, None]


class ModulatedDeformConv(nn.Module):
    """DCNv2 that predicts its own offsets and modulation (mmcv
    ``ModulatedDeformConv2dPack``, ``layers.py:390-423``): ``conv_offset``
    (a biased conv of the layer's geometry, ``3 * deform_groups * K``
    outputs) gives the offsets (its first ``2 dg K`` channels) and, through
    a sigmoid, the modulation, both in float32; then
    ``ops.deform_conv.modulated_deform_conv2d`` in the compute dtype. mmcv
    keys: ``weight`` (C_out, C_in, kh, kw), ``bias``,
    ``conv_offset.weight`` and ``conv_offset.bias``."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 stride: int = 1, padding: int = 1, dilation: int = 1,
                 deform_groups: int = 1, bias: bool = False, device=None, dtype=None):
        super().__init__()
        self.stride, self.padding, self.dilation = stride, padding, dilation
        self.deform_groups = deform_groups
        self.compute_dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, kernel_size,
                                               kernel_size, device=device))
        self.bias = (nn.Parameter(torch.zeros(out_channels, device=device))
                     if bias else None)
        self.conv_offset = Conv(in_channels, 3 * deform_groups * kernel_size ** 2,
                                kernel_size, stride, padding, dilation, bias=True,
                                device=device, dtype=dtype)

    def init_weights(self, gen: torch.Generator):
        """He-normal weight and zero bias; ``conv_offset`` zero, as mmcv
        starts it (offsets 0, modulation 0.5). The JAX package draws
        ``conv_offset`` LeCun-normal despite its comment (ROADMAP C)."""
        normal_(self.weight, math.sqrt(2.0 / self.weight[0].numel()), gen)
        with torch.no_grad():
            self.conv_offset.weight.zero_()
            self.conv_offset.bias.zero_()
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x):
        from ..ops.deform_conv import modulated_deform_conv2d
        dt = self.compute_dtype if _reduced(self.compute_dtype) else torch.float32
        om = self.conv_offset(x).float()
        nk = 2 * om.shape[1] // 3
        return modulated_deform_conv2d(
            x.to(dt), om[:, :nk], torch.sigmoid(om[:, nk:]), self.weight.to(dt),
            self.stride, self.padding, self.dilation, self.deform_groups, self.bias)


class DeformConv(nn.Module):
    """DCNv1 with offsets from outside (mmcv ``DeformConv2d``,
    ``layers.py:363-387``): ``ops.deform_conv.deform_conv2d`` in the
    input's dtype, the weight cast to it, as the JAX layer computes (its
    kernel follows ``x.dtype``, not the model's: VFNet feeds it GroupNorm's
    float32 output in a bfloat16 model too). mmcv key ``weight`` (C_out,
    C_in, k, k); no bias unless ``bias``."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 stride: int = 1, padding: int = 1, dilation: int = 1,
                 deform_groups: int = 1, bias: bool = False, device=None):
        super().__init__()
        self.stride, self.padding, self.dilation = stride, padding, dilation
        self.deform_groups = deform_groups
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, kernel_size,
                                               kernel_size, device=device))
        self.bias = (nn.Parameter(torch.zeros(out_channels, device=device))
                     if bias else None)

    def init_weights(self, gen: torch.Generator):
        """He-normal weight (flax's ``he_normal``), zero bias."""
        normal_(self.weight, math.sqrt(2.0 / self.weight[0].numel()), gen)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()

    def forward(self, x, offset):
        from ..ops.deform_conv import deform_conv2d
        return deform_conv2d(x, offset, self.weight.to(x.dtype), self.stride, self.padding,
                             self.dilation, self.deform_groups, self.bias)


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
    ``module``, then each ``ModulatedDeformConv``'s and ``DeformConv``'s own
    init; frozen BN stays identity."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            lecun_normal_(m.weight, gen)
            if m.bias is not None:
                with torch.no_grad():
                    m.bias.zero_()
    for m in module.modules():
        if isinstance(m, (ModulatedDeformConv, DeformConv)):
            m.init_weights(gen)
