"""Mask head and its static-shape targets (port of
``oadg_tpu/models/roi_heads/mask_heads.py``; mmdet's ``fcn_mask_head.py:30``
and ``mask_target.py``).

Ground truth comes as each gt's mask cropped to its box at M0 x M0 (the
loader's (B, G, M0, M0), ``core/mask/structures.py``). A positive
proposal's target is its matched gt's crop resampled bilinearly onto the
proposal's ``mask_size`` x ``mask_size`` grid through the affinity between
the two boxes (``resample_box_to_box``, ``:27-53``), zero outside the gt's
box, then thresholded at 0.5 (``mask_targets``, ``:56-61``): static shapes
in place of mmdet's crop and resize of full-image bitmaps.

``FCNMaskHead`` (``:65-109``): ``num_convs`` 3x3 convs with ReLU, a 2x2
stride-2 transposed conv with ReLU, a 1x1 ``conv_logits`` to the classes;
(R, C, 14, 14) float32 RoI features in, (R, K, 28, 28) float32 logits out
(NCHW; the JAX package's are NHWC). Its convs compute in ``dtype`` (a
bfloat16 model casts input and kernel, adds the bias in bfloat16, as flax
does); the logits, the loss and the sigmoid are float32. mmdet keys:
``convs.{i}.conv``, ``upsample``, ``conv_logits``.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...parallel import shard_sum
from ...utils.registry import HEADS
from ..layers import Conv, ConvModule, _reduced, lecun_normal_, normal_


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` with one rounding, as XLA fuses it (the float64
    product of float32 values is exact)."""
    return (a.double() * b + c).float()


def _axis_sample(m: torch.Tensor, t: torch.Tensor, dim: int) -> torch.Tensor:
    """Linear interpolation of ``m`` (P, A, B) along ``dim`` (1 or 2) at the
    crop-pixel coordinates ``t`` (P, T), zero outside [-0.5, M0 - 0.5]."""
    m0 = m.shape[dim]
    t0 = torch.floor(t)
    w1 = t - t0
    i0 = t0.long()
    lo, hi = i0.clamp(0, m0 - 1), (i0 + 1).clamp(0, m0 - 1)
    inb = ((t >= -0.5) & (t <= m0 - 0.5)).to(m.dtype)
    if dim == 1:
        def take(i):
            return torch.gather(m, 1, i[:, :, None].expand(-1, -1, m.shape[2]))
        wb, inb = w1[:, :, None], inb[:, :, None]
    else:
        def take(i):
            return torch.gather(m, 2, i[:, None, :].expand(-1, m.shape[1], -1))
        wb, inb = w1[:, None, :], inb[:, None, :]
    return _fma(take(hi), wb.double(), (take(lo) * (1 - wb)).double()) * inb


def resample_box_to_box(mask: torch.Tensor, src_box: torch.Tensor,
                        dst_box: torch.Tensor, out_size: int) -> torch.Tensor:
    """Sample ``dst_box``'s ``out_size`` x ``out_size`` grid from ``mask``
    (P, M0, M0), which spans ``src_box`` (P, 4), boxes in image pixels ->
    (P, out_size, out_size) float32; zero outside ``src_box``. Batched over
    P (the JAX function is one box, vmapped). Rounded as XLA compiles the
    JAX function: the grid ``(i + 0.5) * f32(1 / out_size)``, fused
    multiply-adds for the sample positions and the crop coordinates, a true
    division by the source box's size, each lerp ``fma(b, w, a * (1 - w))``;
    so the result equals jitted JAX bit for bit."""
    m0 = mask.shape[-1]
    sx1, sy1, sx2, sy2 = src_box.float().unbind(-1)
    dx1, dy1, dx2, dy2 = dst_box.float().unbind(-1)
    sw = torch.clamp(sx2 - sx1, min=1e-6)
    sh = torch.clamp(sy2 - sy1, min=1e-6)
    c = torch.from_numpy((np.arange(out_size, dtype=np.float32) + np.float32(0.5))
                         * np.float32(1.0 / out_size)).to(mask.device)
    xs = _fma(c[None], (dx2 - dx1)[:, None], dx1[:, None].double())
    ys = _fma(c[None], (dy2 - dy1)[:, None], dy1[:, None].double())
    u = _fma((xs - sx1[:, None]) / sw[:, None], float(m0), -0.5)
    v = _fma((ys - sy1[:, None]) / sh[:, None], float(m0), -0.5)
    return _axis_sample(_axis_sample(mask.float(), v, 1), u, 2)


def mask_targets(pos_boxes: torch.Tensor, matched_gt_boxes: torch.Tensor,
                 matched_gt_masks: torch.Tensor, mask_size: int) -> torch.Tensor:
    """(P, 4) proposals, (P, 4) their gts' boxes, (P, M0, M0) the gts'
    box-cropped masks -> (P, mask_size, mask_size) binary float32 targets
    (the resample ``>= 0.5``)."""
    t = resample_box_to_box(matched_gt_masks, matched_gt_boxes, pos_boxes, mask_size)
    return (t >= 0.5).float()


class ConvTranspose(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` with float32 parameters and the compute dtype
    ``dtype`` (flax ``nn.ConvTranspose(dtype=...)``: input and kernel cast,
    the bias added in ``dtype``)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int, device=None, dtype=None):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride,
                         device=device)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        if not _reduced(dt):
            return super().forward(x)
        y = F.conv_transpose2d(x.to(dt), self.weight.to(dt), None, self.stride)
        return y + self.bias.to(dt)[:, None, None]


@HEADS.register_module()
class FCNMaskHead(nn.Module):

    def __init__(self, num_convs: int = 4, in_channels: int = 256,
                 conv_out_channels: int = 256, num_classes: int = 80,
                 class_agnostic: bool = False, loss_mask=None, device=None, dtype=None):
        """``loss_mask`` (the config's ``CrossEntropyLoss(use_mask=True)``) is
        taken and not read: the loss is the JAX head's BCE, weight 1."""
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.num_classes = num_classes
        self.class_agnostic = class_agnostic
        self.convs = nn.ModuleList(
            ConvModule(in_channels if i == 0 else conv_out_channels, conv_out_channels,
                       3, 1, 1, **kw)
            for i in range(num_convs))
        width = conv_out_channels if num_convs else in_channels
        self.upsample = ConvTranspose(width, conv_out_channels, 2, 2, **kw)
        self.conv_logits = Conv(conv_out_channels, 1 if class_agnostic else num_classes,
                                1, 1, 0, **kw)

    def init_weights(self, gen: torch.Generator):
        """LeCun-normal kernels (flax's default, fan-in ``in x 2 x 2`` for the
        transposed conv) and zero biases."""
        for m in (*(c.conv for c in self.convs), self.conv_logits):
            lecun_normal_(m.weight, gen)
        normal_(self.upsample.weight,
                1.0 / math.sqrt(self.upsample.in_channels * 4), gen)
        for m in (*(c.conv for c in self.convs), self.upsample, self.conv_logits):
            nn.init.zeros_(m.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(R, C, r, r) RoI features -> (R, K, 2 r, 2 r) float32 logits."""
        for c in self.convs:
            x = torch.relu(c(x))
        x = torch.relu(self.upsample(x))
        return self.conv_logits(x).float()

    def _selected(self, mask_pred: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        """(R, K, M, M) -> (R, M, M) at each roi's class (clipped to the
        classes; a background label takes the last)."""
        if self.class_agnostic:
            return mask_pred[:, 0]
        lab = labels.long().clamp(0, self.num_classes - 1)
        return torch.gather(mask_pred, 1, lab[:, None, None, None].expand(
            -1, 1, *mask_pred.shape[2:]))[:, 0]

    def loss(self, mask_pred: torch.Tensor, targets: torch.Tensor,
             labels: torch.Tensor, pos_valid: torch.Tensor) -> torch.Tensor:
        """Binary cross-entropy of the matched class's logits against the
        targets, the mean over pixels, then over the valid positives
        (``:85-100``), in float32; under data parallel over the valid
        positives of every rank (this rank's share)."""
        sel = self._selected(mask_pred, labels)
        per = (torch.clamp(sel, min=0) - sel * targets
               + torch.log1p(torch.exp(-sel.abs()))).mean(dim=(1, 2))
        w = pos_valid.float()
        return (per * w).sum() / torch.clamp(shard_sum(w.sum()), min=1.0)

    def get_masks(self, mask_pred: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        """Each detection's mask probabilities at its class: (R, M, M)."""
        return torch.sigmoid(self._selected(mask_pred, labels))
