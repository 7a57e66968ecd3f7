"""NAS-FPN, NAS-FCOS's FPN, FPN-CARAFE and FPG (port of
``oadg_tpu/models/necks/more_necks.py:23-257, 397-428``; its SSD, CenterNet and
RFP necks are not ported).

The two NAS necks are built of mmcv ``ConvModule``s with a live BN (the JAX
``ConvModule`` with a ``BN`` norm builds ``FrozenBN(frozen=False)``,
``layers.py:297-320,335-360``): the conv has no bias, the BN normalizes with
the batch's statistics in train mode (all-reduced under data parallel:
SyncBN) and moves its stored ones, and uses the stored ones in eval mode
(``layers.BatchNorm``). ``in_channels`` lists the channels of the maps the
neck takes (``inputs[start_level:]``, every input where ``start_level`` is
0), one lateral a map; the JAX modules read the channels from their inputs
and ignore the argument.

- ``NASFPN`` (``:76-126``): 1x1 laterals with BN (``lateral_convs.i``), 2x2
  max-pools (floor sizes) up to ``num_outs`` (>= 5) levels P3..P7, then
  ``stack_times`` stacks of JAX's eight merging cells in JAX's order, each
  ``relu(merge(a, b))`` resized to its output level, a 3x3 conv and BN
  (``fpn_stages.s.<cell>.out_conv``). The cells' names are mmdet's where JAX
  has the counterpart (``gp_64_4``, ``sum_44_4``, ``sum_43_3``,
  ``sum_34_4``, ``gp_43_5``, ``sum_55_5``, ``gp_75_6``; JAX's
  ``s{s}_gp64_4`` ...) and ``gp_55_7`` for JAX's p7 cell, which mmdet's
  topology lacks (mmdet: ``gp_54_7`` without a conv, then ``sum_77_7``). A
  global-pooling cell computes ``a + sigmoid(mean_hw(a)) * b`` (the mean in
  float32), mmdet's ``b + sigmoid(gp(b)) * a`` (ROADMAP C).
- ``NASFCOS_FPN`` (``:397-428``): 1x1 laterals with BN (``adapt_convs.i``,
  mmdet's name), then top-down from the last level ``merge{i}``
  (``merge_convs.{i - 1}``): the level below becomes ``BN(conv3x3(relu(its
  lateral + the level above resized to it)))``; then 2x2 max-pools up to
  ``num_outs``. mmdet's NAS-FCOS neck is a searched concat topology the JAX
  one does not have.

- ``FPN_CARAFE`` (``:129-183``): 1x1 laterals with a bias
  (``lateral_convs.i``), then top-down from the last level: the level's
  ``upsample_modules.{i - 1}`` (mmcv's ``CARAFEPack`` names:
  ``channel_compressor``, a 1x1 to ``compressed_channels``;
  ``content_encoder``, a 3x3 to ``4 * G * k * k``) gives the kernels of the
  four sub-pixel phases, channel ``(sy * 2 + sx) * G * k * k + tap`` (JAX's
  reshape; mmcv's ``pixel_shuffle`` reads ``tap * 4 + sy * 2 + sx``, which
  ``load_mmdet_checkpoint`` permutes), a softmax over each group's k * k
  taps in float32, then ``ops.misc_ops.carafe``; the 2x map cropped to the
  level below and added (``upsample_cfg``'s ``type`` and
  ``encoder_dilation`` are ignored, as in JAX). Then ``fpn_convs.i`` (3x3
  with a bias) and 2x2 max-pools up to ``num_outs`` (JAX's P6; mmdet's a
  stride-2 conv of C5 with its own CARAFE, which ``load_mmdet_checkpoint``
  refuses; ROADMAP C).
- ``FPG`` (``:186-257``): the JAX package's simplified grid, not mmdet's
  FPG (whose checkpoints ``load_mmdet_checkpoint`` refuses): 1x1 laterals to
  ``inter_channels`` with a bias (``lateral_convs.i``), 2x2 max-pools up to
  ``num_outs`` levels, then ``stack_times`` stacks in which each level adds
  to itself a stride-2 3x3 conv and BN of the level below
  (``down_convs.s.{i - 1}``) and a 3x3 conv and BN of the level above
  resized to it (``up_convs.s.i``), then a ReLU; then a 3x3 conv and BN a
  level (``out_convs.i``). Every BN is live. Where a max-pooled level and
  the stride-2 conv of the level below differ in size (a map with an odd
  side pooled: P6 of a canvas whose P5 is 25x42), it raises ``ValueError``
  naming both sizes; the JAX FPG raises ``TypeError`` on the sum.

Resizing is JAX's ``jax.image.resize(..., "nearest")``: output index ``i``
reads ``floor((i + 0.5) * in / out)`` (float32), as torch's
``nearest-exact`` (on a 2x downsample rows 1, 3, 5, ...; ``nearest`` reads
0, 2, 4, ...); the index is formed as JAX forms it and gathered.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.misc_ops import carafe
from ...utils.registry import NECKS
from ..layers import Conv, ConvModule


def _up2(x, times: int = 1):
    """Repeat each pixel 2x2, ``times`` times (``:23``)."""
    for _ in range(times):
        x = x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
    return x


def _down2(x, times: int = 1):
    """A 2x2 max-pool of stride 2 (floor sizes), ``times`` times (``:29``)."""
    for _ in range(times):
        x = F.max_pool2d(x, 2, 2)
    return x


@lru_cache(maxsize=None)
def _nearest_index(n_in: int, n_out: int, device: torch.device) -> torch.Tensor:
    """JAX's nearest index of each of ``n_out`` outputs into ``n_in``, on
    ``device``: ``floor((arange + 0.5) * n_in / n_out)`` in float32 (a
    product that is exact, then one rounded division), formed on the host;
    a normal tensor even when first asked for under ``inference_mode`` (the
    cache outlives it)."""
    with torch.inference_mode(False):
        pos = (torch.arange(n_out, dtype=torch.float32) + 0.5) * float(n_in) / float(n_out)
        return torch.floor(pos).long().to(device)


def _resize_to(x, hw):
    """Nearest resize of (N, C, H, W) ``x`` to ``hw`` (``:35``)."""
    if tuple(x.shape[2:]) == tuple(hw):
        return x
    iy = _nearest_index(x.shape[2], int(hw[0]), x.device)
    ix = _nearest_index(x.shape[3], int(hw[1]), x.device)
    return x[:, :, iy[:, None], ix[None, :]]


def _bn_cfg(norm_cfg):
    return dict(norm_cfg or dict(type="BN"))


class MergeCell(nn.Module):
    """One NAS-FPN cell (``_GPCell`` ``:43-58`` with ``global_pool``,
    ``_SumCell`` ``:61-73`` without): both inputs resized to ``out_hw``,
    merged, ReLU, then ``out_conv`` (3x3 conv and BN)."""

    def __init__(self, channels: int, global_pool: bool, norm_cfg=None, device=None,
                 dtype=None):
        super().__init__()
        self.global_pool = global_pool
        self.out_conv = ConvModule(channels, channels, 3, 1, 1, norm_cfg=_bn_cfg(norm_cfg),
                                   device=device, dtype=dtype)

    def forward(self, a, b, out_hw):
        a, b = _resize_to(a, out_hw), _resize_to(b, out_hw)
        if self.global_pool:
            att = torch.sigmoid(a.float().mean(dim=(2, 3), keepdim=True)).to(b.dtype)
            merged = a + att * b
        else:
            merged = a + b
        return self.out_conv(F.relu(merged))


# (name, global pooling) of JAX's eight cells a stack, in its order
NAS_CELLS = (("gp_64_4", True), ("sum_44_4", False), ("sum_43_3", False), ("sum_34_4", False),
             ("gp_43_5", True), ("sum_55_5", False), ("gp_55_7", True), ("gp_75_6", True))


@NECKS.register_module()
class NASFPN(nn.Module):

    def __init__(self, in_channels: Sequence[int] = (512, 1024, 2048), out_channels: int = 256,
                 num_outs: int = 5, stack_times: int = 7, start_level: int = 0,
                 end_level: int = -1, norm_cfg=None, init_cfg=None, device=None, dtype=None):
        super().__init__()
        if num_outs < 5:
            raise ValueError(f"NASFPN merges P3..P7: num_outs {num_outs} is below 5")
        self.start_level = start_level
        self.num_outs = num_outs
        conv = dict(norm_cfg=_bn_cfg(norm_cfg), device=device, dtype=dtype)
        self.lateral_convs = nn.ModuleList(ConvModule(c, out_channels, 1, 1, 0, **conv)
                                           for c in in_channels)
        self.fpn_stages = nn.ModuleList(
            nn.ModuleDict({name: MergeCell(out_channels, gp, **conv) for name, gp in NAS_CELLS})
            for _ in range(stack_times))

    def forward(self, inputs):
        ins = list(inputs[self.start_level:])
        if len(ins) != len(self.lateral_convs):
            raise ValueError(f"NASFPN takes {len(ins)} maps from level {self.start_level} and "
                             f"has {len(self.lateral_convs)} laterals (in_channels)")
        feats = [conv(x) for conv, x in zip(self.lateral_convs, ins)]
        while len(feats) < self.num_outs:
            feats.append(_down2(feats[-1]))
        hw = [tuple(f.shape[2:]) for f in feats]
        p3, p4, p5, p6, p7 = feats[:5]
        for stage in self.fpn_stages:
            g4 = stage["gp_64_4"](p6, p4, hw[1])
            s4 = stage["sum_44_4"](g4, p4, hw[1])
            p3 = stage["sum_43_3"](s4, p3, hw[0])
            p4 = stage["sum_34_4"](p3, s4, hw[1])
            g5 = stage["gp_43_5"](p4, p3, hw[2])
            p5 = stage["sum_55_5"](g5, p5, hw[2])
            p7 = stage["gp_55_7"](p5, p7, hw[4])
            p6 = stage["gp_75_6"](p7, p5, hw[3])
        return (p3, p4, p5, p6, p7)[:self.num_outs]


@NECKS.register_module()
class NASFCOS_FPN(nn.Module):

    def __init__(self, in_channels: Sequence[int] = (512, 1024, 2048), out_channels: int = 256,
                 num_outs: int = 5, start_level: int = 1, end_level: int = -1, norm_cfg=None,
                 init_cfg=None, device=None, dtype=None):
        super().__init__()
        self.start_level = start_level
        self.num_outs = num_outs
        conv = dict(norm_cfg=_bn_cfg(norm_cfg), device=device, dtype=dtype)
        self.adapt_convs = nn.ModuleList(ConvModule(c, out_channels, 1, 1, 0, **conv)
                                         for c in in_channels)
        self.merge_convs = nn.ModuleList(ConvModule(out_channels, out_channels, 3, 1, 1, **conv)
                                         for _ in in_channels[1:])

    def out_strides(self, in_strides: Sequence[int]):
        """The strides of the outputs on backbone maps of ``in_strides``: those
        of the maps taken, then one doubling a max-pool level."""
        out = list(in_strides[self.start_level:])
        while len(out) < self.num_outs:
            out.append(out[-1] * 2)
        return out

    def forward(self, inputs):
        ins = list(inputs[self.start_level:])
        if len(ins) != len(self.adapt_convs):
            raise ValueError(f"NASFCOS_FPN takes {len(ins)} maps from level "
                             f"{self.start_level} and has {len(self.adapt_convs)} laterals "
                             "(in_channels)")
        lats = [conv(x) for conv, x in zip(self.adapt_convs, ins)]
        for i in range(len(lats) - 1, 0, -1):
            up = _resize_to(lats[i], lats[i - 1].shape[2:])
            lats[i - 1] = self.merge_convs[i - 1](F.relu(lats[i - 1] + up))
        while len(lats) < self.num_outs:
            lats.append(_down2(lats[-1]))
        return tuple(lats)


class CARAFEPack(nn.Module):
    """CARAFE's kernel prediction and reassembly at scale 2: mmcv's names,
    JAX's channel order of the encoder's outputs (``:163-175``)."""

    def __init__(self, channels: int, up_kernel: int = 5, up_group: int = 1,
                 encoder_kernel: int = 3, compressed_channels: int = 64, device=None,
                 dtype=None):
        super().__init__()
        self.k, self.g = up_kernel, up_group
        self.channel_compressor = Conv(channels, compressed_channels, 1, device=device,
                                       dtype=dtype)
        self.content_encoder = Conv(compressed_channels, up_kernel * up_kernel * up_group * 4,
                                    encoder_kernel, 1, encoder_kernel // 2, device=device,
                                    dtype=dtype)

    def forward(self, x):
        enc = self.content_encoder(self.channel_compressor(x))
        b, _, h, w = enc.shape
        gkk = self.g * self.k * self.k
        masks = enc.view(b, 2, 2, gkk, h, w).permute(0, 3, 4, 1, 5, 2).reshape(
            b, self.g, self.k * self.k, 2 * h, 2 * w)
        masks = torch.softmax(masks.float(), dim=2).reshape(b, gkk, 2 * h, 2 * w)
        return carafe(x, masks, self.k, self.g, 2)


@NECKS.register_module()
class FPN_CARAFE(nn.Module):

    def __init__(self, in_channels: Sequence[int] = (256, 512, 1024, 2048),
                 out_channels: int = 256, num_outs: int = 5, start_level: int = 0,
                 end_level: int = -1, upsample_cfg=None, norm_cfg=None, act_cfg=None,
                 order=None, init_cfg=None, device=None, dtype=None):
        super().__init__()
        up = dict(upsample_cfg or {})
        self.start_level, self.num_outs = start_level, num_outs
        kw = dict(device=device, dtype=dtype)
        ins = list(in_channels[start_level:])
        self.lateral_convs = nn.ModuleList(ConvModule(c, out_channels, 1, **kw) for c in ins)
        self.upsample_modules = nn.ModuleList(
            CARAFEPack(out_channels, int(up.get("up_kernel", 5)), int(up.get("up_group", 1)),
                       int(up.get("encoder_kernel", 3)), int(up.get("compressed_channels", 64)),
                       **kw)
            for _ in ins[1:])
        self.fpn_convs = nn.ModuleList(
            ConvModule(out_channels, out_channels, 3, 1, 1, norm_cfg=norm_cfg, **kw)
            for _ in ins)

    def forward(self, inputs):
        laterals = [conv(x) for conv, x in zip(self.lateral_convs, inputs[self.start_level:])]
        for i in range(len(laterals) - 1, 0, -1):
            up = self.upsample_modules[i - 1](laterals[i])
            tgt = laterals[i - 1]
            laterals[i - 1] = tgt + up[:, :, :tgt.shape[2], :tgt.shape[3]]
        outs = [conv(x) for conv, x in zip(self.fpn_convs, laterals)]
        while len(outs) < self.num_outs:
            outs.append(_down2(outs[-1]))
        return tuple(outs)


@NECKS.register_module()
class FPG(nn.Module):

    def __init__(self, in_channels: Sequence[int] = (256, 512, 1024, 2048),
                 out_channels: int = 256, num_outs: int = 5, stack_times: int = 9,
                 paths=None, start_level: int = 0, inter_channels=None, same_down_trans=None,
                 same_up_trans=None, across_lateral_trans=None, across_down_trans=None,
                 across_up_trans=None, across_skip_trans=None, output_trans=None,
                 norm_cfg=None, skip_inds=None, init_cfg=None, device=None, dtype=None):
        super().__init__()
        ic = inter_channels if isinstance(inter_channels, int) else out_channels
        self.start_level, self.num_outs = start_level, num_outs
        conv = dict(norm_cfg=_bn_cfg(norm_cfg), device=device, dtype=dtype)
        self.lateral_convs = nn.ModuleList(Conv(c, ic, 1, device=device, dtype=dtype)
                                           for c in in_channels[start_level:])
        self.down_convs = nn.ModuleList(
            nn.ModuleList(ConvModule(ic, ic, 3, 2, 1, **conv) for _ in range(1, num_outs))
            for _ in range(stack_times))
        self.up_convs = nn.ModuleList(
            nn.ModuleList(ConvModule(ic, ic, 3, 1, 1, **conv) for _ in range(num_outs - 1))
            for _ in range(stack_times))
        self.out_convs = nn.ModuleList(ConvModule(ic, out_channels, 3, 1, 1, **conv)
                                       for _ in range(num_outs))

    def forward(self, inputs):
        feats = [conv(x) for conv, x in zip(self.lateral_convs, inputs[self.start_level:])]
        while len(feats) < self.num_outs:
            feats.append(_down2(feats[-1]))
        for i in range(1, self.num_outs):
            (h, w), have = feats[i - 1].shape[2:], tuple(feats[i].shape[2:])
            down = ((h - 1) // 2 + 1, (w - 1) // 2 + 1)
            if down != have:
                raise ValueError(
                    f"FPG: the stride-2 conv of level {i - 1} ({h}x{w}) gives {down[0]}x"
                    f"{down[1]}, level {i} is {have[0]}x{have[1]} (a 2x2 max-pool, floor "
                    f"sizes): the canvas's P5 sides must be even (JAX's FPG raises TypeError "
                    "on this sum)")
        for downs, ups in zip(self.down_convs, self.up_convs):
            new = []
            for i, f in enumerate(feats):
                acc = f
                if i > 0:
                    acc = acc + downs[i - 1](feats[i - 1])
                if i < self.num_outs - 1:
                    acc = acc + ups[i](_resize_to(feats[i + 1], f.shape[2:]))
                new.append(F.relu(acc))
            feats = new
        return tuple(conv(f) for conv, f in zip(self.out_convs, feats))
