"""RegNetX backbone (port of ``oadg_tpu/models/backbones/regnet.py``).

The stage widths and depths come from the quantized log-linear schedule of
the ``arch`` (a preset name of ``ARCH_PRESETS`` or a dict of ``w0``, ``wa``,
``wm``, ``group_w`` and ``depth``): ``_generate_widths`` (``:16``) and
``_adjust`` (``:31``), kept here in numpy. RegNetX-3.2GF gives widths [96,
192, 432, 1008], blocks [2, 6, 15, 2] and groups of 48 channels.

A 3x3/s2 stem conv of 32 channels, its BN and a ReLU (no max-pool), then
one stage a width, each block (``RegBlock``, ``:54``) a 1x1, a grouped 3x3
(``width // group_width`` groups) and a 1x1, each with a BN, ReLU after the
first two and after the sum with the shortcut; a stage's first block has
stride 2 and a 1x1 conv and BN shortcut (``downsample``) where the stride or
the width changes. mmdet's names: ``conv1`` / ``bn1`` for the stem,
``layer{s}.{b}.conv{k}`` / ``bn{k}`` / ``downsample.{0,1}``.

BNs are frozen (``norm_eval=True``, folded into their convs by
``resnet._conv_bn``) or live (``norm_eval=False``). Training:
``frozen_stages`` = k sets ``requires_grad=False`` on ``layer1`` ..
``layer<k>`` only (``norm_cfg`` is taken and ignored, as in JAX). The JAX
package's ``frozen_mask`` freezes a backbone child whose name starts with
``conv1`` or ``stem_conv``, or is ``FrozenBN_0``; its RegNet names the stem
``stem`` and ``stem_bn``, so the stem trains while ``layer1`` is frozen, and
the port follows (mmdet freezes the stem too; ROADMAP C).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn

from ...utils.registry import BACKBONES
from ..layers import Conv
from .resnet import _bn, _conv_bn, _identity


def _generate_widths(w0, wa, wm, depth, q=8):
    """regnet.py generate_regnet: quantized log-linear widths."""
    ws_cont = np.arange(depth) * wa + w0
    ks = np.round(np.log(ws_cont / w0) / np.log(wm))
    ws = w0 * np.power(wm, ks)
    ws = np.round(ws / q) * q
    num_stages = len(np.unique(ws))
    ws = ws.astype(int).tolist()
    stage_widths, stage_blocks = [], []
    for w in sorted(set(ws)):
        stage_widths.append(w)
        stage_blocks.append(ws.count(w))
    return stage_widths, stage_blocks, num_stages


def _adjust(widths, groups, bottleneck_ratio=1.0):
    adj_w, adj_g = [], []
    for w, g in zip(widths, groups):
        wb = int(round(w * bottleneck_ratio))
        g = min(g, wb)
        wb = int(round(wb / g) * g)
        adj_w.append(int(wb / bottleneck_ratio))
        adj_g.append(g)
    return adj_w, adj_g


ARCH_PRESETS = {
    "regnetx_400mf": dict(w0=24, wa=24.48, wm=2.54, group_w=16, depth=22),
    "regnetx_800mf": dict(w0=56, wa=35.73, wm=2.28, group_w=16, depth=16),
    "regnetx_1.6gf": dict(w0=80, wa=34.01, wm=2.25, group_w=24, depth=18),
    "regnetx_3.2gf": dict(w0=88, wa=26.31, wm=2.25, group_w=48, depth=25),
    "regnetx_4.0gf": dict(w0=96, wa=38.65, wm=2.43, group_w=40, depth=23),
    "regnetx_6.4gf": dict(w0=184, wa=60.83, wm=2.07, group_w=56, depth=17),
    "regnetx_8.0gf": dict(w0=80, wa=49.56, wm=2.88, group_w=120, depth=23),
    "regnetx_12gf": dict(w0=168, wa=73.36, wm=2.37, group_w=112, depth=19),
}


def regnet_schedule(arch):
    """``arch`` -> (stage widths, blocks a stage, group widths)."""
    a = ARCH_PRESETS[arch] if isinstance(arch, str) else dict(arch)
    widths, blocks, _ = _generate_widths(a["w0"], a["wa"], a["wm"], a["depth"])
    widths, groups = _adjust(widths, [a["group_w"]] * len(widths))
    return widths, blocks, groups


class RegBlock(nn.Module):
    def __init__(self, in_channels: int, width: int, stride: int, group_width: int,
                 norm_eval: bool = True, device=None, dtype=None):
        super().__init__()
        groups = max(width // group_width, 1)
        kw = dict(bias=False, device=device, dtype=dtype)
        self.conv1 = Conv(in_channels, width, 1, **kw)
        self.bn1 = _bn(width, norm_eval, True, device)
        self.conv2 = Conv(width, width, 3, stride, 1, groups=groups, **kw)
        self.bn2 = _bn(width, norm_eval, True, device)
        self.conv3 = Conv(width, width, 1, **kw)
        self.bn3 = _bn(width, norm_eval, True, device)
        self.downsample = None
        if stride != 1 or in_channels != width:
            self.downsample = nn.Sequential(Conv(in_channels, width, 1, stride, **kw),
                                            _bn(width, norm_eval, True, device))

    def forward(self, x):
        y = torch.relu(_conv_bn(self.conv1, self.bn1, x))
        y = torch.relu(_conv_bn(self.conv2, self.bn2, y))
        y = _conv_bn(self.conv3, self.bn3, y)
        return torch.relu(y + _identity(self, x))


@BACKBONES.register_module()
class RegNet(nn.Module):
    def __init__(self, arch="regnetx_3.2gf", out_indices: Sequence[int] = (0, 1, 2, 3),
                 frozen_stages: int = -1, norm_cfg=None, norm_eval: bool = True,
                 init_cfg=None, pretrained=None, device=None, dtype=None):
        super().__init__()
        widths, blocks, groups = regnet_schedule(arch)
        self.out_indices = tuple(out_indices)
        self.conv1 = Conv(3, 32, 3, 2, 1, bias=False, device=device, dtype=dtype)
        self.bn1 = _bn(32, norm_eval, True, device)
        c = 32
        self.res_layers = []
        for si, (width, n, gw) in enumerate(zip(widths, blocks, groups)):
            layer = []
            for bi in range(n):
                layer.append(RegBlock(c, width, 2 if bi == 0 else 1, gw, norm_eval, device, dtype))
                c = width
            self.add_module(f"layer{si + 1}", nn.Sequential(*layer))
            self.res_layers.append(f"layer{si + 1}")
        for name in self.res_layers[:max(frozen_stages, 0)]:
            getattr(self, name).requires_grad_(False)

    def forward(self, x):
        x = torch.relu(_conv_bn(self.conv1, self.bn1, x))
        outs = []
        for i, name in enumerate(self.res_layers):
            x = getattr(self, name)(x)
            if i in self.out_indices:
                outs.append(x)
        return tuple(outs)
