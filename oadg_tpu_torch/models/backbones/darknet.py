"""Darknet-53 backbone (port of ``oadg_tpu/models/backbones/darknet.py:34-65``).

A 3x3 stem of 32 channels (``conv1``), then 5 stages, each a stride-2 3x3
conv (``conv_res_block{i}.conv``) and ``(1, 2, 8, 8, 4)`` residual blocks
(``conv_res_block{i}.res{j}``: a 1x1 to half the channels and a 3x3 back,
``conv1`` and ``conv2``, plus the skip). Every conv is a ``ConvModule`` with
BN and LeakyReLU(0.1); the outputs are the stages in ``out_indices``
(``(3, 4, 5)``: 256, 512 and 1024 channels at strides 8, 16 and 32). The
module names are mmdet's, so ``state_dict`` keys read
``backbone.conv_res_block3.res0.conv1.bn.running_mean`` and so on.

``norm_eval`` (the default) holds the backbone's BNs in eval mode whatever
``train()`` says, as mmdet's ``Darknet.train`` does (``darknet.py:174``): they
apply their stored statistics and never update them, while the neck's and
the head's BNs train. ``frozen_stages`` = k >= 1 freezes (no gradient, eval
mode) the first k of ``conv1, conv_res_block1, ...``, as mmdet's
``_freeze_stages``.
"""
from __future__ import annotations

from typing import Sequence

from torch import nn

from ...utils.registry import BACKBONES
from ..layers import BatchNorm, ConvModule


class ResBlock(nn.Module):
    """``DarkBlock`` (``darknet.py:16``): 1x1 to half the channels, 3x3
    back, plus the input."""

    def __init__(self, channels: int, norm_cfg, device=None, dtype=None):
        super().__init__()
        half = channels // 2
        kw = dict(norm_cfg=norm_cfg, act="leaky_relu", device=device, dtype=dtype)
        self.conv1 = ConvModule(channels, half, 1, **kw)
        self.conv2 = ConvModule(half, channels, 3, 1, 1, **kw)

    def forward(self, x):
        return x + self.conv2(self.conv1(x))


@BACKBONES.register_module()
class Darknet(nn.Module):
    LAYERS = {53: (1, 2, 8, 8, 4)}
    CHANNELS = ((32, 64), (64, 128), (128, 256), (256, 512), (512, 1024))

    def __init__(self, depth: int = 53, out_indices: Sequence[int] = (3, 4, 5),
                 frozen_stages: int = -1, norm_cfg=None, norm_eval: bool = True,
                 act_cfg=None, init_cfg=None, pretrained=None, device=None, dtype=None):
        super().__init__()
        if depth not in self.LAYERS:
            raise KeyError(f"invalid depth {depth} for darknet")
        if act_cfg is not None and act_cfg.get("type") != "LeakyReLU":
            raise NotImplementedError(f"Darknet activation {act_cfg['type']}")
        norm_cfg = dict(norm_cfg or dict(type="BN"))
        kw = dict(norm_cfg=norm_cfg, act="leaky_relu", device=device, dtype=dtype)
        self.out_indices = tuple(out_indices)
        self.frozen_stages = frozen_stages
        self.norm_eval = norm_eval
        self.conv1 = ConvModule(3, 32, 3, 1, 1, **kw)
        self.cr_blocks = ["conv1"]
        for i, (n, (cin, cout)) in enumerate(zip(self.LAYERS[depth], self.CHANNELS)):
            block = nn.Sequential()
            block.add_module("conv", ConvModule(cin, cout, 3, 2, 1, **kw))
            for j in range(n):
                block.add_module(f"res{j}", ResBlock(cout, norm_cfg, device, dtype))
            name = f"conv_res_block{i + 1}"
            self.add_module(name, block)
            self.cr_blocks.append(name)
        for name in self.cr_blocks[:max(frozen_stages, 0)]:
            getattr(self, name).requires_grad_(False)
        self.train()

    def train(self, mode: bool = True):
        super().train(mode)
        for name in self.cr_blocks[:max(self.frozen_stages, 0)]:
            getattr(self, name).eval()
        if mode and self.norm_eval:
            for m in self.modules():
                if isinstance(m, BatchNorm):
                    m.eval()
        return self

    def forward(self, x):
        outs = []
        for i, name in enumerate(self.cr_blocks):
            x = getattr(self, name)(x)
            if i in self.out_indices:
                outs.append(x)
        return tuple(outs)
