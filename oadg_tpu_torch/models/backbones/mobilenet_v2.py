"""MobileNetV2 backbone (port of ``oadg_tpu/models/backbones/mobilenet_v2.py``).

A 3x3/s2 stem (``conv1``), then seven stages of inverted residuals
(``layer1`` .. ``layer7``, ``arch``: expand ratio, channels, blocks, the
first block's stride) and, where ``out_indices`` holds 7, a 1x1 conv to 1280
channels (``conv2``); the outputs are the stages in ``out_indices`` (0-6 the
stages, 7 ``conv2``; ``:77-97``). An inverted residual
(``InvertedResidual``, ``:25``) is an expand 1x1 (none where the ratio is
1), a depthwise 3x3 (``groups`` = its channels) and a project 1x1, ReLU6
after the first two, plus the input where the stride is 1 and the channels
do not change. Channel counts are ``_make_divisible(c * widen_factor)``
(``:18``).

Every conv is an mmcv ``ConvModule`` with a BN, mmdet's names: ``state_dict``
keys read ``backbone.layer2.0.conv.0.conv.weight`` (the expand conv),
``...conv.1.bn.running_mean`` (the depthwise conv's BN) and so on. The BNs
are live (``norm_eval=False``, the reference's default, ``:61``): in train mode
they normalize with the batch's statistics and move their stored ones, as the
JAX ``FrozenBN(frozen=False)`` does in a train step; ``norm_eval=True`` holds
them in eval mode, as the JAX package freezes them. ``frozen_stages`` = k
sets ``requires_grad=False`` on ``layer1`` .. ``layer<k>``, the children that
``oadg_tpu/engine/optim.py:frozen_mask`` masks (its stem is named ``stem``,
which the mask never matches). ``norm_cfg`` and ``act_cfg`` are taken and
ignored, as the JAX module ignores them: BN and ReLU6.
"""
from __future__ import annotations

from typing import Sequence

from torch import nn

from ...utils.registry import BACKBONES
from ..layers import BatchNorm, ConvModule


def _make_divisible(v, divisor=8):
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


class InvertedResidual(nn.Module):
    """``conv``: [the expand 1x1,] the depthwise 3x3 and the project 1x1."""

    def __init__(self, in_channels: int, out_channels: int, stride: int, expand_ratio: int,
                 device=None, dtype=None):
        super().__init__()
        hidden = in_channels * expand_ratio
        kw = dict(norm_cfg=dict(type="BN"), device=device, dtype=dtype)
        layers = []
        if expand_ratio != 1:
            layers.append(ConvModule(in_channels, hidden, 1, act="relu6", **kw))
        layers += [ConvModule(hidden, hidden, 3, stride, 1, groups=hidden, act="relu6", **kw),
                   ConvModule(hidden, out_channels, 1, **kw)]
        self.conv = nn.Sequential(*layers)
        self.residual = stride == 1 and in_channels == out_channels

    def forward(self, x):
        out = self.conv(x)
        return out + x if self.residual else out


@BACKBONES.register_module()
class MobileNetV2(nn.Module):
    # (expand_ratio, channels, num_blocks, stride) per stage
    arch = ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
            (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1))

    def __init__(self, widen_factor: float = 1.0, out_indices: Sequence[int] = (1, 2, 4, 7),
                 frozen_stages: int = -1, norm_cfg=None, norm_eval: bool = False,
                 act_cfg=None, init_cfg=None, pretrained=None, device=None, dtype=None):
        super().__init__()
        self.out_indices = tuple(out_indices)
        self.norm_eval = norm_eval
        kw = dict(norm_cfg=dict(type="BN"), device=device, dtype=dtype)
        c = _make_divisible(32 * widen_factor)
        self.conv1 = ConvModule(3, c, 3, 2, 1, act="relu6", **kw)
        self.stages = []
        for si, (t, ch, nblk, s) in enumerate(self.arch):
            oc = _make_divisible(ch * widen_factor)
            blocks = []
            for bi in range(nblk):
                blocks.append(InvertedResidual(c, oc, s if bi == 0 else 1, t, device, dtype))
                c = oc
            self.add_module(f"layer{si + 1}", nn.Sequential(*blocks))
            self.stages.append(f"layer{si + 1}")
        if 7 in self.out_indices:
            oc = _make_divisible(1280 * widen_factor) if widen_factor > 1.0 else 1280
            self.conv2 = ConvModule(c, oc, 1, act="relu6", **kw)
            self.stages.append("conv2")
        for s in range(1, min(frozen_stages, len(self.arch)) + 1):
            getattr(self, f"layer{s}").requires_grad_(False)
        self.train()

    def train(self, mode: bool = True):
        super().train(mode)
        if mode and self.norm_eval:
            for m in self.modules():
                if isinstance(m, BatchNorm):
                    m.eval()
        return self

    def forward(self, x):
        x = self.conv1(x)
        outs = []
        for i, name in enumerate(self.stages):
            x = getattr(self, name)(x)
            if i in self.out_indices:
                outs.append(x)
        return tuple(outs)
