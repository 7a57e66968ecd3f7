"""The stacked Hourglass backbone of CornerNet and CentripetalNet (port of
``oadg_tpu/models/backbones/hourglass.py``).

- Stem (``stem``): a 7x7 stride-2 ``ConvModule`` of 128 channels (conv, BN,
  ReLU; ``stem.0``), then one ``BasicBlock`` of stride 2 to
  ``stage_channels[0]`` (``stem.1.0``): stride 4.
- Each of ``num_stacks`` stacks (``hourglass_modules.i``) is a recursive
  encoder-decoder of ``downsample_times`` levels (``HourglassModule``):
  ``up1`` (the level's ``stage_blocks[0]`` blocks at its channels), ``low1``
  (as many, the first of stride 2 to the next level's channels), ``low2``
  (the next level's module, or at the bottom ``stage_blocks[1]`` blocks),
  ``low3`` (back to the level's channels), and ``up1`` plus ``low3``
  upsampled 2x by repetition (``jnp.repeat`` twice, ``F.interpolate``'s
  ``nearest``). Every ``_res_layer`` changes its channels in its first
  block (``:17-23``; mmdet's ``low3`` in its last).
- Each stack's output is ``out_convs.i`` (3x3 ``ConvModule`` to
  ``feat_channel``); between stacks ``relu(conv1x1s.i(x) + remap_convs.i(out))``
  (1x1 ``ConvModule``s without activation; the JAX ``remap_x`` /
  ``remap_f``) goes through one ``BasicBlock`` (``inters.i``) into the next.

Every BN is live (``build_norm`` without ``_eval``, ``layers.py:297-324``):
the batch's statistics in train mode (the global batch's under data
parallel, SyncBN), the stored ones in eval mode. mmdet's module names, so
the ``state_dict`` keys read ``hourglass_modules.0.low2.low1.0.conv1.weight``
and so on. Inputs must be a multiple of ``4 * 2^downsample_times`` in each
side (128 for the configs: 1024x2048 and 256x384 are). Returns the stacks'
outputs, (N, feat_channel, H / 4, W / 4) each.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ...utils.registry import BACKBONES
from ..layers import ConvModule
from .resnet import BasicBlock, _downsample


def _res_layer(inplanes: int, planes: int, blocks: int, stride: int, norm_cfg, device,
               dtype) -> nn.Sequential:
    """``blocks`` live-BN ``BasicBlock``s to ``planes``; the first takes the
    stride and a downsample where the stride or the channels change."""
    layers = []
    for j in range(blocks):
        s = stride if j == 0 else 1
        cin = inplanes if j == 0 else planes
        ds = (_downsample(cin, planes, s, True, device, dtype, norm_cfg)
              if j == 0 and (s != 1 or cin != planes) else None)
        layers.append(BasicBlock(cin, planes, s, 1, ds, norm_cfg=norm_cfg, device=device,
                                 dtype=dtype))
    return nn.Sequential(*layers)


class HourglassModule(nn.Module):
    """One level of a stack and, recursively, the levels below it."""

    def __init__(self, depth: int, stage_channels: Sequence[int], stage_blocks: Sequence[int],
                 norm_cfg, device=None, dtype=None):
        super().__init__()
        cur_c, nxt_c = stage_channels[0], stage_channels[1]
        cur_b, nxt_b = stage_blocks[0], stage_blocks[1]
        kw = dict(norm_cfg=norm_cfg, device=device, dtype=dtype)
        self.up1 = _res_layer(cur_c, cur_c, cur_b, 1, **kw)
        self.low1 = _res_layer(cur_c, nxt_c, cur_b, 2, **kw)
        self.low2 = (HourglassModule(depth - 1, stage_channels[1:], stage_blocks[1:], **kw)
                     if depth > 1 else _res_layer(nxt_c, nxt_c, nxt_b, 1, **kw))
        self.low3 = _res_layer(nxt_c, cur_c, cur_b, 1, **kw)

    def forward(self, x):
        low3 = self.low3(self.low2(self.low1(x)))
        return self.up1(x) + low3.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


@BACKBONES.register_module()
class HourglassNet(nn.Module):

    def __init__(self, downsample_times: int = 5, num_stacks: int = 2,
                 stage_channels: Sequence[int] = (256, 256, 384, 384, 384, 512),
                 stage_blocks: Sequence[int] = (2, 2, 2, 2, 2, 4), feat_channel: int = 256,
                 norm_cfg=None, init_cfg=None, pretrained=None, device=None, dtype=None):
        super().__init__()
        assert len(stage_channels) == len(stage_blocks) > downsample_times
        ncfg = dict(norm_cfg or dict(type="BN"))
        kw = dict(norm_cfg=ncfg, device=device, dtype=dtype)
        c0 = stage_channels[0]
        self.num_stacks = num_stacks
        self.stem = nn.Sequential(
            ConvModule(3, 128, 7, 2, 3, act="relu", **kw),
            _res_layer(128, c0, 1, 2, **kw))
        self.hourglass_modules = nn.ModuleList(
            HourglassModule(downsample_times, stage_channels, stage_blocks, **kw)
            for _ in range(num_stacks))
        self.out_convs = nn.ModuleList(ConvModule(c0, feat_channel, 3, 1, 1, act="relu", **kw)
                                       for _ in range(num_stacks))
        self.conv1x1s = nn.ModuleList(ConvModule(c0, c0, 1, **kw) for _ in range(num_stacks - 1))
        self.remap_convs = nn.ModuleList(ConvModule(feat_channel, c0, 1, **kw)
                                         for _ in range(num_stacks - 1))
        self.inters = _res_layer(c0, c0, num_stacks - 1, 1, **kw)

    def forward(self, x):
        x = self.stem(x)
        outs = []
        for si in range(self.num_stacks):
            feat = self.out_convs[si](self.hourglass_modules[si](x))
            outs.append(feat)
            if si < self.num_stacks - 1:
                x = self.inters[si](torch.relu(self.conv1x1s[si](x) + self.remap_convs[si](feat)))
        return tuple(outs)
