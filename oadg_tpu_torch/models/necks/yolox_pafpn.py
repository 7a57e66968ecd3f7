"""YOLOX's PAFPN (port of ``oadg_tpu/models/necks/yolox_pafpn.py``).

Top-down: the top map through ``reduce_layers.{i}`` (1x1 to the next
level's width), upsampled 2x by repetition (JAX's ``_up2``: nearest, cut to
the lateral's size), concatenated (upsampled first) and merged by
``top_down_blocks.{i}`` (a ``CSPLayer`` without identity). Bottom-up:
``downsamples.{i}`` (3x3 stride 2, cut to the next inner map's size),
concatenated before that map, merged by ``bottom_up_blocks.{i}``. Each
output through ``out_convs.{i}`` (1x1 to ``out_channels``). mmdet's names.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ...utils.registry import NECKS
from ..backbones.csp_darknet import ConvBNSiLU, CSPLayer


def up2(x, hw):
    """2x nearest (a plain repeat) cut to ``hw``."""
    return x.repeat_interleave(2, 2).repeat_interleave(2, 3)[:, :, :hw[0], :hw[1]]


@NECKS.register_module()
class YOLOXPAFPN(nn.Module):

    def __init__(self, in_channels: Sequence[int] = (256, 512, 1024), out_channels: int = 256,
                 num_csp_blocks: int = 3, use_depthwise: bool = False, upsample_cfg=None,
                 norm_cfg=None, act_cfg=None, init_cfg=None, device=None, dtype=None):
        super().__init__()
        if use_depthwise:
            raise NotImplementedError("YOLOXPAFPN use_depthwise: the JAX neck has none")
        kw = dict(device=device, dtype=dtype)
        ch = list(in_channels)
        self.reduce_layers = nn.ModuleList()
        self.top_down_blocks = nn.ModuleList()
        for idx in range(len(ch) - 1, 0, -1):
            self.reduce_layers.append(ConvBNSiLU(ch[idx], ch[idx - 1], 1, **kw))
            self.top_down_blocks.append(CSPLayer(2 * ch[idx - 1], ch[idx - 1], num_csp_blocks,
                                                 False, **kw))
        self.downsamples = nn.ModuleList()
        self.bottom_up_blocks = nn.ModuleList()
        for idx in range(len(ch) - 1):
            self.downsamples.append(ConvBNSiLU(ch[idx], ch[idx], 3, 2, **kw))
            self.bottom_up_blocks.append(CSPLayer(2 * ch[idx], ch[idx + 1], num_csp_blocks,
                                                  False, **kw))
        self.out_convs = nn.ModuleList(ConvBNSiLU(c, out_channels, 1, **kw) for c in ch)
        self.num_in = len(ch)

    def forward(self, inputs):
        n = self.num_in
        feats = list(inputs[-n:])
        inner = [feats[-1]]
        for k, idx in enumerate(range(n - 1, 0, -1)):
            high = self.reduce_layers[k](inner[0])
            inner[0] = high
            low = feats[idx - 1]
            merged = torch.cat([up2(high, low.shape[2:]), low], 1)
            inner.insert(0, self.top_down_blocks[k](merged))
        outs = [inner[0]]
        for idx in range(n - 1):
            nxt = inner[idx + 1]
            down = self.downsamples[idx](outs[-1])[:, :, :nxt.shape[2], :nxt.shape[3]]
            outs.append(self.bottom_up_blocks[idx](torch.cat([down, nxt], 1)))
        return tuple(conv(o) for conv, o in zip(self.out_convs, outs))
