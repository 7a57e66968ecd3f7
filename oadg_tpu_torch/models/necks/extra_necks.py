"""YOLOF's DilatedEncoder (port of ``oadg_tpu/models/necks/extra_necks.py:99-143``).

The last backbone map through ``lateral_conv`` (1x1) and ``lateral_norm``,
``fpn_conv`` (3x3) and ``fpn_norm`` (no activation), then
``dilated_encoder_blocks``: residual bottlenecks of a 1x1 to
``block_mid_channels``, a 3x3 dilated by the block's dilation (2, 4, 6, 8)
and a 1x1 back, each conv followed by its BN and a ReLU, the input added.
Every BN is live (``BatchNorm``, torch momentum 0.1: the JAX
``FrozenBN(frozen=False)``), every conv has a bias (the JAX ``Conv``'s;
mmdet's block convs have none). mmdet's names. One output map.
"""
from __future__ import annotations

from typing import Sequence

from torch import nn

from ...utils.registry import NECKS
from ..layers import BatchNorm, Conv, ConvModule


class DilatedBottleneck(nn.Module):

    def __init__(self, channels: int, mid: int, dilation: int, device=None, dtype=None):
        super().__init__()
        kw = dict(norm_cfg=dict(type="BN"), act="relu", bias=True, device=device, dtype=dtype)
        self.conv1 = ConvModule(channels, mid, 1, **kw)
        self.conv2 = ConvModule(mid, mid, 3, 1, dilation, dilation=dilation, **kw)
        self.conv3 = ConvModule(mid, channels, 1, **kw)

    def forward(self, x):
        return x + self.conv3(self.conv2(self.conv1(x)))


@NECKS.register_module()
class DilatedEncoder(nn.Module):

    def __init__(self, in_channels: int = 2048, out_channels: int = 512,
                 block_mid_channels: int = 128, num_residual_blocks: int = 4,
                 block_dilations: Sequence[int] = (2, 4, 6, 8), device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.lateral_conv = Conv(in_channels, out_channels, 1, **kw)
        self.lateral_norm = BatchNorm(out_channels, device=device)
        self.fpn_conv = Conv(out_channels, out_channels, 3, 1, 1, **kw)
        self.fpn_norm = BatchNorm(out_channels, device=device)
        self.dilated_encoder_blocks = nn.Sequential(*(
            DilatedBottleneck(out_channels, block_mid_channels, block_dilations[i], **kw)
            for i in range(num_residual_blocks)))

    def forward(self, inputs):
        x = self.lateral_norm(self.lateral_conv(inputs[-1]))
        x = self.fpn_norm(self.fpn_conv(x))
        return (self.dilated_encoder_blocks(x),)
