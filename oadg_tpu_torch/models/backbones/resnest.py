"""ResNeSt backbone (port of ``oadg_tpu/models/backbones/resnest.py``).

ResNetV1d (the deep stem and the avg-down shortcut of ``resnet.DeepStem``
and ``resnet.AvgDownShortcut``) with split-attention bottlenecks
(``BottleneckS``, ``:57``): ``conv1`` and ``bn1``, the split-attention 3x3
``conv2``, an average pool 3x3 of the block's stride (padding 1, the padding
counted) after it where the stride is not 1 (avd), then ``conv3`` and
``bn3`` and the shortcut.

The block's width is ``int(planes * base_width / 64) * groups``, the JAX
package's rule for every ``groups`` (``:74``): ``planes / 16`` at the
config's ``groups=1, base_width=4`` (4 channels in ``layer1``, 32 in
``layer4``). mmdet's ResNeSt takes ``planes`` where ``groups == 1``, so its
weights do not fit these shapes (``load_mmdet_checkpoint`` refuses them;
ROADMAP C).

``SplitAttentionConv`` (``:18``; mmdet's ``SplitAttentionConv2d`` names
``conv``, ``bn0``, ``fc1``, ``bn1``, ``fc2``): a 3x3 of ``radix * C``
channels in ``groups * radix`` groups, its BN and a ReLU; the splits are
radix-major; their sum's spatial mean goes through ``fc1`` (``max(C * radix
// 4, 32)`` channels, with a bias), its BN and a ReLU, and ``fc2`` (``radix *
C``, with a bias); a softmax over the radix in float32 (cast back, ``:53``)
weighs the splits, which are summed. Every BN is frozen with ``norm_eval``
(folded into its conv, ``resnet._conv_bn``), else live.

Training: ``frozen_stages`` >= 0 freezes the three stem convs and the first
stem BN, k >= 1 ``layer1`` .. ``layer<k>`` (the JAX ``frozen_mask``; the
second and third stem BNs train). The JAX ResNeSt stops no gradient, so
those BNs get theirs through the frozen stage.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...utils.registry import BACKBONES
from ..layers import Conv
from .resnet import DeepStemResNet, _bn, _conv, _conv_bn


class SplitAttentionConv(nn.Module):
    def __init__(self, in_channels: int, channels: int, stride: int = 1, dilation: int = 1,
                 groups: int = 1, radix: int = 2, reduction_factor: int = 4,
                 norm_eval: bool = True, bn_grad: bool = True, device=None, dtype=None):
        super().__init__()
        self.radix, self.channels = radix, channels
        self.conv = Conv(in_channels, channels * radix, 3, stride, dilation, dilation,
                         bias=False, groups=groups * radix, device=device, dtype=dtype)
        self.bn0 = _bn(channels * radix, norm_eval, bn_grad, device)
        inter = max(channels * radix // reduction_factor, 32)
        self.fc1 = Conv(channels, inter, 1, device=device, dtype=dtype)
        self.bn1 = _bn(inter, norm_eval, bn_grad, device)
        self.fc2 = Conv(inter, channels * radix, 1, device=device, dtype=dtype)

    def forward(self, x):
        y = torch.relu(_conv_bn(self.conv, self.bn0, x))
        b, _, h, w = y.shape
        splits = y.view(b, self.radix, self.channels, h, w)
        gap = splits.sum(dim=1).mean(dim=(2, 3), keepdim=True)
        a = self.fc2(torch.relu(_conv_bn(self.fc1, self.bn1, gap)))
        att = torch.softmax(a.view(b, self.radix, self.channels, 1, 1).float(), dim=1)
        return (splits * att.to(y.dtype)).sum(dim=1)


class BottleneckS(nn.Module):
    def __init__(self, inplanes, planes, stride=1, dilation=1, downsample=None, groups=1,
                 base_width=4, radix=2, avg_down_stride=True, norm_eval=True, bn_grad=True,
                 device=None, dtype=None):
        super().__init__()
        width = int(planes * (base_width / 64.0)) * groups
        self.avd_stride = stride if avg_down_stride and stride > 1 else 1
        self.conv1 = _conv(inplanes, width, 1, device=device, dtype=dtype)
        self.bn1 = _bn(width, norm_eval, bn_grad, device)
        self.conv2 = SplitAttentionConv(width, width, 1 if self.avd_stride > 1 else stride,
                                        dilation, groups, radix, norm_eval=norm_eval,
                                        bn_grad=bn_grad, device=device, dtype=dtype)
        self.conv3 = _conv(width, planes * 4, 1, device=device, dtype=dtype)
        self.bn3 = _bn(planes * 4, norm_eval, bn_grad, device)
        self.downsample = downsample

    def forward(self, x):
        out = self.conv2(torch.relu(_conv_bn(self.conv1, self.bn1, x)))
        if self.avd_stride > 1:
            out = F.avg_pool2d(out, 3, self.avd_stride, 1)
        out = _conv_bn(self.conv3, self.bn3, out)
        identity = x if self.downsample is None else self.downsample(x)
        return torch.relu(out + identity)


ARCH_S = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3), 200: (3, 24, 36, 3)}


@BACKBONES.register_module()
class ResNeSt(DeepStemResNet):
    def __init__(self, depth: int = 50, num_stages: int = 4,
                 out_indices: Sequence[int] = (0, 1, 2, 3),
                 strides: Sequence[int] = (1, 2, 2, 2),
                 dilations: Sequence[int] = (1, 1, 1, 1), groups: int = 1,
                 base_width: int = 4, radix: int = 2, stem_channels: int = 64,
                 base_channels: int = 64, style: str = "pytorch", frozen_stages: int = -1,
                 norm_cfg=None, norm_eval: bool = True, init_cfg=None, pretrained=None,
                 device=None, dtype=None):

        def make_block(inplanes, planes, stride, dilation, ds, **kw):
            return BottleneckS(inplanes, planes, stride, dilation, ds, groups, base_width,
                               radix, device=device, dtype=dtype, **kw)

        super().__init__(depth, ARCH_S, num_stages, out_indices, strides, dilations,
                         frozen_stages, norm_cfg, norm_eval, base_channels, stem_channels,
                         stop_gradient=False, make_block=make_block,
                         device=device, dtype=dtype)
