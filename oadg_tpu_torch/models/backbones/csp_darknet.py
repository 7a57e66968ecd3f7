"""CSPDarknet, YOLOX's backbone (port of ``oadg_tpu/models/backbones/csp_darknet.py``),
and its blocks, which ``necks/yolox_pafpn.py`` and YOLOX's head share.

- ``ConvBNSiLU`` (``:18``): a bias-free conv, its live ``BatchNorm`` (eps
  1e-3, torch momentum 0.03: the JAX decay 0.97) and SiLU, ``x *
  sigmoid(x)`` as flax writes it; keys ``conv.weight``, ``bn.*`` (mmcv's
  ``ConvModule``).
- ``DarknetBottleneck`` (``:39``): 1x1 to ``expansion`` of the channels,
  3x3 back, plus the input where ``add_identity`` and the widths agree.
- ``CSPLayer`` (``:60``): ``main_conv`` and ``short_conv`` (1x1 to half),
  ``blocks`` on the main branch, both concatenated (main first) into
  ``final_conv``.
- ``SPPBottleneck`` (``:86``): ``conv1`` to half, max pools of 5, 9 and 13
  at stride 1 over a -inf border (``max_pool2d``'s own padding), all four
  concatenated into ``conv2``.
- ``CSPDarknet`` (``:111``): the Focus stem (space to depth, then a 3x3
  ``ConvBNSiLU``: ``stem.conv``), then four stages ``stage{k}``: a 3x3
  stride-2 ``ConvBNSiLU`` (``.0``), the last stage's ``SPPBottleneck``
  (``.1``), a ``CSPLayer``; widths ``int(c * widen_factor)``, depths
  ``max(round(n * deepen_factor), 1)``, the outputs of ``out_indices``
  (stage 0 the stem). The space-to-depth channels run (dy, dx) = (0, 0),
  (0, 1), (1, 0), (1, 1) as the JAX package's reshape puts them; mmdet's
  ``Focus`` puts (1, 0) before (0, 1), so ``load_mmdet_checkpoint`` swaps
  those two blocks of ``stem.conv.conv.weight``'s input channels
  (``focus_mmdet_order``).

``norm_eval`` holds every BN in eval mode, as Darknet's.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...utils.registry import BACKBONES
from ..layers import BatchNorm, Conv


def silu(x):
    """flax's ``silu``: ``x * sigmoid(x)``."""
    return x * torch.sigmoid(x)


class ConvBNSiLU(nn.Module):

    def __init__(self, in_channels: int, out_channels: int, kernel: int = 1, stride: int = 1,
                 device=None, dtype=None):
        super().__init__()
        self.conv = Conv(in_channels, out_channels, kernel, stride, kernel // 2, bias=False,
                         device=device, dtype=dtype)
        self.bn = BatchNorm(out_channels, eps=1e-3, momentum=0.03, device=device)

    def forward(self, x):
        return silu(self.bn(self.conv(x)))


class DarknetBottleneck(nn.Module):

    def __init__(self, in_channels: int, out_channels: int, expansion: float = 0.5,
                 add_identity: bool = True, **kw):
        super().__init__()
        hidden = int(out_channels * expansion)
        self.conv1 = ConvBNSiLU(in_channels, hidden, 1, **kw)
        self.conv2 = ConvBNSiLU(hidden, out_channels, 3, **kw)
        self.add_identity = add_identity and in_channels == out_channels

    def forward(self, x):
        y = self.conv2(self.conv1(x))
        return x + y if self.add_identity else y


class CSPLayer(nn.Module):

    def __init__(self, in_channels: int, out_channels: int, num_blocks: int = 1,
                 add_identity: bool = True, expand_ratio: float = 0.5, **kw):
        super().__init__()
        mid = int(out_channels * expand_ratio)
        self.main_conv = ConvBNSiLU(in_channels, mid, 1, **kw)
        self.short_conv = ConvBNSiLU(in_channels, mid, 1, **kw)
        self.final_conv = ConvBNSiLU(2 * mid, out_channels, 1, **kw)
        self.blocks = nn.Sequential(*(DarknetBottleneck(mid, mid, 1.0, add_identity, **kw)
                                      for _ in range(num_blocks)))

    def forward(self, x):
        main = self.blocks(self.main_conv(x))
        return self.final_conv(torch.cat([main, self.short_conv(x)], 1))


class SPPBottleneck(nn.Module):

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_sizes: Sequence[int] = (5, 9, 13), **kw):
        super().__init__()
        mid = in_channels // 2
        self.kernel_sizes = tuple(kernel_sizes)
        self.conv1 = ConvBNSiLU(in_channels, mid, 1, **kw)
        self.conv2 = ConvBNSiLU(mid * (len(kernel_sizes) + 1), out_channels, 1, **kw)

    def forward(self, x):
        x = self.conv1(x)
        return self.conv2(torch.cat([x] + [F.max_pool2d(x, k, 1, k // 2)
                                           for k in self.kernel_sizes], 1))


class Focus(nn.Module):
    """Space to depth, channels (dy, dx)-major as the JAX reshape, then
    ``conv``."""

    def __init__(self, in_channels: int, out_channels: int, **kw):
        super().__init__()
        self.conv = ConvBNSiLU(4 * in_channels, out_channels, 3, **kw)

    def forward(self, x):
        n, c, h, w = x.shape
        x = x.reshape(n, c, h // 2, 2, w // 2, 2).permute(0, 3, 5, 1, 2, 4)
        return self.conv(x.reshape(n, 4 * c, h // 2, w // 2))


def focus_mmdet_order(weight: torch.Tensor) -> torch.Tensor:
    """The stem conv's (O, 4C, k, k) weight with its (0, 1) and (1, 0)
    input blocks swapped: mmdet's ``Focus`` order to the port's and back."""
    c = weight.shape[1] // 4
    return torch.cat([weight[:, :c], weight[:, 2 * c:3 * c], weight[:, c:2 * c],
                      weight[:, 3 * c:]], 1)


@BACKBONES.register_module()
class CSPDarknet(nn.Module):
    ARCH = {"P5": ((64, 128, 3, True, False), (128, 256, 9, True, False),
                   (256, 512, 9, True, False), (512, 1024, 3, False, True))}

    def __init__(self, arch: str = "P5", deepen_factor: float = 1.0, widen_factor: float = 1.0,
                 out_indices: Sequence[int] = (2, 3, 4), frozen_stages: int = -1,
                 norm_eval: bool = False, norm_cfg=None, act_cfg=None, init_cfg=None,
                 pretrained=None, device=None, dtype=None):
        super().__init__()
        if frozen_stages != -1:
            raise NotImplementedError("CSPDarknet frozen_stages: the JAX backbone ignores it, "
                                      "the port builds -1 only")
        kw = dict(device=device, dtype=dtype)
        wf, df = widen_factor, deepen_factor
        self.out_indices = tuple(out_indices)
        self.norm_eval = norm_eval
        self.stem = Focus(3, int(64 * wf), **kw)
        cin = int(64 * wf)
        self.layers = ["stem"]
        for si, (_, oc, nb, add_id, use_spp) in enumerate(self.ARCH[arch]):
            oc = int(oc * wf)
            stage = [ConvBNSiLU(cin, oc, 3, 2, **kw)]
            if use_spp:
                stage.append(SPPBottleneck(oc, oc, **kw))
            stage.append(CSPLayer(oc, oc, max(round(nb * df), 1), add_id, **kw))
            self.add_module(f"stage{si + 1}", nn.Sequential(*stage))
            self.layers.append(f"stage{si + 1}")
            cin = oc

    def train(self, mode: bool = True):
        super().train(mode)
        if mode and self.norm_eval:
            for m in self.modules():
                if isinstance(m, BatchNorm):
                    m.eval()
        return self

    def forward(self, x):
        outs = []
        for i, name in enumerate(self.layers):
            x = getattr(self, name)(x)
            if i in self.out_indices:
                outs.append(x)
        return tuple(outs)
