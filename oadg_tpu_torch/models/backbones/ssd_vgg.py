"""SSD's VGG-16 (port of ``oadg_tpu/models/backbones/ssd_vgg.py``).

mmdet's (2.x before its ``SSDNeck``) layout: ``features`` the VGG trunk as
one ``Sequential`` (convs at 0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28,
each followed by its ReLU; 2x2 max pools at 4, 9, 16 and 23 in ceil mode,
which pads the odd sizes' last window as the JAX ``-inf`` pad does), then
pool5 (3x3 stride 1 over a -inf border, 30), ``conv6`` (3x3 dilated by 6,
31) and ``conv7`` (1x1, 33); ``extra`` the eight convs of the SSD300 pyramid
(1x1 and 3x3 in turn, the 3x3s of stride 2, 2, 1 and 1, the last two with
no padding), a ReLU after each; ``l2_norm`` the conv4_3 map's L2Norm: per
pixel ``x / (sqrt(sum_c x^2) + 1e-10) * weight`` in float32 (weight 20 at
the start), cast back. Outputs: the normed conv4_3 (38x38 at 300x300),
conv7 (19x19) and every second extra conv (10, 5, 3, 1).
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...utils.registry import BACKBONES
from ..layers import Conv, widen

STAGES = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))
EXTRA = ((256, 1, 1, 0), (512, 3, 2, 1), (128, 1, 1, 0), (256, 3, 2, 1), (128, 1, 1, 0),
         (256, 3, 1, 0), (128, 1, 1, 0), (256, 3, 1, 0))


class L2Norm(nn.Module):

    def __init__(self, channels: int, scale: float = 20.0, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.full((channels,), float(scale), device=device))

    def forward(self, x):
        xf = widen(x)
        norm = torch.sqrt((xf * xf).sum(1, keepdim=True)) + 1e-10
        return (xf / norm * self.weight[:, None, None]).to(x.dtype)


@BACKBONES.register_module()
class SSDVGG(nn.Module):
    """``input_size``, ``depth`` (16), ``with_last_pool`` (False),
    ``ceil_mode`` (True), ``out_indices`` and ``out_feature_indices`` are the
    config's; the layout is SSD300's."""

    def __init__(self, input_size: int = 300, depth: int = 16, with_last_pool: bool = False,
                 ceil_mode: bool = True, out_indices: Sequence[int] = (3, 4),
                 out_feature_indices: Sequence[int] = (22, 34), l2_norm_scale: float = 20.0,
                 init_cfg=None, pretrained=None, device=None, dtype=None):
        super().__init__()
        if (input_size, depth, with_last_pool, ceil_mode, tuple(out_feature_indices)) != (
                300, 16, False, True, (22, 34)):
            raise NotImplementedError("SSDVGG: the port builds SSD300's VGG-16 (input_size 300, "
                                      "ceil-mode pools, no last pool, taps 22 and 34)")
        kw = dict(device=device, dtype=dtype)
        layers, cin = [], 3
        for si, (ch, n) in enumerate(STAGES):
            for _ in range(n):
                layers += [Conv(cin, ch, 3, 1, 1, **kw), nn.ReLU()]
                cin = ch
            if si < 4:
                layers.append(nn.MaxPool2d(2, 2, ceil_mode=True))
        layers += [nn.MaxPool2d(3, 1, 1), Conv(512, 1024, 3, 1, 6, dilation=6, **kw), nn.ReLU(),
                   Conv(1024, 1024, 1, **kw), nn.ReLU()]
        self.features = nn.Sequential(*layers)
        self.extra = nn.ModuleList()
        cin = 1024
        for ch, k, s, p in EXTRA:
            self.extra.append(Conv(cin, ch, k, s, p, **kw))
            cin = ch
        self.l2_norm = L2Norm(512, l2_norm_scale, device=device)
        self.out_feature_indices = tuple(out_feature_indices)

    def forward(self, x):
        outs = []
        for i, layer in enumerate(self.features):
            x = layer(x)
            if i == self.out_feature_indices[0]:
                outs.append(self.l2_norm(x))
        outs.append(x)
        for i, conv in enumerate(self.extra):
            x = F.relu(conv(x))
            if i % 2 == 1:
                outs.append(x)
        return tuple(outs)
