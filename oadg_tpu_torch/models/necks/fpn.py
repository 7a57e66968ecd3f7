"""FPN (port of ``oadg_tpu/models/necks/fpn.py:24``): 1x1 laterals, nearest
2x top-down upsampling, 3x3 outputs, extra levels by stride-2 subsampling
(``num_outs`` above the inputs, ``add_extra_convs=False``, ``:52-58``).
mmdet keys: ``lateral_convs.i.conv.weight``, ``fpn_convs.i.conv.weight``.
The convs compute in ``dtype`` (float32 parameters); the top-down sums and
the extra levels stay in the maps' dtype, as in the JAX package."""
from __future__ import annotations

from typing import Sequence

import torch.nn.functional as F
from torch import nn

from ...utils.registry import NECKS
from ..layers import ConvModule


def upsample_nearest_2x(x, out_hw):
    """``oadg_tpu/models/necks/fpn.py:17``: repeat each pixel 2x2, then crop
    to ``out_hw`` (``F.interpolate(size=...)`` differs on odd sizes)."""
    y = x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
    return y[:, :, :out_hw[0], :out_hw[1]]


@NECKS.register_module()
class FPN(nn.Module):

    def __init__(self, in_channels: Sequence[int] = (256, 512, 1024, 2048),
                 out_channels: int = 256, num_outs: int = 5, device=None,
                 dtype=None):
        super().__init__()
        self.num_outs = num_outs
        self.lateral_convs = nn.ModuleList(
            ConvModule(c, out_channels, 1, device=device, dtype=dtype) for c in in_channels)
        self.fpn_convs = nn.ModuleList(
            ConvModule(out_channels, out_channels, 3, 1, 1, device=device,
                       dtype=dtype)
            for _ in in_channels)

    def forward(self, inputs):
        laterals = [conv(x) for conv, x in zip(self.lateral_convs, inputs)]
        for i in range(len(laterals) - 1, 0, -1):
            laterals[i - 1] = laterals[i - 1] + upsample_nearest_2x(
                laterals[i], laterals[i - 1].shape[2:])
        outs = [conv(x) for conv, x in zip(self.fpn_convs, laterals)]
        for _ in range(self.num_outs - len(outs)):
            outs.append(F.max_pool2d(outs[-1], 1, stride=2))
        return tuple(outs)
