"""FPN (port of ``oadg_tpu/models/necks/fpn.py:24-70``): 1x1 laterals on the
inputs ``start_level`` .. ``end_level``, nearest 2x top-down upsampling, 3x3
outputs, and ``num_outs`` above those levels made by stride-2 subsampling
(``add_extra_convs=False``) or by stride-2 3x3 convs (``on_input``, the
last used input, e.g. RetinaNet's C5; ``True`` is ``on_input``;
``on_lateral``; ``on_output``), each after the first behind a ReLU with
``relu_before_extra_convs``. mmdet keys: ``lateral_convs.i.conv.weight``,
``fpn_convs.i.conv.weight``; the extra convs follow the output convs in
``fpn_convs`` (the JAX package's ``extra_conv_k`` is ``fpn_convs.{used +
k}``).
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
                 out_channels: int = 256, num_outs: int = 5, start_level: int = 0,
                 end_level: int = -1, add_extra_convs=False,
                 relu_before_extra_convs: bool = False, device=None, dtype=None):
        super().__init__()
        self.num_outs = num_outs
        self.start_level = start_level
        self.end = len(in_channels) if end_level == -1 else end_level + 1
        used = list(in_channels[start_level:self.end])
        if add_extra_convs is True:
            add_extra_convs = "on_input"
        if add_extra_convs not in (False, "on_input", "on_lateral", "on_output"):
            raise ValueError(f"add_extra_convs={add_extra_convs!r}")
        self.add_extra_convs = add_extra_convs
        self.relu_before_extra_convs = relu_before_extra_convs
        conv = dict(device=device, dtype=dtype)
        self.lateral_convs = nn.ModuleList(
            ConvModule(c, out_channels, 1, **conv) for c in used)
        extra = max(num_outs - len(used), 0) if add_extra_convs else 0
        self.fpn_convs = nn.ModuleList(
            [ConvModule(out_channels, out_channels, 3, 1, 1, **conv) for _ in used]
            + [ConvModule(used[-1] if k == 0 and add_extra_convs == "on_input"
                          else out_channels, out_channels, 3, 2, 1, **conv)
               for k in range(extra)])

    def forward(self, inputs):
        used = list(inputs[self.start_level:self.end])
        laterals = [conv(x) for conv, x in zip(self.lateral_convs, used)]
        for i in range(len(laterals) - 1, 0, -1):
            laterals[i - 1] = laterals[i - 1] + upsample_nearest_2x(
                laterals[i], laterals[i - 1].shape[2:])
        outs = [conv(x) for conv, x in zip(self.fpn_convs, laterals)]
        extra = self.num_outs - len(outs)
        if extra > 0 and not self.add_extra_convs:
            for _ in range(extra):
                outs.append(F.max_pool2d(outs[-1], 1, stride=2))
        elif extra > 0:
            src = {"on_input": used[-1], "on_lateral": laterals[-1],
                   "on_output": outs[-1]}[self.add_extra_convs]
            for k, conv in enumerate(self.fpn_convs[len(laterals):]):
                if k > 0 and self.relu_before_extra_convs:
                    src = F.relu(src)
                src = conv(src)
                outs.append(src)
        return tuple(outs)


@NECKS.register_module()
class ChannelMapper(nn.Module):
    """``oadg_tpu/models/necks/fpn.py:74``: one ``kernel_size`` conv per
    input (a ``ConvModule`` with the config's ``norm_cfg`` and no
    activation, as the JAX module; mmdet's default is a ReLU), as many
    outputs as inputs: keys ``convs.{i}.conv.*``. mmdet's ``num_outs`` (an
    extra stride-2 conv above the last input) is dropped, as the JAX
    package's registry drops it: Deformable DETR's config asks for 4 levels
    and both packages build 3 (ROADMAP C)."""

    def __init__(self, in_channels: Sequence[int] = (512, 1024, 2048), out_channels: int = 256,
                 kernel_size: int = 3, norm_cfg=None, num_outs=None, device=None, dtype=None):
        super().__init__()
        self.convs = nn.ModuleList(
            ConvModule(c, out_channels, kernel_size, 1, kernel_size // 2, norm_cfg=norm_cfg,
                       device=device, dtype=dtype) for c in in_channels)

    def forward(self, inputs):
        return tuple(conv(x) for conv, x in zip(self.convs, inputs))
