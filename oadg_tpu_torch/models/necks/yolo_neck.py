"""YOLOv3 neck (port of ``oadg_tpu/models/necks/yolo_neck.py:14-66``).

Three ``DetectionBlock``s (five ``ConvModule``s with BN and LeakyReLU(0.1),
1x1 and 3x3 alternating) from the coarsest backbone level down: a level's
block output goes through the 1x1 ``conv{i}``, a nearest 2x upsample
cropped to the next finer backbone level, and is concatenated in front of
that level, which ``detect{i + 1}`` then takes. Outputs coarse to fine
(strides 32, 16, 8). mmdet module names: ``detect{i}.conv{1..5}``,
``conv{i}``.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...utils.registry import NECKS
from ..layers import ConvModule


class DetectionBlock(nn.Module):
    """``yolo_neck.py:14``: 1x1 to ``out``, 3x3 to ``2 out``, 1x1, 3x3, 1x1."""

    def __init__(self, in_channels: int, out_channels: int, norm_cfg,
                 device=None, dtype=None):
        super().__init__()
        kw = dict(norm_cfg=norm_cfg, act="leaky_relu", device=device, dtype=dtype)
        n = out_channels
        self.conv1 = ConvModule(in_channels, n, 1, **kw)
        self.conv2 = ConvModule(n, 2 * n, 3, 1, 1, **kw)
        self.conv3 = ConvModule(2 * n, n, 1, **kw)
        self.conv4 = ConvModule(n, 2 * n, 3, 1, 1, **kw)
        self.conv5 = ConvModule(2 * n, n, 1, **kw)

    def forward(self, x):
        return self.conv5(self.conv4(self.conv3(self.conv2(self.conv1(x)))))


@NECKS.register_module()
class YOLOV3Neck(nn.Module):

    def __init__(self, num_scales: int = 3, in_channels: Sequence[int] = (1024, 512, 256),
                 out_channels: Sequence[int] = (512, 256, 128), norm_cfg=None,
                 act_cfg=None, init_cfg=None, device=None, dtype=None):
        super().__init__()
        if len(in_channels) != num_scales or len(out_channels) != num_scales:
            raise ValueError("YOLOV3Neck needs one in and out channel count a scale")
        norm_cfg = dict(norm_cfg or dict(type="BN"))
        self.num_scales = num_scales
        self.detect1 = DetectionBlock(in_channels[0], out_channels[0], norm_cfg,
                                      device, dtype)
        for i in range(1, num_scales):
            self.add_module(f"conv{i}", ConvModule(
                out_channels[i - 1], out_channels[i], 1, norm_cfg=norm_cfg,
                act="leaky_relu", device=device, dtype=dtype))
            self.add_module(f"detect{i + 1}", DetectionBlock(
                in_channels[i] + out_channels[i], out_channels[i], norm_cfg, device, dtype))

    def forward(self, feats):
        if len(feats) != self.num_scales:
            raise ValueError(f"{len(feats)} levels for {self.num_scales} scales")
        x = self.detect1(feats[-1])
        outs = [x]
        for i in range(1, self.num_scales):
            t = getattr(self, f"conv{i}")(x)
            skip = feats[-1 - i]
            t = F.interpolate(t, scale_factor=2, mode="nearest")
            t = t[:, :, :skip.shape[2], :skip.shape[3]]
            x = getattr(self, f"detect{i + 1}")(torch.cat([t, skip], dim=1))
            outs.append(x)
        return tuple(outs)
