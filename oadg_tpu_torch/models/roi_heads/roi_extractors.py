"""Single-level-per-roi extractor (port of
``oadg_tpu/models/roi_heads/roi_extractors.py:24``): each roi reads the FPN
level its area maps to, through ``ops/roi_align.roi_align_multilevel`` (the
CUDA kernel on the card). The maps come in the model's dtype (a bfloat16
model's are read as bfloat16 by B1 and its gradient B2); the features are
float32 either way."""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ...ops.roi_align import roi_align_multilevel
from ...utils.registry import ROI_EXTRACTORS


@ROI_EXTRACTORS.register_module()
class SingleRoIExtractor(nn.Module):

    def __init__(self, roi_layer=None, out_channels: int = 256,
                 featmap_strides: Sequence[int] = (4, 8, 16, 32),
                 finest_scale: int = 56, init_cfg=None, device=None):
        super().__init__()
        layer = dict(roi_layer or dict(output_size=7))
        self.output_size = int(layer.get("output_size", 7))
        # sampling_ratio 0 is mmcv's adaptive grid; the port holds the JAX
        # package's static 2
        self.sampling_ratio = int(layer.get("sampling_ratio", 0)) or 2
        self.featmap_strides = tuple(featmap_strides)
        self.finest_scale = finest_scale

    def forward(self, feats, rois: torch.Tensor) -> torch.Tensor:
        """(R, 5) rois -> (R, C, out, out) float32."""
        levels = [f.contiguous(memory_format=torch.channels_last)
                  for f in feats[:len(self.featmap_strides)]]
        return roi_align_multilevel(levels, rois.float().contiguous(),
                                    self.output_size, self.featmap_strides,
                                    self.sampling_ratio, self.finest_scale)
