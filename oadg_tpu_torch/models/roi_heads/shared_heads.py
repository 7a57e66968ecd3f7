"""Shared RoI head (port of ``oadg_tpu/models/roi_heads/shared_heads.py:15-37``):
the C4 Faster R-CNN runs ResNet stage ``stage + 1`` (``layer4`` for
``stage=3``) on the RoI features before a light box head. mmdet keys:
``roi_head.shared_head.layer4.N.*``.

Its blocks are the backbone's ``Bottleneck`` with frozen BN (``norm_eval``)
folded into each conv; ``norm_cfg.requires_grad=False`` freezes their
affines, as mmdet's ``ResLayer`` does (the JAX package trains them: its
optimizer mask freezes backbone norms only; ROADMAP C)."""
from __future__ import annotations

from torch import nn

from ...utils.registry import HEADS
from ..backbones.resnet import ARCH, Bottleneck, _downsample


@HEADS.register_module()
class ResLayer(nn.Module):

    def __init__(self, depth: int = 50, stage: int = 3, stride: int = 2,
                 dilation: int = 1, style: str = "caffe", norm_cfg=None,
                 norm_eval: bool = True, in_channels=None, device=None, dtype=None):
        super().__init__()
        block, stage_blocks = ARCH[depth]
        if block is not Bottleneck or not norm_eval:
            raise NotImplementedError("the port's ResLayer takes a Bottleneck depth "
                                      "with frozen BN (norm_eval=True)")
        bn_grad = dict(norm_cfg or {}).get("requires_grad", True) is not False
        planes = 64 * 2 ** stage
        # mmdet's ResLayer reads the previous stage's width; a narrower
        # backbone passes its own (the RoI extractor's out_channels)
        inplanes = in_channels or 64 * 2 ** (stage - 1) * block.expansion
        self.out_channels = planes * block.expansion
        layers = []
        for j in range(stage_blocks[stage]):
            s = stride if j == 0 else 1
            ds = None
            if j == 0 and (s != 1 or inplanes != self.out_channels):
                ds = _downsample(inplanes, self.out_channels, s, bn_grad, device, dtype)
            layers.append(block(inplanes, planes, s, dilation, ds, style, bn_grad,
                                device=device, dtype=dtype))
            inplanes = self.out_channels
        self.layer_name = f"layer{stage + 1}"
        self.add_module(self.layer_name, nn.Sequential(*layers))

    def forward(self, x):
        """(R, C, h, w) RoI features -> (R, 4 * planes, h / stride, w / stride)."""
        return getattr(self, self.layer_name)(x)
