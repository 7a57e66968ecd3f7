"""ResNet backbone (port of ``oadg_tpu/models/backbones/resnet.py:125``).

``pytorch`` style (stride on the 3x3 of a bottleneck), frozen BN
(``norm_eval=True``), depths 18 and 34 (``BasicBlock``) and 50, 101, 152
(``Bottleneck``). mmdet module names, so ``state_dict`` keys read
``layer1.0.conv1.weight``, ``layer1.0.downsample.0.weight`` and so on.

Training: ``frozen_stages`` (>= 0) sets ``requires_grad=False`` on the stem
(``conv1``, ``bn1``) and ``layer1`` .. ``layer<frozen_stages>``, the direct
children that ``oadg_tpu/engine/optim.py:frozen_mask`` (``:39-62``) masks;
``norm_cfg.requires_grad=False`` freezes every BN affine as well.

Every conv and its frozen BN run as one folded conv (``layers.conv_frozen_bn``,
the JAX package's ``conv_norm``, ``:30-50``), in the compute dtype ``dtype``;
the module pairs and their ``state_dict`` keys stay those of mmdet.
"""
from __future__ import annotations

from typing import Sequence

from torch import nn

from ...utils.registry import BACKBONES
from ..layers import Conv, FrozenBN, conv_frozen_bn, max_pool_3x3_s2


def _conv(cin, cout, k, stride=1, padding=0, device=None, dtype=None):
    return Conv(cin, cout, k, stride, padding, bias=False, device=device,
                dtype=dtype)


def _downsample(cin, cout, stride, bn_grad, device, dtype):
    """``downsample.0`` (1x1 conv) and ``downsample.1`` (its frozen BN)."""
    return nn.Sequential(_conv(cin, cout, 1, stride, device=device, dtype=dtype),
                         FrozenBN(cout, requires_grad=bn_grad, device=device))


def _identity(block, x):
    ds = block.downsample
    return x if ds is None else conv_frozen_bn(ds[0], ds[1], x)


class BasicBlock(nn.Module):
    """``oadg_tpu/models/backbones/resnet.py:52``."""
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=None,
                 bn_grad=True, device=None, dtype=None):
        super().__init__()
        self.conv1 = _conv(inplanes, planes, 3, stride, 1, device=device, dtype=dtype)
        self.bn1 = FrozenBN(planes, requires_grad=bn_grad, device=device)
        self.conv2 = _conv(planes, planes, 3, 1, 1, device=device, dtype=dtype)
        self.bn2 = FrozenBN(planes, requires_grad=bn_grad, device=device)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = downsample

    def forward(self, x):
        identity = _identity(self, x)
        out = self.relu(conv_frozen_bn(self.conv1, self.bn1, x))
        out = conv_frozen_bn(self.conv2, self.bn2, out)
        return self.relu(out + identity)


class Bottleneck(nn.Module):
    """``oadg_tpu/models/backbones/resnet.py:76`` in ``pytorch`` style."""
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=None,
                 bn_grad=True, device=None, dtype=None):
        super().__init__()
        self.conv1 = _conv(inplanes, planes, 1, device=device, dtype=dtype)
        self.bn1 = FrozenBN(planes, requires_grad=bn_grad, device=device)
        self.conv2 = _conv(planes, planes, 3, stride, 1, device=device, dtype=dtype)
        self.bn2 = FrozenBN(planes, requires_grad=bn_grad, device=device)
        self.conv3 = _conv(planes, planes * 4, 1, device=device, dtype=dtype)
        self.bn3 = FrozenBN(planes * 4, requires_grad=bn_grad, device=device)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = downsample

    def forward(self, x):
        identity = _identity(self, x)
        out = self.relu(conv_frozen_bn(self.conv1, self.bn1, x))
        out = self.relu(conv_frozen_bn(self.conv2, self.bn2, out))
        out = conv_frozen_bn(self.conv3, self.bn3, out)
        return self.relu(out + identity)


ARCH = {
    18: (BasicBlock, (2, 2, 2, 2)),
    34: (BasicBlock, (3, 4, 6, 3)),
    50: (Bottleneck, (3, 4, 6, 3)),
    101: (Bottleneck, (3, 4, 23, 3)),
    152: (Bottleneck, (3, 8, 36, 3)),
}


@BACKBONES.register_module()
class ResNet(nn.Module):
    """Stem (7x7/s2 conv, frozen BN, ReLU, 3x3/s2 max pool) and
    ``num_stages`` residual stages; returns the stages in ``out_indices``."""

    def __init__(self, depth: int = 50, num_stages: int = 4,
                 out_indices: Sequence[int] = (0, 1, 2, 3),
                 style: str = "pytorch", frozen_stages: int = -1,
                 norm_cfg=None, norm_eval: bool = True, init_cfg=None,
                 base_channels: int = 64, stem_channels: int = 64,
                 device=None, dtype=None):
        super().__init__()
        if style != "pytorch" or not norm_eval:
            raise NotImplementedError("the port's ResNet is pytorch style with "
                                      "frozen BN (norm_eval=True)")
        if norm_cfg is not None and norm_cfg.get("type", "BN") != "BN":
            raise NotImplementedError(f"norm {norm_cfg['type']}")
        block, blocks = ARCH[depth]
        blocks = blocks[:num_stages]
        bn_grad = dict(norm_cfg or {}).get("requires_grad", True) is not False
        self.out_indices = tuple(out_indices)
        self.conv1 = _conv(3, stem_channels, 7, 2, 3, device=device, dtype=dtype)
        self.bn1 = FrozenBN(stem_channels, requires_grad=bn_grad, device=device)
        self.relu = nn.ReLU(inplace=True)
        inplanes = stem_channels
        self.res_layers = []
        for i, n in enumerate(blocks):
            planes = base_channels * 2 ** i
            layers = []
            for j in range(n):
                stride = 2 if i > 0 and j == 0 else 1
                ds = None
                if j == 0 and (stride != 1 or inplanes != planes * block.expansion):
                    ds = _downsample(inplanes, planes * block.expansion, stride,
                                     bn_grad, device, dtype)
                layers.append(block(inplanes, planes, stride, ds, bn_grad,
                                    device=device, dtype=dtype))
                inplanes = planes * block.expansion
            name = f"layer{i + 1}"
            self.add_module(name, nn.Sequential(*layers))
            self.res_layers.append(name)
        frozen = ([self.conv1, self.bn1] if frozen_stages >= 0 else []) + [
            getattr(self, f"layer{i}") for i in range(1, frozen_stages + 1)]
        for module in frozen:
            module.requires_grad_(False)

    def forward(self, x):
        x = max_pool_3x3_s2(self.relu(conv_frozen_bn(self.conv1, self.bn1, x)))
        outs = []
        for i, name in enumerate(self.res_layers):
            x = getattr(self, name)(x)
            if i in self.out_indices:
                outs.append(x)
        return tuple(outs)
