"""ResNet backbone (port of ``oadg_tpu/models/backbones/resnet.py:125``).

``pytorch`` style (stride on the 3x3 of a bottleneck) and ``caffe`` style
(stride on its first 1x1, ``:88-90``), per-stage ``strides`` and
``dilations`` (a dilated 3x3 pads by its dilation, ``:98-104``; the DC5
variant of the DWD config is ``strides=(1, 2, 2, 1)``, ``dilations=(1, 1,
1, 2)``: stride 16 at ``layer4``), frozen BN (``norm_eval=True``), depths 18
and 34 (``BasicBlock``) and 50, 101, 152 (``Bottleneck``). A stage's first
block gets a downsample 1x1 where its stride is not 1 or the channel count
changes. mmdet module names, so ``state_dict`` keys read
``layer1.0.conv1.weight``, ``layer1.0.downsample.0.weight`` and so on.

Training: ``frozen_stages`` (>= 0) sets ``requires_grad=False`` on the stem
(``conv1``, ``bn1``) and ``layer1`` .. ``layer<frozen_stages>``, the direct
children that ``oadg_tpu/engine/optim.py:frozen_mask`` (``:39-62``) masks;
``norm_cfg.requires_grad=False`` freezes every BN affine as well.

Every conv and its frozen BN run as one folded conv (``layers.conv_frozen_bn``,
the JAX package's ``conv_norm``, ``:30-50``), in the compute dtype ``dtype``;
the module pairs and their ``state_dict`` keys stay those of mmdet. Two 3x3s
are not folded, as in the JAX package, which applies their BN after them
(``norm()``): the DCNv2 ``conv2`` of a stage in ``stage_with_dcn`` when
``dcn=dict(type='DCNv2', deform_groups=...)`` (``:84-104``; offsets and
modulation from its ``conv_offset``, ``layers.ModulatedDeformConv``), and
ResNeXt's grouped ``conv2`` (``ResNeXt``, ``BottleneckX``, ``:200-275``:
``groups`` x ``base_width`` channels a group, width
``int(planes * base_width / 64) * groups``).

The deep stem and the avg-down shortcut that Res2Net and ResNeSt share
(``DeepStem``, ``AvgDownShortcut``): three 3x3 convs (``stem_channels //
2``, ``// 2``, then all of them; strides 2, 1, 1) each with a BN and a ReLU,
then the 3x3/s2 max-pool; the shortcut an average pool of ``stride`` x
``stride`` (floor sizes, where the stride is not 1), a 1x1 conv and a BN.
mmdet's names (``stem.0`` .. ``stem.7``; ``downsample.1`` and
``downsample.2`` after mmdet's ``AvgPool2d`` at ``downsample.0``). The JAX
``frozen_mask`` freezes the three stem convs and the first stem BN (the
stem's BNs are ``FrozenBN_0`` .. ``FrozenBN_2``, and it matches
``FrozenBN_0``): the second and third stem BNs train, as the port keeps
them (mmdet freezes the whole stem; ROADMAP C).

``Res2Net`` (``:329``) and ``Bottle2neck`` (``:277``): ``conv1`` gives
``scales`` chunks of ``int(planes * base_width / 64)`` channels;
``scales - 1`` sequential 3x3s (``convs.k``, ``bns.k``), chunk k > 0 taking
the previous 3x3's output added to it where the 3x3's stride is 1; the last
chunk untouched, or average-pooled 3x3 with padding 1 (the padding
counted) where the stride is not 1; then ``conv3`` and the avg-down
shortcut. mmdet switches both on the block's ``stage_type``, so the first
block of ``layer1`` (stride 1) adds hierarchically here and in the JAX
package and not in mmdet (ROADMAP C). The JAX Res2Net stops the gradient
after the stem and after each frozen stage (``:358``, ``:375``), so its
trainable stem BNs get none; so does the port's. Frozen BNs fold into their
convs (``_conv_bn``), live ones apply after them.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...utils.registry import BACKBONES
from ..layers import (BatchNorm, Conv, FrozenBN, ModulatedDeformConv, build_norm,
                      conv_frozen_bn, max_pool_3x3_s2)


def _conv(cin, cout, k, stride=1, padding=0, device=None, dtype=None):
    return Conv(cin, cout, k, stride, padding, bias=False, device=device,
                dtype=dtype)


def _norm(planes, bn_grad, norm_cfg, device):
    """A block's BN: frozen, or live where ``norm_cfg`` is given."""
    if norm_cfg is None:
        return FrozenBN(planes, requires_grad=bn_grad, device=device)
    return build_norm(norm_cfg, planes, device)


def _downsample(cin, cout, stride, bn_grad, device, dtype, norm_cfg=None):
    """``downsample.0`` (1x1 conv) and ``downsample.1`` (its BN: frozen, or
    live with ``norm_cfg``)."""
    return nn.Sequential(_conv(cin, cout, 1, stride, device=device, dtype=dtype),
                         _norm(cout, bn_grad, norm_cfg, device))


def _conv_bn(conv, bn, x):
    """``bn(conv(x))``: a frozen BN folded into the conv, a live one after it."""
    return conv_frozen_bn(conv, bn, x) if isinstance(bn, FrozenBN) else bn(conv(x))


def _identity(block, x):
    ds = block.downsample
    return x if ds is None else _conv_bn(ds[0], ds[1], x)


class BasicBlock(nn.Module):
    """``oadg_tpu/models/backbones/resnet.py:52``: frozen BNs folded into
    their convs, or with ``norm_cfg`` (a ``BN`` config) live BNs after them
    (the JAX ``build_norm`` without ``_eval``: the Hourglass's blocks)."""
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, dilation=1, downsample=None,
                 style="pytorch", bn_grad=True, norm_cfg=None, device=None, dtype=None):
        super().__init__()
        self.conv1 = Conv(inplanes, planes, 3, stride, dilation, dilation,
                          bias=False, device=device, dtype=dtype)
        self.bn1 = _norm(planes, bn_grad, norm_cfg, device)
        self.conv2 = _conv(planes, planes, 3, 1, 1, device=device, dtype=dtype)
        self.bn2 = _norm(planes, bn_grad, norm_cfg, device)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = downsample

    def forward(self, x):
        identity = _identity(self, x)
        out = self.relu(_conv_bn(self.conv1, self.bn1, x))
        out = _conv_bn(self.conv2, self.bn2, out)
        return self.relu(out + identity)


class Bottleneck(nn.Module):
    """``oadg_tpu/models/backbones/resnet.py:76``: the stride on the 3x3
    (``pytorch``) or on the first 1x1 (``caffe``); the 3x3 dilated by
    ``dilation``, padded by it; with ``dcn`` a DCNv2 3x3, its BN after it.
    ``width`` and ``groups`` are ResNeXt's (``BottleneckX``): the 3x3 is then
    grouped, its BN after it."""
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, dilation=1, downsample=None,
                 style="pytorch", bn_grad=True, dcn=None, width=None, groups=1,
                 device=None, dtype=None):
        super().__init__()
        s1, s2 = (stride, 1) if style == "caffe" else (1, stride)
        width = width or planes
        self.conv1 = _conv(inplanes, width, 1, s1, device=device, dtype=dtype)
        self.bn1 = FrozenBN(width, requires_grad=bn_grad, device=device)
        if dcn is not None:
            self.conv2 = ModulatedDeformConv(
                width, width, 3, s2, dilation, dilation,
                deform_groups=int(dict(dcn).get("deform_groups", 1)),
                device=device, dtype=dtype)
        else:
            self.conv2 = Conv(width, width, 3, s2, dilation, dilation, bias=False,
                              groups=groups, device=device, dtype=dtype)
        self.fold_conv2 = dcn is None and groups == 1
        self.bn2 = FrozenBN(width, requires_grad=bn_grad, device=device)
        self.conv3 = _conv(width, planes * 4, 1, device=device, dtype=dtype)
        self.bn3 = FrozenBN(planes * 4, requires_grad=bn_grad, device=device)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = downsample

    def forward(self, x):
        identity = _identity(self, x)
        out = self.relu(conv_frozen_bn(self.conv1, self.bn1, x))
        if self.fold_conv2:
            out = conv_frozen_bn(self.conv2, self.bn2, out)
        else:
            out = self.bn2(self.conv2(out))
        out = self.relu(out)
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
    groups = 1

    def block_width(self, planes: int) -> int:
        """The 3x3's width in a stage of ``planes``."""
        return planes

    def __init__(self, depth: int = 50, num_stages: int = 4,
                 out_indices: Sequence[int] = (0, 1, 2, 3),
                 strides: Sequence[int] = (1, 2, 2, 2),
                 dilations: Sequence[int] = (1, 1, 1, 1),
                 style: str = "pytorch", frozen_stages: int = -1,
                 norm_cfg=None, norm_eval: bool = True, init_cfg=None,
                 base_channels: int = 64, stem_channels: int = 64,
                 dcn=None, stage_with_dcn: Sequence[bool] = (False, False, False, False),
                 device=None, dtype=None):
        super().__init__()
        if style not in ("pytorch", "caffe") or not norm_eval:
            raise NotImplementedError("the port's ResNet is pytorch or caffe style "
                                      "with frozen BN (norm_eval=True)")
        if norm_cfg is not None and norm_cfg.get("type", "BN") != "BN":
            raise NotImplementedError(f"norm {norm_cfg['type']}")
        if dcn is not None and dict(dcn).get("type", "DCNv2") != "DCNv2":
            raise NotImplementedError(f"dcn type {dict(dcn)['type']}: the port takes DCNv2")
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
                stride = strides[i] if j == 0 else 1
                ds = None
                if j == 0 and (stride != 1 or inplanes != planes * block.expansion):
                    ds = _downsample(inplanes, planes * block.expansion, stride,
                                     bn_grad, device, dtype)
                extra = {}
                if block is Bottleneck:
                    extra = dict(dcn=dcn if dcn is not None and stage_with_dcn[i] else None,
                                 width=self.block_width(planes), groups=self.groups)
                layers.append(block(inplanes, planes, stride, dilations[i], ds, style,
                                    bn_grad, device=device, dtype=dtype, **extra))
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


@BACKBONES.register_module()
class ResNeXt(ResNet):
    """ResNeXt (``oadg_tpu/models/backbones/resnet.py:254``): ResNet with
    grouped bottlenecks (``BottleneckX``, ``:200``) of ``groups`` groups of
    ``base_width`` channels at the first stage's width; the config's
    ``groups`` and ``base_width``."""

    def __init__(self, groups: int = 32, base_width: int = 4, **kwargs):
        if kwargs.get("dcn") is not None:
            raise NotImplementedError("ResNeXt with dcn: the JAX package builds none")
        self.groups, self.base_width = groups, base_width
        super().__init__(**kwargs)

    def block_width(self, planes: int) -> int:
        return int(planes * (self.base_width / 64.0)) * self.groups


def _bn(channels, norm_eval, bn_grad, device):
    """A frozen BN (``norm_eval``) or a live one."""
    if norm_eval:
        return FrozenBN(channels, requires_grad=bn_grad, device=device)
    return BatchNorm(channels, device=device)


class DeepStem(nn.Sequential):
    """``stem.0`` .. ``stem.8``: three (conv, BN, ReLU) of ``channels // 2``,
    ``// 2`` and ``channels``, strides 2, 1, 1 (``_conv_bn``)."""

    def __init__(self, channels: int, norm_eval: bool, bn_grad: bool, device=None, dtype=None):
        half = channels // 2
        layers = []
        for cin, cout, stride in ((3, half, 2), (half, half, 1), (half, channels, 1)):
            layers += [_conv(cin, cout, 3, stride, 1, device=device, dtype=dtype),
                       _bn(cout, norm_eval, bn_grad, device), nn.ReLU(inplace=True)]
        super().__init__(*layers)

    def forward(self, x):
        for i in (0, 3, 6):
            x = torch.relu(_conv_bn(self[i], self[i + 1], x))
        return x


class AvgDownShortcut(nn.Sequential):
    """``downsample.0`` mmdet's ``AvgPool2d`` (no parameters; floor sizes
    here, as the JAX ``nn.avg_pool``), ``.1`` the 1x1 conv, ``.2`` its BN."""

    def __init__(self, cin: int, cout: int, stride: int, norm_eval: bool, bn_grad: bool,
                 device=None, dtype=None):
        super().__init__(nn.AvgPool2d(stride, stride),
                         _conv(cin, cout, 1, device=device, dtype=dtype),
                         _bn(cout, norm_eval, bn_grad, device))
        self.stride = stride

    def forward(self, x):
        if self.stride != 1:
            x = F.avg_pool2d(x, self.stride, self.stride)
        return _conv_bn(self[1], self[2], x)


class DeepStemResNet(nn.Module):
    """The deep stem, the max-pool and ``num_stages`` stages of ``block``s
    (``make_block(inplanes, planes, stride, dilation, downsample)``), a
    stage's first block with an avg-down shortcut where its stride is not 1
    or the channels change; ``frozen_stages`` >= 0 freezes the three stem
    convs and the first stem BN, and k >= 1 ``layer1`` .. ``layer<k>`` (the
    JAX ``frozen_mask``); ``stop_gradient`` detaches the maps after the stem
    and after each frozen stage, as the JAX Res2Net does."""

    def __init__(self, depth, stages, num_stages, out_indices, strides, dilations,
                 frozen_stages, norm_cfg, norm_eval, base_channels, stem_channels,
                 stop_gradient, make_block, device=None, dtype=None):
        super().__init__()
        if norm_cfg is not None and norm_cfg.get("type", "BN") not in ("BN", "SyncBN", "MMSyncBN"):
            raise NotImplementedError(f"norm {norm_cfg['type']}: the port's deep-stem backbones "
                                      "build BN")
        bn_grad = dict(norm_cfg or {}).get("requires_grad", True) is not False
        self.out_indices = tuple(out_indices)
        self.frozen_stages = frozen_stages if stop_gradient else -1
        self.stem = DeepStem(stem_channels, norm_eval, bn_grad, device, dtype)
        inplanes = stem_channels
        self.res_layers = []
        for i, n in enumerate(stages[depth][:num_stages]):
            planes = base_channels * 2 ** i
            layers = []
            for j in range(n):
                stride = strides[i] if j == 0 else 1
                ds = None
                if j == 0 and (stride != 1 or inplanes != planes * 4):
                    ds = AvgDownShortcut(inplanes, planes * 4, stride, norm_eval, bn_grad,
                                         device, dtype)
                layers.append(make_block(inplanes, planes, stride, dilations[i], ds,
                                         norm_eval=norm_eval, bn_grad=bn_grad))
                inplanes = planes * 4
            self.add_module(f"layer{i + 1}", nn.Sequential(*layers))
            self.res_layers.append(f"layer{i + 1}")
        frozen = ([self.stem[0], self.stem[1], self.stem[3], self.stem[6]]
                  if frozen_stages >= 0 else [])
        frozen += [getattr(self, name) for name in self.res_layers[:max(frozen_stages, 0)]]
        for module in frozen:
            module.requires_grad_(False)

    def forward(self, x):
        x = max_pool_3x3_s2(self.stem(x))
        if self.frozen_stages >= 0:
            x = x.detach()
        outs = []
        for i, name in enumerate(self.res_layers):
            x = getattr(self, name)(x)
            if self.frozen_stages >= i + 1:
                x = x.detach()
            if i in self.out_indices:
                outs.append(x)
        return tuple(outs)


class Bottle2neck(nn.Module):
    """Res2Net's block: ``conv1``/``bn1``, ``convs.k``/``bns.k`` (k <
    ``scales - 1``), ``conv3``/``bn3``, ``downsample``."""

    def __init__(self, inplanes, planes, stride=1, dilation=1, downsample=None,
                 style="pytorch", scales=4, base_width=26, norm_eval=True, bn_grad=True,
                 device=None, dtype=None):
        super().__init__()
        width = int(planes * (base_width / 64.0))
        s1, self.s2 = (stride, 1) if style == "caffe" else (1, stride)
        self.width, self.scales = width, scales
        self.conv1 = _conv(inplanes, width * scales, 1, s1, device=device, dtype=dtype)
        self.bn1 = _bn(width * scales, norm_eval, bn_grad, device)
        self.convs = nn.ModuleList(
            Conv(width, width, 3, self.s2, dilation, dilation, bias=False, device=device,
                 dtype=dtype) for _ in range(scales - 1))
        self.bns = nn.ModuleList(_bn(width, norm_eval, bn_grad, device)
                                 for _ in range(scales - 1))
        self.conv3 = _conv(width * scales, planes * 4, 1, device=device, dtype=dtype)
        self.bn3 = _bn(planes * 4, norm_eval, bn_grad, device)
        self.downsample = downsample

    def forward(self, x):
        out = torch.relu(_conv_bn(self.conv1, self.bn1, x))
        chunks = torch.split(out, self.width, dim=1)
        parts, sp = [], None
        for k, (conv, bn) in enumerate(zip(self.convs, self.bns)):
            inp = chunks[k] if k == 0 or self.s2 != 1 else sp + chunks[k]
            sp = torch.relu(_conv_bn(conv, bn, inp))
            parts.append(sp)
        last = chunks[-1]
        if self.s2 != 1:
            last = F.avg_pool2d(last, 3, self.s2, 1)
        out = _conv_bn(self.conv3, self.bn3, torch.cat(parts + [last], dim=1))
        identity = x if self.downsample is None else self.downsample(x)
        return torch.relu(out + identity)


@BACKBONES.register_module()
class Res2Net(DeepStemResNet):
    def __init__(self, depth: int = 50, scales: int = 4, base_width: int = 26,
                 num_stages: int = 4, out_indices: Sequence[int] = (0, 1, 2, 3),
                 strides: Sequence[int] = (1, 2, 2, 2),
                 dilations: Sequence[int] = (1, 1, 1, 1), style: str = "pytorch",
                 frozen_stages: int = -1, norm_cfg=None, norm_eval: bool = True,
                 base_channels: int = 64, stem_channels: int = 64, deep_stem: bool = True,
                 init_cfg=None, pretrained=None, device=None, dtype=None):

        def make_block(inplanes, planes, stride, dilation, ds, **kw):
            return Bottle2neck(inplanes, planes, stride, dilation, ds, style, scales,
                               base_width, device=device, dtype=dtype, **kw)

        super().__init__(depth, {d: b for d, (_, b) in ARCH.items()}, num_stages, out_indices,
                         strides, dilations, frozen_stages, norm_cfg, norm_eval,
                         base_channels, stem_channels, stop_gradient=True,
                         make_block=make_block, device=device, dtype=dtype)
