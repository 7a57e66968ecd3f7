"""TridentNet's ResNet (port of ``oadg_tpu/models/backbones/trident_resnet.py``;
mmdet's ``trident_resnet.py``).

``num_stages`` caffe-style ResNet stages (``resnet.Bottleneck``, the frozen
BNs folded into their convs), then a trident stage of ``TridentBottleneck``
blocks (``:22``): ``num_branch`` branches that share every weight, the 3x3
(``conv2``, one (planes, planes, 3, 3) kernel) applied at each branch's
dilation of ``trident_dilations`` and padded by it, the stride on the 3x3,
each frozen BN after its conv (unfolded, as the JAX block applies them).
``mode`` chooses the output (``:118-121``): ``"train"`` the branches
concatenated on the batch (``num_branch * N`` images), ``"test"`` the branch
``test_branch_idx``. The stem's BN follows its conv, unfolded too.

Built as the JAX package builds it: three stages and then the trident
stage of ``planes = 512`` with stride 2, so the output is stride 32 with
2048 channels (mmdet's trident stage is the third, at stride 16 with 1024);
the TridentNet detector is refused (``models/builder.py``). mmdet keys:
``layer4.{j}.conv2.weight`` (the shared kernel), ``layer4.{j}.bn{k}``,
``layer4.0.downsample.{0,1}``.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...utils.registry import BACKBONES
from ..layers import Conv, FrozenBN, _reduced, max_pool_3x3_s2
from .resnet import ARCH, Bottleneck, _downsample


class TridentBottleneck(nn.Module):
    """``:22-65``: one block applied to every branch with that branch's
    dilation; ``forward`` maps the list of branch inputs to their outputs."""
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 dilations: Sequence[int] = (1, 2, 3), downsample: bool = False,
                 bn_grad: bool = True, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.stride, self.dilations = stride, tuple(dilations)
        self.conv1 = Conv(inplanes, planes, 1, bias=False, **kw)
        self.bn1 = FrozenBN(planes, requires_grad=bn_grad, device=device)
        self.conv2 = Conv(planes, planes, 3, stride, bias=False, **kw)
        self.bn2 = FrozenBN(planes, requires_grad=bn_grad, device=device)
        self.conv3 = Conv(planes, planes * 4, 1, bias=False, **kw)
        self.bn3 = FrozenBN(planes * 4, requires_grad=bn_grad, device=device)
        self.downsample = (_downsample(inplanes, planes * 4, stride, bn_grad, device, dtype)
                           if downsample else None)

    def _conv2(self, x, d):
        dt = self.conv2.compute_dtype if _reduced(self.conv2.compute_dtype) else x.dtype
        return F.conv2d(x.to(dt), self.conv2.weight.to(dt), None, self.stride, d, d)

    def forward(self, xs):
        outs = []
        for x, d in zip(xs, self.dilations):
            out = F.relu(self.bn1(self.conv1(x)))
            out = F.relu(self.bn2(self._conv2(out, d)))
            out = self.bn3(self.conv3(out))
            identity = x if self.downsample is None else self.downsample[1](
                self.downsample[0](x))
            outs.append(F.relu(out + identity))
        return outs


@BACKBONES.register_module()
class TridentResNet(nn.Module):
    """``:69-122``. ``out_indices`` is taken and not read (the JAX backbone
    returns the trident stage alone); ``frozen_stages`` freezes the stem
    and the first stages as ``ResNet`` does."""

    def __init__(self, depth: int = 50, num_branch: int = 3, test_branch_idx: int = 1,
                 trident_dilations: Sequence[int] = (1, 2, 3), num_stages: int = 3,
                 out_indices: Sequence[int] = (2,), strides: Sequence[int] = (1, 2, 2),
                 dilations: Sequence[int] = (1, 1, 1), style: str = "caffe",
                 frozen_stages: int = -1, norm_cfg=None, norm_eval: bool = True,
                 init_cfg=None, pretrained=None, mode: str = "train", device=None, dtype=None):
        super().__init__()
        if style not in ("pytorch", "caffe") or not norm_eval:
            raise NotImplementedError("the port's TridentResNet is pytorch or caffe style "
                                      "with frozen BN (norm_eval=True)")
        if norm_cfg is not None and norm_cfg.get("type", "BN") != "BN":
            raise NotImplementedError(f"norm {norm_cfg['type']}")
        if mode not in ("train", "test"):
            raise ValueError(f"mode {mode!r}: train or test")
        if len(trident_dilations) != num_branch:
            raise ValueError(f"{num_branch} branches, {len(trident_dilations)} dilations")
        _, blocks = ARCH[depth]
        bn_grad = dict(norm_cfg or {}).get("requires_grad", True) is not False
        kw = dict(device=device, dtype=dtype)
        self.mode, self.test_branch_idx, self.num_branch = mode, test_branch_idx, num_branch
        self.conv1 = Conv(3, 64, 7, 2, 3, bias=False, **kw)
        self.bn1 = FrozenBN(64, requires_grad=bn_grad, device=device)
        inplanes = 64
        for i in range(num_stages):
            planes = 64 * 2 ** i
            layers = []
            for j in range(blocks[i]):
                stride = strides[i] if j == 0 else 1
                ds = None
                if j == 0 and (stride != 1 or inplanes != planes * 4):
                    ds = _downsample(inplanes, planes * 4, stride, bn_grad, device, dtype)
                layers.append(Bottleneck(inplanes, planes, stride, dilations[i], ds, style,
                                         bn_grad, **kw))
                inplanes = planes * 4
            self.add_module(f"layer{i + 1}", nn.Sequential(*layers))
        self.num_stages = num_stages
        planes = 64 * 2 ** 3
        self.add_module(f"layer{num_stages + 1}", nn.ModuleList(
            TridentBottleneck(inplanes if j == 0 else planes * 4, planes, 2 if j == 0 else 1,
                              trident_dilations, j == 0, bn_grad, **kw)
            for j in range(blocks[3])))
        frozen = ([self.conv1, self.bn1] if frozen_stages >= 0 else []) + [
            getattr(self, f"layer{i}") for i in range(1, frozen_stages + 1)]
        for module in frozen:
            module.requires_grad_(False)

    def forward(self, x):
        x = max_pool_3x3_s2(F.relu(self.bn1(self.conv1(x))))
        for i in range(1, self.num_stages + 1):
            x = getattr(self, f"layer{i}")(x)
        branches = [x] * self.num_branch
        for block in getattr(self, f"layer{self.num_stages + 1}"):
            branches = block(branches)
        if self.mode == "train":
            return (torch.cat(branches, 0),)
        return (branches[self.test_branch_idx],)
