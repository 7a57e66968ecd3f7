"""HTC's and SCNet's RoI heads (port of
``oadg_tpu/models/roi_heads/htc_scnet_heads.py``): ``FusedSemanticHead``
(``:31``), ``GlobalContextHead`` (``:66``), ``HybridTaskCascadeRoIHead``
(``:95``), ``SCNetRoIHead`` (``:231``), their detectors (``:400, 406``), the
aliases ``SCNetMaskHead``, ``SCNetSemanticHead`` (``:425, 431``) and
``FeatureRelayHead`` (``:437``).

``HybridTaskCascadeRoIHead`` is the cascade of ``cascade_roi_head.py`` with
a mask head a stage (``FCNMaskHead`` whatever the config's type,
``:113-117``). Its training (``loss``, ``:149-222``): the box stages run
with the last stage's refinement too; mask stage k samples afresh (the draws
``rcnn.mask{k}.pos`` / ``.neg``; the JAX keys of ``fold_in(rng, 7)``) from
the boxes that box stage k refined (``interleaved``), keeps the first
``round(num * pos_fraction)`` slots, extracts their mask RoI features
(``_mask_feats``), adds ``info_convs[k]`` of the previous mask stage's
features (the info flow, ``mask_info_flow``: the JAX head's own, not
mmdet's ``conv_res`` of the mask head's output), and holds the head's
``2 out`` logits to the targets resampled from the gt whose box overlaps
the slot's matched box most (the JAX package's index, ``:211-214``), as
``s{k}.loss_mask`` times the stage weight. ``out`` is the
``output_size`` of the mask RoI layer, the box layer's where the config
gives no ``mask_roi_extractor`` (7 on the repo's HTC and SCNet configs).
The test path is the cascade's: boxes only (``:224``).

``_mask_feats`` (``:134-147``): the multilevel RoIAlign at ``out`` (kernel
B1 and its gradient B2), plus, with a semantic head, RoIAlign of the
semantic embedding on its one stride-8 level (B1 and B2 again: JAX's
single-level ``roi_align`` with ``spatial_scale`` 1/8, ``sampling_ratio``
2, aligned, is the multilevel function on one level of stride 8).

``FusedSemanticHead``: every FPN level's 1x1 lateral, resized bilinearly to
the ``fusion_level`` map (``jax.image.resize``, which antialiases a
downsample: ``F.interpolate(antialias=True)``) and summed, four 3x3 convs,
then the segmentation logits and the embedding. ``semantic_loss`` is the
JAX head's ``loss_semantic_seg`` on a label map resized by nearest
(``"nearest-exact"``, as ``jax.image.resize``); the JAX detector never
passes the label map, so neither does the port's (ROADMAP C).

``SCNetRoIHead`` adds ``loss_glbctx``: ``GlobalContextHead`` on the last FPN
level, a multilabel BCE against the image's gt classes, times its
``loss_weight`` (``:253-262``).

Under data parallel the new losses' normalizers count every rank's rows.
mmdet keys: ``roi_head.mask_head.{k}.*``, ``roi_head.semantic_head.*``
(``lateral_convs.{i}.conv``, ``convs.{i}.conv``, ``conv_embedding.conv``,
``conv_logits``), ``roi_head.glbctx_head.*`` (``convs.{i}.conv``, ``fc``);
the info flow's ``roi_head.info_convs.{k}``, which mmdet's HTC lacks (the JAX
head builds ``info_conv0`` and never applies it, so it has no variables:
the port keeps its slot with no weights).
"""
from __future__ import annotations

from collections.abc import Mapping

import torch
import torch.nn.functional as F
from torch import nn

from ...core.bbox.geometry import bbox_overlaps
from ...parallel import shard_sum
from ...utils.registry import DETECTORS, HEADS, ROI_EXTRACTORS, build_from_cfg
from ..detectors.two_stage import TwoStageDetector
from ..layers import Conv, ConvModule, Linear
from .cascade_roi_head import CascadeRoIHead
from .mask_heads import FCNMaskHead, mask_targets

SEMANTIC_STRIDE = 8


def _resize_bilinear(x: torch.Tensor, size) -> torch.Tensor:
    """``jax.image.resize(..., "bilinear")`` of NCHW ``x``: half-pixel
    centres, antialiased when downsampling; computed in float32."""
    return F.interpolate(x.float(), size=tuple(size), mode="bilinear", align_corners=False,
                         antialias=True).to(x.dtype)


@HEADS.register_module()
class FusedSemanticHead(nn.Module):

    def __init__(self, num_ins: int = 5, fusion_level: int = 1, num_convs: int = 4,
                 in_channels: int = 256, conv_out_channels: int = 256,
                 num_classes: int = 183, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.num_ins = num_ins
        self.fusion_level = fusion_level
        self.lateral_convs = nn.ModuleList(
            ConvModule(in_channels, conv_out_channels, 1, **kw) for _ in range(num_ins))
        self.convs = nn.ModuleList(
            ConvModule(conv_out_channels, conv_out_channels, 3, 1, 1, **kw)
            for _ in range(num_convs))
        self.conv_logits = Conv(conv_out_channels, num_classes, 1, **kw)
        self.conv_embedding = ConvModule(conv_out_channels, conv_out_channels, 1, **kw)

    def forward(self, feats):
        """FPN maps -> segmentation logits (N, classes, h, w) float32 and the
        embedding (N, C, h, w), at the ``fusion_level`` map's size."""
        tgt = feats[self.fusion_level]
        x = self.lateral_convs[self.fusion_level](tgt)
        for i, f in enumerate(feats[:self.num_ins]):
            if i != self.fusion_level:
                x = x + _resize_bilinear(self.lateral_convs[i](f), tgt.shape[2:])
        for conv in self.convs:
            x = torch.relu(conv(x))
        return self.conv_logits(x).float(), torch.relu(self.conv_embedding(x))


def semantic_loss(seg: torch.Tensor, gt_semantic_seg: torch.Tensor) -> torch.Tensor:
    """``loss_semantic_seg`` (``:156-169``): the (N, H, W) label map resized
    by nearest to the logits' (N, K, h, w), the mean cross-entropy over the
    pixels below 255, times 0.2."""
    tgt = F.interpolate(gt_semantic_seg[:, None].float(), size=seg.shape[2:],
                        mode="nearest-exact")[:, 0].long()
    nll = -torch.gather(torch.log_softmax(seg.float(), 1), 1,
                        tgt.clamp(0, seg.shape[1] - 1)[:, None])[:, 0]
    valid = (tgt < 255).float()
    return (nll * valid).sum() / shard_sum(valid.sum()).clamp(min=1.0) * 0.2


@HEADS.register_module()
class SCNetSemanticHead(FusedSemanticHead):
    """``:431``."""


@HEADS.register_module()
class SCNetMaskHead(FCNMaskHead):
    """``:425``."""


@HEADS.register_module()
class GlobalContextHead(nn.Module):

    def __init__(self, num_convs: int = 4, in_channels: int = 256,
                 conv_out_channels: int = 256, num_classes: int = 80,
                 loss_weight: float = 1.0, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.num_classes = num_classes
        self.loss_weight = float(loss_weight)
        self.convs = nn.ModuleList(
            ConvModule(in_channels if i == 0 else conv_out_channels, conv_out_channels,
                       3, 1, 1, **kw) for i in range(num_convs))
        self.fc = Linear(conv_out_channels, num_classes, **kw)

    def forward(self, feat):
        """(N, C, h, w) -> logits (N, classes) float32 and the conv features."""
        x = feat
        for conv in self.convs:
            x = torch.relu(conv(x))
        return self.fc(x.mean(dim=(2, 3))).float(), x

    def loss(self, logits, gt_labels, gt_valid) -> torch.Tensor:
        """Multilabel BCE against the classes of each image's valid gts (a
        label outside the classes marks none), the mean over images and
        classes, times ``loss_weight``."""
        onehot = ((gt_labels[..., None] == torch.arange(self.num_classes,
                                                        device=logits.device))
                  & gt_valid[..., None]).any(1).float()
        per = (logits.clamp(min=0) - logits * onehot
               + torch.log1p(torch.exp(-logits.abs())))
        count = shard_sum(torch.tensor(float(per.numel()), device=logits.device))
        return per.sum() / count * self.loss_weight


@HEADS.register_module()
class FeatureRelayHead(nn.Module):
    """``:437``: one FC from the box head's features to an (R, C, r, r)
    map (the JAX FC's outputs are ``r x r x C`` in that order). No config
    of the repo builds it."""

    def __init__(self, in_channels: int = 1024, out_conv_channels: int = 256,
                 roi_feat_size: int = 7, device=None, dtype=None):
        super().__init__()
        self.out_conv_channels = out_conv_channels
        self.roi_feat_size = roi_feat_size
        self.fc = Linear(in_channels, out_conv_channels * roi_feat_size ** 2,
                         device=device, dtype=dtype)

    def forward(self, x):
        r = self.roi_feat_size
        return self.fc(x).view(x.shape[0], r, r, self.out_conv_channels).permute(0, 3, 1, 2)


@HEADS.register_module()
class HybridTaskCascadeRoIHead(CascadeRoIHead):

    def __init__(self, mask_roi_extractor=None, mask_head=None,
                 semantic_roi_extractor=None, semantic_head=None,
                 semantic_fusion=("bbox", "mask"), interleaved: bool = True,
                 mask_info_flow: bool = True, device=None, dtype=None, **kwargs):
        super().__init__(device=device, dtype=dtype, **kwargs)
        kw = dict(device=device, dtype=dtype)
        heads = mask_head
        if heads is None or isinstance(heads, Mapping):
            heads = [dict(heads or {})] * self.num_stages
        self.mask_head = nn.ModuleList(
            build_from_cfg(dict(dict(h or {}), type="FCNMaskHead"), HEADS, kw) for h in heads)
        box_ext = dict(kwargs.get("bbox_roi_extractor") or {})
        layer = dict(dict(mask_roi_extractor or box_ext).get("roi_layer",
                                                             dict(output_size=14)))
        self.mask_out_size = int(layer.get("output_size", 14))
        self.mask_size = 2 * self.mask_out_size
        box_layer = dict(box_ext.get("roi_layer", {}))
        self.mask_roi_extractor = build_from_cfg(
            dict(box_ext, roi_layer=dict(box_layer, output_size=self.mask_out_size)),
            ROI_EXTRACTORS, dict(device=device))
        self.semantic_fusion = tuple(semantic_fusion)
        self.interleaved = interleaved
        self.mask_info_flow = mask_info_flow
        channels = int(box_ext.get("out_channels", 256))
        if mask_info_flow:
            info = int(dict(heads[0] or {}).get("in_channels", 256))
            self.info_convs = nn.ModuleList(
                [nn.Identity()] + [Conv(channels, info, 1, **kw)
                                   for _ in range(1, self.num_stages)])
        self.semantic_head = None
        if semantic_head is not None:
            self.semantic_head = FusedSemanticHead(**{
                k: v for k, v in dict(semantic_head).items() if k != "type"}, **kw)
            self.semantic_roi_extractor = build_from_cfg(
                dict(type="SingleRoIExtractor",
                     roi_layer=dict(box_layer, output_size=self.mask_out_size),
                     out_channels=channels, featmap_strides=[SEMANTIC_STRIDE]),
                ROI_EXTRACTORS, dict(device=device))

    def init_weights(self, gen: torch.Generator):
        """The box heads' init, then each stage's mask head's."""
        super().init_weights(gen)
        for head in self.mask_head:
            head.init_weights(gen)

    def _mask_feats(self, feats, rois, sem_embed=None):
        """Mask RoI features (R, C, out, out) float32, with the semantic
        embedding's on its stride-8 level added (``:134-147``)."""
        mf = self.mask_roi_extractor(feats, rois)
        if sem_embed is not None and "mask" in self.semantic_fusion:
            mf = mf + self.semantic_roi_extractor([sem_embed], rois)
        return mf

    def loss(self, feats, proposals, prop_valid, gt_bboxes, gt_valid, gt_labels,
             draws, random_proposals=None, random_valid=None, gt_masks=None,
             gt_semantic_seg=None):
        """The box stages' losses, ``loss_semantic_seg`` where a label map
        is given, and with ``gt_masks`` (N, G, M0, M0) each mask stage's
        ``s{k}.loss_mask``."""
        losses, chain = self._cascade_stages(feats, proposals, prop_valid, gt_bboxes,
                                             gt_valid, gt_labels, draws,
                                             refine_all=self.interleaved)
        sem_embed = None
        if self.semantic_head is not None:
            seg, sem_embed = self.semantic_head(feats)
            if gt_semantic_seg is not None:
                losses["loss_semantic_seg"] = semantic_loss(seg, gt_semantic_seg)
        if gt_masks is None:
            return losses
        last = None
        gm = gt_masks.float()
        for k in range(self.num_stages):
            if self.interleaved:
                cur, cur_valid = chain[k]
            else:
                cur, cur_valid = chain[k - 1] if k else (proposals, prop_valid)
            with torch.no_grad():
                boxes, labels, is_pos, valid, matched = self._stage_sample(
                    k, cur, cur_valid, gt_bboxes, gt_valid, gt_labels, draws, f"mask{k}")
                p = max(int(round(boxes.shape[1] * self.samplers[k].pos_fraction)), 1)
                pboxes, pmatched = boxes[:, :p], matched[:, :p]
                gi = bbox_overlaps(pmatched, gt_bboxes).argmax(-1)          # (N, p)
                pmasks = torch.gather(gm, 1, gi[:, :, None, None].expand(-1, -1, *gm.shape[2:]))
                tgts = mask_targets(pboxes.reshape(-1, 4), pmatched.reshape(-1, 4),
                                    pmasks.reshape(-1, *gm.shape[2:]), self.mask_size)
            mf = self._mask_feats(feats, self.proposals_to_rois(pboxes), sem_embed)
            if self.mask_info_flow and last is not None:
                mf = mf + self.info_convs[k](last)
            last = mf
            lm = self.mask_head[k].loss(self.mask_head[k](mf), tgts, labels[:, :p].reshape(-1),
                                        (is_pos & valid)[:, :p].reshape(-1))
            losses[f"s{k}.loss_mask"] = lm * self.stage_loss_weights[k]
        return losses


@HEADS.register_module()
class SCNetRoIHead(HybridTaskCascadeRoIHead):

    def __init__(self, glbctx_head=None, device=None, dtype=None, **kwargs):
        super().__init__(device=device, dtype=dtype, **kwargs)
        self.glbctx_head = None
        if glbctx_head is not None:
            self.glbctx_head = GlobalContextHead(**{
                k: v for k, v in dict(glbctx_head).items() if k != "type"},
                device=device, dtype=dtype)

    def loss(self, feats, proposals, prop_valid, gt_bboxes, gt_valid, gt_labels,
             draws, random_proposals=None, random_valid=None, gt_masks=None,
             gt_semantic_seg=None):
        """HTC's losses and ``loss_glbctx``."""
        losses = super().loss(feats, proposals, prop_valid, gt_bboxes, gt_valid, gt_labels,
                              draws, gt_masks=gt_masks, gt_semantic_seg=gt_semantic_seg)
        if self.glbctx_head is not None:
            logits, _ = self.glbctx_head(feats[-1])
            losses["loss_glbctx"] = self.glbctx_head.loss(logits, gt_labels, gt_valid)
        return losses


@DETECTORS.register_module()
class HybridTaskCascade(TwoStageDetector):
    """``:400``."""


@DETECTORS.register_module()
class SCNet(TwoStageDetector):
    """``:406``."""
