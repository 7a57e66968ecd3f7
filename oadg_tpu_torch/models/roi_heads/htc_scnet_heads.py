"""HTC's, SCNet's and PointRend's RoI heads (port of
``oadg_tpu/models/roi_heads/htc_scnet_heads.py``): ``FusedSemanticHead``
(``:31``), ``GlobalContextHead`` (``:66``), ``HybridTaskCascadeRoIHead``
(``:95``), ``SCNetRoIHead`` (``:231``), ``MaskPointHead`` (``:267``),
``PointRendRoIHead`` (``:293``), their detectors (``:400, 406, 412``), the
aliases ``CoarseMaskHead``, ``SCNetMaskHead``, ``SCNetSemanticHead``
(``:418, 425, 431``) and ``FeatureRelayHead`` (``:437``).

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

PointRend (``PointRendRoIHead``): Mask R-CNN's mask branch, its
``loss_mask`` plus the point loss (``_point_loss``, ``:311-367``). Of
``num_points * oversample_ratio`` uniform points in each positive's box
(the draws ``rcnn.point.cand``), the ``num_points * importance_sample_ratio``
where the coarse logit at the slot's class (sampled at ``p * 28 - 0.5``) is
least certain are kept (``jax.lax.top_k``'s order), the rest drawn afresh
(``rcnn.point.rand``). At each point the fine feature of FPN level 0 (at
``x / stride - 0.5``) and the coarse logits of every class go through
``MaskPointHead`` (three FCs, the coarse logits concatenated after each,
then ``fc_logits``), held by binary cross-entropy to the 28x28 targets
sampled there and thresholded at 0.5: the mean over the points, then over
the valid positives. The JAX head draws its points from a fixed
``PRNGKey(0)`` on every step; the port draws them from the step's draws, as
mmdet does (ROADMAP C). The fine gather samples each roi's own image, zero
outside it, as mmcv does; the JAX head folds the batch into y, so a point
within half a pixel of an image's top or bottom edge reads a row of the
image before or after it (ROADMAP C). The test path is Mask R-CNN's coarse
mask, with no subdivision, as in the JAX package. mmdet keys
``roi_head.point_head.fcs.{i}.conv`` and ``.fc_logits`` (1x1 ``Conv1d``
weights, (out, in, 1)).
"""
from __future__ import annotations

from collections.abc import Mapping

import torch
import torch.nn.functional as F
from torch import nn

from ...core.bbox.geometry import bbox_overlaps
from ...core.post_processing.nms import sort_desc
from ...ops.misc_ops import bilinear_gather
from ...parallel import shard_sum
from ...utils.registry import DETECTORS, HEADS, ROI_EXTRACTORS, build_from_cfg
from ..detectors.two_stage import MaskRCNN, TwoStageDetector
from ..layers import Conv, ConvModule, Linear, _reduced, lecun_normal_
from .cascade_roi_head import CascadeRoIHead
from .mask_heads import FCNMaskHead, mask_targets
from .standard_roi_head import StandardRoIHead

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


def semantic_loss(seg: torch.Tensor, gt_semantic_seg: torch.Tensor,
                  weight: float = 0.2) -> torch.Tensor:
    """``loss_semantic_seg`` (``:156-169``): the (N, H, W) label map resized
    by nearest to the logits' (N, K, h, w) (``jax.image.resize``'s nearest
    is torch's ``nearest-exact``), the mean cross-entropy over the pixels
    below 255 (every rank's under data parallel), times ``weight`` (HTC's
    0.2; PanopticFPN's 0.5, ``oadg_tpu/models/detectors/panoptic.py:41-49``)."""
    tgt = F.interpolate(gt_semantic_seg[:, None].float(), size=seg.shape[2:],
                        mode="nearest-exact")[:, 0].long()
    nll = -torch.gather(torch.log_softmax(seg.float(), 1), 1,
                        tgt.clamp(0, seg.shape[1] - 1)[:, None])[:, 0]
    valid = (tgt < 255).float()
    return (nll * valid).sum() / shard_sum(valid.sum()).clamp(min=1.0) * weight


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


class _PointConv(nn.Module):
    """A 1x1 ``Conv1d`` over points, applied to (R, P, in) as a dense layer
    in the compute dtype: ``weight`` (out, in, 1), ``bias`` (out,)."""

    def __init__(self, in_channels: int, out_channels: int, device=None, dtype=None):
        super().__init__()
        self.compute_dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, 1, device=device))
        self.bias = nn.Parameter(torch.zeros(out_channels, device=device))

    def init_weights(self, gen: torch.Generator):
        lecun_normal_(self.weight, gen)
        nn.init.zeros_(self.bias)

    def forward(self, x):
        dt = self.compute_dtype
        if not _reduced(dt):
            return F.linear(x, self.weight[..., 0], self.bias)
        return F.linear(x.to(dt), self.weight[..., 0].to(dt)) + self.bias.to(dt)


class _PointFC(nn.Module):
    """mmcv's ``ConvModule`` of one ``_PointConv`` (key ``conv``)."""

    def __init__(self, in_channels: int, out_channels: int, device=None, dtype=None):
        super().__init__()
        self.conv = _PointConv(in_channels, out_channels, device=device, dtype=dtype)

    def forward(self, x):
        return self.conv(x)


@HEADS.register_module()
class MaskPointHead(nn.Module):
    """``:267-290``: (R, P, C) fine features and (R, P, K) coarse logits ->
    (R, P, K) float32 point logits (one a point when ``class_agnostic``)."""

    def __init__(self, num_fcs: int = 3, in_channels: int = 256, fc_channels: int = 256,
                 num_classes: int = 80, class_agnostic: bool = False,
                 coarse_pred_each_layer: bool = True, device=None, dtype=None):
        super().__init__()
        self.num_classes = num_classes
        self.class_agnostic = class_agnostic
        self.coarse_pred_each_layer = coarse_pred_each_layer
        extra = num_classes if coarse_pred_each_layer else 0
        self.fcs = nn.ModuleList(
            _PointFC(in_channels + num_classes if i == 0 else fc_channels + extra, fc_channels,
                     device=device, dtype=dtype) for i in range(num_fcs))
        width = (fc_channels + extra) if num_fcs else in_channels + num_classes
        self.fc_logits = _PointConv(width, 1 if class_agnostic else num_classes,
                                    device=device, dtype=dtype)

    def init_weights(self, gen: torch.Generator):
        for fc in self.fcs:
            fc.conv.init_weights(gen)
        self.fc_logits.init_weights(gen)

    def forward(self, fine, coarse):
        x = torch.cat([fine, coarse.to(fine.dtype)], -1)
        for fc in self.fcs:
            x = torch.relu(fc(x))
            if self.coarse_pred_each_layer:
                x = torch.cat([x, coarse.to(x.dtype)], -1)
        return self.fc_logits(x).float()


@HEADS.register_module()
class PointRendRoIHead(StandardRoIHead):

    def __init__(self, point_head=None, num_points: int = 196, oversample_ratio: float = 3.0,
                 importance_sample_ratio: float = 0.75, device=None, dtype=None, **kwargs):
        super().__init__(device=device, dtype=dtype, **kwargs)
        ph = {k: v for k, v in dict(point_head or {}).items() if k != "type"}
        ph.setdefault("num_classes", dict(kwargs.get("mask_head") or {}).get("num_classes", 80))
        self.point_head = MaskPointHead(**ph, device=device, dtype=dtype)
        self.num_points = num_points
        self.oversample_ratio = oversample_ratio
        self.importance_sample_ratio = importance_sample_ratio

    def init_weights(self, gen: torch.Generator):
        super().init_weights(gen)
        self.point_head.init_weights(gen)

    def _point_loss(self, feats, rois, mask_pred, tgts, labels, pvalid, draws):
        """The point loss of the (R, 5) positive slots' rois, their (R, K, M,
        M) coarse logits and (R, M, M) targets (``:311-367``)."""
        r, _, m, _ = mask_pred.shape
        dev = mask_pred.device
        npts = self.num_points
        nover = int(npts * self.oversample_ratio)
        k_imp = int(npts * self.importance_sample_ratio)
        lab = labels.long().clamp(0, self.point_head.num_classes - 1)
        coarse_map = mask_pred.permute(0, 2, 3, 1)                     # (R, M, M, K)
        with torch.no_grad():
            cand = draws("rcnn.point.cand", (r, nover, 2), dev)
            sel = torch.gather(coarse_map, 3, lab[:, None, None, None].expand(-1, m, m, 1))
            logit = bilinear_gather(sel, cand[..., 1] * m - 0.5, cand[..., 0] * m - 0.5)[..., 0]
            _, ti = sort_desc(-logit.abs(), k_imp)
            pts = torch.cat([torch.gather(cand, 1, ti[..., None].expand(-1, -1, 2)),
                             draws("rcnn.point.rand", (r, npts - k_imp, 2), dev)], 1)
            wh = (rois[:, 3:5] - rois[:, 1:3]).clamp(min=1.0)
            img_pts = rois[:, None, 1:3] + pts * wh[:, None, :]
            stride0 = float(self.bbox_roi_extractor.featmap_strides[0])
            fx, fy = img_pts[..., 0] / stride0 - 0.5, img_pts[..., 1] / stride0 - 0.5
            ts = tgts.shape[-1]
            tgt = (bilinear_gather(tgts[..., None], pts[..., 1] * ts - 0.5,
                                   pts[..., 0] * ts - 0.5)[..., 0] >= 0.5).float()
        fine = bilinear_gather(feats[0].permute(0, 2, 3, 1), fy, fx, image=rois[:, 0].long())
        coarse = bilinear_gather(coarse_map, pts[..., 1] * m - 0.5, pts[..., 0] * m - 0.5)
        refined = self.point_head(fine, coarse)
        if self.point_head.class_agnostic:
            plog = refined[..., 0]
        else:
            plog = torch.gather(refined, 2, lab[:, None, None].expand(-1, npts, 1))[..., 0]
        per = (torch.clamp(plog, min=0) - plog * tgt
               + torch.log1p(torch.exp(-plog.abs()))).mean(-1)
        w = pvalid.float()
        return (per * w).sum() / shard_sum(w.sum()).clamp(min=1.0)

    def _mask_loss(self, feats, boxes, labels, pos, matched_gt, matched, gt_masks, draws=None):
        """Mask R-CNN's ``loss_mask`` plus the point loss (``:369-393``)."""
        _, mask_pred, tgts, p = self._mask_branch(feats, boxes, matched_gt, matched, gt_masks)
        plabels, pvalid = labels[:, :p].reshape(-1), pos[:, :p].reshape(-1)
        lm = self.mask_head.loss(mask_pred, tgts, plabels, pvalid)
        return lm + self._point_loss(feats, self.proposals_to_rois(boxes[:, :p]), mask_pred,
                                     tgts, plabels, pvalid, draws)


@DETECTORS.register_module()
class PointRend(MaskRCNN):
    """``:412``: Mask R-CNN's test path (the coarse masks)."""


@HEADS.register_module()
class CoarseMaskHead(FCNMaskHead):
    """``:418``: the FCN mask head."""
