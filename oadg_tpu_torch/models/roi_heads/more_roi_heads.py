"""Six ``StandardRoIHead`` variants (port of
``oadg_tpu/models/roi_heads/more_roi_heads.py`` and
``standard_roi_head.py:341``) and their detectors.

``DynamicRoIHead`` (``more_roi_heads.py:34``): the assigner's three IoU
thresholds are the batch mean of each image's ``ktop_iou``-th best proposal
IoU (a proposal's IoU is its largest with a valid gt), clipped to [0.4,
0.6], computed in the step and handed to the assigner for this call
(``:47-55``). The JAX head adapts no SmoothL1 beta (``ktop_beta`` is taken
and unused), nor does the port.

``MaskScoringRoIHead`` (``:107``) with ``MaskIoUHead`` (``:77``): the mask
branch's loss adds ``0.5 * MSE`` of the predicted IoU at the slot's class
against the detached IoU of the binarised mask and its target
(``:118-150``). ``MaskIoUHead``: the class-wise maximum of the mask
logits' sigmoid, 2x2 max-pooled, concatenated after the mask RoI features,
four 3x3 convs (the last of stride 2) with ReLU, two FCs with ReLU, then
one IoU a class. Its test path returns boxes only, as the JAX detector's.

``PISARoIHead`` (``:248``): ISR-P reweights the positives' classification
by their rank in a global IoU order (``torch.argsort(..., stable=True)``,
as ``jnp.argsort``: the padded rows tie at -1), normalised to keep the
positives' weight mass; CARL adds ``loss_carl``, a SmoothL1 of the
positives' deltas at their class weighted by that class's probability
(``:284-318``). Under data parallel the rank runs over every rank's rows in
the one-process order (``losses.pisa.isr_p_weights``), and CARL's weight
mass and the positives' count are global.

``DoubleHeadRoIHead`` is ``StandardRoIHead`` with the box head
``DoubleConvFCBBoxHead`` (``bbox_heads.py``).

``GridRoIHead`` (``:179-244``) with ``GridHead`` (``:154-175``): the box
head's losses without ``loss_bbox``, plus ``loss_grid``. The grid branch
takes the box branch's own sample (the JAX head samples again with the same
key, which gives the same rows; the port does not draw again): the first
``round(num * pos_fraction)`` slots of each clean image, masked by ``is_pos
& valid``, through RoIAlign at 14x14 (B1 and B2 on the card) on the box
extractor's levels, into ``GridHead``: 8 x (3x3 conv, ``GroupNorm32`` of 36
groups, ReLU), then two 2x2 stride-2 transposed convs (576 channels with a
ReLU, then the 9 grid points) -> (R, 9, 56, 56) float32 heatmaps. Targets:
each grid point of the matched gt (its corners and mid-points), projected
into the sampled box, as a separable Gaussian of std ``56 / 14`` on the
56x56 map, thresholded at 0.5 (``:216-236``); the loss is the heatmaps'
binary cross-entropy, the mean over pixels and points, then over the valid
positives, times 15. The test path is ``StandardRoIHead.simple_test``: the
grid head never runs there and the boxes come from ``fc_reg``, which no
loss trains (ROADMAP C), as in the JAX package. mmdet keys:
``roi_head.grid_head.convs.{i}.conv`` (with a bias, which mmdet's
``ConvModule`` lacks), ``.convs.{i}.gn``, ``.deconv1``, ``.deconv2``
(mmdet's are 4x4 grouped deconvs with ``norm1``, ``forder_trans`` and
``sorder_trans`` beside: such a checkpoint is refused).

``TridentRoIHead`` (``:323``) is ``StandardRoIHead`` with ``num_branch``
and ``test_branch_idx``, which it does not read; the TridentNet detector is
refused (``models/builder.py``).

mmdet keys of ``MaskIoUHead``: ``roi_head.mask_iou_head.convs.{i}``,
``.fcs.{i}`` (the first FC's input flattened C, H, W), ``.fc_mask_iou``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.profiler import record_function

from ...core.bbox.geometry import bbox_overlaps
from ...parallel import shard_sum, shard_sum_grad
from ...utils.registry import DETECTORS, HEADS, ROI_EXTRACTORS, build_from_cfg
from ..detectors.two_stage import TwoStageDetector
from ..layers import Conv, ConvGN, Linear, normal_
from ..losses.pisa import isr_p_weights
from .mask_heads import ConvTranspose
from .standard_roi_head import StandardRoIHead


@HEADS.register_module()
class DynamicRoIHead(StandardRoIHead):

    def __init__(self, ktop_iou: int = 75, ktop_beta: int = 10, **kwargs):
        super().__init__(**kwargs)
        self.ktop_iou = ktop_iou

    def iou_threshold(self, proposals, prop_valid, gt_bboxes, gt_valid) -> torch.Tensor:
        """The step's IoU threshold, a 0-d float32 tensor in [0.4, 0.6]."""
        ious = bbox_overlaps(proposals, gt_bboxes)
        ious = torch.where(prop_valid[..., None] & gt_valid[:, None, :], ious,
                           torch.zeros_like(ious))
        best = ious.max(-1).values                                    # (N, P)
        k = min(self.ktop_iou, best.shape[1])
        kth = torch.topk(best, k, dim=-1).values[:, -1]
        count = shard_sum(torch.tensor(float(kth.shape[0]), device=kth.device))
        return (shard_sum(kth.sum()) / count).clamp(0.4, 0.6)

    def loss(self, feats, proposals, prop_valid, gt_bboxes, gt_valid, gt_labels,
             draws, random_proposals=None, random_valid=None, gt_masks=None):
        with torch.no_grad():
            thr = self.iou_threshold(proposals, prop_valid, gt_bboxes, gt_valid)
        return self._loss(feats, proposals, prop_valid, gt_bboxes, gt_valid, gt_labels,
                          draws, gt_masks, iou_thr=thr)[0]


@HEADS.register_module()
class DoubleHeadRoIHead(StandardRoIHead):
    """``standard_roi_head.py:341``."""


@HEADS.register_module()
class MaskIoUHead(nn.Module):

    def __init__(self, num_convs: int = 4, num_fcs: int = 2, in_channels: int = 256,
                 conv_out_channels: int = 256, fc_out_channels: int = 1024,
                 num_classes: int = 80, roi_feat_size: int = 14, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.num_classes = num_classes
        self.convs = nn.ModuleList(
            Conv(in_channels + 1 if i == 0 else conv_out_channels, conv_out_channels, 3,
                 2 if i == num_convs - 1 else 1, 1, **kw) for i in range(num_convs))
        side = (roi_feat_size - 1) // 2 + 1 if num_convs else roi_feat_size
        widths = [conv_out_channels * side * side] + [fc_out_channels] * num_fcs
        self.fcs = nn.ModuleList(Linear(a, b, **kw) for a, b in zip(widths[:-1], widths[1:]))
        self.fc_mask_iou = Linear(widths[-1], num_classes, **kw)

    def forward(self, mask_feat, mask_pred):
        """(R, C, r, r) mask RoI features and (R, K, 2r, 2r) mask logits ->
        (R, classes) float32 predicted IoUs."""
        mp = F.max_pool2d(torch.sigmoid(mask_pred).amax(1, keepdim=True), 2, 2)
        x = torch.cat([mask_feat, mp.to(mask_feat.dtype)], 1)
        for conv in self.convs:
            x = torch.relu(conv(x))
        x = x.flatten(1)
        for fc in self.fcs:
            x = torch.relu(fc(x))
        return self.fc_mask_iou(x).float()


@HEADS.register_module()
class MaskScoringRoIHead(StandardRoIHead):

    def __init__(self, mask_iou_head=None, device=None, dtype=None, **kwargs):
        super().__init__(device=device, dtype=dtype, **kwargs)
        self.mask_iou_head = MaskIoUHead(**{
            k: v for k, v in dict(mask_iou_head or {}).items() if k != "type"},
            roi_feat_size=self.mask_roi_extractor.output_size, device=device, dtype=dtype)

    def _mask_loss(self, feats, boxes, labels, pos, matched_gt, matched, gt_masks,
                   draws=None):
        """``loss_mask`` plus the mask IoU loss (``:118-150``)."""
        mfeats, mask_pred, tgts, p = self._mask_branch(feats, boxes, matched_gt, matched,
                                                       gt_masks)
        plabels, w = labels[:, :p].reshape(-1), pos[:, :p].reshape(-1).float()
        lm = self.mask_head.loss(mask_pred, tgts, plabels, pos[:, :p].reshape(-1))
        with torch.no_grad():
            binm = self.mask_head.get_masks(mask_pred, plabels) >= 0.5
            on = tgts >= 0.5
            iou_t = ((binm & on).sum((1, 2)).float()
                     / (binm | on).sum((1, 2)).float().clamp(min=1.0))
        iou_p = self.mask_iou_head(mfeats, mask_pred)
        lab = plabels.clamp(0, self.mask_iou_head.num_classes - 1)
        sel = torch.gather(iou_p, 1, lab[:, None].long())[:, 0]
        lmi = 0.5 * ((sel - iou_t) ** 2 * w).sum() / shard_sum(w.sum()).clamp(min=1.0)
        return lm + lmi


@HEADS.register_module()
class PISARoIHead(StandardRoIHead):

    def __init__(self, isr_k: float = 2.0, isr_bias: float = 0.0, carl_k: float = 1.0,
                 carl_lambda: float = 1.0, **kwargs):
        super().__init__(**kwargs)
        self.isr_k, self.isr_bias = float(isr_k), float(isr_bias)
        self.carl_k, self.carl_lambda = float(carl_k), float(carl_lambda)

    def loss(self, feats, proposals, prop_valid, gt_bboxes, gt_valid, gt_labels,
             draws, random_proposals=None, random_valid=None, gt_masks=None):
        """``loss_cls`` and ``loss_bbox`` with the ISR-P label weights, ``acc``
        and ``loss_carl``. The IoU rank spans the global batch: under data
        parallel every rank's rows are gathered in the one-process order
        (``losses.pisa.isr_p_weights``), and CARL's weight mass and ``npos``
        are global sums."""
        v = self.num_views
        b = feats[0].shape[0] // v
        with torch.no_grad():
            sampled = self._sample(proposals[:b], prop_valid[:b], gt_bboxes[:b],
                                   gt_valid[:b], gt_labels[:b], draws)
            boxes, labels, is_pos, valid, matched_gt, _ = (
                t.repeat(v, *[1] * (t.dim() - 1)) for t in sampled)
            tl, tw, td, tb = self.bbox_head.get_targets(boxes, labels, is_pos, valid,
                                                        matched_gt, self.pos_weight)
            tl, td = tl.reshape(-1), td.reshape(-1, 4)
            posm = (is_pos & valid).reshape(-1)
            ious = bbox_overlaps(boxes.reshape(-1, 4), matched_gt.reshape(-1, 4),
                                 is_aligned=True)
            w_isr, npos = isr_p_weights(ious, posm, self.isr_k, self.isr_bias, v)
            lw = tw.reshape(-1) * torch.where(posm, w_isr, torch.ones_like(w_isr))
        cls_score, bbox_pred, _ = self.bbox_forward(feats, self.proposals_to_rois(boxes))
        losses = self.bbox_head.loss(cls_score, bbox_pred, tl, lw, td, tb.reshape(-1, 4))
        nc = self.bbox_head.num_classes
        lab = tl.clamp(0, nc - 1)
        sg = torch.gather(torch.softmax(cls_score.float(), -1), 1, lab[:, None])[:, 0]
        cw = sg ** self.carl_k
        pm = posm.float()
        cw = cw / (shard_sum_grad((cw * pm).mean() * posm.shape[0]) / npos).clamp(min=1e-6)
        r = bbox_pred.shape[0]
        bp = bbox_pred.reshape(r, -1, 4)
        reg = torch.gather(bp, 1, lab.clamp(0, bp.shape[1] - 1)[:, None, None]
                           .expand(r, 1, 4))[:, 0].float()
        d = (reg - td).abs()
        sl1 = torch.where(d < 1.0, 0.5 * d * d, d - 0.5).sum(-1)
        losses["loss_carl"] = self.carl_lambda * (cw * sl1 * pm).sum() / npos
        return losses


@DETECTORS.register_module()
class DynamicRCNN(TwoStageDetector):
    """``more_roi_heads.py:367``."""


@DETECTORS.register_module()
class MaskScoringRCNN(TwoStageDetector):
    """``more_roi_heads.py:357``: serves boxes only, as the JAX detector."""


@HEADS.register_module()
class GridHead(nn.Module):
    """``more_roi_heads.py:154``: (R, C, r, r) RoI features -> (R, 9, 4 r,
    4 r) float32 grid-point heatmaps. ``point_feat_channels`` is taken and
    not read, as in the JAX head."""

    def __init__(self, grid_points: int = 9, num_convs: int = 8, in_channels: int = 256,
                 conv_out_channels: int = 576, point_feat_channels: int = 64,
                 num_groups: int = 36, device=None, dtype=None):
        super().__init__()
        self.convs = nn.ModuleList(
            ConvGN(in_channels if i == 0 else conv_out_channels, conv_out_channels,
                    num_groups, device=device, dtype=dtype) for i in range(num_convs))
        self.deconv1 = ConvTranspose(conv_out_channels, conv_out_channels, 2, 2,
                                     device=device, dtype=dtype)
        self.deconv2 = ConvTranspose(conv_out_channels, grid_points, 2, 2, device=device,
                                     dtype=dtype)

    def init_weights(self, gen: torch.Generator):
        """The transposed convs LeCun-normal at fan-in ``in x 2 x 2``, as
        flax draws them (the convs come from ``init_default_``)."""
        for m in (self.deconv1, self.deconv2):
            normal_(m.weight, 1.0 / math.sqrt(m.in_channels * 4), gen)
            nn.init.zeros_(m.bias)

    def forward(self, x):
        for conv in self.convs:
            x = conv(x)
        return self.deconv2(torch.relu(self.deconv1(x))).float()


def grid_targets(pboxes: torch.Tensor, gt_boxes: torch.Tensor, size: int) -> torch.Tensor:
    """(R, 4) sampled boxes and their (R, 4) matched gts -> (R, 9, size,
    size) float32 targets (``:216-236``): point (gj, gi) of the gt's 3x3
    grid, projected into the box's ``size`` x ``size`` map, as the product
    of two Gaussians of std ``size / 14``; the loss thresholds them at 0.5."""
    gx = torch.stack([gt_boxes[:, 0], (gt_boxes[:, 0] + gt_boxes[:, 2]) / 2, gt_boxes[:, 2]], -1)
    gy = torch.stack([gt_boxes[:, 1], (gt_boxes[:, 1] + gt_boxes[:, 3]) / 2, gt_boxes[:, 3]], -1)
    w = torch.clamp(pboxes[:, 2] - pboxes[:, 0], min=1.0)
    h = torch.clamp(pboxes[:, 3] - pboxes[:, 1], min=1.0)
    px = (gx - pboxes[:, 0:1]) / w[:, None] * size
    py = (gy - pboxes[:, 1:2]) / h[:, None] * size
    ys = torch.arange(size, dtype=torch.float32, device=pboxes.device)
    sd = size / 14.0 + 1e-6
    tgt = []
    for gj in range(3):
        ty = torch.exp(-0.5 * ((ys[None, :] - py[:, gj:gj + 1]) / sd) ** 2)
        for gi in range(3):
            tx = torch.exp(-0.5 * ((ys[None, :] - px[:, gi:gi + 1]) / sd) ** 2)
            tgt.append(ty[:, :, None] * tx[:, None, :])
    return torch.stack(tgt, 1)


@HEADS.register_module()
class GridRoIHead(StandardRoIHead):

    def __init__(self, grid_roi_extractor=None, grid_head=None, device=None, dtype=None,
                 **kwargs):
        """``grid_roi_extractor`` is taken and not read: the grid branch
        reads the box extractor's levels at 14x14, as the JAX head does."""
        super().__init__(device=device, dtype=dtype, **kwargs)
        self.grid_size = 14
        ext = self.bbox_roi_extractor
        self.grid_roi_extractor = build_from_cfg(
            dict(type="SingleRoIExtractor",
                 roi_layer=dict(output_size=self.grid_size, sampling_ratio=ext.sampling_ratio),
                 featmap_strides=ext.featmap_strides, finest_scale=ext.finest_scale),
            ROI_EXTRACTORS, dict(device=device))
        self.grid_head = GridHead(**{k: v for k, v in dict(grid_head or {}).items()
                                     if k != "type"}, device=device, dtype=dtype)

    def init_weights(self, gen: torch.Generator):
        super().init_weights(gen)
        self.grid_head.init_weights(gen)

    def _branch_losses(self, losses, feats, boxes, labels, is_pos, valid, matched_gt, matched,
                       gt_masks, draws):
        """``loss_grid`` on the first ``max_pos`` slots of the clean images
        (``:198-244``); ``loss_bbox`` removed."""
        b = boxes.shape[0] // self.num_views
        p = max(int(round(boxes.shape[1] * self.sampler.pos_fraction)), 1)
        pboxes = boxes[:b, :p]
        with record_function("forward_train: grid branch"):
            heat = self.grid_head(self.grid_roi_extractor(feats, self.proposals_to_rois(pboxes)))
            with torch.no_grad():
                tgt = (grid_targets(pboxes.reshape(-1, 4), matched_gt[:b, :p].reshape(-1, 4),
                                    heat.shape[-1]) > 0.5).float()
            per = (torch.clamp(heat, min=0) - heat * tgt
                   + torch.log1p(torch.exp(-heat.abs()))).mean(dim=(1, 2, 3))
            w = (is_pos & valid)[:b, :p].reshape(-1).float()
            losses.pop("loss_bbox", None)
            losses["loss_grid"] = (per * w).sum() / shard_sum(w.sum()).clamp(min=1.0) * 15.0


@HEADS.register_module()
class TridentRoIHead(StandardRoIHead):
    """``more_roi_heads.py:323``."""

    def __init__(self, num_branch: int = 3, test_branch_idx: int = 1, **kwargs):
        super().__init__(**kwargs)
        self.num_branch, self.test_branch_idx = num_branch, test_branch_idx


@DETECTORS.register_module()
class GridRCNN(TwoStageDetector):
    """``more_roi_heads.py:362``."""
