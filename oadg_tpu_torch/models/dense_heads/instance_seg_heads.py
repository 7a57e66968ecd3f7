"""SOLO and YOLACT: heads and detectors (port of
``oadg_tpu/models/dense_heads/instance_seg_heads.py``).

``paste_crop_masks`` (``:32-68``): (G, M0, M0) box-cropped gt masks drawn
into an (H, W) grid of pixel centres ``(i + 0.5) * stride``: each pixel
inside a gt box samples the crop bilinearly at its place in the box, the
rest are 0.

SOLO (``SOLOHead``, ``:71-258``): per FPN level ``li`` (P2..P6 as the
config's FPN gives them; the JAX head's stride table ``(8, 8, 16, 32,
32)`` is not the maps' 4..64, ROADMAP C) the category branch on the map
resized to ``num_grids[li]`` square (``jax.image.resize``'s bilinear:
antialiased where it shrinks), ``cls_convs`` (GN convs) and ``conv_cls``;
the mask branch on the map with two coordinate channels (``linspace(-1,
1)`` of y, then x, in the map's dtype), ``mask_convs``, a 2x nearest
upsample and ``conv_mask_list.{li}`` (``S^2`` channels). mmdet's module
names; every conv has a bias (the JAX ``Conv``'s).

- ``loss``: per level the cells within ``pos_scale`` of a gt's centre (in
  the level's scale range) go to the smallest such gt; the focal loss of
  the level over its positives, and the dice loss (x3) of every positive
  cell's mask against its gt's mask pasted at ``stride / 2`` over all
  levels' positives. Only the positive cells' masks are read: no second
  copy of a level's (S^2, H, W) logits is made.
- ``get_results``: the top ``nms_pre`` of every (cell, class) sigmoid
  (ties to the lower index), their cells' masks resized to level 0's mask
  size (only those cells'), the area filter (mask pixels > the level's
  stride), maskness rescoring and ``mask_matrix_nms`` -> (N, K, H, W) bool
  masks, labels and scores.

YOLACT (``YOLACTHead``, ``:261-443``): per level ``head_convs`` (one 3x3
conv and a ReLU, shared by the levels), ``conv_cls`` (``A * (C + 1)``),
``conv_reg`` and ``conv_coeff`` (tanh); the protonet on the first level
(``proto_convs``: three 3x3 convs with ReLU, a 2x nearest upsample,
``proto_out`` 1x1 and a ReLU) and ``segm_conv`` (built, never trained: the
JAX head has no semantic loss). The loss as the JAX head's: softmax CE over
every positive and negative anchor (no OHEM), SmoothL1 (x1.5) of the
positives, and the mask BCE cropped to the gt box over each image's 32
positives of largest IoU (ties to the lower index), averaged over the
images (the global batch's under data parallel), x6.125. ``get_bboxes``
through ``fast_nms`` -> dets, labels, valid and each detection's
coefficients.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...core.bbox.assign_sample import MaxIoUAssigner
from ...core.post_processing.matrix_nms import fast_nms, mask_matrix_nms
from ...core.post_processing.nms import sort_desc
from ...parallel import shard_sum
from ...utils.registry import (BBOX_CODERS, DETECTORS, HEADS, LOSSES, PRIOR_GENERATORS,
                               build_from_cfg, cfg_args)
from ..detectors.single_stage import SingleStageDetector
from ..layers import Conv, ConvGN, ConvModule, widen
from ..losses.common import binary_cross_entropy_with_logits
from ..roi_heads.htc_scnet_heads import _resize_bilinear
from ..utils.misc import images_mean
from .retina_head import _flatten, gather_rows


def paste_crop_masks(crops: torch.Tensor, boxes: torch.Tensor, out_hw, stride: float = 1.0):
    """(..., G, M0, M0) crops and (..., G, 4) boxes -> (..., G, H, W)."""
    m0 = crops.shape[-1]
    h, w = out_hw
    dev = boxes.device
    ys = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) * stride
    xs = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) * stride
    x1, y1, x2, y2 = (boxes[..., i, None, None] for i in range(4))
    bw = torch.clamp_min(x2 - x1, 1e-3)
    bh = torch.clamp_min(y2 - y1, 1e-3)
    u = (xs[None, :] - x1) / bw                                   # (..., G, 1, W)
    v = (ys[:, None] - y1) / bh                                   # (..., G, H, 1)
    inside = (u >= 0) & (u <= 1) & (v >= 0) & (v <= 1)
    cu = torch.clamp(u * (m0 - 1), 0, m0 - 1)
    cv = torch.clamp(v * (m0 - 1), 0, m0 - 1)
    u0 = torch.floor(cu).long()
    v0 = torch.floor(cv).long()
    u1 = torch.clamp_max(u0 + 1, m0 - 1)
    v1 = torch.clamp_max(v0 + 1, m0 - 1)
    fu = cu - u0
    fv = cv - v0
    flat = crops.float().flatten(-2)

    def at(vi, ui):
        idx = (vi * m0 + ui).expand(*inside.shape)
        return torch.gather(flat, -1, idx.flatten(-2)).view(inside.shape)

    val = (at(v0, u0) * (1 - fv) * (1 - fu) + at(v0, u1) * (1 - fv) * fu
           + at(v1, u0) * fv * (1 - fu) + at(v1, u1) * fv * fu)
    return torch.where(inside, val, torch.zeros_like(val))


def coord_channels(x: torch.Tensor) -> torch.Tensor:
    """``x`` with two more channels: ``linspace(-1, 1)`` of the rows, then
    of the columns, in ``x``'s dtype."""
    n, _, h, w = x.shape
    yy = torch.linspace(-1, 1, h, device=x.device)[:, None].expand(h, w)
    xx = torch.linspace(-1, 1, w, device=x.device)[None, :].expand(h, w)
    return torch.cat([x, torch.stack([yy, xx]).to(x.dtype)[None].expand(n, 2, h, w)], 1)


def up2(x):
    return x.repeat_interleave(2, 2).repeat_interleave(2, 3)


@HEADS.register_module()
class SOLOHead(nn.Module):

    def __init__(self, num_classes: int = 80, in_channels: int = 256, feat_channels: int = 256,
                 stacked_convs: int = 4, num_grids: Sequence[int] = (40, 36, 24, 16, 12),
                 scale_ranges=((1, 96), (48, 192), (96, 384), (192, 768), (384, 2048)),
                 pos_scale: float = 0.2, strides: Sequence[int] = (8, 8, 16, 32, 32),
                 mask_stride: int = 4, loss_mask=None, loss_cls=None, norm_cfg=None,
                 train_cfg=None, test_cfg=None, num_views: int = 1, device=None, dtype=None):
        super().__init__()
        self.num_classes = num_classes
        self.num_grids = tuple(num_grids)
        self.scale_ranges = tuple(tuple(r) for r in scale_ranges)
        self.pos_scale = pos_scale
        self.strides = tuple(strides)
        self.test_cfg = dict(test_cfg or {})
        self.loss_cls = build_from_cfg(dict(loss_cls or dict(
            type="FocalLoss", use_sigmoid=True, gamma=2.0, alpha=0.25)), LOSSES)
        kw = dict(device=device, dtype=dtype)
        self.cls_convs = nn.ModuleList(ConvGN(in_channels if i == 0 else feat_channels,
                                              feat_channels, **kw) for i in range(stacked_convs))
        self.mask_convs = nn.ModuleList(ConvGN(in_channels + 2 if i == 0 else feat_channels,
                                               feat_channels, **kw)
                                        for i in range(stacked_convs))
        self.conv_cls = Conv(feat_channels, num_classes, 3, 1, 1, **kw)
        self.conv_mask_list = nn.ModuleList(Conv(feat_channels, s * s, 1, **kw)
                                            for s in self.num_grids)

    def init_weights(self, gen: torch.Generator):
        """The model's default (``init_default_``), as the JAX head's: the
        class bias at 0 (mmdet's at the 0.01 prior)."""

    def forward(self, feats):
        """Per level: category logits (N, C, S, S) and mask logits (N, S^2,
        2h, 2w), float32."""
        cate_preds, mask_preds = [], []
        for li, x in enumerate(feats[:len(self.num_grids)]):
            s = self.num_grids[li]
            c = _resize_bilinear(x, (s, s))
            for conv in self.cls_convs:
                c = conv(c)
            cate_preds.append(widen(self.conv_cls(c)))
            m = coord_channels(x)
            for conv in self.mask_convs:
                m = conv(m)
            mask_preds.append(widen(self.conv_mask_list[li](up2(m))))
        return cate_preds, mask_preds

    def level_targets(self, li: int, mh: int, mw: int, gt, gt_valid, gt_labels):
        """Level ``li``'s cells: labels (N, S^2) (``C`` background), positives
        and each cell's gt (N, S^2)."""
        s = self.num_grids[li]
        lo, hi = self.scale_ranges[li]
        gw = gt[..., 2] - gt[..., 0]
        gh = gt[..., 3] - gt[..., 1]
        scale = torch.sqrt(torch.clamp_min(gw * gh, 1e-6))
        in_lvl = (scale >= lo) & (scale <= hi) & gt_valid
        cx = (gt[..., 0] + gt[..., 2]) * 0.5
        cy = (gt[..., 1] + gt[..., 3]) * 0.5
        iw = mw * (self.strides[li] / 2.0)
        ih = mh * (self.strides[li] / 2.0)

        def cell(c, extent):
            return torch.clamp((c / extent * s).to(torch.int32), 0, s - 1)

        gx0 = cell(cx - gw * self.pos_scale / 2, iw)
        gx1 = cell(cx + gw * self.pos_scale / 2, iw)
        gy0 = cell(cy - gh * self.pos_scale / 2, ih)
        gy1 = cell(cy + gh * self.pos_scale / 2, ih)
        ii = torch.arange(s, device=gt.device)
        inx = (ii >= gx0[..., None]) & (ii <= gx1[..., None])                  # (N, G, S)
        iny = (ii >= gy0[..., None]) & (ii <= gy1[..., None])
        cells = (iny[..., :, None] & inx[..., None, :] & in_lvl[..., None, None]).flatten(-2)
        am = torch.where(cells, (gw * gh)[..., None], torch.full_like(cells, 1e12,
                                                                      dtype=gw.dtype))
        gi = am.argmin(-2)                                                     # (N, S^2)
        pos = am.amin(-2) < 1e12
        labels = torch.where(pos, torch.gather(gt_labels.long(), 1, gi),
                             torch.full_like(gi, self.num_classes))
        return labels, pos, gi

    def loss(self, outs, gt_bboxes, gt_valid, gt_labels, draws=None, gt_masks=None):
        """``loss_cls`` (the levels' focal losses) and ``loss_mask`` (dice);
        ``draws`` is unused."""
        cate_preds, mask_preds = outs
        if gt_masks is None:
            gt_masks = gt_bboxes.new_zeros(*gt_bboxes.shape[:2], 28, 28)
        cls_losses, total_dice, total_pos = [], 0.0, 0.0
        for li, (cate, mp) in enumerate(zip(cate_preds, mask_preds)):
            mh, mw = mp.shape[-2:]
            with torch.no_grad():
                labels, pos, gi = self.level_targets(li, mh, mw, gt_bboxes, gt_valid, gt_labels)
                npos = shard_sum(pos.sum().float())
                b, cidx = torch.nonzero(pos, as_tuple=True)
                full = paste_crop_masks(gt_masks, gt_bboxes, (mh, mw), self.strides[li] / 2.0)
                tgt = full[b, gi[b, cidx]]                                    # (M, mh, mw)
            p = torch.sigmoid(mp[b, cidx])
            inter = (p * tgt).sum((1, 2))
            dice = 1 - 2 * inter / torch.clamp_min((p * p).sum((1, 2)) + (tgt * tgt).sum((1, 2)),
                                                   1e-6)
            total_dice = total_dice + dice.sum()
            total_pos = total_pos + npos
            cls_losses.append(self.loss_cls(cate.permute(0, 2, 3, 1).reshape(-1, self.num_classes),
                                            labels.reshape(-1),
                                            avg_factor=torch.clamp_min(npos, 1.0)))
        return dict(loss_cls=sum(cls_losses),
                    loss_mask=3.0 * total_dice / torch.clamp_min(total_pos, 1.0))

    def candidates(self, outs, cfg=None):
        """The top ``nms_pre`` (cell, class) candidates over N·C: their class
        scores (N, K), classes, cells and mask logits (N, K, H, W) at level
        0's mask size."""
        cate_preds, mask_preds = outs
        cfg = dict(cfg or self.test_cfg)
        nc = self.num_classes
        n = cate_preds[0].shape[0]
        mh, mw = mask_preds[0].shape[-2:]
        cate = torch.cat([torch.sigmoid(c).permute(0, 2, 3, 1).reshape(n, -1, nc)
                          for c in cate_preds], 1)
        counts = torch.tensor([s * s for s in self.num_grids], device=cate.device)
        starts = torch.cumsum(counts, 0) - counts
        top, ti = sort_desc(cate.reshape(n, -1), min(int(cfg.get("nms_pre", 500)),
                                                     cate.shape[1] * nc))
        ci, ni = ti % nc, ti // nc
        level = torch.bucketize(ni, starts[1:], right=True)
        logits = mask_preds[0].new_empty(n, ti.shape[1], mh, mw)
        for li, mp in enumerate(mask_preds):
            b, k = torch.nonzero(level == li, as_tuple=True)
            if b.numel() == 0:
                continue
            sel = mp[b, ni[b, k] - starts[li]]
            logits[b, k] = sel if li == 0 else _resize_bilinear(sel[None], (mh, mw))[0]
        return top, ci, ni, logits

    def get_results(self, outs, img_shapes=None, scale_factors=None, cfg=None):
        """-> masks (N, max_per_img, H, W) bool at level 0's mask size, labels
        (N, max_per_img) and scores (0 where invalid)."""
        cfg = dict(cfg or self.test_cfg)
        score_thr = float(cfg.get("score_thr", 0.1))
        mask_thr = float(cfg.get("mask_thr", 0.5))
        top, ci, ni, logits = self.candidates(outs, cfg)
        n, dev = top.shape[0], top.device
        counts = torch.tensor([s * s for s in self.num_grids], device=dev)
        stride_of = torch.repeat_interleave(torch.tensor(self.strides, dtype=torch.float32,
                                                         device=dev), counts)
        outs = []
        for i in range(n):
            mp = torch.sigmoid(logits[i])
            bm = mp > mask_thr
            sums = bm.sum((1, 2)).float()
            valid = (top[i] > score_thr) & (sums > stride_of[ni[i]])
            maskness = (mp * bm).sum((1, 2)) / torch.clamp_min(sums, 1.0)
            sc, labels, bms, _, valid = mask_matrix_nms(
                bm, ci[i], top[i] * maskness, valid=valid,
                filter_thr=float(cfg.get("filter_thr", 0.05)),
                max_num=int(cfg.get("max_per_img", 100)), kernel=str(cfg.get("kernel", "gaussian")),
                sigma=float(cfg.get("sigma", 2.0)), mask_area=sums)
            outs.append((bms, labels, torch.where(valid, sc, torch.zeros_like(sc))))
        return tuple(torch.stack(t) for t in zip(*outs))


@HEADS.register_module()
class YOLACTHead(nn.Module):

    def __init__(self, num_classes: int = 80, in_channels: int = 256, feat_channels: int = 256,
                 stacked_convs: int = 1, num_protos: int = 32, anchor_generator=None,
                 bbox_coder=None, loss_cls=None, loss_bbox=None, train_cfg=None, test_cfg=None,
                 num_views: int = 1, device=None, dtype=None):
        super().__init__()
        self.num_classes = num_classes
        self.num_protos = num_protos
        self.prior_generator = build_from_cfg(dict(anchor_generator or dict(
            type="AnchorGenerator", octave_base_scale=3, scales_per_octave=1,
            ratios=[0.5, 1.0, 2.0], strides=[8, 16, 32, 64, 128])), PRIOR_GENERATORS)
        self.bbox_coder = build_from_cfg(dict(bbox_coder or dict(
            type="DeltaXYWHBBoxCoder", target_means=(0., 0., 0., 0.),
            target_stds=(0.1, 0.1, 0.2, 0.2))), BBOX_CODERS)
        self.loss_cls = build_from_cfg(dict(loss_cls or dict(type="CrossEntropyLoss")), LOSSES)
        self.loss_bbox = build_from_cfg(dict(loss_bbox or dict(
            type="SmoothL1Loss", beta=1.0, loss_weight=1.5)), LOSSES)
        self.assigner = MaxIoUAssigner(**cfg_args(dict(train_cfg or {}).get("assigner"), dict(
            pos_iou_thr=0.5, neg_iou_thr=0.4, min_pos_iou=0.0), "MaxIoUAssigner"))
        self.test_cfg = dict(test_cfg or {})
        na = self.prior_generator.num_base_anchors[0]
        kw = dict(device=device, dtype=dtype)
        self.head_convs = nn.ModuleList(ConvModule(in_channels if i == 0 else feat_channels,
                                                   feat_channels, 3, 1, 1, act="relu", **kw)
                                        for i in range(stacked_convs))
        self.conv_cls = Conv(feat_channels, na * (num_classes + 1), 3, 1, 1, **kw)
        self.conv_reg = Conv(feat_channels, na * 4, 3, 1, 1, **kw)
        self.conv_coeff = Conv(feat_channels, na * num_protos, 3, 1, 1, **kw)
        self.proto_convs = nn.ModuleList(Conv(in_channels if i == 0 else feat_channels,
                                              feat_channels, 3, 1, 1, **kw) for i in range(3))
        self.proto_out = Conv(feat_channels, num_protos, 1, **kw)
        self.segm_conv = Conv(in_channels, num_classes, 1, **kw)

    def init_weights(self, gen: torch.Generator):
        """The model's default (``init_default_``), as the JAX head's."""

    def forward(self, feats):
        """-> per level class logits (N, A * (C + 1), H, W), deltas (N, A *
        4, H, W) and tanh coefficients (N, A * P, H, W); the prototypes (N,
        P, 2h, 2w) of the first level and its ``segm_conv`` logits, all
        float32."""
        cls_scores, bbox_preds, coeffs = [], [], []
        for x in feats:
            h = x
            for conv in self.head_convs:
                h = conv(h)
            cls_scores.append(widen(self.conv_cls(h)))
            bbox_preds.append(widen(self.conv_reg(h)))
            coeffs.append(torch.tanh(widen(self.conv_coeff(h))))
        p = feats[0]
        for conv in self.proto_convs:
            p = F.relu(conv(p))
        protos = F.relu(widen(self.proto_out(up2(p))))
        return cls_scores, bbox_preds, coeffs, protos, widen(self.segm_conv(feats[0]))

    def _flat(self, outs):
        cls_scores, bbox_preds, coeffs = outs[:3]
        anchors = self.prior_generator.grid_priors_cat(
            [tuple(s.shape[-2:]) for s in cls_scores], cls_scores[0].device)
        return (anchors, _flatten(cls_scores, self.num_classes + 1), _flatten(bbox_preds, 4),
                _flatten(coeffs, self.num_protos))

    @staticmethod
    def mask_positives(pos: torch.Tensor, max_overlaps: torch.Tensor):
        """(N, K) positives and their largest IoUs -> the 32 anchors of the
        mask loss per image, by IoU (ties to the lower index): their IoUs
        (-1 past the positives) and indices."""
        return sort_desc(torch.where(pos, max_overlaps, torch.full_like(max_overlaps, -1.0)), 32)

    def loss(self, outs, gt_bboxes, gt_valid, gt_labels, draws=None, gt_masks=None):
        """``loss_cls``, ``loss_bbox`` and ``loss_mask``; ``draws`` is unused."""
        anchors, cls, reg, cof = self._flat(outs)
        protos = outs[3]
        n, k = reg.shape[:2]
        nc = self.num_classes
        ph, pw = protos.shape[-2:]
        if gt_masks is None:
            gt_masks = gt_bboxes.new_zeros(*gt_bboxes.shape[:2], 28, 28)
        with torch.no_grad():
            a = self.assigner.assign(anchors, gt_bboxes, gt_valid, gt_labels=gt_labels)
            pos = a.gt_inds > 0
            neg = a.gt_inds == 0
            gi = (a.gt_inds - 1).clamp(0, gt_bboxes.shape[1] - 1)
            labels = torch.where(pos, torch.gather(gt_labels.long(), 1, gi),
                                 torch.full_like(gi, nc))
            deltas = self.bbox_coder.encode(anchors.expand(n, k, 4), torch.gather(
                gt_bboxes, 1, gi[..., None].expand(n, k, 4)))
            top, ti = self.mask_positives(pos, a.max_overlaps)
            mvalid = (top > 0).float()
            mgi = torch.gather(gi, 1, ti)                                     # (N, 32)
            full = paste_crop_masks(gt_masks, gt_bboxes, (ph, pw), 4.0)
            tgt = gather_rows(full, mgi)                                      # (N, 32, ph, pw)
            box = torch.gather(gt_bboxes, 1, mgi[..., None].expand(n, 32, 4)) / 4.0
            ys = torch.arange(ph, dtype=torch.float32, device=box.device)[:, None]
            xs = torch.arange(pw, dtype=torch.float32, device=box.device)[None, :]
            x1, y1, x2, y2 = (box[..., i, None, None] for i in range(4))
            inb = ((xs >= x1) & (xs <= x2) & (ys >= y1) & (ys <= y2)).float()
            area = torch.clamp_min(inb.sum((2, 3)), 1.0)
            num_pos = torch.clamp_min(shard_sum(pos.sum()).float(), 1.0)
        mlogit = torch.einsum("nphw,nkp->nkhw", protos, gather_rows(cof, ti))
        ce = binary_cross_entropy_with_logits(mlogit, tgt)
        lm = ((ce * inb).sum((2, 3)) / area * mvalid).sum(1) / torch.clamp_min(mvalid.sum(1), 1.0)
        return dict(
            loss_cls=self.loss_cls(cls.reshape(-1, nc + 1), labels.reshape(-1),
                                   (pos | neg).float().reshape(-1), avg_factor=num_pos),
            loss_bbox=self.loss_bbox(reg, deltas, pos.float()[..., None].expand(n, k, 4),
                                     avg_factor=num_pos),
            loss_mask=6.125 * images_mean(lm))

    def get_bboxes(self, outs, img_shapes, scale_factors, rescale: bool = True, cfg=None):
        """-> dets (N, max_per_img, 5), labels, valid, coefficients (N,
        max_per_img, P)."""
        cfg = dict(cfg or self.test_cfg)
        iou_thr = float(cfg.get("iou_thr", dict(cfg.get("nms", {})).get("iou_threshold", 0.5)))
        anchors, cls, reg, cof = self._flat(outs)
        sc = torch.softmax(cls, -1)
        ti = sort_desc(sc[..., :self.num_classes].amax(-1),
                       min(int(cfg.get("nms_pre", 1000)), sc.shape[1]))[1]
        boxes = self.bbox_coder.decode(anchors[ti], gather_rows(reg, ti),
                                       max_shape=(img_shapes[:, 0:1], img_shapes[:, 1:2]))
        if rescale:
            boxes = boxes / scale_factors.float()[:, None, :4]
        outs = [fast_nms(boxes[i], gather_rows(sc, ti)[i], gather_rows(cof, ti)[i],
                         float(cfg.get("score_thr", 0.05)), iou_thr, int(cfg.get("top_k", 200)),
                         int(cfg.get("max_per_img", 100))) for i in range(boxes.shape[0])]
        dets, labels, coeffs, valid = (torch.stack(t) for t in zip(*outs))
        return dets, labels, valid, coeffs


class _InstanceSegDetector(SingleStageDetector):
    """A single-stage detector whose head's loss takes the batch's
    ``gt_masks`` (``oadg_tpu/models/dense_heads/instance_seg_heads.py:446-480``)."""

    #: the test call's outputs, named when the box test path refuses them
    instance_outputs = ""

    def forward_train(self, batch, draws):
        from torch.profiler import record_function
        with record_function("forward_train: backbone+neck"):
            feats = self.extract_feat(batch["img"])
        with record_function("forward_train: head"):
            outs = self.bbox_head(feats)
        with record_function("forward_train: loss"):
            return self.bbox_head.loss(outs, batch["gt_bboxes"], batch["gt_valid"],
                                       batch["gt_labels"], draws, gt_masks=batch.get("gt_masks"))


@DETECTORS.register_module()
class SOLO(_InstanceSegDetector):
    instance_outputs = "(masks (N, K, H, W), labels, scores)"

    def simple_test(self, batch, rescale: bool = True):
        """-> masks (N, max_per_img, H, W) bool, labels, scores."""
        return self.bbox_head.get_results(self.bbox_head(self.extract_feat(batch["img"])),
                                          batch["img_shape"], batch.get("scale_factor"))


@DETECTORS.register_module()
class YOLACT(_InstanceSegDetector):
    instance_outputs = "(dets, labels, valid, coefficients)"
