"""TOOD head and detector (port of ``oadg_tpu/models/dense_heads/tood_head.py:36-259``).

Per level a shared stack of ``stacked_convs`` GN convs (``inter_convs.i``),
their outputs concatenated (``stacked``) and averaged over the map, then:

- ``TaskDecomposition`` (``:36-57``) for each task (``cls_decomp``,
  ``reg_decomp``): a layer attention (``layer_attention.0`` 1x1 to C / 4,
  ReLU, ``layer_attention.2`` 1x1 to ``stacked_convs``, sigmoid) scales
  each conv's C channels of ``stacked``, then ``reduction_conv`` (a 1x1 GN
  conv to C);
- classification: ``sqrt(sigmoid(tood_cls) * sigmoid(cls_prob_module))``
  (a probability, clipped to [1e-12, 1] inside the root);
- regression: ``relu(scales.i * tood_reg) * stride`` distances about the
  level's points, decoded to boxes, and each box side resampled at its own
  learned offset (``reg_offset_module``: (dy, dx) a side, in cells) by
  ``ops.misc_ops.bilinear_gather`` (zero outside the map; ``_align_boxes``,
  ``:110-122``).

Every conv LeCun-normal with a zero bias (ROADMAP C). mmdet's layer
attention narrows to ``C * stacked_convs / (8 * stacked_convs)``, the JAX
one to C / 4 (``utils/checkpoint.py`` raises on the shape).

- ``loss`` (``:158-219``): the task-aligned targets inlined, as the JAX head
  computes them: alignment ``t = score[gt] ** alpha * IoU ** beta``
  plus ``1e-9 / (1 + L1 distance to the gt centre)``, 0 outside the gt;
  per gt the points at or above its ``topk``-th alignment (a mask: tied
  alignments all count); a point of several gts takes the one of largest
  alignment; the target ``t / max_t(gt) * max_IoU(gt)``. QFL on the
  probabilities' logits against it over its sum, GIoU weighted by it
  (floored at 0.05 on the positives) over its sum. The targets keep their
  gradient, as in the JAX head, and so do both sums: under data parallel
  they are all-reduced with their gradient (``shard_sum_grad``), as every
  rank's loss share reads every rank's targets.
- ``get_bboxes`` (``:221-254``): top ``nms_pre`` points a level by their
  largest class probability, boxes clipped to the image, ``multiclass_nms``
  (IoU 0.6 unless given).
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ...core.bbox.geometry import bbox_overlaps
from ...core.bbox.transforms import distance2bbox
from ...ops.misc_ops import bilinear_gather
from ...parallel import shard_sum_grad
from ...utils.registry import DETECTORS, HEADS, LOSSES, build_from_cfg
from ..detectors.single_stage import SingleStageDetector
from ..layers import Conv, ConvGN, Scale
from .fcos_head import gn_tower, level_points
from .retina_head import _flatten, gather_rows, nms_detections, top_candidates


def _max(x: torch.Tensor, floor: float) -> torch.Tensor:
    return torch.maximum(x, x.new_full((), floor))


class TaskDecomposition(nn.Module):
    """Layer attention over the ``stacked_convs`` convs' outputs, then a 1x1
    GN conv back to ``feat_channels`` (float32 out)."""

    def __init__(self, feat_channels: int, stacked_convs: int, device=None, dtype=None):
        super().__init__()
        c, n = feat_channels, stacked_convs
        conv = dict(device=device, dtype=dtype)
        self.stacked_convs = n
        self.layer_attention = nn.Sequential(Conv(n * c, c // 4, 1, **conv), nn.ReLU(),
                                             Conv(c // 4, n, 1, **conv), nn.Sigmoid())
        self.reduction_conv = ConvGN(n * c, c, kernel_size=1, padding=0, **conv)

    def forward(self, stacked, avg):
        b, nc, h, w = stacked.shape
        la = self.layer_attention(avg)                                       # (B, n, 1, 1)
        s = stacked.view(b, self.stacked_convs, -1, h, w) * la[:, :, None]
        return self.reduction_conv(s.view(b, nc, h, w))


@HEADS.register_module()
class TOODHead(nn.Module):

    def __init__(self, num_classes: int = 80, in_channels: int = 256,
                 feat_channels: int = 256, stacked_convs: int = 6,
                 strides: Sequence[int] = (8, 16, 32, 64, 128), anchor_type: str = "anchor_free",
                 alignment_topk: int = 13, alignment_alpha: float = 1.0,
                 alignment_beta: float = 6.0, loss_cls=None, loss_bbox=None, train_cfg=None,
                 test_cfg=None, num_views: int = 1, device=None, dtype=None):
        super().__init__()
        self.num_classes = num_classes
        self.strides = tuple(strides)
        self.alpha, self.beta = alignment_alpha, alignment_beta
        self.train_cfg = dict(train_cfg or {})
        self.test_cfg = dict(test_cfg or {})
        assigner = dict(self.train_cfg.get("assigner") or {})
        if assigner.get("type", "TaskAlignedAssigner") != "TaskAlignedAssigner":
            raise ValueError(f"{assigner['type']} is not ported: the TOOD head takes "
                             "TaskAlignedAssigner (the port builds only the ported slices' types)")
        self.topk = int(assigner.get("topk", alignment_topk))
        self.l_cls = build_from_cfg(dict(loss_cls or dict(
            type="QualityFocalLoss", use_sigmoid=True, beta=2.0, loss_weight=1.0)), LOSSES)
        self.l_bbox = build_from_cfg(dict(loss_bbox or dict(type="GIoULoss", loss_weight=2.0)),
                                     LOSSES)
        conv = dict(device=device, dtype=dtype)
        c, n = feat_channels, stacked_convs
        self.inter_convs = gn_tower(in_channels, c, n, **conv)
        self.cls_decomp = TaskDecomposition(c, n, **conv)
        self.reg_decomp = TaskDecomposition(c, n, **conv)
        self.tood_cls = Conv(c, num_classes, 3, 1, 1, **conv)
        self.tood_reg = Conv(c, 4, 3, 1, 1, **conv)
        self.cls_prob_module = nn.Sequential(Conv(n * c, c // 4, 1, **conv), nn.ReLU(),
                                             Conv(c // 4, 1, 3, 1, 1, **conv))
        self.reg_offset_module = nn.Sequential(Conv(n * c, c // 4, 1, **conv), nn.ReLU(),
                                               Conv(c // 4, 8, 3, 1, 1, **conv))
        self.scales = nn.ModuleList(Scale(1.0, device=device) for _ in self.strides)

    def init_weights(self, gen: torch.Generator):
        """The model's default (``init_default_``), as the JAX head's."""

    @staticmethod
    def _align_boxes(boxes: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
        """(N, H, W, 4) boxes, (N, 8, H, W) offsets -> (N, H, W, 4): side c
        sampled at (row + dy_c, column + dx_c) of its own map."""
        _, h, w, _ = boxes.shape
        ys = torch.arange(h, dtype=torch.float32, device=boxes.device)[None, :, None]
        xs = torch.arange(w, dtype=torch.float32, device=boxes.device)[None, None, :]
        return torch.stack([bilinear_gather(boxes[..., c:c + 1].contiguous(),
                                            ys + offsets[:, 2 * c], xs + offsets[:, 2 * c + 1])
                            [..., 0] for c in range(4)], -1)

    def forward(self, feats):
        """Per level: class probabilities (N, C, H, W) and aligned float32
        boxes (N, 4, H, W) in pixels."""
        cls_scores, bbox_preds = [], []
        for li, x in enumerate(feats):
            inter, h = [], x
            for conv in self.inter_convs:
                h = conv(h)
                inter.append(h)
            stacked = torch.cat(inter, 1)
            avg = stacked.mean(dim=(2, 3), keepdim=True)
            cf = self.cls_decomp(stacked, avg)
            rf = self.reg_decomp(stacked, avg)
            prob = (torch.sigmoid(self.tood_cls(cf).float())
                    * torch.sigmoid(self.cls_prob_module(stacked).float()))
            score = torch.sqrt(torch.minimum(_max(prob, 1e-12), prob.new_ones(())))
            s = float(self.strides[li])
            reg = torch.relu(self.scales[li](self.tood_reg(rf))) * s
            n, _, hh, ww = reg.shape
            pts, _ = level_points([(hh, ww)], [s], x.device)
            boxes = distance2bbox(pts, _flatten([reg], 4)).view(n, hh, ww, 4)
            aligned = self._align_boxes(boxes, self.reg_offset_module(stacked).float())
            cls_scores.append(score)
            bbox_preds.append(aligned.permute(0, 3, 1, 2))
        return cls_scores, bbox_preds

    def loss(self, outs, gt_bboxes, gt_valid, gt_labels, draws=None):
        """``loss_cls`` (QFL) and ``loss_bbox`` (GIoU) of N images; ``draws``
        is unused."""
        cls_scores, bbox_preds = outs
        sizes = [tuple(s.shape[-2:]) for s in cls_scores]
        points, _ = level_points(sizes, self.strides, cls_scores[0].device)
        cls = _flatten(cls_scores, self.num_classes)                          # probabilities
        boxes = _flatten(bbox_preds, 4)
        valid = gt_valid[:, None, :]
        u = torch.where(valid, bbox_overlaps(boxes, gt_bboxes), boxes.new_zeros(()))  # (N, P, G)
        cls_of_gt = gt_labels.long().clamp(0, self.num_classes - 1)          # padded gts: any
        sg = torch.gather(cls, 2, cls_of_gt[:, None, :].expand(-1, cls.shape[1], -1))
        t = sg ** self.alpha * u ** self.beta
        px, py = points[:, 0, None], points[:, 1, None]
        gt = gt_bboxes[:, None]
        inside = ((px >= gt[..., 0]) & (px <= gt[..., 2]) & (py >= gt[..., 1])
                  & (py <= gt[..., 3]))
        # the JAX head's bootstrap: a vanishing centre-distance term keeps the
        # nearest inside points selected while every IoU is still 0
        dist = ((px - (gt[..., 0] + gt[..., 2]) * 0.5).abs()
                + (py - (gt[..., 1] + gt[..., 3]) * 0.5).abs())
        t = torch.where(inside & valid, t + 1e-9 / (1.0 + dist), t.new_zeros(()))
        with torch.no_grad():
            k = min(self.topk, t.shape[1])
            kth = torch.topk(t, k, dim=1).values.amin(1, keepdim=True)          # (N, 1, G)
            cand = (t >= _max(kth, 1e-12)) & (t > 0)
            sel = torch.where(cand, t, t.new_full((), -1.0))
            gi = sel.argmax(-1)                                               # (N, P)
            pos = sel.amax(-1) > 0
            labels = torch.where(pos, torch.gather(gt_labels.long(), 1, gi),
                                 torch.full_like(gi, self.num_classes))
        zero = t.new_zeros(())
        tmax = torch.where(cand, t, zero).amax(1)                             # (N, G)
        umax = torch.where(cand, u, zero).amax(1)
        tsel = torch.gather(t, 2, gi[..., None])[..., 0]
        norm_t = (tsel / _max(torch.gather(tmax, 1, gi), 1e-12)
                  * torch.gather(umax, 1, gi)) * pos.float()
        num_pos = _max(shard_sum_grad(norm_t.sum()), 1.0)
        logits = torch.log(torch.minimum(_max(cls, 1e-12), cls.new_ones(()))
                           / torch.minimum(_max(1 - cls, 1e-12), cls.new_ones(())))
        loss_cls = self.l_cls(logits.reshape(-1, self.num_classes),
                              (labels.reshape(-1), norm_t.reshape(-1)), avg_factor=num_pos)
        # the regression weight floored on the positives, so that they train
        # before any IoU exists (the JAX head's stand-in for ATSS warm-up epochs)
        wb = torch.maximum(norm_t, 0.05 * pos.float())
        loss_bbox = self.l_bbox(boxes.reshape(-1, 4), gather_rows(gt_bboxes, gi).reshape(-1, 4),
                                weight=wb.reshape(-1),
                                avg_factor=_max(shard_sum_grad(wb.sum()), 1.0))
        return dict(loss_cls=loss_cls, loss_bbox=loss_bbox)

    def get_bboxes(self, outs, img_shapes, scale_factors, rescale: bool = True, cfg=None):
        """Detections of N images: dets (N, max_per_img, 5), labels, valid."""
        cls_scores, bbox_preds = outs
        cfg = dict(cfg or self.test_cfg)
        nms_pre = int(cfg.get("nms_pre", 1000))
        h, w = img_shapes[:, 0:1].float(), img_shapes[:, 1:2].float()
        hi = torch.stack([w, h, w, h], -1)                                   # (N, 1, 4)
        levels = [(_flatten([c], self.num_classes), _flatten([b], 4), None)
                  for c, b in zip(cls_scores, bbox_preds)]
        boxes, scores = top_candidates(levels, nms_pre, lambda li, ti, bx: torch.minimum(
            torch.maximum(bx, bx.new_zeros(())), hi))
        return nms_detections(boxes, scores, scale_factors, rescale, cfg, self.num_classes, 0.6)


@DETECTORS.register_module()
class TOOD(SingleStageDetector):
    """``tood_head.py:257``."""
