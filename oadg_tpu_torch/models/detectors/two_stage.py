"""Two-stage detector (port of ``oadg_tpu/models/detectors/two_stage.py:55``):
backbone and neck (``extract_feat``), the OA-DG training forward
(``forward_train``, ``:161-196``) and the test path (``simple_test``, ``:198``);
``MaskRCNN`` (``:319-342``) adds the mask branch's outputs to the test path.
A ``CascadeRoIHead`` config with a ``mask_head`` (Cascade Mask R-CNN) builds
the HTC head without its semantic branch and mask info flow (``:86-95``).

Batches follow ``oadg_tpu/engine/train_step.py``: ``img`` (N, 3, H, W)
float32 normalized and padded (NCHW here, channels-last memory on the card),
``img_shape`` (N, 2) valid (h, w), ``scale_factor`` (N, 4) for testing;
training adds ``gt_bboxes`` (N, G, 4), ``gt_labels`` (N, G) and ``gt_valid``
(N, G) bool (and for Mask R-CNN ``gt_masks`` (N, G, M0, M0), each gt's mask
cropped to its box), the images views-major ``[B clean; B view 2; ...]`` with each
view's gts equal to the clean ones. Every shape is static: padding is
masked, never indexed away.

``dtype`` is the compute dtype of the backbone, neck and heads
(``:65-101``; None is float32), recorded as ``self.dtype``; parameters stay
float32, and the random proposals are float32 in either dtype.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn
from torch.profiler import record_function

from ...core.bbox.geometry import bbox_overlaps
from ...core.bbox.transforms import flip_boxes
from ...core.post_processing.nms import nms_padded, sort_desc
from ...utils.registry import BACKBONES, DETECTORS, HEADS, NECKS, build_from_cfg
from ..layers import init_default_


def random_boxes_uniform(img_shapes: torch.Tensor, num: int,
                         scales: Sequence[float], ratios: Sequence[float],
                         u: torch.Tensor):
    """``num`` random boxes per image (``two_stage.py:31-51``): corner
    uniform in the image, area ``U(scales) * H * W``, aspect ``U(ratios)``;
    boxes that would leave the image are marked invalid, not drawn again.

    Args:
        img_shapes: (N, 2) valid (h, w).
        u: (N, 4, num) uniform [0, 1) draws for x1, y1, scale and ratio;
            the last two are scaled to their ranges as ``jax.random.uniform``
            scales (``u * (hi - lo) + lo``, floored at ``lo``).

    Returns boxes (N, num, 4), valid (N, num).
    """
    h, w = img_shapes[:, 0:1], img_shapes[:, 1:2]

    def in_range(x, bounds):
        lo = torch.tensor(np.float32(min(bounds)), device=x.device)
        hi = torch.tensor(np.float32(max(bounds)), device=x.device)
        return torch.maximum(lo, x * (hi - lo) + lo)

    x1 = u[:, 0] * w
    y1 = u[:, 1] * h
    scale = in_range(u[:, 2], scales) * h * w
    ratio = in_range(u[:, 3], ratios)
    x2 = x1 + torch.sqrt(scale / ratio)
    y2 = y1 + torch.sqrt(scale * ratio)
    valid = (x2 <= w) & (y2 <= h)
    boxes = torch.stack([x1, y1, torch.minimum(x2, w), torch.minimum(y2, h)], -1)
    return boxes, valid


def _max_iou_with_gt(boxes, gt, gt_valid):
    """(N, Q, 4) boxes -> (N, Q) largest IoU with a valid gt (0 if none)."""
    ious = bbox_overlaps(boxes, gt)
    return torch.where(gt_valid[:, None, :], ious, torch.zeros_like(ious)).max(-1).values


@DETECTORS.register_module()
class TwoStageDetector(nn.Module):

    def __init__(self, backbone, neck=None, rpn_head=None, roi_head=None,
                 train_cfg=None, test_cfg=None, init_cfg=None, pretrained=None,
                 num_views: int = 1, device=None, dtype=None):
        super().__init__()
        dev = dict(device=device, dtype=dtype)
        self.dtype = torch.float32 if dtype is None else dtype
        self.train_cfg = dict(train_cfg or {})
        self.test_cfg = dict(test_cfg or {})
        self.num_views = num_views
        self.backbone = build_from_cfg(dict(backbone), BACKBONES, dev)
        self.neck = build_from_cfg(dict(neck), NECKS, dev) if neck else None
        self.rpn_head = build_from_cfg(
            dict(rpn_head, train_cfg=self.train_cfg.get("rpn"),
                 test_cfg=self.test_cfg.get("rpn")), HEADS, dev)
        roi_head = dict(roi_head)
        if roi_head.get("type") == "CascadeRoIHead" and roi_head.get("mask_head"):
            # Cascade Mask R-CNN is HTC without the semantic branch and the
            # mask info flow (:86-95)
            roi_head["type"] = "HybridTaskCascadeRoIHead"
            roi_head.setdefault("mask_info_flow", False)
            roi_head.setdefault("semantic_fusion", ())
        self.roi_head = build_from_cfg(
            dict(roi_head, train_cfg=self.train_cfg.get("rcnn"),
                 test_cfg=self.test_cfg.get("rcnn"), num_views=num_views),
            HEADS, dev)
        self.random_proposal_cfg = self.train_cfg.get("random_proposal_cfg")

    def init_weights(self, gen: torch.Generator):
        """Seeded random weights: LeCun-normal convs and FCs (the JAX
        package's default), then each head's own init; frozen BN identity."""
        init_default_(self, gen)
        self.rpn_head.init_weights(gen)
        self.roi_head.init_weights(gen)

    def extract_feat(self, img):
        x = self.backbone(img)
        return self.neck(x) if self.neck is not None else x

    # ---------------- training ----------------

    def _random_proposals(self, batch, draws):
        """OA-Loss random proposals (``two_stage.py:112-149``): the batch's
        OA-Mix ``multilevel_boxes`` (kept below ``iou_max`` with every gt)
        and ``oamix_boxes`` where it has them, then ``oagrb`` random boxes
        (kept below ``iou_max``). Returns (N, Q, 4), (N, Q) or None."""
        cfg = dict(self.random_proposal_cfg)
        iou_max = float(cfg.get("iou_max", 0.7))
        gt, gtv = batch["gt_bboxes"], batch["gt_valid"]
        n = gt.shape[0]
        parts, parts_valid = [], []
        if "multilevel_boxes" in batch:
            mb = batch["multilevel_boxes"]
            mv = batch.get("multilevel_valid",
                           torch.ones(mb.shape[:2], dtype=torch.bool, device=mb.device))
            parts.append(mb)
            parts_valid.append(mv & (_max_iou_with_gt(mb, gt, gtv) < iou_max))
        if "oamix_boxes" in batch:
            ob = batch["oamix_boxes"]
            parts.append(ob)
            parts_valid.append(batch.get(
                "oamix_valid", torch.ones(ob.shape[:2], dtype=torch.bool,
                                          device=ob.device)))
        if cfg.get("bbox_from", "oagrb").endswith("rb"):
            num = int(cfg.get("num_bboxes", 10))
            u = draws("random_boxes", (n, 4, num), gt.device)
            rb, rv = random_boxes_uniform(batch["img_shape"], num,
                                          tuple(cfg.get("scales", (0.01, 0.3))),
                                          tuple(cfg.get("ratios", (0.3, 1 / 0.3))), u)
            parts.append(rb)
            parts_valid.append(rv & (_max_iou_with_gt(rb, gt, gtv) < iou_max))
        if not parts:
            return None, None
        return torch.cat(parts, 1), torch.cat(parts_valid, 1)

    def forward_train(self, batch, draws, feats=None):
        """Loss dict of one views-major batch. ``draws``
        (``utils.draws.UniformDraws``) gives every random number: the RPN
        and RoI samplers' and the random proposals'. Each stage runs in a
        ``record_function`` span named ``forward_train: <stage>``. ``feats``,
        where given, are the batch's maps (``extract_feat``'s), computed by
        the caller."""
        img = batch["img"]
        if feats is None:
            with record_function("forward_train: backbone+neck"):
                feats = self.extract_feat(img)
        with record_function("forward_train: rpn head+loss"):
            cls_scores, bbox_preds = self.rpn_head(feats)
            losses = self.rpn_head.loss(cls_scores, bbox_preds, batch["gt_bboxes"],
                                        batch["gt_valid"], draws,
                                        img_shapes=batch.get("img_shape"))
        # proposals of the clean chunk only; the RoI head samples once and
        # tiles the sample over the views (contrastive_roi_head.py:84-97)
        b = img.shape[0] // self.num_views
        with record_function("forward_train: proposals"):
            boxes, _, valid = self.rpn_head.get_proposals(
                [s[:b] for s in cls_scores], [p[:b] for p in bbox_preds],
                batch["img_shape"][:b],
                self.train_cfg.get("rpn_proposal", self.test_cfg.get("rpn", {})))
            boxes = boxes.repeat(self.num_views, 1, 1)
            valid = valid.repeat(self.num_views, 1)
        with record_function("forward_train: roi head+loss"):
            random_proposals = random_valid = None
            if self.random_proposal_cfg is not None:
                random_proposals, random_valid = self._random_proposals(batch, draws)
            losses.update(self.roi_head.loss(
                feats, boxes, valid, batch["gt_bboxes"], batch["gt_valid"],
                batch["gt_labels"], draws, random_proposals=random_proposals,
                random_valid=random_valid, gt_masks=batch.get("gt_masks")))
        return losses

    # ---------------- inference ----------------

    def _simple_test(self, batch, rescale: bool):
        """-> the FPN maps, the scale factors (N, 4) and ``simple_test``'s
        dets, labels and valid."""
        img = batch["img"]
        feats = self.extract_feat(img)
        cls_scores, bbox_preds = self.rpn_head(feats)
        boxes, _, valid = self.rpn_head.get_proposals(cls_scores, bbox_preds,
                                                      batch["img_shape"])
        sf = batch.get("scale_factor")
        if sf is None:
            sf = torch.ones((img.shape[0], 4), device=img.device)
        return feats, sf, self.roi_head.simple_test(feats, boxes, valid, batch["img_shape"],
                                                    sf, rescale=rescale)

    def simple_test(self, batch, rescale: bool = True):
        """Returns dets (N, max_per_img, 5), labels, valid."""
        return self._simple_test(batch, rescale)[2]

    def aug_test(self, views, metas):
        """Test-time augmentation (mmdet ``two_stage.py:268``,
        ``merge_augs.py:13, 84``): each view's RPN proposals are flipped
        back and divided by its scale factor, merged by one NMS and cut to
        the rpn ``max_per_img``; the RoI head runs on the merged proposals
        mapped into each view (one RoIAlign a view), its decoded boxes are
        mapped back; boxes and softmax scores are averaged over the views
        and go through the rcnn NMS once.

        Args:
            views: per-view batches (``simple_test``'s keys), shapes may
                differ between views.
            metas: per-view ``(flip, flip_direction)``.

        Returns dets (N, max_per_img, 5), labels, valid. A cascade RoI head
        raises ``ValueError``: the JAX ``aug_test`` reads ``roi.head``, which
        the cascade lacks (``:275-278``).
        """
        from ..roi_heads.standard_roi_head import StandardRoIHead
        if not isinstance(self.roi_head, StandardRoIHead):
            raise ValueError(f"test-time augmentation of a {type(self.roi_head).__name__}: "
                             "the reference's aug_test serves one box head (roi.head), "
                             "which the cascade family lacks")
        rpn_cfg = dict(self.test_cfg.get("rpn", {}))
        feats_l, boxes_l, scores_l, valid_l = [], [], [], []
        for vd, (flip, fdir) in zip(views, metas):
            feats = self.extract_feat(vd["img"])
            feats_l.append(feats)
            boxes, scores, valid = self.rpn_head.get_proposals(
                *self.rpn_head(feats), vd["img_shape"])
            if flip:
                boxes = flip_boxes(boxes, vd["img_shape"], fdir)
            boxes_l.append(boxes / vd["scale_factor"][:, None, :4])
            scores_l.append(scores)
            valid_l.append(valid)
        boxes, scores = torch.cat(boxes_l, 1), torch.cat(scores_l, 1)
        keep = nms_padded(boxes, scores,
                          float(dict(rpn_cfg.get("nms", {})).get("iou_threshold", 0.7)),
                          torch.cat(valid_l, 1))
        top_s, top_i = sort_desc(
            torch.where(keep, scores, torch.full_like(scores, float("-inf"))),
            min(int(rpn_cfg.get("max_per_img", 1000)), scores.shape[1]))
        props = torch.gather(boxes, 1, top_i[..., None].expand(*top_i.shape, 4))
        prop_valid = torch.isfinite(top_s)
        n, p = props.shape[:2]
        bidx = torch.arange(n, dtype=props.dtype, device=props.device)
        bidx = bidx.view(n, 1, 1).expand(n, p, 1)

        agg_boxes = agg_scores = None
        for vd, feats, (flip, fdir) in zip(views, feats_l, metas):
            vb = props * vd["scale_factor"][:, None, :4]
            if flip:
                vb = flip_boxes(vb, vd["img_shape"], fdir)
            boxes, scores = self.roi_head.view_scores(
                feats, torch.cat([bidx, vb], -1), vd["img_shape"], vd["scale_factor"],
                rescale=False)
            boxes = boxes.reshape(n, -1, 4)
            if flip:
                boxes = flip_boxes(boxes, vd["img_shape"], fdir)
            boxes = boxes / vd["scale_factor"][:, None, :4]
            agg_boxes = boxes if agg_boxes is None else agg_boxes + boxes
            agg_scores = scores if agg_scores is None else agg_scores + scores
        scores = agg_scores / len(views)
        scores = torch.where(prop_valid[..., None], scores, torch.zeros_like(scores))
        return self.roi_head.detect((agg_boxes / len(views)).reshape(n, p, -1), scores)


@DETECTORS.register_module()
class FasterRCNN(TwoStageDetector):
    """``two_stage.py:313``."""


@DETECTORS.register_module()
class MaskRCNN(TwoStageDetector):
    """``two_stage.py:319-342``: the RoI head's mask branch
    (``roi_head.mask_head``) trains on the batch's ``gt_masks``; the test
    path adds each detection's mask probabilities at its class."""

    def simple_test(self, batch, rescale: bool = True):
        """Returns dets (N, max_per_img, 5), labels, valid and (with a mask
        head) masks (N, max_per_img, M, M) float32 probabilities, M = 2 x the
        mask RoI size (28). The mask RoIs are the detections in the maps'
        frame: a rescale to the original image is undone first (``:339``)."""
        feats, sf, (dets, labels, valid) = self._simple_test(batch, rescale)
        if self.roi_head.mask_head is None:
            return dets, labels, valid
        boxes = dets[..., :4] * sf[:, None, :] if rescale else dets[..., :4]
        return dets, labels, valid, self.roi_head.simple_test_mask(feats, boxes, labels)
