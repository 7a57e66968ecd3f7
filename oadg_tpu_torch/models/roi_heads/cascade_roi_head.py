"""Cascade R-CNN's RoI head (port of
``oadg_tpu/models/roi_heads/cascade_roi_head.py:24``) and its ``CascadeRCNN``
detector (``:219``).

Three box stages, each with its own box head, assigner and sampler (a
single dict config is repeated over the stages, ``:34-77``). Training
(``_cascade_stages``, ``:107-157``): stage k assigns and samples from the
gts (``add_gt_as_proposals``, per stage) followed by stage k-1's refined
sampled boxes (the proposals at stage 0), runs RoIAlign (kernel B1, its
gradient B2, at the box head's 7x7) and its box head, and logs its losses
as ``s{k}.<key>``, the ``loss*`` keys times the stage's loss weight. Its
sampled boxes are then refined by its own deltas, chosen at the clipped
target label (or class-agnostic), decoded without ``max_shape`` and
detached: the next stage's candidates (``:140-156``). Every image samples
on its own (``:114-120``), from the draws ``rcnn.s{k}.pos`` /
``rcnn.s{k}.neg``, (N, candidates) each.

The test path (``simple_test``, ``:159-211``): every stage runs on the
previous stage's refined boxes; between stages the deltas are chosen by the
argmax over the ``nc`` class columns of that stage's softmax, and each
decode is clipped to the image. The scores are the three stages' softmax
averaged; the last stage's per-class deltas are decoded on its input boxes,
the scores of padded proposals zeroed, then one hard per-class NMS (the
JAX head reads only ``nms.iou_threshold``). mmdet keys:
``roi_head.bbox_head.{k}.*``.

The detector's test-time augmentation (``TwoStageDetector.aug_test``)
refuses this family: the JAX ``aug_test`` reads ``roi.head``, which the
cascade lacks (``two_stage.py:275-278``; ROADMAP C).
"""
from __future__ import annotations

from collections.abc import Mapping

import torch
from torch import nn

from ...core.bbox.assign_sample import MaxIoUAssigner, RandomSampler
from ...core.post_processing.nms import multiclass_nms
from ...utils.registry import DETECTORS, HEADS, ROI_EXTRACTORS, build_from_cfg, cfg_args
from ..detectors.two_stage import TwoStageDetector
from .standard_roi_head import StandardRoIHead, sample_rois

_DEFAULT_THRS = (0.5, 0.6, 0.7)


@HEADS.register_module()
class CascadeRoIHead(nn.Module):

    def __init__(self, num_stages: int = 3, stage_loss_weights=(1.0, 0.5, 0.25),
                 bbox_roi_extractor=None, bbox_head=None, train_cfg=None, test_cfg=None,
                 num_views: int = 1, device=None, dtype=None):
        super().__init__()
        self.num_stages = num_stages
        self.stage_loss_weights = tuple(float(w) for w in stage_loss_weights)
        self.num_views = num_views
        self.bbox_roi_extractor = build_from_cfg(
            dict(bbox_roi_extractor), ROI_EXTRACTORS, dict(device=device))
        heads = bbox_head
        if heads is None or isinstance(heads, Mapping):
            heads = [dict(heads or {})] * num_stages
        self.bbox_head = nn.ModuleList(
            build_from_cfg(dict(dict(h), type=dict(h).get("type", "Shared2FCBBoxHead")),
                           HEADS, dict(device=device, dtype=dtype))
            for h in heads)
        tcs = train_cfg
        if tcs is None:
            tcs = [dict(assigner=dict(pos_iou_thr=t, neg_iou_thr=t, min_pos_iou=t,
                                      match_low_quality=False),
                        sampler=dict(num=512, pos_fraction=0.25, add_gt_as_proposals=True))
                   for t in _DEFAULT_THRS]
        if isinstance(tcs, Mapping):
            tcs = [tcs] * num_stages
        if len(tcs) != num_stages or len(self.bbox_head) != num_stages:
            raise ValueError(f"{num_stages} stages need {num_stages} box heads and rcnn "
                             f"train configs, got {len(self.bbox_head)} and {len(tcs)}")
        self.assigners, self.samplers, self.add_gt = [], [], []
        for tc in tcs:
            tc = dict(tc)
            self.assigners.append(MaxIoUAssigner(**cfg_args(
                tc.get("assigner"), dict(pos_iou_thr=0.5, neg_iou_thr=0.5, min_pos_iou=0.5,
                                         match_low_quality=False), "MaxIoUAssigner")))
            smp = cfg_args(tc.get("sampler"), dict(num=512, pos_fraction=0.25),
                           "RandomSampler")
            self.add_gt.append(smp.pop("add_gt_as_proposals", True))
            self.samplers.append(RandomSampler(**smp))
        self.test_cfg = dict(test_cfg or {})

    @property
    def num_classes(self) -> int:
        return self.bbox_head[-1].num_classes

    def init_weights(self, gen: torch.Generator):
        """Each stage's box head init, in stage order."""
        for head in self.bbox_head:
            head.init_weights(gen)

    proposals_to_rois = staticmethod(StandardRoIHead.proposals_to_rois)

    # ---------------- training ----------------

    def _stage_sample(self, stage: int, proposals, prop_valid, gt, gt_valid, gt_labels,
                      draws, name: str):
        """Stage ``stage``'s assignment and sample of every image (``:88-99``)
        from the draws ``rcnn.{name}.pos`` / ``.neg``. -> sampled boxes,
        labels, is_pos, valid, matched gt boxes (N, num, ...)."""
        return sample_rois(self.assigners[stage], self.samplers[stage], self.add_gt[stage],
                           proposals, prop_valid, gt, gt_valid, gt_labels, draws,
                           f"rcnn.{name}")[:5]

    def _cascade_stages(self, feats, proposals, prop_valid, gt_bboxes, gt_valid, gt_labels,
                        draws, refine_all: bool = False):
        """The box cascade -> (losses, chain): ``chain[k]`` is (boxes, valid)
        refined by stage k's regressor (the last stage's only with
        ``refine_all``; else its input), the boxes HTC's mask stage k
        samples from."""
        n = feats[0].shape[0]
        losses, chain = {}, []
        cur, cur_valid = proposals, prop_valid
        for k, head in enumerate(self.bbox_head):
            with torch.no_grad():
                boxes, labels, is_pos, valid, matched = self._stage_sample(
                    k, cur, cur_valid, gt_bboxes, gt_valid, gt_labels, draws, f"s{k}")
                tl, tw, td, tb = head.get_targets(boxes, labels, is_pos, valid, matched)
            s = boxes.shape[1]
            rois = self.proposals_to_rois(boxes)
            cls_score, bbox_pred, _ = head(self.bbox_roi_extractor(feats, rois))
            stage = head.loss(cls_score, bbox_pred, tl.reshape(-1), tw.reshape(-1),
                              td.reshape(-1, 4), tb.reshape(-1, 4))
            w = self.stage_loss_weights[k]
            for key, v in stage.items():
                losses[f"s{k}.{key}"] = v * w if key.startswith("loss") else v
            if k < self.num_stages - 1 or refine_all:
                with torch.no_grad():
                    r = bbox_pred.shape[0]
                    if head.reg_class_agnostic:
                        deltas = bbox_pred.reshape(r, 4)
                    else:
                        safe = tl.reshape(-1).clamp(0, head.num_classes - 1)
                        deltas = torch.gather(bbox_pred.reshape(r, -1, 4), 1,
                                              safe[:, None, None].expand(r, 1, 4))[:, 0]
                    cur = head.bbox_coder.decode(rois[:, 1:5], deltas.float()).view(n, s, 4)
                    cur_valid = valid
            chain.append((cur, cur_valid))
        return losses, chain

    def loss(self, feats, proposals, prop_valid, gt_bboxes, gt_valid, gt_labels,
             draws, random_proposals=None, random_valid=None, gt_masks=None):
        """The three stages' losses (``s{k}.loss_cls``, ``s{k}.loss_bbox``,
        ``s{k}.acc``). The cascade without a mask head reads no
        ``gt_masks``."""
        return self._cascade_stages(feats, proposals, prop_valid, gt_bboxes, gt_valid,
                                    gt_labels, draws)[0]

    # ---------------- inference ----------------

    def simple_test(self, feats, proposals, prop_valid, img_shapes, scale_factors,
                    rescale: bool = True):
        """Returns dets (N, max_per_img, 5), labels (N, max_per_img), valid."""
        tc = self.test_cfg
        n, p = proposals.shape[:2]
        nc = self.num_classes
        h = img_shapes[:, 0].view(n, 1)
        w = img_shapes[:, 1].view(n, 1)
        boxes, scores = proposals, None
        for k, head in enumerate(self.bbox_head):
            rois = self.proposals_to_rois(boxes)
            cls_score, bbox_pred, _ = head(self.bbox_roi_extractor(feats, rois))
            sc = torch.softmax(cls_score.float(), -1)
            scores = sc if scores is None else scores + sc
            if k < self.num_stages - 1:
                r = bbox_pred.shape[0]
                if head.reg_class_agnostic:
                    deltas = bbox_pred.reshape(r, 4)
                else:
                    lbl = sc[:, :nc].argmax(-1)
                    deltas = torch.gather(bbox_pred.reshape(r, -1, 4), 1,
                                          lbl[:, None, None].expand(r, 1, 4))[:, 0]
                boxes = head.bbox_coder.decode(boxes, deltas.float().view(n, p, 4),
                                               max_shape=(h, w))
        last = self.bbox_head[-1]
        scores = (scores / self.num_stages).view(n, p, -1)
        reg = bbox_pred.float().view(n, p, -1, 4)
        dec = last.bbox_coder.decode(boxes[:, :, None].expand(n, p, reg.shape[2], 4), reg,
                                     max_shape=(h[..., None], w[..., None]))
        dec = dec.expand(n, p, nc, 4)
        if rescale:
            dec = dec / scale_factors.float().view(n, 1, 1, -1)[..., :4]
        scores = torch.where(prop_valid[..., None], scores, torch.zeros_like(scores))
        return multiclass_nms(dec.reshape(n, p, -1), scores,
                              float(tc.get("score_thr", 0.05)),
                              float(dict(tc.get("nms", {})).get("iou_threshold", 0.5)),
                              int(tc.get("max_per_img", 100)), nc)


@DETECTORS.register_module()
class CascadeRCNN(TwoStageDetector):
    """``cascade_roi_head.py:219``."""
