"""RoI heads (port of ``oadg_tpu/models/roi_heads/standard_roi_head.py:32,268``).

Test path (``simple_test``, ``:229``): rois from the padded proposals,
multilevel RoIAlign, the box head, decoding and per-class NMS. Padded
proposals go through RoIAlign and the head like real ones and are zeroed in
the scores, as in the JAX package.

Training (``loss``, ``:174-225``): the clean images' proposals, with the gts
in front (``add_gt_as_proposals``), are assigned and sampled once
(``_sample``, ``:116-131``) and the sample is tiled over the views
(views-major batches ``[B clean; B view 2; ...]``); RoIAlign, the box head,
targets and losses follow. ``ContrastiveRoIHead.loss`` (``:271-337``) adds
the supervised-contrastive loss over the sampled rows' embeddings and those
of the random proposals, which go through a second extraction.

The box head computes in ``dtype``; RoIAlign returns float32 features from
maps of either dtype, and the contrastive loss takes the embeddings cast to
float32 (``:336``).
"""
from __future__ import annotations

import torch
from torch import nn

from ...core.bbox.assign_sample import MaxIoUAssigner, RandomSampler
from ...core.post_processing.nms import multiclass_nms
from ...utils.registry import HEADS, LOSSES, ROI_EXTRACTORS, build_from_cfg, cfg_args


@HEADS.register_module()
class StandardRoIHead(nn.Module):

    def __init__(self, bbox_roi_extractor=None, bbox_head=None, train_cfg=None,
                 test_cfg=None, num_views: int = 1, device=None, dtype=None):
        super().__init__()
        self.bbox_roi_extractor = build_from_cfg(
            dict(bbox_roi_extractor), ROI_EXTRACTORS, dict(device=device))
        self.bbox_head = build_from_cfg(dict(bbox_head), HEADS,
                                        dict(device=device, dtype=dtype))
        self.test_cfg = dict(test_cfg or {})
        nms = dict(self.test_cfg.get("nms", {}))
        if nms.get("type", "nms") != "nms":
            raise NotImplementedError(f"rcnn nms type {nms['type']} (the port "
                                      "serves hard NMS)")
        self.num_views = num_views
        train_cfg = dict(train_cfg or {})
        self.assigner = MaxIoUAssigner(**cfg_args(
            train_cfg.get("assigner"), dict(pos_iou_thr=0.5, neg_iou_thr=0.5,
                                            min_pos_iou=0.5,
                                            match_low_quality=False)))
        smp = cfg_args(train_cfg.get("sampler"), dict(num=512, pos_fraction=0.25))
        self.add_gt_as_proposals = smp.pop("add_gt_as_proposals", True)
        self.sampler = RandomSampler(**smp)
        self.pos_weight = float(train_cfg.get("pos_weight", -1))

    @staticmethod
    def proposals_to_rois(proposals: torch.Tensor) -> torch.Tensor:
        """(N, P, 4) -> (N * P, 5) [batch_idx, x1, y1, x2, y2]."""
        n, p = proposals.shape[:2]
        bidx = torch.arange(n, dtype=proposals.dtype, device=proposals.device)
        bidx = bidx.repeat_interleave(p).view(n * p, 1)
        return torch.cat([bidx, proposals.reshape(n * p, 4)], dim=1)

    # ---------------- training ----------------

    def _sample(self, proposals, prop_valid, gt, gt_valid, gt_labels, draws):
        """Assign and sample the B clean images at once; ``draws`` gives
        ``rcnn.pos`` and ``rcnn.neg``, (B, candidates) each. Returns
        per-sample boxes, labels, is_pos, valid and matched gt boxes,
        (B, num, ...)."""
        if self.add_gt_as_proposals:
            cand = torch.cat([gt, proposals], 1)
            cand_valid = torch.cat([gt_valid, prop_valid], 1)
        else:
            cand, cand_valid = proposals, prop_valid
        b, m = cand.shape[:2]
        dev = cand.device
        assign = self.assigner.assign(cand, gt, gt_valid, gt_labels=gt_labels,
                                      box_valid=cand_valid)
        res = self.sampler.sample(assign, draws("rcnn.pos", (b, m), dev),
                                  draws("rcnn.neg", (b, m), dev))
        s = res.inds.shape[1]
        boxes = torch.gather(cand, 1, res.inds[..., None].expand(b, s, 4))
        matched = (res.gt_inds - 1).clamp(0, gt.shape[1] - 1)
        matched_gt = torch.gather(gt, 1, matched[..., None].expand(b, s, 4))
        return boxes, res.labels, res.is_pos, res.valid, matched_gt

    def _loss(self, feats, proposals, prop_valid, gt_bboxes, gt_valid,
              gt_labels, draws):
        """Shared by both heads: the losses, the sampled rows' embeddings
        (or None), their targets' labels and validity, and (B, S)."""
        v = self.num_views
        n = feats[0].shape[0]
        b = n // v
        with torch.no_grad():
            sampled = self._sample(proposals[:b], prop_valid[:b], gt_bboxes[:b],
                                   gt_valid[:b], gt_labels[:b], draws)
            boxes, labels, is_pos, valid, matched_gt = (
                t.repeat(v, *[1] * (t.dim() - 1)) for t in sampled)
            tgt_labels, tgt_lw, tgt_deltas, tgt_bw = self.bbox_head.get_targets(
                boxes, labels, is_pos, valid, matched_gt, self.pos_weight)
        cls_score, bbox_pred, cont = self.bbox_head(
            self.bbox_roi_extractor(feats, self.proposals_to_rois(boxes)))
        losses = self.bbox_head.loss(cls_score, bbox_pred, tgt_labels.reshape(-1),
                                     tgt_lw.reshape(-1), tgt_deltas.reshape(-1, 4),
                                     tgt_bw.reshape(-1, 4))
        return losses, cont, tgt_labels.reshape(-1), valid.reshape(-1), boxes.shape[:2]

    def loss(self, feats, proposals, prop_valid, gt_bboxes, gt_valid, gt_labels,
             draws, random_proposals=None, random_valid=None):
        """RoI losses over views-major FPN maps (N = num_views * B images).

        Args:
            proposals, prop_valid: (N, P, 4), (N, P); the first B rows
                (the clean images) are used.
            gt_bboxes, gt_valid, gt_labels: (N, G, ...) padded ground truth.
            draws: ``utils.draws.UniformDraws`` for the sampler.
            random_proposals, random_valid: OA-Loss random proposals, used
                by ``ContrastiveRoIHead`` only.
        """
        return self._loss(feats, proposals, prop_valid, gt_bboxes, gt_valid,
                          gt_labels, draws)[0]

    # ---------------- inference ----------------

    def simple_test(self, feats, proposals, prop_valid, img_shapes,
                    scale_factors, rescale: bool = True):
        """Returns dets (N, max_per_img, 5), labels (N, max_per_img), valid."""
        n, p = proposals.shape[:2]
        rois = self.proposals_to_rois(proposals)
        cls_score, bbox_pred, _ = self.bbox_head(self.bbox_roi_extractor(feats, rois))
        boxes, scores = self.bbox_head.get_bboxes(
            rois.view(n, p, 5), cls_score.view(n, p, -1), bbox_pred.view(n, p, -1),
            img_shapes, scale_factors, rescale=rescale)
        scores = torch.where(prop_valid[..., None], scores, torch.zeros_like(scores))
        nms = dict(self.test_cfg.get("nms", {}))
        return multiclass_nms(boxes, scores,
                              float(self.test_cfg.get("score_thr", 0.05)),
                              float(nms.get("iou_threshold", 0.5)),
                              int(self.test_cfg.get("max_per_img", 100)),
                              self.bbox_head.num_classes)


@HEADS.register_module()
class ContrastiveRoIHead(StandardRoIHead):
    """``standard_roi_head.py:268``: the OA-DG head; its loss adds
    ``loss_cont``, the test path is the standard one."""

    def loss(self, feats, proposals, prop_valid, gt_bboxes, gt_valid, gt_labels,
             draws, random_proposals=None, random_valid=None):
        losses, cont, labels, valid, (n, s) = self._loss(
            feats, proposals, prop_valid, gt_bboxes, gt_valid, gt_labels, draws)
        if cont is None:
            return losses
        b = n // self.num_views
        cfg = self.bbox_head.loss_cont_cfg or dict(
            type="ContrastiveLossPlus", loss_weight=0.01, temperature=0.06,
            num_views=2)
        if random_proposals is not None:
            q = random_proposals.shape[1]
            _, _, rcont = self.bbox_head(self.bbox_roi_extractor(
                feats, self.proposals_to_rois(random_proposals)))
            if random_valid is None:
                random_valid = torch.ones(random_proposals.shape[:2], dtype=torch.bool,
                                          device=cont.device)
            cont = torch.cat([cont, rcont])
            labels = torch.cat([labels, torch.full((n * q,), self.bbox_head.num_classes,
                                                   dtype=labels.dtype, device=labels.device)])
            valid = torch.cat([valid, random_valid.reshape(-1)])
            layout = (s * b, self.num_views, q * b)
        else:
            layout = (s * b, self.num_views, 0)
        losses["loss_cont"] = build_from_cfg(dict(cfg), LOSSES)(
            cont.float(), labels, valid, layout)
        return losses
