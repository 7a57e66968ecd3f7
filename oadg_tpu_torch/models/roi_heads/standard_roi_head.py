"""RoI heads (port of ``oadg_tpu/models/roi_heads/standard_roi_head.py:32,268``).

Test path (``simple_test``, ``:229``): rois from the padded proposals,
multilevel RoIAlign, the box head, decoding and per-class NMS, hard or soft
as the rcnn ``test_cfg.nms`` says (``detect``); ``view_scores`` is the part
before the NMS, which the test-time augmentation runs once a view. Padded
proposals go through RoIAlign and the head like real ones and are zeroed in
the scores, as in the JAX package.

Training (``loss``, ``:174-225``): the clean images' proposals, with the gts
in front (``add_gt_as_proposals``), are assigned and sampled once
(``_sample``, ``:116-131``) and the sample is tiled over the views
(views-major batches ``[B clean; B view 2; ...]``); RoIAlign, the box head,
targets and losses follow. ``ContrastiveRoIHead.loss`` (``:271-337``) adds
the supervised-contrastive loss over the sampled rows' embeddings and those
of the random proposals, which go through a second extraction.

Under data parallel the losses are each rank's share of the global
batch's (``parallel/dist.py``): the box head's and the mask head's
normalizers count every rank's rows, and ``supcontrast`` gathers every
rank's contrastive rows.

The C4 head (``shared_head``, ``:37-56``): ResNet's next stage
(``shared_heads.ResLayer``) runs on the RoI features before the box head,
in training, in the test path and in the test-time augmentation's views
(``:207, 247, 293``); the IoU-loss family's box head gets the sampled rois
to decode its deltas against.

The box head computes in ``dtype``; RoIAlign returns float32 features from
maps of either dtype, and the contrastive loss takes the embeddings cast to
float32 (``:336``).

The mask branch (Mask R-CNN; ``mask_head`` set, ``:87-99``): a second
RoIAlign at the mask RoI layer's ``output_size`` (14: kernel B1 and its
gradient B2 at 14x14 on the card) over the bbox RoI layer's strides,
``finest_scale`` and ``sampling_ratio`` (the JAX package takes only the
output size from ``mask_roi_extractor``, ``:93-96, :103-108``), then
``FCNMaskHead``. Training (``_mask_loss``, ``:133-157``) runs it on the first
``round(num * pos_fraction)`` sampled slots of each image, where the sampler
puts the positives, and holds them to targets resampled from the matched
gts' box-cropped masks; ``simple_test_mask`` (``:159-170``) runs it on the
detections.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.profiler import record_function

from ...core.bbox.assign_sample import MaxIoUAssigner, RandomSampler
from ...core.post_processing.nms import NMS_TYPES, multiclass_nms
from ...utils.registry import HEADS, LOSSES, ROI_EXTRACTORS, build_from_cfg, cfg_args
from .mask_heads import mask_targets


def sample_rois(assigner, sampler, add_gt: bool, proposals, prop_valid, gt, gt_valid,
                gt_labels, draws, name: str, iou_thr=None):
    """Assign and sample (N, P) proposals of N images at once (``:116-131``),
    the gts in front of them with ``add_gt``; ``draws`` gives ``{name}.pos``
    and ``{name}.neg``, (N, candidates) each; ``iou_thr`` (a tensor)
    overrides the assigner's thresholds. Returns per-sample boxes, labels,
    is_pos, valid, matched gt boxes and the matched gts' indices, (N, num,
    ...)."""
    if add_gt:
        cand = torch.cat([gt, proposals], 1)
        cand_valid = torch.cat([gt_valid, prop_valid], 1)
    else:
        cand, cand_valid = proposals, prop_valid
    b, m = cand.shape[:2]
    dev = cand.device
    assign = assigner.assign(cand, gt, gt_valid, gt_labels=gt_labels, box_valid=cand_valid,
                             thr=iou_thr)
    res = sampler.sample(assign, draws(f"{name}.pos", (b, m), dev),
                         draws(f"{name}.neg", (b, m), dev))
    s = res.inds.shape[1]
    boxes = torch.gather(cand, 1, res.inds[..., None].expand(b, s, 4))
    matched = (res.gt_inds - 1).clamp(0, gt.shape[1] - 1)
    matched_gt = torch.gather(gt, 1, matched[..., None].expand(b, s, 4))
    return boxes, res.labels, res.is_pos, res.valid, matched_gt, matched


@HEADS.register_module()
class StandardRoIHead(nn.Module):

    def __init__(self, bbox_roi_extractor=None, bbox_head=None, train_cfg=None,
                 test_cfg=None, num_views: int = 1, mask_roi_extractor=None,
                 mask_head=None, shared_head=None, device=None, dtype=None):
        super().__init__()
        self.bbox_roi_extractor = build_from_cfg(
            dict(bbox_roi_extractor), ROI_EXTRACTORS, dict(device=device))
        self.shared_head = None
        if shared_head:
            self.shared_head = build_from_cfg(
                dict(shared_head), HEADS,
                dict(device=device, dtype=dtype,
                     in_channels=int(dict(bbox_roi_extractor).get("out_channels", 256))))
        self.bbox_head = build_from_cfg(dict(bbox_head), HEADS,
                                        dict(device=device, dtype=dtype))
        if (self.shared_head is not None
                and self.bbox_head.in_channels != self.shared_head.out_channels):
            raise ValueError(f"bbox_head.in_channels={self.bbox_head.in_channels}: the "
                             f"shared head gives {self.shared_head.out_channels} channels")
        self.mask_head = None
        if mask_head:
            layer = dict((mask_roi_extractor or bbox_roi_extractor or {})
                         .get("roi_layer", dict(output_size=14)))
            bbox_ext = dict(bbox_roi_extractor)
            self.mask_roi_extractor = build_from_cfg(
                dict(bbox_ext, roi_layer=dict(bbox_ext.get("roi_layer", {}),
                                              output_size=int(layer.get("output_size", 14)))),
                ROI_EXTRACTORS, dict(device=device))
            self.mask_head = build_from_cfg(dict(mask_head), HEADS,
                                            dict(device=device, dtype=dtype))
        self.test_cfg = dict(test_cfg or {})
        nms = dict(self.test_cfg.get("nms", {}))
        if nms.get("type", "nms") not in NMS_TYPES:
            raise ValueError(f"rcnn nms type {nms['type']!r}: one of {sorted(NMS_TYPES)}")
        self.num_views = num_views
        train_cfg = dict(train_cfg or {})
        self.assigner = MaxIoUAssigner(**cfg_args(
            train_cfg.get("assigner"), dict(pos_iou_thr=0.5, neg_iou_thr=0.5,
                                            min_pos_iou=0.5,
                                            match_low_quality=False), "MaxIoUAssigner"))
        smp = cfg_args(train_cfg.get("sampler"), dict(num=512, pos_fraction=0.25),
                       "RandomSampler")
        self.add_gt_as_proposals = smp.pop("add_gt_as_proposals", True)
        self.sampler = RandomSampler(**smp)
        self.pos_weight = float(train_cfg.get("pos_weight", -1))
        self.mask_size = int(train_cfg.get("mask_size", 28))

    @property
    def num_classes(self) -> int:
        return self.bbox_head.num_classes

    def init_weights(self, gen: torch.Generator):
        """The box head's init, then the mask head's."""
        self.bbox_head.init_weights(gen)
        if self.mask_head is not None:
            self.mask_head.init_weights(gen)

    def bbox_forward(self, feats, rois: torch.Tensor):
        """(R, 5) rois -> the box head's outputs on their RoIAlign features
        (through the shared head where there is one)."""
        x = self.bbox_roi_extractor(feats, rois)
        if self.shared_head is not None:
            x = self.shared_head(x)
        return self.bbox_head(x)

    @staticmethod
    def proposals_to_rois(proposals: torch.Tensor) -> torch.Tensor:
        """(N, P, 4) -> (N * P, 5) [batch_idx, x1, y1, x2, y2]."""
        n, p = proposals.shape[:2]
        bidx = torch.arange(n, dtype=proposals.dtype, device=proposals.device)
        bidx = bidx.repeat_interleave(p).view(n * p, 1)
        return torch.cat([bidx, proposals.reshape(n * p, 4)], dim=1)

    # ---------------- training ----------------

    def _sample(self, proposals, prop_valid, gt, gt_valid, gt_labels, draws, iou_thr=None):
        """``sample_rois`` of the B clean images with this head's assigner
        and sampler, from the draws ``rcnn.pos`` and ``rcnn.neg``."""
        return sample_rois(self.assigner, self.sampler, self.add_gt_as_proposals, proposals,
                           prop_valid, gt, gt_valid, gt_labels, draws, "rcnn", iou_thr)

    def _loss(self, feats, proposals, prop_valid, gt_bboxes, gt_valid,
              gt_labels, draws, gt_masks=None, iou_thr=None):
        """Shared by both heads: the losses (``loss_mask`` too where the head
        has a mask branch and ``gt_masks`` are given), the sampled rows'
        embeddings (or None), their targets' labels and validity, and (B, S)."""
        v = self.num_views
        n = feats[0].shape[0]
        b = n // v
        with torch.no_grad():
            sampled = self._sample(proposals[:b], prop_valid[:b], gt_bboxes[:b],
                                   gt_valid[:b], gt_labels[:b], draws, iou_thr)
            boxes, labels, is_pos, valid, matched_gt, matched = (
                t.repeat(v, *[1] * (t.dim() - 1)) for t in sampled)
            tgt_labels, tgt_lw, tgt_deltas, tgt_bw = self.bbox_head.get_targets(
                boxes, labels, is_pos, valid, matched_gt, self.pos_weight)
        cls_score, bbox_pred, cont = self.bbox_forward(feats, self.proposals_to_rois(boxes))
        losses = self.bbox_head.loss(cls_score, bbox_pred, tgt_labels.reshape(-1),
                                     tgt_lw.reshape(-1), tgt_deltas.reshape(-1, 4),
                                     tgt_bw.reshape(-1, 4), rois=boxes.reshape(-1, 4))
        self._branch_losses(losses, feats, boxes, tgt_labels, is_pos, valid, matched_gt,
                            matched, gt_masks, draws)
        return losses, cont, tgt_labels.reshape(-1), valid.reshape(-1), boxes.shape[:2]

    def _branch_losses(self, losses, feats, boxes, labels, is_pos, valid, matched_gt, matched,
                       gt_masks, draws):
        """The branches beside the box head on the views-major sample (N,
        S, ...), into ``losses``: ``loss_mask`` where the head has a mask
        branch and ``gt_masks`` are given."""
        if self.mask_head is not None and gt_masks is not None:
            with record_function("forward_train: mask branch"):
                losses["loss_mask"] = self._mask_loss(feats, boxes, labels, is_pos & valid,
                                                      matched_gt, matched, gt_masks, draws)

    def _mask_branch(self, feats, boxes, matched_gt, matched, gt_masks):
        """The mask head on the first ``max_pos = round(num * pos_fraction)``
        sampled slots of each image (N, S): the sampler puts the positives
        first, so these hold every positive (``:133-157``). -> (their RoI
        features, the head's logits, the targets resampled from the matched
        gts' box-cropped masks (N, G, M0, M0), max_pos)."""
        out = self.mask_roi_extractor.output_size
        if 2 * out != self.mask_size:
            # the JAX package's mask head gives (2 out)^2 logits against
            # mask_size^2 targets and raises on the product
            raise ValueError(f"the mask head's {2 * out}x{2 * out} logits (mask RoI "
                             f"output_size {out}) do not match train_cfg.rcnn.mask_size="
                             f"{self.mask_size}: give the config a "
                             f"model.roi_head.mask_roi_extractor of output_size "
                             f"{self.mask_size // 2}")
        p = max(int(round(boxes.shape[1] * self.sampler.pos_fraction)), 1)
        pboxes = boxes[:, :p]
        with torch.no_grad():
            gm = gt_masks.float()
            idx = matched[:, :p]
            pmasks = torch.gather(gm, 1, idx[:, :, None, None].expand(-1, -1, *gm.shape[2:]))
            tgts = mask_targets(pboxes.reshape(-1, 4), matched_gt[:, :p].reshape(-1, 4),
                                pmasks.reshape(-1, *gm.shape[2:]), self.mask_size)
        mfeats = self.mask_roi_extractor(feats, self.proposals_to_rois(pboxes))
        return mfeats, self.mask_head(mfeats), tgts, p

    def _mask_loss(self, feats, boxes, labels, pos, matched_gt, matched, gt_masks, draws=None):
        """``loss_mask`` of ``_mask_branch``'s slots against their targets
        (``draws`` is PointRend's)."""
        _, mask_pred, tgts, p = self._mask_branch(feats, boxes, matched_gt, matched, gt_masks)
        return self.mask_head.loss(mask_pred, tgts, labels[:, :p].reshape(-1),
                                   pos[:, :p].reshape(-1))

    def loss(self, feats, proposals, prop_valid, gt_bboxes, gt_valid, gt_labels,
             draws, random_proposals=None, random_valid=None, gt_masks=None):
        """RoI losses over views-major FPN maps (N = num_views * B images).

        Args:
            proposals, prop_valid: (N, P, 4), (N, P); the first B rows
                (the clean images) are used.
            gt_bboxes, gt_valid, gt_labels: (N, G, ...) padded ground truth.
            draws: ``utils.draws.UniformDraws`` for the sampler.
            random_proposals, random_valid: OA-Loss random proposals, used
                by ``ContrastiveRoIHead`` only.
            gt_masks: (N, G, M0, M0) box-cropped gt masks, for the mask
                branch.
        """
        return self._loss(feats, proposals, prop_valid, gt_bboxes, gt_valid,
                          gt_labels, draws, gt_masks)[0]

    # ---------------- inference ----------------

    def detect(self, boxes: torch.Tensor, scores: torch.Tensor):
        """``multiclass_nms`` with the rcnn ``test_cfg``: ``score_thr``,
        ``max_per_img`` and ``nms`` (``type='nms'`` or ``'soft_nms'``, the
        latter ``method='gaussian'`` with ``sigma``, and ``min_score``;
        ``:230-242``)."""
        tc = self.test_cfg
        nms = dict(tc.get("nms", {}))
        nms_type = str(nms.get("type", "nms"))
        if nms_type == "soft_nms" and nms.get("method") == "gaussian":
            nms_type = "soft_nms_gaussian"
        return multiclass_nms(boxes, scores, float(tc.get("score_thr", 0.05)),
                              float(nms.get("iou_threshold", 0.5)),
                              int(tc.get("max_per_img", 100)), self.bbox_head.num_classes,
                              nms_type=nms_type, sigma=float(nms.get("sigma", 0.5)),
                              min_score=float(nms.get("min_score", 1e-3)))

    def view_scores(self, feats, rois: torch.Tensor, img_shapes, scale_factors,
                    rescale: bool):
        """(N, P, 5) rois on one view's maps -> decoded boxes (N, P, 4 C) and
        softmax scores (N, P, C + 1)."""
        n, p = rois.shape[:2]
        cls_score, bbox_pred, _ = self.bbox_forward(feats, rois.reshape(n * p, 5))
        return self.bbox_head.get_bboxes(rois, cls_score.view(n, p, -1),
                                         bbox_pred.view(n, p, -1), img_shapes,
                                         scale_factors, rescale=rescale)

    def simple_test(self, feats, proposals, prop_valid, img_shapes,
                    scale_factors, rescale: bool = True):
        """Returns dets (N, max_per_img, 5), labels (N, max_per_img), valid."""
        n, p = proposals.shape[:2]
        rois = self.proposals_to_rois(proposals).view(n, p, 5)
        boxes, scores = self.view_scores(feats, rois, img_shapes, scale_factors, rescale)
        scores = torch.where(prop_valid[..., None], scores, torch.zeros_like(scores))
        return self.detect(boxes, scores)

    def simple_test_mask(self, feats, boxes: torch.Tensor,
                         labels: torch.Tensor) -> torch.Tensor:
        """(N, D, 4) detections' boxes in the maps' frame and their (N, D)
        labels -> (N, D, M, M) float32 mask probabilities at each one's class
        (``:159-170``)."""
        n, d = boxes.shape[:2]
        probs = self.mask_head.get_masks(
            self.mask_head(self.mask_roi_extractor(feats, self.proposals_to_rois(boxes))),
            labels.reshape(-1))
        return probs.view(n, d, *probs.shape[1:])


@HEADS.register_module()
class ContrastiveRoIHead(StandardRoIHead):
    """``standard_roi_head.py:268``: the OA-DG head; its loss adds
    ``loss_cont``, the test path is the standard one."""

    def loss(self, feats, proposals, prop_valid, gt_bboxes, gt_valid, gt_labels,
             draws, random_proposals=None, random_valid=None, gt_masks=None):
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
