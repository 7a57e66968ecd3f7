"""Panoptic FPN (port of ``oadg_tpu/models/detectors/panoptic.py``).

``PanopticFPN`` (``:23``): the two-stage detector (the config's RPN and
``StandardRoIHead`` with its mask branch) plus a ``FusedSemanticHead``
(``models/roi_heads/htc_scnet_heads.py``) over the FPN maps, under
``semantic_head.``. The JAX detector runs ``extract_feat`` twice, once
for the detector and once for the semantic head (``:36-37``, ``:55-56``);
the port runs it once: its frozen-BN backbone and its neck give the same
maps both times, and the gradients of the two uses sum to those of one.

- ``forward_train``: the detector's losses, and where the batch has a
  ``gt_semantic_seg`` (N, H, W) label map, ``loss_semantic_seg``: 0.5 x the
  mean cross-entropy of the stuff logits at the fusion level over the
  pixels of the map resized by ``nearest-exact`` (JAX's
  ``jax.image.resize(..., "nearest")``) that are below 255.
- ``simple_test``: the pair JAX returns, the detector's ``(dets, labels,
  valid)`` and the stuff probabilities (N, h, w, K) channels last at the
  fusion level's stride; no masks are served (the mask head trains only),
  so ``heuristic_fuse_panoptic`` has no caller in either package. The box
  test path refuses the pair (``instance_outputs``,
  ``apis/test.py:refuse_instance_outputs``).

The repo's config names no ``mask_roi_extractor``: the mask head then reads
the box layer's 7x7 RoIs and gives 14x14 logits against ``mask_size`` 28
targets, and a training step raises ``ValueError`` naming
``model.roi_head.mask_roi_extractor`` (JAX's raises ``TypeError`` on the
product; ROADMAP C). Serving needs no mask RoIs and runs as given.

``heuristic_fuse_panoptic`` (``:61``) is the host numpy fusion, kept
bit-equal.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

from ...utils.registry import DETECTORS
from ..roi_heads.htc_scnet_heads import FusedSemanticHead, semantic_loss
from .two_stage import TwoStageDetector


@DETECTORS.register_module()
class PanopticFPN(TwoStageDetector):
    instance_outputs = "((dets, labels, valid), stuff probabilities)"

    def __init__(self, backbone, neck=None, rpn_head=None, roi_head=None, semantic_head=None,
                 train_cfg=None, test_cfg=None, init_cfg=None, pretrained=None,
                 num_views: int = 1, device=None, dtype=None):
        super().__init__(backbone, neck, rpn_head, roi_head, train_cfg, test_cfg, init_cfg,
                         pretrained, num_views, device, dtype)
        sh = dict(semantic_head or dict(num_classes=54))
        sh.pop("type", None)
        self.semantic_head = FusedSemanticHead(**sh, device=device, dtype=dtype)

    def forward_train(self, batch, draws):
        with record_function("forward_train: backbone+neck"):
            feats = self.extract_feat(batch["img"])
        losses = super().forward_train(batch, draws, feats=feats)
        with record_function("forward_train: semantic head+loss"):
            seg, _ = self.semantic_head(feats)
            gt_sem = batch.get("gt_semantic_seg")
            if gt_sem is not None:
                losses["loss_semantic_seg"] = semantic_loss(seg, gt_sem, weight=0.5)
        return losses

    def simple_test(self, batch, rescale: bool = True):
        """-> ((dets, labels, valid), stuff probabilities (N, h, w, K))."""
        feats, _, dets = self._simple_test(batch, rescale)
        seg, _ = self.semantic_head(feats)
        return dets, torch.softmax(seg, 1).permute(0, 2, 3, 1)


@DETECTORS.register_module()
class TwoStagePanopticSegmentor(PanopticFPN):
    """``:97``."""


def heuristic_fuse_panoptic(dets, det_labels, det_masks, stuff_probs, num_things: int,
                            overlap_thr: float = 0.5, stuff_area_limit: int = 4096,
                            instance_id_offset: int = 1000) -> np.ndarray:
    """``:61``: higher-scoring thing masks claim pixels first (a mask keeps
    its unclaimed part if that part is at least ``overlap_thr`` of it);
    each stuff class's argmax pixels left unclaimed fill in if they number
    ``stuff_area_limit`` or more. numpy: dets (D, 5), det_labels (D,),
    det_masks (D, H, W) bool, stuff_probs (H, W, S) -> (H, W) int64 ids
    ``label * instance_id_offset + instance`` (stuff ``(num_things + s) *
    instance_id_offset``), -1 unclaimed."""
    h, w = stuff_probs.shape[:2]
    pan = np.full((h, w), -1, np.int64)
    taken = np.zeros((h, w), bool)
    order = np.argsort(-dets[:, 4])
    inst = 0
    for i in order:
        if dets[i, 4] <= 0:
            continue
        m = det_masks[i] & ~taken
        if m.sum() == 0 or m.sum() / max(det_masks[i].sum(), 1) < overlap_thr:
            continue
        inst += 1
        pan[m] = int(det_labels[i]) * instance_id_offset + inst
        taken |= m
    stuff = np.argmax(stuff_probs, -1)
    for s in range(stuff_probs.shape[-1]):
        m = (stuff == s) & ~taken
        if m.sum() >= stuff_area_limit:
            pan[m] = (num_things + s) * instance_id_offset
            taken |= m
    return pan
