"""RoI heads, test path (port of
``oadg_tpu/models/roi_heads/standard_roi_head.py:32,268``): rois from the
padded proposals, multilevel RoIAlign, the box head, decoding and per-class
NMS (``simple_test``, ``:229``). Padded proposals go through RoIAlign and the
head like real ones and are zeroed in the scores, as in the JAX package.
``ContrastiveRoIHead`` differs only in training."""
from __future__ import annotations

import torch
from torch import nn

from ...core.post_processing.nms import multiclass_nms
from ...utils.registry import HEADS, ROI_EXTRACTORS, build_from_cfg


@HEADS.register_module()
class StandardRoIHead(nn.Module):

    def __init__(self, bbox_roi_extractor=None, bbox_head=None, train_cfg=None,
                 test_cfg=None, device=None):
        super().__init__()
        self.bbox_roi_extractor = build_from_cfg(
            dict(bbox_roi_extractor), ROI_EXTRACTORS, dict(device=device))
        self.bbox_head = build_from_cfg(dict(bbox_head), HEADS, dict(device=device))
        self.test_cfg = dict(test_cfg or {})
        nms = dict(self.test_cfg.get("nms", {}))
        if nms.get("type", "nms") != "nms":
            raise NotImplementedError(f"rcnn nms type {nms['type']} (the port "
                                      "serves hard NMS)")

    @staticmethod
    def proposals_to_rois(proposals: torch.Tensor) -> torch.Tensor:
        """(N, P, 4) -> (N * P, 5) [batch_idx, x1, y1, x2, y2]."""
        n, p = proposals.shape[:2]
        bidx = torch.arange(n, dtype=proposals.dtype, device=proposals.device)
        bidx = bidx.repeat_interleave(p).view(n * p, 1)
        return torch.cat([bidx, proposals.reshape(n * p, 4)], dim=1)

    def simple_test(self, feats, proposals, prop_valid, img_shapes,
                    scale_factors, rescale: bool = True):
        """Returns dets (N, max_per_img, 5), labels (N, max_per_img), valid."""
        n, p = proposals.shape[:2]
        rois = self.proposals_to_rois(proposals)
        cls_score, bbox_pred = self.bbox_head(self.bbox_roi_extractor(feats, rois))
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
    """``standard_roi_head.py:268``: the OA-DG head; same test path."""
