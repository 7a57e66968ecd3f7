"""Two-stage detector, test path (port of
``oadg_tpu/models/detectors/two_stage.py:55``): backbone and neck
(``extract_feat``), RPN proposals, RoI head (``simple_test``, ``:198``).

The batch follows ``oadg_tpu/engine/train_step.py:102``: ``img`` (N, 3, H, W)
float32 normalized and padded (NCHW here, channels-last memory on the card),
``img_shape`` (N, 2) valid (h, w), ``scale_factor`` (N, 4)."""
from __future__ import annotations

import torch
from torch import nn

from ...utils.registry import BACKBONES, DETECTORS, HEADS, NECKS, build_from_cfg
from ..layers import init_default_


@DETECTORS.register_module()
class TwoStageDetector(nn.Module):

    def __init__(self, backbone, neck=None, rpn_head=None, roi_head=None,
                 train_cfg=None, test_cfg=None, init_cfg=None, pretrained=None,
                 device=None):
        super().__init__()
        dev = dict(device=device)
        test_cfg = dict(test_cfg or {})
        self.backbone = build_from_cfg(dict(backbone), BACKBONES, dev)
        self.neck = build_from_cfg(dict(neck), NECKS, dev) if neck else None
        self.rpn_head = build_from_cfg(
            dict(rpn_head, test_cfg=test_cfg.get("rpn")), HEADS, dev)
        self.roi_head = build_from_cfg(
            dict(roi_head, test_cfg=test_cfg.get("rcnn")), HEADS, dev)

    def init_weights(self, gen: torch.Generator):
        """Seeded random weights: LeCun-normal convs and FCs (the JAX
        package's default), then each head's own init; frozen BN identity."""
        init_default_(self, gen)
        self.rpn_head.init_weights(gen)
        self.roi_head.bbox_head.init_weights(gen)

    def extract_feat(self, img):
        x = self.backbone(img)
        return self.neck(x) if self.neck is not None else x

    def simple_test(self, batch, rescale: bool = True):
        """Returns dets (N, max_per_img, 5), labels, valid."""
        img = batch["img"]
        feats = self.extract_feat(img)
        cls_scores, bbox_preds = self.rpn_head(feats)
        boxes, _, valid = self.rpn_head.get_proposals(cls_scores, bbox_preds,
                                                      batch["img_shape"])
        sf = batch.get("scale_factor")
        if sf is None:
            sf = torch.ones((img.shape[0], 4), device=img.device)
        return self.roi_head.simple_test(feats, boxes, valid, batch["img_shape"],
                                         sf, rescale=rescale)


@DETECTORS.register_module()
class FasterRCNN(TwoStageDetector):
    """``two_stage.py:313``."""
