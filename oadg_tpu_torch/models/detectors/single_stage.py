"""Single-stage detectors (port of ``oadg_tpu/models/detectors/single_stage.py:16-128``):
backbone -> neck -> dense head. ``YOLOV3`` is the YOLOv3 config's type,
``RetinaNet`` (``:131``) RetinaNet's (``dense_heads/retina_head.py``).

The interface is ``TwoStageDetector``'s, which ``make_train_step``,
``make_test_step``, ``DetectorHandle`` and ``single_gpu_test`` use:
``forward_train(batch, draws)`` on a views-major batch (the head splits the
views), ``simple_test(batch)`` -> dets, labels, valid, ``dtype`` (the
compute dtype; None is float32) and ``init_weights(gen)``. The training
forward runs in ``record_function`` spans ``forward_train: backbone+neck``,
``forward_train: head`` and ``forward_train: loss``.

Train mode trains the live BNs of the neck and the head (their stored
statistics move each step); a backbone with ``norm_eval`` keeps its own in
eval mode. ``aug_test`` is the test-time augmentation (``:70-110``).
"""
from __future__ import annotations

import torch
from torch import nn
from torch.profiler import record_function

from ...core.bbox.transforms import flip_boxes
from ...core.post_processing.nms import batched_nms_padded, sort_desc
from ...utils.registry import BACKBONES, DETECTORS, HEADS, NECKS, build_from_cfg
from ..layers import init_default_


@DETECTORS.register_module()
class SingleStageDetector(nn.Module):

    def __init__(self, backbone, neck=None, bbox_head=None, train_cfg=None,
                 test_cfg=None, init_cfg=None, pretrained=None, num_views: int = 1,
                 device=None, dtype=None):
        super().__init__()
        dev = dict(device=device, dtype=dtype)
        self.dtype = torch.float32 if dtype is None else dtype
        self.train_cfg = dict(train_cfg or {})
        self.test_cfg = dict(test_cfg or {})
        self.num_views = num_views
        self.backbone = build_from_cfg(dict(backbone), BACKBONES, dev)
        self.neck = build_from_cfg(dict(neck), NECKS, dev) if neck else None
        self.bbox_head = build_from_cfg(
            dict(bbox_head, train_cfg=self.train_cfg, test_cfg=self.test_cfg,
                 num_views=num_views), HEADS, dev)

    def init_weights(self, gen: torch.Generator):
        """Seeded random weights: LeCun-normal convs with zero biases (the
        JAX package's default), then the head's own init; BN identity."""
        init_default_(self, gen)
        self.bbox_head.init_weights(gen)

    def extract_feat(self, img):
        x = self.backbone(img)
        return self.neck(x) if self.neck is not None else x

    def forward_train(self, batch, draws):
        """Loss dict of one views-major batch; ``draws``
        (``utils.draws.UniformDraws``) gives the head's random numbers."""
        with record_function("forward_train: backbone+neck"):
            feats = self.extract_feat(batch["img"])
        with record_function("forward_train: head"):
            outs = self.bbox_head(feats)
        with record_function("forward_train: loss"):
            return self.bbox_head.loss(outs, batch["gt_bboxes"], batch["gt_valid"],
                                       batch["gt_labels"], draws)

    def simple_test(self, batch, rescale: bool = True):
        """Returns dets (N, max_per_img, 5), labels, valid."""
        img = batch["img"]
        outs = self.bbox_head(self.extract_feat(img))
        sf = batch.get("scale_factor")
        if sf is None:
            sf = torch.ones((img.shape[0], 4), device=img.device)
        return self.bbox_head.get_bboxes(outs, batch["img_shape"], sf, rescale=rescale)

    def aug_test(self, views, metas):
        """Test-time augmentation: each view's detections, rescaled to the
        original image and flipped back within its extent (the view's shape
        over its scale factor), pooled over the views and put through one
        class-aware NMS, cut to ``max_per_img``. As in the JAX package, a
        view gives its post-NMS detections (mmdet pools the pre-NMS
        candidates: the same unless a view has more than ``max_per_img``
        near-duplicates).

        Args: per-view batches and per-view ``(flip, flip_direction)``.
        Returns dets (N, K, 5), labels (N, K), valid (N, K).
        """
        iou_thr = float(dict(self.test_cfg.get("nms", {})).get("iou_threshold", 0.5))
        dets_l, labels_l, valid_l = [], [], []
        for vd, (flip, fdir) in zip(views, metas):
            img = vd["img"]
            sf = vd.get("scale_factor")
            if sf is None:
                sf = torch.ones((img.shape[0], 4), device=img.device)
            dets, labels, valid = self.bbox_head.get_bboxes(
                self.bbox_head(self.extract_feat(img)), vd["img_shape"], sf)
            if flip:
                ori_shape = vd["img_shape"] / sf[:, [1, 0]]
                dets = torch.cat([flip_boxes(dets[..., :4], ori_shape, fdir),
                                  dets[..., 4:]], -1)
            dets_l.append(dets)
            labels_l.append(labels)
            valid_l.append(valid)
        dets, labels = torch.cat(dets_l, 1), torch.cat(labels_l, 1)
        keep = batched_nms_padded(dets[..., :4], dets[..., 4], labels, iou_thr,
                                  torch.cat(valid_l, 1))
        top_s, top_i = sort_desc(
            torch.where(keep, dets[..., 4], torch.full_like(dets[..., 4], float("-inf"))),
            min(int(self.test_cfg.get("max_per_img", 100)), dets.shape[1]))
        return (torch.gather(dets, 1, top_i[..., None].expand(*top_i.shape, 5)),
                torch.gather(labels, 1, top_i), torch.isfinite(top_s))


@DETECTORS.register_module()
class YOLOV3(SingleStageDetector):
    """``oadg_tpu/models/detectors/single_stage.py:117``."""


@DETECTORS.register_module()
class RetinaNet(SingleStageDetector):
    """``oadg_tpu/models/detectors/single_stage.py:131``."""
