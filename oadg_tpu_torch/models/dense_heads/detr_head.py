"""DETR head and detector (port of ``oadg_tpu/models/dense_heads/detr_head.py``).

``DETRHead`` (``:26``): the last backbone map through ``input_proj`` (a
dense layer on the channels; mmdet's is a 1x1 conv, which
``load_mmdet_checkpoint`` reshapes), flattened to H * W tokens with the
sine positions (``models/utils/transformer.py``), the post-norm
encoder-decoder from ``query_embedding`` (Q, C), then on every decoder
layer the softmax classifier ``fc_cls`` (C + 1 outputs, the last the
background) and the box MLP ``reg_ffn.layers.0.0`` -> ReLU ->
``reg_ffn.layers.1`` -> ReLU -> ``fc_reg`` -> sigmoid (normalized cxcywh).

- ``loss`` (``:75-116``): per decoder layer the Hungarian assignment
  (``core/bbox/hungarian.py``: scipy's exact assignment on the host, one
  round trip a layer for the batch) of the softmax probabilities and the
  boxes; per image the cross-entropy with the background weighted
  ``bg_cls_weight`` over ``num_pos + bg_cls_weight * num_neg``, the L1 of
  the normalized boxes and 1 - GIoU of the absolute ones over ``num_pos``;
  each the mean over the images (under data parallel this rank's share of
  the global batch's mean). The last layer's keys are ``loss_cls``,
  ``loss_bbox`` and ``loss_iou``, layer ``i``'s before it ``d{i}.loss_*``.
- ``get_bboxes`` (``:118``): the last layer's largest foreground
  probability per query, its class, the box in pixels over the scale
  factor, the top ``max_per_img`` queries (``jax.lax.top_k``'s order);
  every row valid.

The classifier's bias starts at 0, as the JAX head's (mmdet's too: a
``Linear``'s default init).
"""
from __future__ import annotations

import torch
from torch import nn
from torch.profiler import record_function

from ...core.bbox.geometry import bbox_overlaps
from ...core.bbox.hungarian import HungarianAssigner, cxcywh_to_xyxy, xyxy_to_cxcywh
from ...core.post_processing.nms import sort_desc
from ...utils.registry import DETECTORS, HEADS
from ..detectors.single_stage import SingleStageDetector
from ..layers import Linear, normal_
from ..utils.misc import images_mean
from ..utils.transformer import SinePositionalEncoding, Transformer, init_attention


def image_factor(img_shapes: torch.Tensor) -> torch.Tensor:
    """(N, 2) (h, w) -> (N, 4) ``[w, h, w, h]`` float32."""
    shp = img_shapes.float()
    return torch.stack([shp[:, 1], shp[:, 0], shp[:, 1], shp[:, 0]], -1)


def _gather_rows(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(N, G, ...) rows at (N, Q) indices -> (N, Q, ...)."""
    return torch.gather(t, 1, idx.reshape(*idx.shape, *([1] * (t.dim() - 2))).expand(
        *idx.shape, *t.shape[2:]))


def box_losses(boxes, assigned, gt_bboxes, factor, l1_weight, giou_weight):
    """The matched queries' L1 of the normalized cxcywh boxes and 1 - GIoU
    of the absolute xyxy ones, each per image over ``max(num_pos, 1)``
    (``:99-114``) -> (N,), (N,), the positives (N, Q) and ``num_pos`` (N,)."""
    pos = assigned > 0
    matched = (assigned - 1).clamp(0, gt_bboxes.shape[1] - 1)
    num_pos = pos.sum(1).float().clamp(min=1.0)
    posf = pos.float()
    f = factor[:, None, :]
    tgt = _gather_rows(xyxy_to_cxcywh(gt_bboxes / f), matched)
    loss_l1 = l1_weight * ((boxes - tgt).abs() * posf[..., None]).sum((1, 2)) / num_pos
    gious = bbox_overlaps(cxcywh_to_xyxy(boxes) * f, _gather_rows(gt_bboxes, matched),
                          mode="giou", is_aligned=True)
    loss_giou = giou_weight * ((1 - gious) * posf).sum(1) / num_pos
    return loss_l1, loss_giou, pos, num_pos


def matched_labels(assigned, gt_labels, num_classes):
    """(N, Q) assignments -> each query's label, ``num_classes`` where it
    is unmatched."""
    matched = (assigned - 1).clamp(0, gt_labels.shape[1] - 1)
    lab = torch.gather(gt_labels.long(), 1, matched)
    return torch.where(assigned > 0, lab, torch.full_like(lab, num_classes))


def layer_losses(loss_single, cls_all, box_all, *args):
    """``loss_single(cls, boxes, *args)`` -> per-image (N,) losses of one
    decoder layer; each layer's means over the images under mmdet's keys."""
    n_layers = cls_all.shape[0]
    losses = {}
    for li in range(n_layers):
        lc, ll, lg = loss_single(cls_all[li], box_all[li], *args)
        tag = "" if li == n_layers - 1 else f"d{li}."
        losses[f"{tag}loss_cls"] = images_mean(lc)
        losses[f"{tag}loss_bbox"] = images_mean(ll)
        losses[f"{tag}loss_iou"] = images_mean(lg)
    return losses


@HEADS.register_module()
class DETRHead(nn.Module):

    def __init__(self, num_classes: int = 80, in_channels: int = 2048, num_query: int = 100,
                 embed_dims: int = 256, num_heads: int = 8, num_encoder_layers: int = 6,
                 num_decoder_layers: int = 6, feedforward_channels: int = 2048,
                 bg_cls_weight: float = 0.1, l1_weight: float = 5.0, giou_weight: float = 2.0,
                 cls_weight: float = 1.0, train_cfg=None, test_cfg=None, num_views: int = 1,
                 device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.num_classes = num_classes
        self.embed_dims = embed_dims
        self.bg_cls_weight = float(bg_cls_weight)
        self.l1_weight, self.giou_weight = float(l1_weight), float(giou_weight)
        self.cls_weight = float(cls_weight)
        self.test_cfg = dict(test_cfg or {})
        asn = dict(dict(train_cfg or {}).get("assigner") or {})
        asn.pop("type", None)
        self.assigner = HungarianAssigner(**asn)
        self.positional_encoding = SinePositionalEncoding(embed_dims // 2)
        self.input_proj = Linear(in_channels, embed_dims, **kw)
        self.transformer = Transformer(embed_dims, num_heads, num_encoder_layers,
                                       num_decoder_layers, feedforward_channels, **kw)
        self.query_embedding = nn.Embedding(num_query, embed_dims, device=device)
        self.fc_cls = Linear(embed_dims, num_classes + 1, **kw)
        self.reg_ffn = nn.Module()
        self.reg_ffn.layers = nn.ModuleList([nn.ModuleList([Linear(embed_dims, embed_dims, **kw)]),
                                             Linear(embed_dims, embed_dims, **kw)])
        self.fc_reg = Linear(embed_dims, 4, **kw)

    def init_weights(self, gen: torch.Generator):
        """The queries N(0, 1) and the attentions' input projections
        LeCun-normal, as the JAX head's (the FCs are the detector's
        ``init_default_``)."""
        normal_(self.query_embedding.weight, 1.0, gen)
        init_attention(self, gen)

    def forward(self, feats):
        """The maps -> class logits (L, N, Q, C + 1) and boxes (L, N, Q, 4),
        float32, of every decoder layer."""
        x = feats[-1]
        b, _, h, w = x.shape
        x = self.input_proj(x.permute(0, 2, 3, 1)).reshape(b, h * w, self.embed_dims)
        pos = self.positional_encoding(h, w, x.device).reshape(h * w, -1).to(x.dtype)
        dec = self.transformer(x, pos, self.query_embedding.weight.to(x.dtype))
        cls = self.fc_cls(dec).float()
        y = torch.relu(self.reg_ffn.layers[0][0](dec))
        y = torch.relu(self.reg_ffn.layers[1](y))
        return cls, torch.sigmoid(self.fc_reg(y).float())

    def _loss_single(self, cls, boxes, gt_bboxes, gt_valid, gt_labels, factor):
        """One decoder layer on the batch (``:75-116``) -> per-image losses."""
        nc = self.num_classes
        prob = torch.softmax(cls, -1)
        assigned = self.assigner.assign(prob, boxes, gt_bboxes, gt_valid, gt_labels, factor)
        labels = matched_labels(assigned, gt_labels, nc)
        ce = -torch.gather(torch.log_softmax(cls, -1), 2, labels[..., None])[..., 0]
        bg = labels == nc
        cls_w = torch.where(bg, torch.full_like(ce, self.bg_cls_weight), torch.ones_like(ce))
        loss_l1, loss_giou, _, num_pos = box_losses(boxes, assigned, gt_bboxes, factor,
                                                    self.l1_weight, self.giou_weight)
        loss_cls = self.cls_weight * (ce * cls_w).sum(1) / (
            num_pos + (cls_w * bg.float()).sum(1))
        return loss_cls, loss_l1, loss_giou

    def loss(self, outs, gt_bboxes, gt_valid, gt_labels, draws=None, img_shapes=None):
        cls_all, box_all = outs
        return layer_losses(self._loss_single, cls_all, box_all, gt_bboxes, gt_valid,
                            gt_labels, image_factor(img_shapes))

    def get_bboxes(self, outs, img_shapes, scale_factors, rescale: bool = True, cfg=None):
        """-> dets (N, k, 5), labels (N, k), valid (N, k), k =
        ``max_per_img`` (at most Q)."""
        cls, boxes = outs[0][-1], outs[1][-1]
        cfg = dict(cfg or self.test_cfg or {})
        prob = torch.softmax(cls, -1)[..., :self.num_classes]
        scores, labels = prob.max(-1)
        xyxy = cxcywh_to_xyxy(boxes) * image_factor(img_shapes)[:, None]
        if rescale:
            xyxy = xyxy / scale_factors.float().reshape(xyxy.shape[0], -1)[:, None, :4]
        k = min(int(cfg.get("max_per_img", 100)), scores.shape[1])
        top, ti = sort_desc(scores, k)
        dets = torch.cat([_gather_rows(xyxy, ti), top[..., None]], -1)
        return dets, torch.gather(labels, 1, ti), torch.ones_like(top, dtype=torch.bool)


@DETECTORS.register_module()
class DETR(SingleStageDetector):
    """``oadg_tpu/models/dense_heads/detr_head.py:143``: backbone, an
    optional neck, a set-prediction head whose loss reads the images'
    ``img_shape``."""

    def forward_train(self, batch, draws=None):
        with record_function("forward_train: backbone+neck"):
            feats = self.extract_feat(batch["img"])
        with record_function("forward_train: head"):
            outs = self.bbox_head(feats)
        with record_function("forward_train: loss"):
            return self.bbox_head.loss(outs, batch["gt_bboxes"], batch["gt_valid"],
                                       batch["gt_labels"], draws, img_shapes=batch["img_shape"])
