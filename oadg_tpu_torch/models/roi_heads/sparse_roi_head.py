"""Sparse R-CNN and QueryInst (port of
``oadg_tpu/models/roi_heads/sparse_roi_head.py``; mmdet's
``embedding_rpn_head.py``, ``dii_head.py``, ``sparse_roi_head.py``,
``sparse_rcnn.py`` and ``queryinst.py``).

``EmbeddingRPNHead`` (``:30``): ``P`` learned proposals, normalized cxcywh
boxes started at ``[0.5, 0.5, 1, 1]`` and features drawn N(0, 1), scaled by
each image's ``[w, h, w, h]`` of its ``img_shape`` (not of the padded
canvas).

``DIIHead`` (``:58-128``), per stage: self-attention over the proposals
(8 heads; flax's ``MultiHeadDotProductAttention``, written out as mmdet's
``nn.MultiheadAttention`` keys ``attention.attn.in_proj_weight`` and
``.out_proj``), the dynamic instance interaction (two products of each
RoI's 7x7 features, flattened H, W, C, with kernels generated from its
proposal feature, accumulated in float32, each with a LayerNorm and a
ReLU), the FFN, then ``num_cls_fcs`` / ``num_reg_fcs`` bias-free FCs with a
LayerNorm and a ReLU each, ``fc_cls`` (sigmoid classes) and ``fc_reg``.
Every LayerNorm has flax's epsilon 1e-6. Under ``dtype`` the dense layers
compute in it with flax's cast points: the attention's softmax runs in it
(``force_fp32_for_softmax`` is off), the norms in float32, and the dynamic
products in float32 (the RoI features are float32, and the generated
kernels are cast to them).

``SparseRoIHead`` (``:150-268``): ``num_stages`` stages, each RoIAlign at
7x7 (``sampling_ratio`` 2; kernel B1 on the card, B2 in its backward) on
the 4 FPN levels at ``P`` rois an image, then the DII head and the deltas
(``_apply_deltas``: ``dx``, ``dy`` halved, ``dw``, ``dh`` clipped to 4).
Training matches every stage's boxes to the gts (``HungarianAssigner``)
and adds focal (gamma 2, alpha 0.25), L1 (normalized cxcywh) and 1 - GIoU
losses, each over ``max(npos, 1)`` and weighted 2 / 5 / 2, averaged over
the images (under data parallel each rank's share of the global mean),
as ``s{k}.loss_{cls,bbox,iou}``; the boxes are detached between stages.
``simple_test``: the last stage's sigmoid, a flat top-k over P x C
(``jax.lax.top_k``'s order, ties to the lower index), query ``i // C``,
class ``i % C``, boxes over ``scale_factor``; no NMS.

The detectors run no anchor RPN and no NMS. ``QueryInst`` is the same model
with boxes only, as in the JAX package. The classifier's bias starts at 0
(mmdet's at the 0.01 prior; ROADMAP C).

mmdet keys of a stage ``roi_head.bbox_head.{k}``: ``attention.attn``,
``attention_norm``, ``instance_interactive_conv.{dynamic_layer, norm_in,
norm_out, fc_layer}``, ``instance_interactive_conv_norm``,
``ffn.layers.0.0``, ``ffn.layers.1``, ``ffn_norm``, ``cls_fcs.{3i, 3i +
1}``, ``reg_fcs.{3i, 3i + 1}``, ``fc_cls``, ``fc_reg``. The JAX head has no
``instance_interactive_conv.fc_norm`` (mmdet's LayerNorm and ReLU after
``fc_layer``): a checkpoint that holds one is refused
(``utils/checkpoint.py``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.profiler import record_function

from ...core.bbox.geometry import bbox_overlaps
from ...core.bbox.hungarian import HungarianAssigner, xyxy_to_cxcywh
from ...core.post_processing.nms import sort_desc
from ...parallel import shard_sum
from ...utils.registry import DETECTORS, HEADS, ROI_EXTRACTORS, build_from_cfg
from ..detectors.two_stage import TwoStageDetector
from ..layers import Linear, normal_
from ..losses.common import sigmoid_focal_loss
from ..utils.transformer import Attention as _Attention

LN_EPS = 1e-6                   # flax's LayerNorm epsilon


@HEADS.register_module()
class EmbeddingRPNHead(nn.Module):
    """``:30``; ``train_cfg`` and ``test_cfg`` are taken and not read."""

    def __init__(self, num_proposals: int = 100, proposal_feature_channel: int = 256,
                 train_cfg=None, test_cfg=None, init_cfg=None, device=None, dtype=None):
        super().__init__()
        self.num_proposals = num_proposals
        self.init_proposal_bboxes = nn.Embedding(num_proposals, 4, device=device)
        self.init_proposal_features = nn.Embedding(num_proposals, proposal_feature_channel,
                                                   device=device)

    def init_weights(self, gen: torch.Generator):
        with torch.no_grad():
            self.init_proposal_bboxes.weight.copy_(torch.tensor([0.5, 0.5, 1.0, 1.0]))
        normal_(self.init_proposal_features.weight, 1.0, gen)

    def forward(self, img_shape: torch.Tensor):
        """(B, 2) valid (h, w) -> absolute xyxy proposals (B, P, 4) float32
        and their features (B, P, C) float32."""
        boxes = self.init_proposal_bboxes.weight
        cx, cy, w, h = boxes.unbind(-1)
        xyxy = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)
        shp = img_shape.to(device=boxes.device, dtype=torch.float32)
        whwh = torch.stack([shp[:, 1], shp[:, 0], shp[:, 1], shp[:, 0]], -1)
        feats = self.init_proposal_features.weight
        return xyxy[None] * whwh[:, None, :], feats[None].expand(shp.shape[0], -1, -1)


def _ln(channels, device):
    return nn.LayerNorm(channels, eps=LN_EPS, device=device)


class _DynamicConv(nn.Module):
    """mmdet's ``DynamicConv`` without ``fc_norm``: ``dynamic_layer``
    generates each proposal's (C, D) and (D, C) kernels, applied to its
    (r * r, C) RoI features in float32, each product with a LayerNorm
    (``norm_in``, ``norm_out``) and a ReLU, then ``fc_layer`` on the
    flattened (r * r * C) result."""

    def __init__(self, channels: int, dynamic_dim: int, roi_size: int, device=None, dtype=None):
        super().__init__()
        self.dynamic_dim = dynamic_dim
        self.dynamic_layer = Linear(channels, 2 * channels * dynamic_dim, device=device,
                                    dtype=dtype)
        self.norm_in = _ln(dynamic_dim, device)
        self.norm_out = _ln(channels, device)
        self.fc_layer = Linear(roi_size * roi_size * channels, channels, device=device,
                               dtype=dtype)

    def forward(self, x, roi_feats):
        """(B, P, C) proposal features (float32), (B * P, C, r, r) float32
        RoI features -> (B, P, C) in the compute dtype."""
        b, p, c = x.shape
        n = c * self.dynamic_dim
        params = self.dynamic_layer(x)
        rf = roi_feats.flatten(2).transpose(1, 2)                         # (B P, r r, C)
        w1 = params[..., :n].reshape(b * p, c, self.dynamic_dim).to(rf.dtype)
        w2 = params[..., n:].reshape(b * p, self.dynamic_dim, c).to(rf.dtype)
        y = torch.relu(self.norm_in(torch.bmm(rf, w1)))
        y = torch.relu(self.norm_out(torch.bmm(y.to(rf.dtype), w2)))
        return self.fc_layer(y.reshape(b, p, -1).to(x.dtype))


def _fcs(num, channels, device, dtype):
    """``num`` x (bias-free FC, LayerNorm, ReLU), as mmdet's ``cls_fcs``."""
    mods = []
    for _ in range(num):
        mods += [Linear(channels, channels, bias=False, device=device, dtype=dtype),
                 _ln(channels, device), nn.ReLU(inplace=True)]
    return nn.ModuleList(mods)


@HEADS.register_module()
class DIIHead(nn.Module):
    """``:58-128``."""

    def __init__(self, num_classes: int = 80, feat_channels: int = 256,
                 dim_feedforward: int = 2048, num_heads: int = 8, dynamic_dim: int = 64,
                 pooler_resolution: int = 7, num_cls_fcs: int = 1, num_reg_fcs: int = 3,
                 device=None, dtype=None):
        super().__init__()
        c = feat_channels
        kw = dict(device=device, dtype=dtype)
        self.num_classes = num_classes
        self.attention = _Attention(c, num_heads, **kw)
        self.attention_norm = _ln(c, device)
        self.instance_interactive_conv = _DynamicConv(c, dynamic_dim, pooler_resolution, **kw)
        self.instance_interactive_conv_norm = _ln(c, device)
        self.ffn = nn.Module()
        self.ffn.layers = nn.ModuleList([nn.ModuleList([Linear(c, dim_feedforward, **kw)]),
                                         Linear(dim_feedforward, c, **kw)])
        self.ffn_norm = _ln(c, device)
        self.cls_fcs = _fcs(num_cls_fcs, c, device, dtype)
        self.reg_fcs = _fcs(num_reg_fcs, c, device, dtype)
        self.fc_cls = Linear(c, num_classes, **kw)
        self.fc_reg = Linear(c, 4, **kw)

    def init_weights(self, gen: torch.Generator):
        """The attention's input projection LeCun-normal (the FCs are drawn
        by the detector's ``init_default_``)."""
        self.attention.attn.init_weights(gen)

    @staticmethod
    def _branch(fcs, x):
        for i in range(0, len(fcs), 3):
            x = torch.relu(fcs[i + 1](fcs[i](x).float())).to(x.dtype)
        return x

    def forward(self, roi_feats, prop_feats):
        """(B * P, C, r, r) float32 RoI features, (B, P, C) float32 proposal
        features -> class logits (B, P, classes) float32, deltas (B, P, 4)
        float32, the new proposal features (B, P, C)."""
        x = prop_feats
        x = self.attention_norm((x + self.attention(x)).float()).to(prop_feats.dtype)
        y = self.instance_interactive_conv(x, roi_feats)
        x = self.instance_interactive_conv_norm((x + y).float()).to(prop_feats.dtype)
        f = self.ffn.layers[1](torch.relu(self.ffn.layers[0][0](x)))
        x = self.ffn_norm((x + f).float()).to(prop_feats.dtype)
        cls = self.fc_cls(self._branch(self.cls_fcs, x)).float()
        delta = self.fc_reg(self._branch(self.reg_fcs, x)).float()
        return cls, delta, x


def apply_deltas(boxes: torch.Tensor, deltas: torch.Tensor) -> torch.Tensor:
    """``_apply_deltas`` (``:131-146``): xyxy boxes moved in cxcywh by
    ``dx / 2``, ``dy / 2`` (of the width and height) and scaled by
    ``exp(clip(dw, -4, 4))``, ``exp(clip(dh, -4, 4))``."""
    cx = (boxes[..., 0] + boxes[..., 2]) * 0.5
    cy = (boxes[..., 1] + boxes[..., 3]) * 0.5
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    ncx = cx + deltas[..., 0] / 2.0 * w
    ncy = cy + deltas[..., 1] / 2.0 * h
    nw = w * torch.exp(deltas[..., 2].clamp(-4.0, 4.0))
    nh = h * torch.exp(deltas[..., 3].clamp(-4.0, 4.0))
    return torch.stack([ncx - nw / 2, ncy - nh / 2, ncx + nw / 2, ncy + nh / 2], -1)


@HEADS.register_module()
class SparseRoIHead(nn.Module):
    """``:150-268``. ``train_cfg`` and ``num_views`` are taken and not read:
    every image of the batch is matched to its gts."""

    def __init__(self, num_stages: int = 6, stage_loss_weights=(1.0,) * 6,
                 proposal_feature_channel: int = 256, bbox_roi_extractor=None, bbox_head=None,
                 mask_head=None, train_cfg=None, test_cfg=None, num_views: int = 1,
                 cls_weight: float = 2.0, l1_weight: float = 5.0, giou_weight: float = 2.0,
                 device=None, dtype=None):
        super().__init__()
        if mask_head:
            raise ValueError("SparseRoIHead: the JAX head builds no mask branch (QueryInst "
                             "serves boxes only); remove mask_head")
        bh = dict(bbox_head or {})
        bh.pop("type", None)
        bh.setdefault("feat_channels", proposal_feature_channel)
        self.bbox_head = nn.ModuleList(DIIHead(**bh, device=device, dtype=dtype)
                                       for _ in range(num_stages))
        ext = dict(bbox_roi_extractor or {})
        layer = dict(ext.get("roi_layer", dict(output_size=7)))
        self.bbox_roi_extractor = build_from_cfg(
            dict(type="SingleRoIExtractor",
                 roi_layer=dict(output_size=int(layer.get("output_size", 7)), sampling_ratio=2),
                 featmap_strides=tuple(ext.get("featmap_strides", (4, 8, 16, 32))),
                 finest_scale=int(ext.get("finest_scale", 56))), ROI_EXTRACTORS,
            dict(device=device))
        self.stage_loss_weights = [float(w) for w in stage_loss_weights]
        self.cls_weight, self.l1_weight, self.giou_weight = cls_weight, l1_weight, giou_weight
        self.assigner = HungarianAssigner(cls_cost=dict(weight=cls_weight),
                                          reg_cost=dict(weight=l1_weight),
                                          iou_cost=dict(weight=giou_weight))
        self.test_cfg = dict(test_cfg or {})

    @property
    def num_classes(self) -> int:
        return self.bbox_head[-1].num_classes

    def init_weights(self, gen: torch.Generator):
        for head in self.bbox_head:
            head.init_weights(gen)

    def _stage(self, head, feats, boxes, prop_feats):
        """One stage on (B, P, 4) boxes -> logits, refined boxes, features."""
        b, p = boxes.shape[:2]
        bidx = torch.arange(b, dtype=boxes.dtype, device=boxes.device).repeat_interleave(p)
        rois = torch.cat([bidx[:, None], boxes.reshape(b * p, 4)], 1)
        cls, delta, prop_feats = head(self.bbox_roi_extractor(feats, rois), prop_feats)
        return cls, apply_deltas(boxes, delta), prop_feats

    def stage_loss(self, cls, boxes, gt, gt_valid, gt_labels, img_shapes):
        """``_stage_loss`` (``:198-221``) of every image: (B, P, C) logits and
        (B, P, 4) boxes against the gts -> the per-image (cls, L1, GIoU)
        losses, each (B,)."""
        nc = cls.shape[-1]
        shp = img_shapes.to(device=cls.device, dtype=torch.float32)
        factor = torch.stack([shp[:, 1], shp[:, 0], shp[:, 1], shp[:, 0]], -1)
        prob = torch.sigmoid(cls)
        probp = torch.cat([prob, torch.zeros_like(prob[..., :1])], -1)
        bnorm = xyxy_to_cxcywh(boxes / factor[:, None])
        assigned = self.assigner.assign(probp.detach(), bnorm.detach(), gt, gt_valid,
                                        gt_labels, factor)
        pos = assigned > 0
        gi = (assigned - 1).clamp(0, gt.shape[1] - 1)
        labels = torch.where(pos, torch.gather(gt_labels.long(), 1, gi),
                             torch.full_like(gi, nc))
        onehot = F.one_hot(labels, nc + 1)[..., :nc].float()
        lcls = sigmoid_focal_loss(cls, onehot, 2.0, 0.25).sum((1, 2))
        tgt = torch.gather(gt, 1, gi[..., None].expand(-1, -1, 4))
        tnorm = xyxy_to_cxcywh(tgt / factor[:, None])
        posf = pos.float()
        l1 = (bnorm - tnorm).abs().sum(-1) * posf
        lgiou = (1 - bbox_overlaps(boxes, tgt, mode="giou", is_aligned=True)) * posf
        npos = posf.sum(1).clamp(min=1.0)
        return (self.cls_weight * lcls / npos, self.l1_weight * l1.sum(1) / npos,
                self.giou_weight * lgiou.sum(1) / npos)

    def loss(self, feats, proposals, prop_valid, gt_bboxes, gt_valid, gt_labels, draws,
             prop_feats=None, img_shapes=None, **kw):
        """Every stage's ``s{k}.loss_{cls,bbox,iou}`` (``:223-239``)."""
        boxes, pf = proposals, prop_feats
        n = shard_sum(torch.tensor(float(boxes.shape[0]), device=boxes.device))
        losses = {}
        for k, head in enumerate(self.bbox_head):
            with record_function(f"forward_train: sparse stage {k}"):
                cls, new_boxes, pf = self._stage(head, feats, boxes, pf)
                lc, l1, lg = self.stage_loss(cls, new_boxes, gt_bboxes, gt_valid, gt_labels,
                                             img_shapes)
                w = self.stage_loss_weights[k]
                losses[f"s{k}.loss_cls"] = lc.sum() / n * w
                losses[f"s{k}.loss_bbox"] = l1.sum() / n * w
                losses[f"s{k}.loss_iou"] = lg.sum() / n * w
                boxes = new_boxes.detach()
        return losses

    def simple_test(self, feats, proposals, prop_valid, img_shapes, scale_factors,
                    prop_feats=None, rescale: bool = True):
        """-> dets (B, max_per_img, 5), labels (B, max_per_img), valid (the
        score above 0) (``:241-268``)."""
        boxes, pf = proposals, prop_feats
        for head in self.bbox_head:
            cls, boxes, pf = self._stage(head, feats, boxes, pf)
        prob = torch.sigmoid(cls)
        b, p, nc = prob.shape
        k = min(int(self.test_cfg.get("max_per_img", 100)), p * nc)
        top, ti = sort_desc(prob.reshape(b, -1), k)
        bsel = torch.gather(boxes, 1, (ti // nc)[..., None].expand(-1, -1, 4))
        if rescale:
            bsel = bsel / scale_factors.to(bsel)[:, None, :4]
        return torch.cat([bsel, top[..., None]], -1), ti % nc, top > 0.0


@DETECTORS.register_module()
class SparseRCNN(TwoStageDetector):
    """``:271-296``: the learned proposals into the sparse head."""

    def forward_train(self, batch, draws):
        with record_function("forward_train: backbone+neck"):
            feats = self.extract_feat(batch["img"])
        boxes, pf = self.rpn_head(batch["img_shape"])
        with record_function("forward_train: roi head+loss"):
            return self.roi_head.loss(feats, boxes, None, batch["gt_bboxes"], batch["gt_valid"],
                                      batch["gt_labels"], draws, prop_feats=pf,
                                      img_shapes=batch["img_shape"])

    def simple_test(self, batch, rescale: bool = True):
        img = batch["img"]
        feats = self.extract_feat(img)
        boxes, pf = self.rpn_head(batch["img_shape"])
        sf = batch.get("scale_factor")
        if sf is None:
            sf = torch.ones((img.shape[0], 4), device=img.device)
        return self.roi_head.simple_test(feats, boxes, None, batch["img_shape"], sf,
                                         prop_feats=pf, rescale=rescale)

    def aug_test(self, views, metas):
        raise ValueError("test-time augmentation of a Sparse R-CNN: the reference's aug_test "
                         "runs an anchor RPN and one box head, which it lacks")


@DETECTORS.register_module()
class QueryInst(SparseRCNN):
    """``:298``: Sparse R-CNN's model, boxes only."""
