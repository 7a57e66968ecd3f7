"""Deformable DETR head and detector (port of
``oadg_tpu/models/dense_heads/deformable_detr_head.py``).

``MSDeformAttention`` (``:29``): per query ``num_heads x levels x points``
sampling offsets and attention weights (the softmax over ``levels x
points`` in float32), one ``value_proj.{l}`` per level (mmdet shares one
``value_proj``; ROADMAP C), each sample at the reference point in pixels of
its level plus its offset times ``w / (2 * points)`` and ``h / (2 *
points)`` (``:61-64``), read bilinearly with zeros outside the map (JAX's
``ops/deform_conv.py:30`` ``bilinear_gather`` at ``x - 0.5``, pixel centres
at integers), weighted and summed in float32, then ``output_proj``. The
sampling runs in float32 in either dtype: a bfloat16 grid would place the
samples up to a quarter pixel off at 128 columns (JAX forms the positions
and floors in float32 and rounds only the corner weights and values). The
samples are one ``F.grid_sample`` a level with the heads folded into the
batch (``align_corners=False``, ``padding_mode='zeros'``: the normalized
``2 * x / w - 1`` lands on ``x - 0.5``), so that autograd keeps the value
map, the grid and the sampled values, not four corners and their weights
(43,008 tokens an image at 1024x2048). The JAX package computes this in XLA,
not Pallas: there is no kernel to write.

``DeformableDETRHead`` (``:145``): the last ``num_levels`` maps flattened
to tokens with the sine positions plus ``transformer.level_embeds[l]``
added once (mmdet adds the positions in every layer; ROADMAP C), encoder
reference points at the cell centres (x tiled, y repeated), the
post-norm deformable encoder (``_LN``: float32 LayerNorms, epsilon 1e-6,
cast back); ``query_embedding`` (Q, 2C) split into the query positions and
the first target, the reference points ``sigmoid(reference_points(query
positions))``; each decoder layer self-attends with ``target + position``
as query, key and value (``:120-123``), cross-attends deformably, and on
its output ``cls_branches.{i}`` (per-layer classifiers, zero-started; mmdet
shares one) and ``reg_branches.{i}`` (three FCs) give logits and boxes
``sigmoid(delta_xy + logit(ref))``, ``sigmoid(delta_wh - 2)``
(the reference points stay fixed: ``with_box_refine=True`` is refused).

- ``loss``: per layer the Hungarian assignment of the sigmoid probabilities
  with a zero background column; the focal loss (gamma 2, alpha 0.25) summed
  over queries and classes over ``num_pos``, times ``cls_weight``; L1 and
  1 - GIoU as DETR's; each the mean over the images.
- ``get_bboxes``: the top ``max_per_img`` of the Q x C sigmoid scores, query
  ``i // C``, class ``i % C``; valid where the score is above 0.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...core.bbox.hungarian import HungarianAssigner, cxcywh_to_xyxy
from ...core.post_processing.nms import sort_desc
from ...utils.registry import DETECTORS, HEADS
from ..layers import Linear, normal_
from ..losses.common import sigmoid_focal_loss
from ..utils.transformer import (FFN, Attention, LayerStack, SinePositionalEncoding,
                                 init_attention, layer_norm, ln)
from .detr_head import (DETR, _gather_rows, box_losses, image_factor, layer_losses,
                        matched_labels)


def sample_levels(values, shapes, ref, offsets, weights, num_points):
    """The deformable sampling of every level (``:53-71``).

    Args:
        values: per level (B, H_l * W_l, heads, D) projected values.
        shapes: per level (H_l, W_l).
        ref: (B, Q, 2) float32 normalized reference points (x, y).
        offsets: (B, Q, heads, levels, points, 2) float32.
        weights: (B, Q, heads, levels, points) float32 softmax weights.

    Returns (B, Q, heads * D) float32.
    """
    b, q, nh = offsets.shape[:3]
    out = None
    for li, (v, (h, w)) in enumerate(zip(values, shapes)):
        d = v.shape[-1]
        val = v.permute(0, 2, 3, 1).reshape(b * nh, d, h, w).float()
        sx = ref[:, :, None, None, 0] * w + offsets[:, :, :, li, :, 0] * (w / (2.0 * num_points))
        sy = ref[:, :, None, None, 1] * h + offsets[:, :, :, li, :, 1] * (h / (2.0 * num_points))
        grid = torch.stack([2 * sx / w - 1, 2 * sy / h - 1], -1)      # (B, Q, nh, P, 2)
        grid = grid.permute(0, 2, 1, 3, 4).reshape(b * nh, q, num_points, 2)
        taps = F.grid_sample(val, grid, mode="bilinear", padding_mode="zeros",
                             align_corners=False)                    # (B * nh, D, Q, P)
        wl = weights[:, :, :, li].permute(0, 2, 1, 3).reshape(b * nh, 1, q, num_points)
        part = (taps * wl).sum(-1)                                   # (B * nh, D, Q)
        out = part if out is None else out + part
    return out.reshape(b, nh * out.shape[1], q).transpose(1, 2)


class MSDeformAttention(nn.Module):
    """``:29``: keys ``sampling_offsets``, ``attention_weights``,
    ``value_proj.{l}``, ``output_proj``."""

    def __init__(self, embed_dims: int = 256, num_heads: int = 8, num_levels: int = 4,
                 num_points: int = 4, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.num_heads, self.num_levels, self.num_points = num_heads, num_levels, num_points
        self.sampling_offsets = Linear(embed_dims, num_heads * num_levels * num_points * 2, **kw)
        self.attention_weights = Linear(embed_dims, num_heads * num_levels * num_points, **kw)
        self.value_proj = nn.ModuleList(Linear(embed_dims, embed_dims, **kw)
                                        for _ in range(num_levels))
        self.output_proj = Linear(embed_dims, embed_dims, **kw)

    def forward(self, query, ref_points, tokens, shapes):
        """query (B, Q, C), ref_points (B, Q, 2) normalized, the value
        tokens (B, sum H_l W_l, C) of the levels ``shapes`` -> (B, Q, C)."""
        b, q, c = query.shape
        nh, nl, npt = self.num_heads, len(shapes), self.num_points
        off = self.sampling_offsets(query).reshape(b, q, nh, nl, npt, 2).float()
        att = torch.softmax(self.attention_weights(query).reshape(b, q, nh, nl * npt).float(),
                            -1).reshape(b, q, nh, nl, npt)
        values, start = [], 0
        for li, (h, w) in enumerate(shapes):
            v = self.value_proj[li](tokens[:, start:start + h * w])
            values.append(v.reshape(b, h * w, nh, c // nh))
            start += h * w
        out = sample_levels(values, shapes, ref_points.float(), off, att, npt)
        return self.output_proj(out.to(query.dtype))


def _norm(norm, x, dtype):
    """``_LN`` (``:77``): a float32 LayerNorm cast to the compute dtype."""
    return layer_norm(norm, x.float()).to(dtype or x.dtype)


class DeformableEncoderLayer(nn.Module):
    """``:86``: keys ``attentions.0``, ``ffns.0``, ``norms.{0,1}``."""

    def __init__(self, embed_dims, num_heads, num_levels, num_points, ffn_dims, device=None,
                 dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.dtype = dtype
        self.attentions = nn.ModuleList([MSDeformAttention(embed_dims, num_heads, num_levels,
                                                           num_points, **kw)])
        self.ffns = nn.ModuleList([FFN(embed_dims, ffn_dims, **kw)])
        self.norms = nn.ModuleList([ln(embed_dims, device) for _ in range(2)])

    def forward(self, tokens, ref_points, shapes):
        y = self.attentions[0](tokens, ref_points, tokens, shapes)
        x = _norm(self.norms[0], tokens + y, self.dtype)
        return _norm(self.norms[1], self.ffns[0](x), self.dtype)


class DeformableDecoderLayer(nn.Module):
    """``:108``: keys ``attentions.0`` (self-attention), ``attentions.1``
    (deformable cross-attention), ``ffns.0``, ``norms.{0,1,2}``."""

    def __init__(self, embed_dims, num_heads, num_levels, num_points, ffn_dims, device=None,
                 dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.dtype = dtype
        self.attentions = nn.ModuleList([
            Attention(embed_dims, num_heads, **kw),
            MSDeformAttention(embed_dims, num_heads, num_levels, num_points, **kw)])
        self.ffns = nn.ModuleList([FFN(embed_dims, ffn_dims, **kw)])
        self.norms = nn.ModuleList([ln(embed_dims, device) for _ in range(3)])

    def forward(self, tgt, query_pos, ref_points, memory, shapes):
        q = tgt + query_pos
        x = _norm(self.norms[0], tgt + self.attentions[0](q, q, q), self.dtype)
        ca = self.attentions[1](x + query_pos, ref_points, memory, shapes)
        x = _norm(self.norms[1], x + ca, self.dtype)
        return _norm(self.norms[2], self.ffns[0](x), self.dtype)


@HEADS.register_module()
class DeformableDETRHead(nn.Module):

    def __init__(self, num_classes: int = 80, num_query: int = 300, embed_dims: int = 256, num_heads: int = 8, num_encoder_layers: int = 6,
                 num_decoder_layers: int = 6, num_points: int = 4,
                 feedforward_channels: int = 1024, with_box_refine: bool = False,
                 cls_weight: float = 2.0, l1_weight: float = 5.0, giou_weight: float = 2.0,
                 num_levels: int = 4, train_cfg=None, test_cfg=None, num_views: int = 1,
                 device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.num_classes, self.num_query, self.embed_dims = num_classes, num_query, embed_dims
        self.num_levels = num_levels
        if with_box_refine:
            raise ValueError("DeformableDETRHead(with_box_refine=True) is not ported: the JAX "
                             "head's reference points stay fixed, as with_box_refine=False")
        self.cls_weight = float(cls_weight)
        self.l1_weight, self.giou_weight = float(l1_weight), float(giou_weight)
        self.test_cfg = dict(test_cfg or {})
        asn = dict(dict(train_cfg or {}).get("assigner") or {})
        asn.pop("type", None)
        self.assigner = HungarianAssigner(**asn)
        self.positional_encoding = SinePositionalEncoding(embed_dims // 2)
        layer = dict(embed_dims=embed_dims, num_heads=num_heads, num_levels=num_levels,
                     num_points=num_points, ffn_dims=feedforward_channels, **kw)
        self.transformer = nn.Module()
        self.transformer.encoder = LayerStack([DeformableEncoderLayer(**layer)
                                           for _ in range(num_encoder_layers)])
        self.transformer.decoder = LayerStack([DeformableDecoderLayer(**layer)
                                           for _ in range(num_decoder_layers)])
        self.transformer.level_embeds = nn.Parameter(torch.zeros(4, embed_dims, device=device))
        self.transformer.reference_points = Linear(embed_dims, 2, **kw)
        self.query_embedding = nn.Embedding(num_query, 2 * embed_dims, device=device)
        self.cls_branches = nn.ModuleList(Linear(embed_dims, num_classes, **kw)
                                          for _ in range(num_decoder_layers))
        self.reg_branches = nn.ModuleList(
            nn.Sequential(Linear(embed_dims, embed_dims, **kw), nn.ReLU(),
                          Linear(embed_dims, embed_dims, **kw), nn.ReLU(),
                          Linear(embed_dims, 4, **kw))
            for _ in range(num_decoder_layers))

    def init_weights(self, gen: torch.Generator):
        """The queries and level embeddings N(0, 1), the self-attentions'
        input projections LeCun-normal, as the JAX head's; the classifiers'
        biases at 0 (mmdet's at the 0.01 prior)."""
        normal_(self.query_embedding.weight, 1.0, gen)
        normal_(self.transformer.level_embeds, 1.0, gen)
        init_attention(self, gen)

    def _tokens(self, feats):
        """The levels' tokens (B, N, C) with the positions and level
        embeddings, the encoder's reference points (B, N, 2), the shapes."""
        b = feats[0].shape[0]
        toks, refs, shapes = [], [], []
        for li, f in enumerate(feats):
            h, w = f.shape[2:]
            pos = self.positional_encoding(h, w, f.device).reshape(h * w, self.embed_dims)
            t = f.flatten(2).transpose(1, 2)
            toks.append(t + (pos + self.transformer.level_embeds[li]).to(t.dtype))
            ys = (torch.arange(h, dtype=torch.float32, device=f.device) + 0.5) / h
            xs = (torch.arange(w, dtype=torch.float32, device=f.device) + 0.5) / w
            refs.append(torch.stack([xs.repeat(h), ys.repeat_interleave(w)], -1))
            shapes.append((h, w))
        tokens = torch.cat(toks, 1)
        return tokens, torch.cat(refs, 0)[None].expand(b, -1, -1), shapes

    def forward(self, feats):
        """The maps -> class logits (L, N, Q, C) and boxes (L, N, Q, 4),
        float32, of every decoder layer."""
        tokens, enc_refs, shapes = self._tokens(list(feats[-self.num_levels:]))
        for layer in self.transformer.encoder.layers:
            tokens = layer(tokens, enc_refs, shapes)
        b, e = tokens.shape[0], self.embed_dims
        qe = self.query_embedding.weight
        query_pos = qe[None, :, :e].expand(b, -1, -1).to(tokens.dtype)
        tgt = qe[None, :, e:].expand(b, -1, -1).to(tokens.dtype)
        ref = torch.sigmoid(self.transformer.reference_points(query_pos).float())
        cls_all, box_all = [], []
        for i, layer in enumerate(self.transformer.decoder.layers):
            tgt = layer(tgt, query_pos, ref, tokens, shapes)
            cls_all.append(self.cls_branches[i](tgt).float())
            delta = self.reg_branches[i](tgt).float()
            ref_logit = torch.log(ref.clamp(1e-6, 1 - 1e-6) / (1 - ref).clamp(min=1e-6))
            xy = torch.sigmoid(delta[..., :2] + ref_logit)
            wh = torch.sigmoid(delta[..., 2:] - 2.0)
            boxes = torch.cat([xy, wh], -1)
            box_all.append(boxes)
        return torch.stack(cls_all), torch.stack(box_all)

    def _loss_single(self, cls, boxes, gt_bboxes, gt_valid, gt_labels, factor):
        prob = torch.sigmoid(cls)
        probp = torch.cat([prob, torch.zeros_like(prob[..., :1])], -1)
        assigned = self.assigner.assign(probp, boxes, gt_bboxes, gt_valid, gt_labels, factor)
        labels = matched_labels(assigned, gt_labels, self.num_classes)
        onehot = F.one_hot(labels, self.num_classes + 1)[..., :self.num_classes].to(cls.dtype)
        loss_l1, loss_giou, _, num_pos = box_losses(boxes, assigned, gt_bboxes, factor,
                                                    self.l1_weight, self.giou_weight)
        loss_cls = self.cls_weight * sigmoid_focal_loss(cls, onehot, 2.0, 0.25).sum((1, 2)) \
            / num_pos
        return loss_cls, loss_l1, loss_giou

    def loss(self, outs, gt_bboxes, gt_valid, gt_labels, draws=None, img_shapes=None):
        cls_all, box_all = outs
        return layer_losses(self._loss_single, cls_all, box_all, gt_bboxes, gt_valid,
                            gt_labels, image_factor(img_shapes))

    def get_bboxes(self, outs, img_shapes, scale_factors, rescale: bool = True, cfg=None):
        """-> dets (N, k, 5), labels (N, k), valid (N, k) (score > 0), k =
        ``max_per_img`` (at most Q x C)."""
        cls, boxes = outs[0][-1], outs[1][-1]
        cfg = dict(cfg or self.test_cfg or {})
        nc = self.num_classes
        prob = torch.sigmoid(cls).flatten(1)
        k = min(int(cfg.get("max_per_img", 100)), prob.shape[1])
        top, ti = sort_desc(prob, k)
        qi = torch.div(ti, nc, rounding_mode="floor")
        xyxy = cxcywh_to_xyxy(_gather_rows(boxes, qi)) * image_factor(img_shapes)[:, None]
        if rescale:
            xyxy = xyxy / scale_factors.float().reshape(xyxy.shape[0], -1)[:, None, :4]
        return torch.cat([xyxy, top[..., None]], -1), ti % nc, top > 0.0


@DETECTORS.register_module()
class DeformableDETR(DETR):
    """``:314``: DETR's detector; the head takes as many levels as the neck
    gives (``ChannelMapper``'s inputs, or the backbone's outputs without a
    neck), at most 4, as the JAX head's ``feats[-4:]``."""

    def __init__(self, backbone, neck=None, bbox_head=None, **kwargs):
        levels = len(neck["in_channels"]) if neck else len(backbone.get("out_indices", (3,)))
        super().__init__(backbone, neck, dict(bbox_head, num_levels=min(levels, 4)), **kwargs)
