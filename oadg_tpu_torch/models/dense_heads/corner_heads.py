"""CornerNet's and CentripetalNet's heads and the ``CornerNet`` detector
(port of ``oadg_tpu/models/dense_heads/corner_heads.py``; the JAX package
serves CentripetalNet with the CornerNet detector, as mmdet does).

Per stack of the Hourglass (``num_feat_levels`` of them, the last ones)
two ``CascadeCornerPool``s (``tl_pool.i``, ``br_pool.i``) and, on each
pooled map, branches of a 3x3 conv, a ReLU and a 1x1 conv (mmdet's
``_make_layers``: ``tl_heat.i.0`` / ``.1``): the corner heatmaps' logits
(C), CornerNet's embeddings (``tl_emb``, ``br_emb``: 1 channel) or
CentripetalNet's centripetal shifts (``tl_centripetal_shift``: 2) and the
sub-cell offsets (``tl_off``: 2), all float32. Every conv LeCun-normal with
a zero bias, the heatmaps' too (mmdet starts them at a 0.1 prior; ROADMAP
C).

- ``CascadeCornerPool`` (``:62-82``): two 3x3 ``ConvModule``s with a live
  BN and a ReLU (``direction1_conv``, ``direction2_conv``), each pooled
  toward one border (``ops.misc_ops.corner_pool``: top and left, or bottom
  and right), summed, a 3x3 ``ConvModule`` with BN (``aftpool_conv``) plus
  a 1x1 one (``conv1``), then a ReLU. mmdet's ``BiCornerPool`` has a 3x3
  ``conv2`` after it, which the JAX pool lacks; its direction convs have
  128 channels (ROADMAP C).
- Targets (``:137-145``): each gt's corners at ``corner / 4`` without
  rounding, the corner head's own ``gaussian_radius`` (``:28``: each case's
  smaller root, without mmdet's ``/ a``), a gaussian of sigma ``max(2 r +
  1, 1) / 6`` over the whole map (no eps cut), masked where the gt is
  padding, each into its class plane with an ``amax`` reduction (equal bit
  for bit to JAX's (H, W, G, C) product max, which the port never forms).
  ``GaussianFocalLoss`` counts a cell positive only where its target is
  exactly 1: a corner off the stride-4 grid gives none (ROADMAP C).
- ``loss`` (``:147-188``, ``:299-346``), over every stack: per image the
  ``GaussianFocalLoss`` of both heatmaps' sigmoids, each a mean over every
  cell and class (no ``avg_factor``); CornerNet's
  ``AssociativeEmbeddingLoss`` of the embeddings read at each gt's corner
  cells (``int`` truncation); CentripetalNet's L1 of the shifts against
  ``log(max(centre - corner, 1e-4))``; the offsets' L1 against the
  corners' fractions; the shift and offset L1s over ``2 x`` the image's
  gts. Each is the mean over the images (of every rank's under data
  parallel), under ``l{i}.loss_heatmap``, ``l{i}.loss_pull``,
  ``l{i}.loss_push`` (or ``l{i}.loss_centripetal``) and ``l{i}.loss_offset``.
- ``get_bboxes`` (``:190-243``, ``:348-386``), on the last stack: the top
  ``corner_topk`` (K) of each heatmap's sigmoids over (H, W, C) (ties to the
  lower index), the K x K pairs of one class with the bottom-right corner
  below and right of the top-left one, CornerNet's with embeddings closer
  than ``distance_threshold``, CentripetalNet's with both shifted centres
  within ``0.3`` of the pair's width and height of each other (the fixed
  ``mu``; the JAX head has no guiding-shift feature adaption, ROADMAP C),
  scored by the mean of both corners (0 for any other pair), then the top
  ``max_per_img`` pairs (ties to the lower index); no NMS.
"""
from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from ...core.post_processing.nms import sort_desc
from ...ops.misc_ops import corner_pool
from ...utils.registry import DETECTORS, HEADS, LOSSES, build_from_cfg
from ..detectors.single_stage import SingleStageDetector
from ..layers import ConvModule
from ..utils.misc import class_planes, gaussian_maps, images_mean, radius_cases

IMG_STRIDE = 4.0
_BN = dict(type="BN")


def gaussian_radius(h: torch.Tensor, w: torch.Tensor, min_overlap: float = 0.3) -> torch.Tensor:
    """The corner head's radius (``corner_heads.py:28``): each case's
    smaller root ``(b - sqrt(max(b^2 - 4ac, 0))) / 2`` (the third's
    larger), their least, at least 0; mmdet divides by ``2a``, which this
    does not."""
    (b1, d1), (b2, d2), (b3, d3) = radius_cases(h, w, min_overlap)
    zero = torch.zeros((), dtype=d1.dtype, device=d1.device)
    r1 = (b1 - torch.sqrt(torch.maximum(d1, zero))) / 2
    r2 = (b2 - torch.sqrt(torch.maximum(d2, zero))) / 2
    r3 = (b3 + torch.sqrt(torch.maximum(d3, zero))) / 2
    return torch.maximum(torch.minimum(torch.minimum(r1, r2), r3), zero)


class CascadeCornerPool(nn.Module):
    """``corner_heads.py:62``: ``relu(aftpool_conv(pool1(direction1_conv(x))
    + pool2(direction2_conv(x))) + conv1(x))``."""

    def __init__(self, channels: int, directions, device=None, dtype=None):
        super().__init__()
        kw = dict(norm_cfg=_BN, device=device, dtype=dtype)
        self.directions = tuple(directions)
        self.direction1_conv = ConvModule(channels, channels, 3, 1, 1, act="relu", **kw)
        self.direction2_conv = ConvModule(channels, channels, 3, 1, 1, act="relu", **kw)
        self.aftpool_conv = ConvModule(channels, channels, 3, 1, 1, **kw)
        self.conv1 = ConvModule(channels, channels, 1, 1, 0, **kw)

    def forward(self, x):
        d1, d2 = self.directions
        p = (corner_pool(self.direction1_conv(x), d1)
             + corner_pool(self.direction2_conv(x), d2))
        return torch.relu(self.aftpool_conv(p) + self.conv1(x))


def _branches(n: int, channels: int, out: int, device, dtype) -> nn.ModuleList:
    kw = dict(device=device, dtype=dtype)
    return nn.ModuleList(nn.Sequential(ConvModule(channels, channels, 3, 1, 1, act="relu", **kw),
                                       ConvModule(channels, out, 1, 1, 0, **kw))
                         for _ in range(n))


def _at(m: torch.Tensor, iy: torch.Tensor, ix: torch.Tensor) -> torch.Tensor:
    """(N, K, H, W) maps read at (N, G) cells -> (N, G, K)."""
    n, k, _, w = m.shape
    cell = (iy * w + ix)[:, None].expand(n, k, iy.shape[1])
    return torch.gather(m.flatten(2), 2, cell).transpose(1, 2)


def _top(heat: torch.Tensor, k: int):
    """The top ``k`` sigmoids of (N, C, H, W) logits over (H, W, C) -> the
    scores, classes and cells (y, x) (N, k)."""
    n, c, _, w = heat.shape
    scores, idx = sort_desc(torch.sigmoid(heat).permute(0, 2, 3, 1).reshape(n, -1), k)
    pos = idx // c
    return scores, idx % c, pos // w, pos % w


@HEADS.register_module()
class CornerHead(nn.Module):

    def __init__(self, num_classes: int = 80, in_channels: int = 256, num_feat_levels: int = 2,
                 corner_emb_channels: int = 1, train_cfg=None, test_cfg=None, num_views: int = 1,
                 device=None, dtype=None):
        super().__init__()
        self.num_classes = num_classes
        self.num_feat_levels = num_feat_levels
        self.test_cfg = dict(test_cfg or {})
        kw = dict(device=device, dtype=dtype)
        n, c = num_feat_levels, in_channels
        self.tl_pool = nn.ModuleList(CascadeCornerPool(c, ("top", "left"), **kw) for _ in range(n))
        self.br_pool = nn.ModuleList(CascadeCornerPool(c, ("bottom", "right"), **kw)
                                     for _ in range(n))
        self.tl_heat = _branches(n, c, num_classes, **kw)
        self.br_heat = _branches(n, c, num_classes, **kw)
        self._init_pair_branches(n, c, corner_emb_channels, kw)
        self.tl_off = _branches(n, c, 2, **kw)
        self.br_off = _branches(n, c, 2, **kw)
        self.heat_loss = build_from_cfg(dict(type="GaussianFocalLoss", alpha=2.0, gamma=4.0,
                                             loss_weight=1.0), LOSSES)
        self.emb_loss = build_from_cfg(dict(type="AssociativeEmbeddingLoss"), LOSSES)

    def _init_pair_branches(self, n, c, emb, kw):
        self.tl_emb = _branches(n, c, emb, **kw)
        self.br_emb = _branches(n, c, emb, **kw)

    def _pair_branches(self, i):
        return self.tl_emb[i], self.br_emb[i]

    def init_weights(self, gen: torch.Generator):
        """The model's default (``init_default_``), as the JAX head's."""

    def forward(self, feats):
        """Per stack a dict of (N, K, H, W) float32 maps: ``tl_heat``,
        ``br_heat`` (logits), ``tl_emb``, ``br_emb`` (CentripetalNet's
        shifts), ``tl_off``, ``br_off``."""
        outs = []
        for i, x in enumerate(feats[-self.num_feat_levels:]):
            tl = self.tl_pool[i](x)
            br = self.br_pool[i](x)
            tl_pair, br_pair = self._pair_branches(i)
            outs.append(dict(tl_heat=self.tl_heat[i](tl).float(),
                             br_heat=self.br_heat[i](br).float(),
                             tl_emb=tl_pair(tl).float(), br_emb=br_pair(br).float(),
                             tl_off=self.tl_off[i](tl).float(), br_off=self.br_off[i](br).float()))
        return outs

    def corner_targets(self, gt, gt_valid, gt_labels, h: int, w: int):
        """(N, G, 4) gts -> the top-left and bottom-right heatmaps (N, C, H,
        W) and the corners in cells (x1, y1, x2, y2), each (N, G)."""
        x1, y1, x2, y2 = (gt[..., i] / IMG_STRIDE for i in range(4))
        sigma = torch.clamp_min(2 * gaussian_radius(y2 - y1, x2 - x1) + 1, 1.0) / 6
        heats = []
        for cx, cy in ((x1, y1), (x2, y2)):
            g = gaussian_maps(cx, cy, sigma, h, w)
            g = torch.where(gt_valid[..., None, None], g, torch.zeros_like(g))
            heats.append(class_planes(g, gt_labels, self.num_classes))
        return heats[0], heats[1], (x1, y1, x2, y2)

    def _common(self, o, gt, gt_valid, gt_labels):
        """A stack's heatmap loss per image, the corners, their cells and
        the offsets' L1 per image."""
        h, w = o["tl_heat"].shape[-2:]
        with torch.no_grad():
            tl_t, br_t, (x1, y1, x2, y2) = self.corner_targets(gt, gt_valid, gt_labels, h, w)
            xi1, yi1 = x1.long().clamp(0, w - 1), y1.long().clamp(0, h - 1)
            xi2, yi2 = x2.long().clamp(0, w - 1), y2.long().clamp(0, h - 1)
            gv = gt_valid.float()[..., None]
            ng2 = 2 * torch.clamp_min(gt_valid.float().sum(1), 1.0)
            t_tl = torch.stack([x1 - xi1, y1 - yi1], -1)
            t_br = torch.stack([x2 - xi2, y2 - yi2], -1)
        heat = (self.heat_loss(torch.sigmoid(o["tl_heat"]), tl_t, reduction_override="none")
                .flatten(1).mean(1)
                + self.heat_loss(torch.sigmoid(o["br_heat"]), br_t, reduction_override="none")
                .flatten(1).mean(1))
        off = (((_at(o["tl_off"], yi1, xi1) - t_tl).abs() * gv).flatten(1).sum(1)
               + ((_at(o["br_off"], yi2, xi2) - t_br).abs() * gv).flatten(1).sum(1)) / ng2
        return heat, off, (x1, y1, x2, y2), (xi1, yi1, xi2, yi2), gv, ng2

    def _pair_loss(self, o, corners, cells, gt_valid, gv, ng2) -> Dict[str, torch.Tensor]:
        """The per-image losses of the corner pairs' branches: CornerNet's
        pull and push of the embeddings read at each gt's corner cells."""
        xi1, yi1, xi2, yi2 = cells
        pull, push = self.emb_loss(_at(o["tl_emb"], yi1, xi1)[..., 0],
                                   _at(o["br_emb"], yi2, xi2)[..., 0], gt_valid)
        return dict(loss_pull=pull, loss_push=push)

    def loss(self, outs, gt_bboxes, gt_valid, gt_labels, draws=None):
        """The losses of every stack; ``draws`` is unused."""
        losses: Dict[str, torch.Tensor] = {}
        for li, o in enumerate(outs):
            heat, off, corners, cells, gv, ng2 = self._common(o, gt_bboxes, gt_valid, gt_labels)
            losses[f"l{li}.loss_heatmap"] = images_mean(heat)
            for k, v in self._pair_loss(o, corners, cells, gt_valid, gv, ng2).items():
                losses[f"l{li}.{k}"] = images_mean(v)
            losses[f"l{li}.loss_offset"] = images_mean(off)
        return losses

    def _corners(self, o, k):
        """The top ``k`` corners of each side: scores, classes, cells, and
        positions with their offsets (N, k)."""
        out = []
        for side in ("tl", "br"):
            s, c, yi, xi = _top(o[f"{side}_heat"], k)
            off = _at(o[f"{side}_off"], yi, xi)
            out.append((s, c, yi, xi, xi + off[..., 0], yi + off[..., 1]))
        return out

    def _pair_mask(self, o, tl, br, cfg):
        (_, _, tyi, txi, _, _), (_, _, byi, bxi, _, _) = tl, br
        et = _at(o["tl_emb"], tyi, txi)[..., 0]
        eb = _at(o["br_emb"], byi, bxi)[..., 0]
        return (et[:, :, None] - eb[:, None, :]).abs() < float(cfg.get("distance_threshold", 0.5))

    def get_bboxes(self, outs, img_shapes, scale_factors, rescale: bool = True, cfg=None):
        """Detections of N images from the last stack: dets (N,
        max_per_img, 5), labels, valid (score > 0)."""
        o = outs[-1]
        cfg = dict(cfg or self.test_cfg)
        k = int(cfg.get("corner_topk", 100))
        tl, br = self._corners(o, k)
        ts, tcls, _, _, tx, ty = tl
        bs, bcls, _, _, bx, by = br
        score = (ts[:, :, None] + bs[:, None, :]) / 2
        valid = ((tcls[:, :, None] == bcls[:, None, :])
                 & (bx[:, None, :] >= tx[:, :, None]) & (by[:, None, :] >= ty[:, :, None])
                 & self._pair_mask(o, tl, br, cfg))
        score = torch.where(valid, score, torch.zeros_like(score))
        m = min(int(cfg.get("max_per_img", 100)), k * k)
        top, pi = sort_desc(score.flatten(1), m)
        i1, i2 = pi // k, pi % k
        pick = lambda t, i: torch.gather(t, 1, i)                          # noqa: E731
        boxes = torch.stack([pick(tx, i1), pick(ty, i1), pick(bx, i2), pick(by, i2)],
                            -1) * IMG_STRIDE
        if rescale:
            boxes = boxes / scale_factors.float()[:, None, :4]
        return torch.cat([boxes, top[..., None]], -1), pick(tcls, i1), top > 0


@HEADS.register_module()
class CentripetalHead(CornerHead):
    """CentripetalNet's head (``corner_heads.py:246``): the corner pools,
    heatmaps and offsets of ``CornerHead``; centripetal shifts
    (``tl_centripetal_shift``, ``br_centripetal_shift``) where CornerNet has
    embeddings, which it does not build (the JAX head's tree has none)."""

    def _init_pair_branches(self, n, c, emb, kw):
        self.tl_centripetal_shift = _branches(n, c, 2, **kw)
        self.br_centripetal_shift = _branches(n, c, 2, **kw)

    def _pair_branches(self, i):
        return self.tl_centripetal_shift[i], self.br_centripetal_shift[i]

    def _pair_loss(self, o, corners, cells, gt_valid, gv, ng2):
        x1, y1, x2, y2 = corners
        xi1, yi1, xi2, yi2 = cells
        with torch.no_grad():
            cx, cy = (x1 + x2) / 2, (y1 + y2) / 2
            floor = x1.new_full((), 1e-4)
            t_tl = torch.log(torch.maximum(torch.stack([cx - x1, cy - y1], -1), floor))
            t_br = torch.log(torch.maximum(torch.stack([x2 - cx, y2 - cy], -1), floor))
        ctr = (((_at(o["tl_emb"], yi1, xi1) - t_tl).abs() * gv).flatten(1).sum(1)
               + ((_at(o["br_emb"], yi2, xi2) - t_br).abs() * gv).flatten(1).sum(1)) / ng2
        return dict(loss_centripetal=ctr)

    def _pair_mask(self, o, tl, br, cfg):
        (_, _, tyi, txi, tx, ty), (_, _, byi, bxi, bx, by) = tl, br
        tc = _at(o["tl_emb"], tyi, txi)
        bc = _at(o["br_emb"], byi, bxi)
        ctx, cty = tx + torch.exp(tc[..., 0]), ty + torch.exp(tc[..., 1])
        cbx, cby = bx - torch.exp(bc[..., 0]), by - torch.exp(bc[..., 1])
        floor = tx.new_full((), 1e-3)
        bw = torch.maximum(bx[:, None, :] - tx[:, :, None], floor)
        bh = torch.maximum(by[:, None, :] - ty[:, :, None], floor)
        mu = 0.3
        return (((ctx[:, :, None] - cbx[:, None, :]).abs() < mu * bw)
                & ((cty[:, :, None] - cby[:, None, :]).abs() < mu * bh))


@DETECTORS.register_module()
class CornerNet(SingleStageDetector):
    """``oadg_tpu/models/dense_heads/corner_heads.py:383``; CentripetalNet's
    detector too."""
