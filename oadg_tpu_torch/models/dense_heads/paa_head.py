"""PAA head and detector (port of ``oadg_tpu/models/dense_heads/paa_head.py:30-191``).

``RetinaHead``'s towers and convs (the JAX head subclasses RetinaHead: no
GN, the convs Normal(0.01), ``retina_cls`` at the 0.01 prior) plus
``retina_iou``, an IoU-prediction conv on the box tower (LeCun-normal; mmdet's
PAA head is an ATSS head, whose GN towers, scales and ``atss_*`` convs the
JAX one lacks: ``utils/checkpoint.py`` names them).

- ``gmm_em_1d`` (``:30-72``): a two-component 1-D Gaussian mixture fitted
  by 10 EM steps in float32, started at the candidates' min and max with
  their variance and equal weights -> each candidate's responsibility of
  the low-mean component (mmdet fits sklearn's ``GaussianMixture``;
  ROADMAP C).
- ``loss`` (``:103-167``): per gt and level the anchors at or above the
  level's ``topk``-th IoU with the gt (a mask: tied IoUs all count; IoU >
  0); each candidate's cost, the focal term ``-(1 - p) ** 2 log p`` of the
  gt's class plus ``1 - GIoU`` of its decoded box; the mixture over a
  gt's candidates' costs; positives those whose low-cost responsibility
  exceeds 0.5, an anchor of several gts going to the gt of largest anchor
  IoU. Focal loss over every anchor, ``1.3 (1 - GIoU)`` and the IoU
  branch's BCE against the decoded box's IoU (detached, times 0.5) on the
  positives, each over their count.
- ``get_bboxes`` (``:169-186``): the class sigmoid times the IoU sigmoid
  under a square root, turned back into logits, through
  ``RetinaHead.get_bboxes``.
"""
from __future__ import annotations

import math

import torch

from ...core.bbox.geometry import bbox_overlaps
from ...parallel import shard_sum
from ...utils.registry import DETECTORS, HEADS, LOSSES, build_from_cfg
from ..detectors.single_stage import SingleStageDetector
from ..layers import Conv, lecun_normal_
from ..losses.common import binary_cross_entropy_with_logits
from .fcos_head import INF
from .retina_head import RetinaHead, _flatten, gather_rows


def _gauss_logp(x, mu, sig, pi):
    """(..., K) samples, (..., 2) parameters -> (..., K, 2) log densities
    plus log weights."""
    d = x[..., None] - mu[..., None, :]
    s = sig[..., None, :]
    return (-0.5 * d * d / s - 0.5 * torch.log(2 * math.pi * s)
            + torch.log(torch.clamp(pi[..., None, :], min=1e-12)))


def gmm_em_1d(x: torch.Tensor, valid: torch.Tensor, iters: int = 10) -> torch.Tensor:
    """Batched two-component 1-D GMM over the last axis of (..., K) ``x``
    where ``valid`` -> the low-mean component's responsibility (..., K), 0
    where not valid."""
    zero = x.new_zeros(())
    cnt = valid.sum(-1, keepdim=True).clamp(min=1)
    mean = torch.where(valid, x, zero).sum(-1, keepdim=True) / cnt
    var = torch.where(valid, (x - mean) ** 2, zero).sum(-1, keepdim=True) / cnt + 1e-6
    mu = torch.cat([torch.where(valid, x, x.new_full((), INF)).amin(-1, keepdim=True),
                    torch.where(valid, x, x.new_full((), -INF)).amax(-1, keepdim=True)], -1)
    sig = torch.cat([var, var], -1)
    pi = torch.full_like(mu, 0.5)
    for _ in range(iters):
        r = torch.where(valid[..., None], torch.softmax(_gauss_logp(x, mu, sig, pi), -1), zero)
        nk = torch.clamp(r.sum(-2), min=1e-6)
        mu = (r * x[..., None]).sum(-2) / nk
        sig = (r * (x[..., None] - mu[..., None, :]) ** 2).sum(-2) / nk + 1e-6
        pi = nk / torch.clamp(nk.sum(-1, keepdim=True), min=1e-6)
    r = torch.softmax(_gauss_logp(x, mu, sig, pi), -1)
    low = mu.argmin(-1)
    r_low = torch.gather(r, -1, low[..., None, None].expand(*r.shape[:-1], 1))[..., 0]
    return torch.where(valid, r_low, zero)


@HEADS.register_module()
class PAAHead(RetinaHead):

    def __init__(self, topk: int = 9, score_voting: bool = True, covariance_type: str = "diag",
                 **kwargs):
        super().__init__(**kwargs)
        self.topk = topk
        na = self.prior_generator.num_base_anchors[0]
        self.retina_iou = Conv(self.retina_reg.in_channels, na, 3, 1, 1,
                               device=kwargs.get("device"), dtype=kwargs.get("dtype"))

    def init_weights(self, gen: torch.Generator):
        """RetinaHead's init, then ``retina_iou`` LeCun-normal with a zero
        bias (the JAX head gives it no initializer of its own)."""
        super().init_weights(gen)
        lecun_normal_(self.retina_iou.weight, gen)
        torch.nn.init.zeros_(self.retina_iou.bias)

    def forward(self, feats):
        """Per level: class logits (N, A C, H, W), deltas (N, A 4, H, W), IoU
        logits (N, A, H, W)."""
        cls_scores, bbox_preds, ious = [], [], []
        for x in feats:
            c = r = x
            for conv in self.cls_convs:
                c = torch.relu(conv(c))
            for conv in self.reg_convs:
                r = torch.relu(conv(r))
            cls_scores.append(self.retina_cls(c))
            bbox_preds.append(self.retina_reg(r))
            ious.append(self.retina_iou(r))
        return cls_scores, bbox_preds, ious

    def _assign(self, anchors, num_level, cls, decoded, gt, gt_valid, gt_labels):
        """Positives (N, K) and their gts' indices (N, K) by the mixture over
        each gt's candidates' costs."""
        zero = cls.new_zeros(())
        ious = torch.where(gt_valid[:, None, :], bbox_overlaps(anchors.expand(
            gt.shape[0], *anchors.shape), gt), zero)                          # (N, K, G)
        cand, start = [], 0
        for nl in num_level:
            i_lv = ious[:, start:start + nl]
            kth = torch.topk(i_lv, min(self.topk, nl), dim=1).values.amin(1, keepdim=True)
            cand.append((i_lv >= torch.clamp(kth, min=1e-12)) & (i_lv > 0))
            start += nl
        cand = torch.cat(cand, 1) & gt_valid[:, None, :]
        labels = gt_labels.long().clamp(0, self.num_classes - 1)
        pg = torch.gather(torch.sigmoid(cls), 2, labels[:, None, :].expand(-1, cls.shape[1], -1))
        cost = (-((1 - pg) ** 2) * torch.log(torch.clamp(pg, 1e-12, 1.0))
                + (1 - bbox_overlaps(decoded, gt, mode="giou")))
        big = torch.where(cand, cost, cost.new_full((), INF))
        r_low = gmm_em_1d(big.transpose(1, 2), cand.transpose(1, 2)).transpose(1, 2)
        sel = torch.where((r_low > 0.5) & cand, ious, ious.new_full((), -1.0))
        return sel.amax(-1) > -0.5, sel.argmax(-1)

    def loss(self, outs, gt_bboxes, gt_valid, gt_labels, draws=None):
        """``loss_cls`` (focal), ``loss_bbox`` (GIoU), ``loss_iou`` of N
        images; ``draws`` is unused."""
        cls_scores, bbox_preds, iou_preds = outs
        n = cls_scores[0].shape[0]
        per_level = self.prior_generator.grid_priors([tuple(s.shape[-2:]) for s in cls_scores],
                                                     cls_scores[0].device)
        anchors = torch.cat(per_level)
        k = anchors.shape[0]
        cls = _flatten(cls_scores, self.num_classes).float()
        reg = _flatten(bbox_preds, 4).float()
        iop = _flatten(iou_preds, 1)[..., 0].float()
        decoded = self.bbox_coder.decode(anchors.expand(n, k, 4), reg)
        with torch.no_grad():
            pos, gi = self._assign(anchors, [len(a) for a in per_level], cls, decoded,
                                   gt_bboxes, gt_valid, gt_labels)
            labels = torch.where(pos, torch.gather(gt_labels.long(), 1, gi),
                                 torch.full_like(gi, self.num_classes))
            tgt = gather_rows(gt_bboxes, gi)
            iou_t = bbox_overlaps(decoded, tgt, is_aligned=True)
            posf = pos.float().reshape(-1)
            num_pos = shard_sum(pos.sum()).clamp(min=1).float()
        loss_cls = build_from_cfg(self.loss_cls_cfg, LOSSES)(
            cls.reshape(-1, self.num_classes), labels.reshape(-1), avg_factor=num_pos)
        giou = bbox_overlaps(decoded.reshape(-1, 4), tgt.reshape(-1, 4), mode="giou",
                             is_aligned=True)
        iou_l = binary_cross_entropy_with_logits(iop.reshape(-1), iou_t.reshape(-1))
        return dict(loss_cls=loss_cls, loss_bbox=((1 - giou) * posf * 1.3).sum() / num_pos,
                    loss_iou=(iou_l * posf * 0.5).sum() / num_pos)

    def get_bboxes(self, outs, img_shapes, scale_factors, rescale: bool = True, cfg=None):
        """Detections of N images: dets (N, max_per_img, 5), labels, valid."""
        cls_scores, bbox_preds, iou_preds = outs
        logits = []
        for s, i in zip(cls_scores, iou_preds):
            b, ac, h, w = s.shape
            sc = torch.sigmoid(s.float()).view(b, -1, self.num_classes, h, w)
            io = torch.sigmoid(i.float())[:, :, None]
            f = torch.sqrt(torch.clamp(sc * io, 1e-12, 1.0)).view(b, ac, h, w)
            logits.append(torch.log(torch.clamp(f, 1e-12, 1.0) / torch.clamp(1 - f, 1e-12, 1.0)))
        return super().get_bboxes((logits, bbox_preds), img_shapes, scale_factors,
                                  rescale=rescale, cfg=cfg)


@DETECTORS.register_module()
class PAA(SingleStageDetector):
    """``paa_head.py:189``."""
