"""AutoAssign, LD and PISA-RetinaNet heads and their detectors (port of
``oadg_tpu/models/dense_heads/autoassign_ld_heads.py:32-286``; its LAD and
PISA-SSD heads are not ported: no config of the repo names them).

``AutoAssignHead`` (``:32-114``): ``FCOSHead``'s towers and outputs (the
centerness conv is the objectness), plus ``center_prior``: a learned
per-class Gaussian centre prior, ``mean`` (C, 2) at 0 and ``sigma`` (C, 2)
at 1 (mmdet's ``CenterPrior`` keys).

- ``loss`` (``:51-114``), fully differentiable, per image: the prior
  ``g = exp(-((d / stride - mean) / sigma) ** 2 / 2)`` of each point inside
  a gt (``|sigma|`` floored at 0.01), the positive confidence
  ``p_cls * exp(-5 (1 - IoU))`` with ``p = sigmoid(cls) * sigmoid(obj)``,
  the bag weights ``g * exp(confidence / temperature)`` normalized over the
  gt's points; ``loss_pos`` the bag's ``-log`` per gt, ``loss_neg`` the
  focal-style ``p^2 -log(1 - p)`` of every class of every point, ``p``
  discounted by the point's best IoU inside a gt (``1 - (1 / (1 - IoU) -
  1) / (max - 1)``), ``loss_center`` the ``-log`` of each gt's mean prior;
  each over the batch's gts, times 0.25, 0.75 and 0.75.
- ``get_bboxes``: ``FCOSHead``'s, the objectness as the centerness.

``LDHead`` (``:126-160``): a ``GFLHead`` whose ``loss`` takes the teacher's
bin logits as ``soft_targets`` and adds ``loss_ld``, the distillation KL
(``KnowledgeDistillationKLDivLoss``, T = 10, weight 0.25) of the student's
``4 x (reg_max + 1)`` bin logits against the teacher's (detached), the mean
over every point's four sides (mmdet's is over the positives alone,
weighted by their scores; ROADMAP C).

``KnowledgeDistillationSingleStageDetector`` (``:172-207``): the student
and ``teacher_model``, a plain ``SingleStageDetector`` of the
``teacher_config.model``'s backbone, neck and head. ``forward_train`` runs
the teacher under ``no_grad`` (its ``forward_train: teacher`` span) and
hands its bin logits to the student's loss; the test path is the
student's. The teacher's parameters do not require grad, so the optimizer
never sees them (mmdet's behaviour: SGD skips a parameter without a
gradient), and the teacher stays in eval mode. JAX's teacher sits in the
optimized tree and decays with SGD's weight decay every step (ROADMAP C).
``init_weights`` seeds the teacher too.

``NASFCOSHead`` (``:117-129``) is ``FCOSHead`` as the JAX head is: its
towers' convs are renamed ``cls_sep{i}`` / ``reg_sep{i}`` and stay plain
3x3 convs before their GN, although the docstring calls them separable
(mmdet's searched tower, DCNv2 and 1x1 convs, is not what JAX runs;
ROADMAP C); mmdet's keys ``cls_convs.{i}.conv`` / ``.gn``. The ``NASFCOS``
detector (``:222-224``) refuses, at build, a neck whose output strides
differ from the head's ``strides``: the repo's config gives
``NASFCOS_FPN`` ``start_level=0``, which takes the backbone's four maps,
strides 4 to 64, while the head lays its points and regress ranges at 8 to
128; the JAX package runs it so, each level's points at twice its map's
stride (ROADMAP C). ``model.neck.start_level=1`` makes them agree.

``PISARetinaHead`` (``:226-286``): ``RetinaHead``'s MaxIoU assignment;
ISR-P label weights of the positives from a stable IoU rank over the
global batch (``losses.pisa.isr_p_weights``, the one-process order under
data parallel); focal loss with those weights and L1 over ``num_pos``;
``loss_carl``, CARL's SmoothL1 (beta 1/9) of the positives' deltas
weighted by the class sigmoid at their label, normalized to the positives'
count (a global sum that carries its gradient), times 5 over ``num_pos``.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.profiler import record_function

from ...core.bbox.geometry import bbox_overlaps
from ...core.bbox.transforms import distance2bbox
from ...parallel import shard_sum, shard_sum_grad
from ...utils.registry import DETECTORS, HEADS, LOSSES, build_from_cfg
from ..detectors.single_stage import SingleStageDetector
from ..losses.pisa import isr_p_weights
from .fcos_head import FCOSHead, level_points
from .gfl_head import GFLHead
from .retina_head import RetinaHead, _flatten


def _clip(x: torch.Tensor, lo=None, hi=None) -> torch.Tensor:
    """``jnp.clip``: ``minimum(maximum(x, lo), hi)`` (ties split the
    gradient, as in JAX)."""
    if lo is not None:
        x = torch.maximum(x, x.new_full((), lo))
    if hi is not None:
        x = torch.minimum(x, x.new_full((), hi))
    return x


class CenterPrior(nn.Module):
    """Per-class Gaussian centre prior: ``mean`` and ``sigma`` (C, 2)."""

    def __init__(self, num_classes: int, device=None):
        super().__init__()
        self.mean = nn.Parameter(torch.zeros(num_classes, 2, device=device))
        self.sigma = nn.Parameter(torch.ones(num_classes, 2, device=device))


@HEADS.register_module()
class AutoAssignHead(FCOSHead):

    def __init__(self, pos_loss_weight: float = 0.25, neg_loss_weight: float = 0.75,
                 center_loss_weight: float = 0.75, temperature: float = 1.0 / 3.0, **kwargs):
        super().__init__(**kwargs)
        self.pos_loss_weight = pos_loss_weight
        self.neg_loss_weight = neg_loss_weight
        self.center_loss_weight = center_loss_weight
        self.temperature = temperature
        self.center_prior = CenterPrior(self.num_classes, kwargs.get("device"))

    def loss(self, outs, gt_bboxes, gt_valid, gt_labels, draws=None):
        """``loss_pos``, ``loss_neg``, ``loss_center`` of N images; ``draws``
        is unused."""
        cls_scores, bbox_preds, objs = outs
        sizes = [tuple(s.shape[-2:]) for s in cls_scores]
        points, lvl = level_points(sizes, self.strides, cls_scores[0].device)
        strides = torch.tensor(self.strides, dtype=torch.float32, device=points.device)[lvl]
        cls = _flatten(cls_scores, self.num_classes).float()
        boxes = distance2bbox(points, _flatten(bbox_preds, 4))
        obj = _flatten(objs, 1)[..., 0].float()
        prob = torch.sigmoid(cls) * torch.sigmoid(obj)[..., None]               # (N, P, C)
        valid = gt_valid[:, None, :]
        gt = gt_bboxes[:, None]                                               # (N, 1, G, 4)
        px, py = points[:, 0, None], points[:, 1, None]
        inside = ((px >= gt[..., 0]) & (px <= gt[..., 2]) & (py >= gt[..., 1])
                  & (py <= gt[..., 3])) & valid                               # (N, P, G)
        zero = cls.new_zeros(())
        labels = gt_labels.long().clamp(0, self.num_classes - 1)              # padded gts: any
        mu = self.center_prior.mean[labels][:, None]                         # (N, 1, G, 2)
        sig = _clip(self.center_prior.sigma[labels].abs(), 1e-2)[:, None]
        dx = (px - (gt[..., 0] + gt[..., 2]) * 0.5) / strides[:, None] - mu[..., 0]
        dy = (py - (gt[..., 1] + gt[..., 3]) * 0.5) / strides[:, None] - mu[..., 1]
        g = torch.where(inside, torch.exp(-0.5 * ((dx / sig[..., 0]) ** 2
                                                  + (dy / sig[..., 1]) ** 2)), zero)
        ious = bbox_overlaps(boxes, gt_bboxes)                                # (N, P, G)
        p_pos = (torch.gather(prob, 2, labels[:, None, :].expand(-1, prob.shape[1], -1))
                 * torch.exp(-5.0 * (1 - ious)))
        w = torch.where(inside, g * torch.exp(p_pos / self.temperature), zero)
        w = w / _clip(w.sum(1, keepdim=True), 1e-12)
        bag = (w * p_pos).sum(1)                                              # (N, G)
        gv = gt_valid.float()
        pos_loss = (-torch.log(_clip(bag, 1e-12, 1.0)) * gv).sum()
        fiou = torch.where(inside, ious, zero).amax(-1)                       # (N, P)
        disc = _clip(1.0 / (1 - _clip(fiou, 0.0, 0.99)), 1.0)
        wneg = _clip(1 - (disc - 1) / _clip(disc.amax(-1, keepdim=True) - 1, 1e-6), 0.0, 1.0)
        neg_p = prob * wneg[..., None]
        neg_loss = (neg_p ** 2 * -torch.log(_clip(1 - neg_p, 1e-12, 1.0))).sum()
        ctr = (-torch.log(_clip(g.sum(1) / _clip(inside.sum(1).float(), 1.0), 1e-12, 1.0))
               * gv).sum()
        num_gts = _clip(shard_sum(gv.sum()), 1.0)
        return dict(loss_pos=self.pos_loss_weight * pos_loss / num_gts,
                    loss_neg=self.neg_loss_weight * neg_loss / num_gts,
                    loss_center=self.center_loss_weight * ctr / num_gts)


@DETECTORS.register_module()
class AutoAssign(SingleStageDetector):
    """``autoassign_ld_heads.py:217``."""


@HEADS.register_module()
class LDHead(GFLHead):

    def __init__(self, loss_ld=None, **kwargs):
        super().__init__(**kwargs)
        self.l_ld = build_from_cfg(dict(loss_ld or dict(
            type="KnowledgeDistillationKLDivLoss", loss_weight=0.25, T=10)), LOSSES)

    def loss(self, outs, gt_bboxes, gt_valid, gt_labels, draws=None, soft_targets=None):
        """``GFLHead``'s losses of N images, and ``loss_ld`` against the
        teacher's per-level bin logits ``soft_targets`` where given: the
        mean over every row of ``reg_max + 1`` bins (of every rank's rows
        under data parallel)."""
        losses = super().loss(outs, gt_bboxes, gt_valid, gt_labels, draws)
        if soft_targets is not None:
            nb = self.reg_max + 1
            pred = _flatten(outs[1], 4 * nb).float().reshape(-1, nb)
            soft = _flatten(soft_targets, 4 * nb).float().detach().reshape(-1, nb)
            rows = shard_sum(pred.new_tensor(float(pred.shape[0])))
            losses["loss_ld"] = self.l_ld(pred, soft, avg_factor=rows)
        return losses


@DETECTORS.register_module()
class KnowledgeDistillationSingleStageDetector(SingleStageDetector):

    def __init__(self, backbone, neck=None, bbox_head=None, teacher_config=None,
                 device=None, dtype=None, **kwargs):
        super().__init__(backbone, neck, bbox_head, device=device, dtype=dtype, **kwargs)
        if teacher_config is None:
            raise ValueError("KnowledgeDistillationSingleStageDetector needs a teacher_config")
        model = dict(dict(teacher_config).get("model", teacher_config))
        self.teacher_model = SingleStageDetector(
            **{k: model[k] for k in ("backbone", "neck", "bbox_head") if k in model},
            device=device, dtype=dtype)
        self.teacher_model.requires_grad_(False)

    def init_weights(self, gen: torch.Generator):
        """The student's and the teacher's seeded weights (the default init
        covers both; then each head's own)."""
        super().init_weights(gen)
        self.teacher_model.bbox_head.init_weights(gen)

    def train(self, mode: bool = True):
        super().train(mode)
        self.teacher_model.train(False)
        return self

    def forward_train(self, batch, draws):
        """The student's loss dict, ``loss_ld`` against the teacher's bin
        logits."""
        with record_function("forward_train: backbone+neck"):
            feats = self.extract_feat(batch["img"])
        with record_function("forward_train: head"):
            outs = self.bbox_head(feats)
        with record_function("forward_train: teacher"), torch.no_grad():
            teacher = self.teacher_model
            soft = teacher.bbox_head(teacher.extract_feat(batch["img"]))[1]
        with record_function("forward_train: loss"):
            return self.bbox_head.loss(outs, batch["gt_bboxes"], batch["gt_valid"],
                                       batch["gt_labels"], draws, soft_targets=soft)


@HEADS.register_module()
class PISARetinaHead(RetinaHead):

    def __init__(self, isr_k: float = 2.0, isr_bias: float = 0.0, carl_k: float = 1.0,
                 carl_lambda: float = 5.0, num_views: int = 1, **kwargs):
        super().__init__(num_views=num_views, **kwargs)
        self.num_views = num_views
        self.isr_k, self.isr_bias = float(isr_k), float(isr_bias)
        self.carl_k, self.carl_lambda = float(carl_k), float(carl_lambda)

    def loss(self, outs, gt_bboxes, gt_valid, gt_labels, draws=None):
        """``loss_cls`` (focal, ISR-P label weights), ``loss_bbox`` (L1) and
        ``loss_carl`` of N images; ``draws`` is unused."""
        cls_scores, bbox_preds = outs
        n = cls_scores[0].shape[0]
        anchors = self.prior_generator.grid_priors_cat(
            [tuple(s.shape[-2:]) for s in cls_scores], cls_scores[0].device)
        k, nc = anchors.shape[0], self.num_classes
        cls = _flatten(cls_scores, nc).float()
        reg = _flatten(bbox_preds, 4).float()
        with torch.no_grad():
            assign = self.assigner.assign(anchors, gt_bboxes, gt_valid, gt_labels=gt_labels)
            pos = assign.gt_inds > 0
            neg = assign.gt_inds == 0
            labels = torch.where(pos, assign.labels, torch.full_like(assign.labels, nc))
            matched = (assign.gt_inds - 1).clamp(0, gt_bboxes.shape[1] - 1)
            matched_gt = torch.gather(gt_bboxes, 1, matched[..., None].expand(n, k, 4))
            deltas = self.bbox_coder.encode(anchors.expand(n, k, 4), matched_gt)
            posm = pos.reshape(-1)
            w_isr, num_pos = isr_p_weights(assign.max_overlaps.reshape(-1), posm, self.isr_k,
                                           self.isr_bias, self.num_views)
            lw = (pos | neg).float().reshape(-1) * torch.where(posm, w_isr,
                                                               torch.ones_like(w_isr))
            bw = pos.float()[..., None].expand(n, k, 4)
        loss_cls = build_from_cfg(self.loss_cls_cfg, LOSSES)
        loss_bbox = build_from_cfg(self.loss_bbox_cfg, LOSSES)
        lab = labels.reshape(-1).clamp(0, nc - 1)
        sg = torch.gather(torch.sigmoid(cls.reshape(-1, nc)), 1, lab[:, None])[:, 0]
        cw = sg ** self.carl_k
        pm = posm.float()
        cw = cw * num_pos / shard_sum_grad((cw * pm).sum()).clamp(min=1e-6)
        d = (reg.reshape(-1, 4) - deltas.reshape(-1, 4)).abs()
        sl1 = torch.where(d < 1.0 / 9.0, 4.5 * d * d, d - 1.0 / 18.0).sum(-1)
        return dict(
            loss_cls=loss_cls(cls.reshape(-1, nc), labels.reshape(-1), lw, avg_factor=num_pos),
            loss_bbox=loss_bbox(reg, deltas, bw, avg_factor=num_pos),
            loss_carl=self.carl_lambda * (cw * sl1 * pm).sum() / num_pos)


@HEADS.register_module()
class NASFCOSHead(FCOSHead):
    """``autoassign_ld_heads.py:117-129``: ``FCOSHead``."""


def backbone_strides(backbone: dict):
    """The strides of a ResNet config's ``out_indices`` maps: 4 after the
    stem, times each stage's ``strides`` entry."""
    stage, s = [], 4
    for step in backbone.get("strides", (1, 2, 2, 2)):
        s *= step
        stage.append(s)
    return [stage[i] for i in backbone.get("out_indices", (0, 1, 2, 3))]


@DETECTORS.register_module()
class NASFCOS(SingleStageDetector):

    def __init__(self, backbone, neck=None, bbox_head=None, **kwargs):
        super().__init__(backbone, neck, bbox_head, **kwargs)
        got = self.neck.out_strides(backbone_strides(dict(backbone)))
        want = list(self.bbox_head.strides)
        if got != want:
            raise ValueError(
                f"NASFCOS: the neck's outputs lie at strides {got} and the head's points at "
                f"{want}; the JAX package runs each level's points at another stride than "
                "its map's. Set model.neck.start_level=1 (the neck then takes C3..C5, "
                "strides 8 to 128)")
