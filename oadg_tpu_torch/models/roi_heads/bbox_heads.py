"""Box heads (port of ``oadg_tpu/models/roi_heads/bbox_heads.py:37,204``):
flatten the (C, 7, 7) RoI features, two shared FCs with ReLU, then the
classifier (C + 1), the class-wise box regressor (4 C) and, in the
contrastive head, the embedding MLP ``fc_cont`` (ReLU between its layers,
none after the last; the test path discards it). ``get_targets`` and
``loss`` (``:117-174``) are the static-shape training targets and losses.
mmdet keys: ``shared_fcs.0.weight`` (input flattened C, H, W), ``fc_cls``,
``fc_reg``, ``fc_cont.i``.

Every FC computes in ``dtype`` (float32 parameters; the float32 RoI features
are cast on entry, as ``nn.Dense(dtype=...)`` does) and returns it; the
losses and the test path's softmax take ``cls_score`` and ``bbox_pred`` cast
to float32 (``:154,169,172,182``), and the deltas are decoded in float32."""
from __future__ import annotations

import torch
from torch import nn

from ...core.bbox.coder import DeltaXYWHBBoxCoder
from ...utils.registry import HEADS, LOSSES, build_from_cfg
from ..layers import Linear, lecun_normal_, normal_, xavier_uniform_
from ..losses.common import accuracy


@HEADS.register_module()
class Shared2FCBBoxHead(nn.Module):

    def __init__(self, in_channels: int = 256, fc_out_channels: int = 1024,
                 roi_feat_size: int = 7, num_classes: int = 80,
                 bbox_coder=None, reg_class_agnostic: bool = False,
                 with_cont: bool = False, cont_predictor_cfg=None,
                 out_dim_cont=None, loss_cls=None, loss_bbox=None,
                 loss_cont=None, device=None, dtype=None):
        super().__init__()
        coder = dict(bbox_coder or dict(target_means=(0., 0., 0., 0.),
                                        target_stds=(0.1, 0.1, 0.2, 0.2)))
        coder.pop("type", None)
        self.bbox_coder = DeltaXYWHBBoxCoder(**coder)
        self.num_classes = num_classes
        self.reg_class_agnostic = reg_class_agnostic
        self.loss_cls_cfg = dict(loss_cls or dict(type="CrossEntropyLoss"))
        self.loss_bbox_cfg = dict(loss_bbox or dict(type="SmoothL1Loss", beta=1.0))
        self.loss_cont_cfg = dict(loss_cont) if loss_cont else None
        flat = in_channels * roi_feat_size * roi_feat_size
        fc = dict(device=device, dtype=dtype)
        self.shared_fcs = nn.ModuleList([
            Linear(flat, fc_out_channels, **fc),
            Linear(fc_out_channels, fc_out_channels, **fc)])
        self.fc_cls = Linear(fc_out_channels, num_classes + 1, **fc)
        self.fc_reg = Linear(fc_out_channels,
                             4 if reg_class_agnostic else 4 * num_classes, **fc)
        if with_cont:
            cfg = dict(cont_predictor_cfg or dict(num_linear=2, feat_channels=256))
            width = cfg.get("feat_channels", 256)
            dims = [fc_out_channels] + [width] * cfg.get("num_linear", 2)
            self.fc_cont = nn.ModuleList(Linear(a, b, **fc)
                                         for a, b in zip(dims[:-1], dims[1:]))

    def init_weights(self, gen: torch.Generator):
        """mmdet init: Xavier shared FCs, Normal(0.01) classifier, Normal(0.001)
        regressor, LeCun-normal ``fc_cont``; zero biases."""
        for fc in self.shared_fcs:
            xavier_uniform_(fc.weight, gen)
        normal_(self.fc_cls.weight, 0.01, gen)
        normal_(self.fc_reg.weight, 0.001, gen)
        for fc in getattr(self, "fc_cont", ()):
            lecun_normal_(fc.weight, gen)
        for m in self.modules():
            if isinstance(m, nn.Linear):
                nn.init.zeros_(m.bias)

    def forward(self, roi_feats: torch.Tensor):
        """(R, C, 7, 7) -> cls_score (R, C + 1), bbox_pred (R, 4 C), and the
        contrastive embedding (R, feat_channels) or None."""
        x = roi_feats.flatten(1)
        for fc in self.shared_fcs:
            x = torch.relu(fc(x))
        cont = None
        if hasattr(self, "fc_cont"):
            cont = x
            for i, fc in enumerate(self.fc_cont):
                cont = fc(cont)
                if i < len(self.fc_cont) - 1:
                    cont = torch.relu(cont)
        return self.fc_cls(x), self.fc_reg(x), cont

    def get_targets(self, boxes, labels, is_pos, valid, matched_gt,
                    pos_weight: float = -1.0):
        """Targets of sampled rows, any leading dims (``:117-142``).

        Args: boxes (..., 4) sampled proposals; labels (...) matched gt
        labels; is_pos, valid (...) bool; matched_gt (..., 4).

        Returns labels (background = num_classes), label weights, encoded
        deltas and box weights (1 on positives).
        """
        tgt_labels = torch.where(is_pos, labels, self.num_classes)
        pw = 1.0 if pos_weight <= 0 else pos_weight
        label_w = torch.where(valid, torch.where(is_pos, pw, 1.0), 0.0)
        deltas = self.bbox_coder.encode(boxes, matched_gt)
        bbox_w = is_pos.float()[..., None].expand(deltas.shape)
        return tgt_labels, label_w, deltas, bbox_w

    def loss(self, cls_score, bbox_pred, labels, label_weights, bbox_targets,
             bbox_weights):
        """``loss_cls`` averaged over the rows with a label weight, ``acc``
        (logged, never summed), ``loss_bbox`` over the positive rows of the
        target class averaged over all rows (``:146-174``)."""
        avg_factor = (label_weights > 0).sum().clamp(min=1).float()
        loss_cls = build_from_cfg(self.loss_cls_cfg, LOSSES)
        loss_bbox = build_from_cfg(self.loss_bbox_cfg, LOSSES)
        r = bbox_pred.shape[0]
        if self.reg_class_agnostic:
            pos_pred = bbox_pred.reshape(r, 4)
        else:
            safe = labels.clamp(0, self.num_classes - 1)
            pos_pred = torch.gather(bbox_pred.reshape(r, -1, 4), 1,
                                    safe[:, None, None].expand(r, 1, 4))[:, 0]
        return dict(
            loss_cls=loss_cls(cls_score.float(), labels, label_weights,
                              avg_factor=avg_factor),
            acc=accuracy(cls_score.detach(), labels, (label_weights > 0).float()),
            loss_bbox=loss_bbox(pos_pred.float(), bbox_targets, bbox_weights,
                                avg_factor=float(r)))

    def get_bboxes(self, rois, cls_score, bbox_pred, img_shapes, scale_factors,
                   rescale: bool = False):
        """Decoded boxes and softmax scores, batched over images
        (``bbox_heads.py:178``).

        Args: rois (N, P, 5); cls_score (N, P, C + 1); bbox_pred (N, P, 4 C);
        img_shapes (N, 2) (h, w); scale_factors (N, 4).

        Returns boxes (N, P, 4 C) and scores (N, P, C + 1).
        """
        n, p = rois.shape[:2]
        scores = torch.softmax(cls_score.float(), dim=-1)
        k = 1 if self.reg_class_agnostic else self.num_classes
        boxes = self.bbox_coder.decode(
            rois[:, :, None, 1:5].expand(n, p, k, 4), bbox_pred.reshape(n, p, k, 4),
            max_shape=(img_shapes[:, 0].view(n, 1, 1), img_shapes[:, 1].view(n, 1, 1)))
        if rescale:
            boxes = boxes / scale_factors.float().view(n, 1, 1, -1)[..., :4]
        return boxes.reshape(n, p, -1), scores


@HEADS.register_module()
class Shared2FCContrastiveHead(Shared2FCBBoxHead):
    """``bbox_heads.py:204``: the box head with the contrastive branch."""

    def __init__(self, with_cont: bool = True, **kwargs):
        super().__init__(with_cont=with_cont, **kwargs)
