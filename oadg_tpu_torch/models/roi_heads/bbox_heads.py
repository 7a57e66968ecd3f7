"""Box heads (port of ``oadg_tpu/models/roi_heads/bbox_heads.py:37,204``):
flatten the (C, 7, 7) RoI features, two shared FCs with ReLU, then the
classifier (C + 1) and the class-wise box regressor (4 C). The contrastive
head adds ``fc_cont``, whose weights load but which the test path does not
evaluate (the JAX package discards it at test). mmdet keys:
``shared_fcs.0.weight`` (input flattened C, H, W), ``fc_cls``, ``fc_reg``,
``fc_cont.i``."""
from __future__ import annotations

import torch
from torch import nn

from ...core.bbox.coder import DeltaXYWHBBoxCoder
from ...utils.registry import HEADS
from ..layers import lecun_normal_, normal_, xavier_uniform_


@HEADS.register_module()
class Shared2FCBBoxHead(nn.Module):

    def __init__(self, in_channels: int = 256, fc_out_channels: int = 1024,
                 roi_feat_size: int = 7, num_classes: int = 80,
                 bbox_coder=None, reg_class_agnostic: bool = False,
                 with_cont: bool = False, cont_predictor_cfg=None,
                 out_dim_cont=None, loss_cls=None, loss_bbox=None,
                 loss_cont=None, device=None):
        super().__init__()
        coder = dict(bbox_coder or dict(target_means=(0., 0., 0., 0.),
                                        target_stds=(0.1, 0.1, 0.2, 0.2)))
        coder.pop("type", None)
        self.bbox_coder = DeltaXYWHBBoxCoder(**coder)
        self.num_classes = num_classes
        self.reg_class_agnostic = reg_class_agnostic
        flat = in_channels * roi_feat_size * roi_feat_size
        self.shared_fcs = nn.ModuleList([
            nn.Linear(flat, fc_out_channels, device=device),
            nn.Linear(fc_out_channels, fc_out_channels, device=device)])
        self.fc_cls = nn.Linear(fc_out_channels, num_classes + 1, device=device)
        self.fc_reg = nn.Linear(fc_out_channels,
                                4 if reg_class_agnostic else 4 * num_classes,
                                device=device)
        if with_cont:
            cfg = dict(cont_predictor_cfg or dict(num_linear=2, feat_channels=256))
            width = cfg.get("feat_channels", 256)
            dims = [fc_out_channels] + [width] * cfg.get("num_linear", 2)
            self.fc_cont = nn.ModuleList(nn.Linear(a, b, device=device)
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
        """(R, C, 7, 7) -> cls_score (R, C + 1), bbox_pred (R, 4 C)."""
        x = roi_feats.flatten(1)
        for fc in self.shared_fcs:
            x = torch.relu(fc(x))
        return self.fc_cls(x), self.fc_reg(x)

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
