"""Losses of the port; importing this registers the stock losses, the
one-stage family's (LD's distillation KL, CenterNet's and CornerNet's among them) and the OA-Loss
family."""
from .common import (BoundedIoULoss, CIoULoss, CrossEntropyLoss, DIoULoss,
                     DistributionFocalLoss, FocalLoss, GaussianFocalLoss, GIoULoss, IoULoss, L1Loss, MSELoss,
                     QualityFocalLoss, SmoothL1Loss, accuracy,
                     binary_cross_entropy_with_logits, l1, smooth_l1,
                     sigmoid_focal_loss, softmax_cross_entropy, weight_reduce_loss)
from .extra import AssociativeEmbeddingLoss, KnowledgeDistillationKLDivLoss, VarifocalLoss
from .oadg import (ContrastiveLossPlus, CrossEntropyLossPlus, L1LossPlus,
                   SmoothL1LossPlus, jsd_consistency, supcontrast)

__all__ = ["AssociativeEmbeddingLoss", "BoundedIoULoss", "CIoULoss", "DIoULoss", "DistributionFocalLoss", "FocalLoss", "GaussianFocalLoss",
           "GIoULoss", "KnowledgeDistillationKLDivLoss", "QualityFocalLoss", "VarifocalLoss",
           "IoULoss", "sigmoid_focal_loss", "CrossEntropyLoss", "L1Loss", "MSELoss", "SmoothL1Loss", "accuracy",
           "binary_cross_entropy_with_logits", "l1", "smooth_l1", "softmax_cross_entropy", "weight_reduce_loss", "ContrastiveLossPlus",
           "CrossEntropyLossPlus", "L1LossPlus", "SmoothL1LossPlus",
           "jsd_consistency", "supcontrast"]
