"""Losses of the port; importing this registers the OA-Loss family."""
from .common import (accuracy, binary_cross_entropy_with_logits, l1, smooth_l1,
                     softmax_cross_entropy, weight_reduce_loss)
from .oadg import (ContrastiveLossPlus, CrossEntropyLossPlus, L1LossPlus,
                   SmoothL1LossPlus, jsd_consistency, supcontrast)

__all__ = ["accuracy", "binary_cross_entropy_with_logits", "l1", "smooth_l1",
           "softmax_cross_entropy", "weight_reduce_loss", "ContrastiveLossPlus",
           "CrossEntropyLossPlus", "L1LossPlus", "SmoothL1LossPlus",
           "jsd_consistency", "supcontrast"]
