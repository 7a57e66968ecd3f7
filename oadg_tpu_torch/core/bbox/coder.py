"""Delta box coder (port of ``oadg_tpu/core/bbox/coder.py:20``, mmdet 2.x
``DeltaXYWHBBoxCoder``: widths are ``x2 - x1``).

``decode`` of bfloat16 deltas runs in float32, as in the JAX package: there
``deltas * self.stds`` promotes bfloat16 against a numpy float32 array (not
weakly typed) to float32 (``:58``); here the float32 ``stds`` tensor promotes
the bfloat16 deltas the same way, and the float32 boxes carry the rest."""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ...utils.registry import BBOX_CODERS


@BBOX_CODERS.register_module()
class DeltaXYWHBBoxCoder:

    def __init__(self, target_means: Sequence[float] = (0., 0., 0., 0.),
                 target_stds: Sequence[float] = (1., 1., 1., 1.)):
        self.means = torch.tensor(np.asarray(target_means, np.float32))
        self.stds = torch.tensor(np.asarray(target_stds, np.float32))

    def encode(self, bboxes: torch.Tensor, gt_bboxes: torch.Tensor) -> torch.Tensor:
        """(..., 4) proposals and ground truth -> normalized deltas (..., 4)."""
        px = (bboxes[..., 0] + bboxes[..., 2]) * 0.5
        py = (bboxes[..., 1] + bboxes[..., 3]) * 0.5
        pw = (bboxes[..., 2] - bboxes[..., 0]).clamp(min=1e-6)
        ph = (bboxes[..., 3] - bboxes[..., 1]).clamp(min=1e-6)
        gx = (gt_bboxes[..., 0] + gt_bboxes[..., 2]) * 0.5
        gy = (gt_bboxes[..., 1] + gt_bboxes[..., 3]) * 0.5
        gw = (gt_bboxes[..., 2] - gt_bboxes[..., 0]).clamp(min=1e-6)
        gh = (gt_bboxes[..., 3] - gt_bboxes[..., 1]).clamp(min=1e-6)
        deltas = torch.stack([(gx - px) / pw, (gy - py) / ph,
                              torch.log(gw / pw), torch.log(gh / ph)], dim=-1)
        dev = deltas.device
        return (deltas - self.means.to(dev)) / self.stds.to(dev)

    def decode(self, bboxes: torch.Tensor, deltas: torch.Tensor,
               max_shape: Optional[Tuple] = None,
               wh_ratio_clip: float = 16 / 1000) -> torch.Tensor:
        """Apply (..., 4) deltas to (..., 4) boxes; clip to ``max_shape`` =
        (H, W), numbers or tensors that broadcast against ``bboxes[..., 0]``."""
        dev = deltas.device
        denorm = deltas * self.stds.to(dev) + self.means.to(dev)
        dx, dy, dw, dh = denorm.unbind(-1)
        max_ratio = float(np.abs(np.log(wh_ratio_clip)))
        px = (bboxes[..., 0] + bboxes[..., 2]) * 0.5
        py = (bboxes[..., 1] + bboxes[..., 3]) * 0.5
        pw = bboxes[..., 2] - bboxes[..., 0]
        ph = bboxes[..., 3] - bboxes[..., 1]
        gw = pw * torch.exp(dw.clamp(-max_ratio, max_ratio))
        gh = ph * torch.exp(dh.clamp(-max_ratio, max_ratio))
        gx = px + pw * dx
        gy = py + ph * dy
        x1, y1 = gx - gw * 0.5, gy - gh * 0.5
        x2, y2 = gx + gw * 0.5, gy + gh * 0.5
        if max_shape is not None:
            h, w = max_shape
            x1 = torch.minimum(x1.clamp(min=0), torch.as_tensor(w, device=dev))
            x2 = torch.minimum(x2.clamp(min=0), torch.as_tensor(w, device=dev))
            y1 = torch.minimum(y1.clamp(min=0), torch.as_tensor(h, device=dev))
            y2 = torch.minimum(y2.clamp(min=0), torch.as_tensor(h, device=dev))
        return torch.stack([x1, y1, x2, y2], dim=-1)
