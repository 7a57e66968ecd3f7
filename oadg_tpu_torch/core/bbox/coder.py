"""Delta box coder (port of ``oadg_tpu/core/bbox/coder.py:20``, mmdet 2.x
``DeltaXYWHBBoxCoder``: widths are ``x2 - x1``).

``decode`` of bfloat16 deltas runs in float32, as in the JAX package: there
``deltas * self.stds`` promotes bfloat16 against a numpy float32 array (not
weakly typed) to float32 (``:58``); here the float32 ``stds`` tensor promotes
the bfloat16 deltas the same way, and the float32 boxes carry the rest.

``add_ctr_clamp`` (YOLOF's, ``:67-71``): the centre shifts ``pw * dx`` and
``ph * dy`` clamped to +-``ctr_clamp`` and ``dw`` / ``dh`` bounded from
above only; without it the default path, ``dw`` / ``dh`` clamped both ways.

``YOLOBBoxCoder`` (port of ``:104-127``): centre offsets within a cell of
``stride`` and log size ratios, with the ``eps`` clamps of the JAX package."""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ...utils.registry import BBOX_CODERS


@BBOX_CODERS.register_module()
class DeltaXYWHBBoxCoder:

    def __init__(self, target_means: Sequence[float] = (0., 0., 0., 0.),
                 target_stds: Sequence[float] = (1., 1., 1., 1.),
                 add_ctr_clamp: bool = False, ctr_clamp: int = 32):
        self.means = torch.tensor(np.asarray(target_means, np.float32))
        self.stds = torch.tensor(np.asarray(target_stds, np.float32))
        self.add_ctr_clamp = add_ctr_clamp
        self.ctr_clamp = ctr_clamp

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
        dx_width, dy_height = pw * dx, ph * dy
        if self.add_ctr_clamp:
            c = float(self.ctr_clamp)
            dx_width, dy_height = dx_width.clamp(-c, c), dy_height.clamp(-c, c)
            dw, dh = dw.clamp(max=max_ratio), dh.clamp(max=max_ratio)
        else:
            dw, dh = dw.clamp(-max_ratio, max_ratio), dh.clamp(-max_ratio, max_ratio)
        gw = pw * torch.exp(dw)
        gh = ph * torch.exp(dh)
        gx = px + dx_width
        gy = py + dy_height
        x1, y1 = gx - gw * 0.5, gy - gh * 0.5
        x2, y2 = gx + gw * 0.5, gy + gh * 0.5
        if max_shape is not None:
            h, w = max_shape
            x1 = torch.minimum(x1.clamp(min=0), torch.as_tensor(w, device=dev))
            x2 = torch.minimum(x2.clamp(min=0), torch.as_tensor(w, device=dev))
            y1 = torch.minimum(y1.clamp(min=0), torch.as_tensor(h, device=dev))
            y2 = torch.minimum(y2.clamp(min=0), torch.as_tensor(h, device=dev))
        return torch.stack([x1, y1, x2, y2], dim=-1)


@BBOX_CODERS.register_module()
class YOLOBBoxCoder:

    def __init__(self, eps: float = 1e-6):
        self.eps = eps

    def encode(self, bboxes: torch.Tensor, gt_bboxes: torch.Tensor,
               stride: torch.Tensor) -> torch.Tensor:
        """(..., 4) priors, gt boxes and (...) strides -> (..., 4) targets:
        ``x, y`` the gt centre's place in the prior's cell, clamped to
        ``[eps, 1 - eps]``; ``w, h`` the log of the size ratio, floored at
        ``eps`` on both sides of the division."""
        eps = self.eps
        x_gt = (gt_bboxes[..., 0] + gt_bboxes[..., 2]) * 0.5
        y_gt = (gt_bboxes[..., 1] + gt_bboxes[..., 3]) * 0.5
        w_gt = gt_bboxes[..., 2] - gt_bboxes[..., 0]
        h_gt = gt_bboxes[..., 3] - gt_bboxes[..., 1]
        x = (bboxes[..., 0] + bboxes[..., 2]) * 0.5
        y = (bboxes[..., 1] + bboxes[..., 3]) * 0.5
        w = bboxes[..., 2] - bboxes[..., 0]
        h = bboxes[..., 3] - bboxes[..., 1]
        w_t = torch.log((w_gt / w.clamp(min=eps)).clamp(min=eps))
        h_t = torch.log((h_gt / h.clamp(min=eps)).clamp(min=eps))
        x_t = ((x_gt - x) / stride + 0.5).clamp(eps, 1 - eps)
        y_t = ((y_gt - y) / stride + 0.5).clamp(eps, 1 - eps)
        return torch.stack([x_t, y_t, w_t, h_t], dim=-1)

    def decode(self, bboxes: torch.Tensor, pred_bboxes: torch.Tensor,
               stride: torch.Tensor) -> torch.Tensor:
        """(..., 4) priors, (..., 4) predictions (sigmoid x, y and raw w, h)
        and (...) strides -> (..., 4) boxes."""
        xy = (bboxes[..., :2] + bboxes[..., 2:4]) * 0.5 + (
            pred_bboxes[..., :2] - 0.5) * stride[..., None]
        wh = (bboxes[..., 2:4] - bboxes[..., :2]) * 0.5 * torch.exp(pred_bboxes[..., 2:4])
        return torch.cat([xy - wh, xy + wh], dim=-1)
