"""PISA's ISR-P weights, shared by ``PISARoIHead`` (``oadg_tpu/models/roi_heads/
more_roi_heads.py:285-297``) and ``PISARetinaHead``
(``oadg_tpu/models/dense_heads/autoassign_ld_heads.py:261-270``).

The JAX step ranks the IoUs of every row of the global batch at once, so
under data parallel the ranks gather them (``parallel.gather_views_major``:
the one-process order, views-major over the global batch) and each keeps
its own rows' weights.
"""
from __future__ import annotations

import torch

from ...parallel import gather_views_major


def isr_p_weights(ious: torch.Tensor, posm: torch.Tensor, isr_k: float, isr_bias: float,
                  num_views: int = 1):
    """(R,) IoUs of this rank's views-major rows with their matched gt
    (anything where not positive) and the positives ``posm`` (R,) -> each
    row's ISR-P weight (R,) and the positives of the global batch (a
    float32 0-d tensor, floored at 1).

    Each positive's importance is ``1 - rank / num_pos``, ``rank`` its place
    in a stable descending sort of the global batch's IoUs (the
    non-positives at -1 behind them, ties to the earlier row, as
    ``jnp.argsort``), clipped to [0, 1]; its weight ``((1 - bias) + bias *
    imp) * imp ** k``, scaled so that the positives' weights sum to their
    count. Call under ``no_grad``."""
    ious = torch.where(posm, ious, torch.full_like(ious, -1.0))
    both, mine = gather_views_major(torch.stack([ious, posm.to(ious.dtype)], -1), num_views)
    ious_g, posm_g = both[:, 0], both[:, 1] > 0
    order = torch.argsort(-ious_g, stable=True)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(order.shape[0], device=order.device)
    npos = posm_g.sum().float().clamp(min=1.0)
    imp = (1.0 - rank.float() / npos).clamp(0.0, 1.0)
    w = ((1 - isr_bias) + isr_bias * imp) * imp ** isr_k
    w = w * npos / (w * posm_g).sum().clamp(min=1e-6)
    return w[mine], npos
