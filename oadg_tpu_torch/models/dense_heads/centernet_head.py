"""CenterNet head and detector (port of
``oadg_tpu/models/dense_heads/centernet_head.py``).

One map (the config's ResNet-18 ``out_indices=(1,)``, no neck: stride 8,
128 channels) through three branches of a 3x3 conv, a ReLU and a 1x1 conv
(``heatmap_head``, ``wh_head``, ``offset_head``: mmdet's
``Sequential(conv, ReLU, conv)``): the centre heatmap's sigmoid (C
classes), the box width and height and the centre's sub-cell offset, all
float32 and in feature cells. Every conv LeCun-normal with a zero bias, the
heatmap's too (mmdet starts it at a 0.1 prior; ROADMAP C).

- ``targets`` (``:61-82``): per gt its centre ``(x1 + x2) / 2 / stride``
  (and y), its size in cells, mmdet's ``gaussian_radius`` at overlap 0.3
  (``models/utils/misc.py``), a gaussian of radius ``max(r, 1)`` centred on
  the centre's cell (``floor``) over the whole map, zero below float32's eps
  and for a padded or empty gt; each gaussian goes into its class plane with
  an ``amax`` reduction, which equals the JAX ``fori_loop``'s max-composite
  bit for bit (every value >= 0, a masked gt contributes 0).
- ``loss`` (``:84-107``): per image the ``GaussianFocalLoss`` of the heatmap
  clipped to ``[1e-4, 1 - 1e-4]`` summed over every cell and divided by the
  image's gts, the L1 of the width / height and of the offset read at each
  gt's centre cell over ``2 x`` its gts; each the mean over the images (of
  every rank's under data parallel), the width's times 0.1.
- ``get_bboxes`` (``:109-141``): the peaks (a cell equal to its 3x3 maximum,
  ``max_pool2d`` padding with -inf as the JAX ``reduce_window``), the top
  ``max_per_img`` over (H, W, C) (ties to the lower index), boxes about the
  offset centre; no NMS. Only ``max_per_img`` of ``test_cfg`` is read
  (``topk`` and ``local_maximum_kernel`` are not, as in the JAX head).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...core.post_processing.nms import sort_desc
from ...utils.registry import DETECTORS, HEADS, LOSSES, build_from_cfg
from ..detectors.single_stage import SingleStageDetector
from ..layers import Conv
from ..utils.misc import class_planes, gaussian_maps, gaussian_radius, images_mean

_EPS = torch.finfo(torch.float32).eps


@HEADS.register_module()
class CenterNetHead(nn.Module):

    def __init__(self, num_classes: int = 80, in_channels: int = 64, feat_channels: int = 64,
                 stride: int = 4, loss_center_heatmap=None, loss_wh=None, loss_offset=None,
                 train_cfg=None, test_cfg=None, num_views: int = 1, device=None, dtype=None):
        super().__init__()
        self.num_classes = num_classes
        self.stride = stride
        self.test_cfg = dict(test_cfg or {})
        self.loss_hm = build_from_cfg(dict(loss_center_heatmap or dict(
            type="GaussianFocalLoss", loss_weight=1.0)), LOSSES)
        self.wh_weight = float((loss_wh or {}).get("loss_weight", 0.1))
        self.off_weight = float((loss_offset or {}).get("loss_weight", 1.0))
        conv = dict(device=device, dtype=dtype)

        def branch(out):
            return nn.Sequential(Conv(in_channels, feat_channels, 3, 1, 1, **conv), nn.ReLU(),
                                 Conv(feat_channels, out, 1, 1, 0, **conv))

        self.heatmap_head = branch(num_classes)
        self.wh_head = branch(2)
        self.offset_head = branch(2)

    def init_weights(self, gen: torch.Generator):
        """The model's default (``init_default_``), as the JAX head's."""

    def forward(self, feats):
        """-> (heatmap sigmoid (N, C, H, W), wh (N, 2, H, W), offset (N, 2,
        H, W)), float32."""
        x = feats[0]
        return (torch.sigmoid(self.heatmap_head(x).float()), self.wh_head(x).float(),
                self.offset_head(x).float())

    def targets(self, gt, gt_valid, gt_labels, fh: int, fw: int):
        """(N, G, 4) gts -> the heatmap (N, C, H, W), each gt's centre cell
        (x, y) (N, G) int64, its size (w, h) and offset (N, G, 2)."""
        s = float(self.stride)
        cx = (gt[..., 0] + gt[..., 2]) / 2 / s
        cy = (gt[..., 1] + gt[..., 3]) / 2 / s
        bw = (gt[..., 2] - gt[..., 0]) / s
        bh = (gt[..., 3] - gt[..., 1]) / s
        radius = torch.clamp_min(gaussian_radius((bh, bw), 0.3), 0.0)
        fx, fy = torch.floor(cx), torch.floor(cy)
        g = gaussian_maps(fx, fy, (2 * torch.clamp_min(radius, 1.0) + 1) / 6, fh, fw)
        keep = gt_valid & (bw > 0) & (bh > 0)
        g = torch.where((g < _EPS) | ~keep[..., None, None], torch.zeros_like(g), g)
        hm = class_planes(g, gt_labels, self.num_classes)
        ix = fx.long().clamp(0, fw - 1)
        iy = fy.long().clamp(0, fh - 1)
        return hm, ix, iy, torch.stack([bw, bh], -1), torch.stack([cx - fx, cy - fy], -1)

    def loss(self, outs, gt_bboxes, gt_valid, gt_labels, draws=None):
        """``loss_center_heatmap``, ``loss_wh`` and ``loss_offset``;
        ``draws`` is unused."""
        hm, wh, off = outs
        n, _, fh, fw = hm.shape
        with torch.no_grad():
            hm_t, ix, iy, size_t, off_t = self.targets(gt_bboxes, gt_valid, gt_labels, fh, fw)
            vw = gt_valid.float()
            ngt = torch.clamp_min(vw.sum(1), 1.0)
            ncell = torch.clamp_min(vw.sum(1) * 2, 1.0)
        p = torch.minimum(torch.maximum(hm, hm.new_full((), 1e-4)), hm.new_full((), 1 - 1e-4))
        l_hm = self.loss_hm(p, hm_t, reduction_override="none").flatten(1).sum(1) / ngt
        cell = (iy * fw + ix)[:, None, :]                                  # (N, 1, G)

        def at(m):                                                         # (N, G, 2)
            return torch.gather(m.flatten(2), 2, cell.expand(n, 2, cell.shape[-1])).transpose(1, 2)

        l_wh = ((at(wh) - size_t).abs() * vw[..., None]).flatten(1).sum(1) / ncell
        l_off = ((at(off) - off_t).abs() * vw[..., None]).flatten(1).sum(1) / ncell
        return dict(loss_center_heatmap=images_mean(l_hm),
                    loss_wh=self.wh_weight * images_mean(l_wh),
                    loss_offset=self.off_weight * images_mean(l_off))

    def get_bboxes(self, outs, img_shapes, scale_factors, rescale: bool = True, cfg=None):
        """Detections of N images: dets (N, max_per_img, 5), labels, valid
        (score > 0)."""
        hm, wh, off = outs
        cfg = dict(cfg or self.test_cfg)
        k = int(cfg.get("max_per_img", 100))
        n, nc, fh, fw = hm.shape
        hmax = F.max_pool2d(hm, 3, 1, 1)
        peaks = torch.where(hm == hmax, hm, torch.zeros_like(hm))
        scores, idx = sort_desc(peaks.permute(0, 2, 3, 1).reshape(n, -1), k)
        cls = idx % nc
        pix = idx // nc
        ys = (pix // fw).float()
        xs = (pix % fw).float()
        o = torch.gather(off.flatten(2), 2, pix[:, None].expand(n, 2, k))
        s = torch.gather(wh.flatten(2), 2, pix[:, None].expand(n, 2, k))
        cx = (xs + o[:, 0]) * self.stride
        cy = (ys + o[:, 1]) * self.stride
        bw = s[:, 0] * self.stride
        bh = s[:, 1] * self.stride
        boxes = torch.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2], -1)
        if rescale:
            boxes = boxes / scale_factors.float()[:, None, :4]
        return torch.cat([boxes, scores[..., None]], -1), cls, scores > 0


@DETECTORS.register_module()
class CenterNet(SingleStageDetector):
    """``oadg_tpu/models/dense_heads/centernet_head.py:144``."""
