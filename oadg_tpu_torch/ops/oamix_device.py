"""On-device OA-Mix (port of the production path of ``oadg_tpu/ops/oamix_device.py``).

Per image and augmented view (``_oamix_single``, ``:1090-1379``):

1. multilevel random boxes (hard masks) partition the image into slots;
2. per-gt saliency scores (``ops.saliency``) and the foreground maps of the
   blurred gt masks, kernel B3 (``_precompute_fg_maps``, ``:421-454``);
3. the AugMix chain: ``mixture_width`` chains of ``depth`` steps; each step
   applies one drawn op per active slot to the whole image and keeps it
   inside the slot. Two chains compute it, chosen by ``chain``:

   - ``"slots"`` (``_aug_once``, ``:900-1085``, the op order of
     ``get_aug_list``): PIL photometric ops (``ops.photometric``; equalize on
     kernel B6), per-box geometric ops on the piecewise row shift B5
     (``_pw_rotate/_pw_shear/_pw_translate``, ``:457-570``; with
     ``geo_pw=False`` on the per-pixel gather path, ``_apply_geo_bboxes_only``,
     ``:573-613``) and background geometric ops on the row shift B4 blended
     through the fg union (``_bg_blend``);
   - ``"merged"`` (``_depth_step_merged``, ``:638-897``): one photometric
     pass per depth step for all slots, with shared image statistics (one
     pair of autocontrast extremes, one equalize histogram), then per slot
     that drew a geometric op one X Y X trio of the merged row shift B7 on
     the 4-channel image (rgb + fg-union alpha);

   the chain state is uint8 between steps;
4. Dirichlet mixing of the chains, then the sequential overlap-corrected
   object-aware mixing with the original image over low-saliency gts and
   random boxes, and ``floor(clip(.))`` to uint8.

Draws. One code path, driven by a draw table in the JAX package's layout
(``:1096-1103``; each key with leading (B, V-1) dims): ``ml_boxes``,
``ml_valid``, ``ws``, ``depth``, ``op_idx``, ``op_level``, ``op_sign``,
``op_coin``, ``oa_boxes``, ``oa_valid`` (or ``oa_valid0``), ``mix_us``,
``m_global`` and optionally ``fg_scores``. ``oamix_batch(draws=None,
generator=...)`` fills the table on the host from a CPU ``torch.Generator``
(``draw_table``): the random boxes from the host copy of ``img_shape``,
Dirichlet(1, ..., 1) as normalized -log U, Beta(1, 1) as U. Saliency scores
are computed on the device unless the table gives ``fg_scores``; without
``oa_valid`` the device masks ``oa_valid0`` by the count of low-saliency gts.
Op dispatch, depths and active slots are Python control flow on host values;
the numeric part of the table goes to the device in one copy (pinned,
non-blocking, on CUDA), and nothing is read back from the device.

Values kept from the JAX package: ``best_id`` int8 with sentinel G, ``cover``
and ``union`` in bf16, the background alpha ``bf16(union * 255)``, the warp
clamps. Warp outputs are float32 as on the JAX package's CPU path (on the TPU
it rounds them to bf16 lanes).

Knobs, keyword arguments of ``oamix_batch`` whose defaults read the JAX
package's environment variables: ``chain`` (``OAMIX_CHAIN``, ``slots`` or
``merged``), ``geo_pw`` (``OAMIX_GEO_PW``; only ``0`` selects the gather path,
on the card and on the CPU alike; the merged chain ignores it),
``force_op`` (``OAMIX_FORCE_OP``, every op index of the table),
``skip_chain`` and ``skip_mix`` (``OAMIX_SKIP_CHAIN``, ``OAMIX_SKIP_MIX``,
for profiling). Not ported: ``OAMIX_LANES`` / ``OAMIX_F32_LANES``, which
choose the type in which the state crosses TPU conditionals.
"""
from __future__ import annotations

import functools
import math
import os
from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from .fg_maps import fg_maps
from .photometric import (autocontrast, blend, color_degenerate, contrast_degenerate,
                          enhance_brightness, enhance_color, enhance_contrast,
                          enhance_sharpness, equalize, invert, posterize,
                          sharpness_degenerate, solarize)
from .saliency import saliency_score
from .warp import (fma, merged_shift_rows, piecewise_shift_rows, warp_rotate,
                   warp_shear_x, warp_shear_y, warp_translate_x, warp_translate_y)

__all__ = ["MAX_ML", "MAX_OA", "MAX_FG", "ATTEMPTS", "MAX_DEPTH", "N_SLOTS",
           "num_photometric", "draw_table", "oamix_batch"]

MAX_ML = 2          # multilevel random boxes
MAX_OA = 5          # object-aware random boxes
MAX_FG = 16         # gts taking part in the per-box warps and the mixing
ATTEMPTS = 8        # draws per random-box slot
MAX_DEPTH = 3
N_SLOTS = MAX_ML + 1
_BB_MAX_SHIFT = {1: 512, 0: 768}     # per-box pass clamps: x passes (axis 1), y passes


def num_photometric(version: str) -> int:
    """Photometric ops in front of the 6 geometric ones: 4 for ``augmix``,
    9 for ``augmix.all``."""
    return 4 if version == "augmix" else 9


def _f32(v) -> np.float32:
    return np.float32(v)


def _r(c) -> np.float32:
    """XLA compiles a division by the constant ``c`` as a multiplication by
    float32 ``1 / c``; the port rounds as the compiled JAX package does."""
    return np.float32(1.0 / c)


def _k(*factors) -> np.float32:
    """The float32 product of constant factors, folded left to right as XLA
    folds ``x * c1 * c2 / c3`` into ``x * ((c1 * c2) * (1 / c3))``."""
    out = np.float32(factors[0])
    for f in factors[1:]:
        out = np.float32(out * np.float32(f))
    return out


# ---------------------------------------------------------------- draws ----

def _sample_random_boxes(gen: torch.Generator, img_shape, scale_rng, ratio_rng,
                         max_boxes: int, num_lo: int, num_hi: int):
    """Host version of ``_sample_random_boxes`` (``:168-215``): up to
    ``max_boxes`` slots, the first ``target ~ U{num_lo..num_hi-1}`` of them
    taking the first of ATTEMPTS candidates that fits the image and misses
    every earlier valid box. -> boxes (max_boxes, 4) f32, valid (max_boxes,)."""
    h, w = _f32(img_shape[0]), _f32(img_shape[1])
    target = int(torch.randint(num_lo, num_hi, (), generator=gen))
    s_lo, s_hi = _f32(min(scale_rng)), _f32(max(scale_rng))
    r_lo, r_hi = _f32(min(ratio_rng)), _f32(max(ratio_rng))
    boxes = np.zeros((max_boxes, 4), np.float32)
    valid = np.zeros((max_boxes,), bool)
    for i in range(max_boxes):
        u = torch.rand((ATTEMPTS, 4), generator=gen).numpy()
        x1 = np.floor(u[:, 0] * w)
        y1 = np.floor(u[:, 1] * h)
        s = (s_lo + u[:, 2] * (s_hi - s_lo)) * h * w
        r = r_lo + u[:, 3] * (r_hi - r_lo)
        bw = np.floor(np.sqrt(s / r))
        bh = np.floor(np.sqrt(s * r))
        ok = (x1 + bw <= w) & (y1 + bh <= h) & (bw >= 1) & (bh >= 1)
        cand = np.stack([x1, y1, x1 + bw, y1 + bh], -1).astype(np.float32)
        iw = np.maximum(np.minimum(cand[:, None, 2], boxes[None, :, 2])
                        - np.maximum(cand[:, None, 0], boxes[None, :, 0]), 0)
        ih = np.maximum(np.minimum(cand[:, None, 3], boxes[None, :, 3])
                        - np.maximum(cand[:, None, 1], boxes[None, :, 1]), 0)
        ok &= ~((iw * ih > 1e-6) & valid[None, :]).any(axis=1)
        if i < target and ok.any():
            boxes[i] = cand[int(np.argmax(ok))]
            valid[i] = True
    return boxes, valid


def draw_table(img_shape, cfg: Dict, generator: torch.Generator) -> Dict[str, np.ndarray]:
    """Every draw of ``oamix_batch`` for (B, 2) host image shapes, from a CPU
    generator, in the JAX package's table layout (leading (B, V-1) dims);
    ``oa_valid0`` is the random boxes' own validity, before the device masks
    it by the count of low-saliency gts."""
    if generator is None or generator.device.type != "cpu":
        raise ValueError("OA-Mix draws its table on the host: pass a CPU torch.Generator")
    img_shape = np.asarray(img_shape, np.float32)
    n_aug = max(int(cfg.get("num_views", 2)) - 1, 0)
    width = int(cfg.get("mixture_width", 3))
    depth_cfg = int(cfg.get("mixture_depth", -1))
    severity = _f32(cfg.get("severity", 10))
    max_fg = int(cfg.get("max_fg", MAX_FG))
    n_ops = num_photometric(cfg.get("version", "augmix")) + 6
    rand = lambda *shape: torch.rand(shape, generator=generator).numpy()
    views = []
    for shape in img_shape:
        for _ in range(n_aug):
            ml_boxes, ml_valid = _sample_random_boxes(
                generator, shape, cfg.get("random_box_scale", (0.01, 0.1)),
                cfg.get("random_box_ratio", (3, 1 / 3)), MAX_ML, 1, 3)
            e = -np.log1p(-rand(width))                       # Dirichlet(1, ..., 1)
            depth = (np.full((width,), depth_cfg) if depth_cfg > 0 else
                     torch.randint(1, MAX_DEPTH + 1, (width,), generator=generator).numpy())
            op_idx = torch.randint(0, n_ops, (width, MAX_DEPTH, N_SLOTS),
                                   generator=generator).numpy()
            level = _f32(0.1) + rand(width, MAX_DEPTH, N_SLOTS, max_fg) * (severity - _f32(0.1))
            sign = np.where(rand(width, MAX_DEPTH, N_SLOTS, max_fg) > 0.5, -1.0, 1.0)
            oa_boxes, oa_valid0 = _sample_random_boxes(
                generator, shape, cfg.get("oa_random_box_scale", (0.005, 0.1)),
                cfg.get("oa_random_box_ratio", (3, 1 / 3)), MAX_OA, 1, MAX_OA + 1)
            views.append(dict(
                ml_boxes=ml_boxes, ml_valid=ml_valid,
                ws=(e / e.sum()).astype(np.float32), depth=depth.astype(np.int32),
                op_idx=op_idx.astype(np.int32), op_level=level.astype(np.float32),
                op_sign=sign.astype(np.float32),
                op_coin=rand(width, MAX_DEPTH, N_SLOTS),
                oa_boxes=oa_boxes, oa_valid0=oa_valid0,
                mix_us=rand(max_fg + MAX_OA), m_global=rand()))
    b = img_shape.shape[0]
    return {k: np.stack([v[k] for v in views]).reshape(b, n_aug, *views[0][k].shape)
            for k in views[0]} if views else {}


def _rotation_params(level: np.ndarray, sign: np.ndarray):
    """-tan(rad / 2) and sin(rad) of ``floor(level * 30 / 10) * sign``
    degrees, in float32 (torch's CPU trigonometry, as the JAX package's)."""
    deg = np.floor(level * _k(30.0, _r(10.0))) * sign
    rad = torch.from_numpy(np.ascontiguousarray(deg, np.float32)) * (math.pi / 180)
    return (-torch.tan(rad / 2.0)).numpy(), torch.sin(rad).numpy()


_ON_DEVICE = ("ml_boxes", "ml_valid", "oa_boxes", "oa_valid", "oa_valid0", "mix_us",
              "m_global", "fg_scores", "op_level", "op_sign", "rot_a", "rot_b")


def _upload(table: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """The numeric keys of the table as float32 device tensors, sent as one
    buffer (pinned and non-blocking on CUDA)."""
    keys = [k for k in _ON_DEVICE if k in table]
    parts = [np.asarray(table[k], np.float32).reshape(-1) for k in keys]
    flat = torch.from_numpy(np.concatenate(parts))
    device = torch.device(device)
    if device.type == "cuda":
        flat = flat.pin_memory().to(device, non_blocking=True)
    out, start = {}, 0
    for k, p in zip(keys, parts):
        out[k] = flat[start:start + p.size].view(np.shape(table[k]))
        start += p.size
    return out


# ------------------------------------------------------------ fg maps ----

_ERF_P = (0.00022905065861350646, 0.0034082910107109506, 0.050955695062380861,
          0.18520832239976145, 1.128379143519084)
_ERF_Q = (-1.1791602954361697e-7, 0.000023547966471313185, 0.0010179625278914885,
          0.014070470171167667, 0.11098505178285362, 0.49746925110067538, 1.0)


def _erf(x: torch.Tensor) -> torch.Tensor:
    """float32 erf as XLA evaluates it (``x * P(x^2) / Q(x^2)`` on x clamped
    to +-erfinv(1 - 2^-23), Horner steps fused): elementwise float32 and
    float64 ops, so the card and the CPU round alike."""
    x = torch.clamp(x, -3.7439211627767994, 3.7439211627767994)
    x2 = x * x

    def horner(cs):
        r = torch.full_like(x2, float(np.float32(cs[0])))
        for c in cs[1:]:
            r = fma(r, x2, float(np.float32(c)))
        return r

    return x * horner(_ERF_P) / horner(_ERF_Q)


def _box_blur_1d(t, a, b, sigma):
    """A 1-D box [a, b) convolved with a Gaussian of ``sigma``, at ``t``."""
    s = sigma * math.sqrt(2)
    return 0.5 * (_erf((t - a) / s) - _erf((t - b) / s))


def _blurred_profiles(boxes: torch.Tensor, h: int, w: int, sigma_ratio: float):
    """Per box the x and y profiles of its blurred mask, (G, W) and (G, H),
    with the REFLECT_101 terms about both borders, clipped to [0, 1]."""
    x1, y1, x2, y2 = (boxes[:, i:i + 1] for i in range(4))
    c = float(_k(sigma_ratio, 2.0, _r(3.0)))
    sx = torch.clamp((x2 - x1) * c, min=1e-3)
    sy = torch.clamp((y2 - y1) * c, min=1e-3)
    xs = torch.arange(w, dtype=torch.float32, device=boxes.device) + 0.5
    ys = torch.arange(h, dtype=torch.float32, device=boxes.device) + 0.5
    fx = (_box_blur_1d(xs, x1, x2, sx) + _box_blur_1d(-xs, x1, x2, sx)
          + _box_blur_1d(2.0 * w - xs, x1, x2, sx))
    fy = (_box_blur_1d(ys, y1, y2, sy) + _box_blur_1d(-ys, y1, y2, sy)
          + _box_blur_1d(2.0 * h - ys, y1, y2, sy))
    return torch.clamp(fx, 0.0, 1.0), torch.clamp(fy, 0.0, 1.0)


def _hard_profiles(boxes: torch.Tensor, h: int, w: int):
    """Per box the 0/1 x and y profiles of its floored hard mask."""
    b = torch.floor(boxes)
    xs = torch.arange(w, dtype=torch.float32, device=boxes.device)
    ys = torch.arange(h, dtype=torch.float32, device=boxes.device)
    fx = ((xs >= b[:, 0:1]) & (xs < b[:, 2:3])).float()
    fy = ((ys >= b[:, 1:2]) & (ys < b[:, 3:4])).float()
    return fx, fy


class _FgInfo(NamedTuple):
    """The gts of one view and the maps every aug call shares (``:402-418``)."""
    boxes: torch.Tensor      # (G, 4)
    cx: torch.Tensor         # (G,) box centres and extents (+1, as the reference)
    cy: torch.Tensor
    bw: torch.Tensor
    bh: torch.Tensor
    best_id: torch.Tensor    # (H, W) int8, G where no mask reaches BID_EPS
    cover: torch.Tensor      # (H, W) bf16, 1 - prod(1 - m_i)
    union: torch.Tensor      # (H, W) bf16, max m_i


def _precompute_fg(boxes, valid, fx, fy) -> _FgInfo:
    """The gated profiles through kernel B3 (``_precompute_fg_maps``)."""
    small = ((boxes[:, 2] - boxes[:, 0]) < 1) | ((boxes[:, 3] - boxes[:, 1]) < 1)
    gate = (valid & ~small).float()
    best_id, cover, union = fg_maps(fx, fy * gate[:, None], fy.shape[1], fx.shape[1])
    return _FgInfo(boxes, (boxes[:, 0] + boxes[:, 2]) / 2.0,
                   (boxes[:, 1] + boxes[:, 3]) / 2.0,
                   boxes[:, 2] - boxes[:, 0] + 1, boxes[:, 3] - boxes[:, 1] + 1,
                   best_id, cover, union)


# -------------------------------------------------------------- the ops ----

class _OpDraws(NamedTuple):
    """One aug call's draws: host level, sign and coin (level[0] and sign[0]
    drive the photometric and background ops) and the device rows for the
    per-box ops."""
    level: np.ndarray        # (G,) f32
    sign: np.ndarray         # (G,) f32
    coin: float
    level_dev: torch.Tensor  # (G,)
    sign_dev: torch.Tensor
    rot_a: torch.Tensor      # (G,) -tan(rad / 2)
    rot_b: torch.Tensor      # (G,) sin(rad)
    rot_a_host: float        # rot_a[0] and rot_b[0] on the host, for the merged
    rot_b_host: float        # chain's background rotate


def _pw_finish(img, warped, fg: _FgInfo):
    cov = fg.cover.float()[..., None]
    return torch.clamp(torch.round(fma(img, 1.0 - cov, warped * cov)), 0, 255)


def _bb_tables(family: int, fg: _FgInfo, dr: _OpDraws, h: int, w: int):
    """The shift passes of a bboxes_only rotate (0), shear (1) or translate
    (2), as (axis, table) pairs with tables (keys, G) before their clamp:
    the Paeth trio X(a1) Y(b2) X(a1) for a rotate, one pass along the coin's
    axis otherwise."""
    g = fg.boxes.shape[0]
    dev = fg.boxes.device
    ys = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    xs = torch.arange(w, dtype=torch.float32, device=dev)[:, None]
    use_x = dr.coin < 0.5
    if family == 0:
        p1 = dr.rot_a[None, :] * (ys - fg.cy[None, :])
        return [(1, p1), (0, dr.rot_b[None, :] * (xs - fg.cx[None, :])), (1, p1)]
    if family == 1:
        sh = dr.level_dev * float(_k(0.3, _r(10.0))) * dr.sign_dev
        return [(1, sh[None, :] * (ys - fg.cy[None, :]))] if use_x else \
            [(0, sh[None, :] * (xs - fg.cx[None, :]))]
    extent, n = (fg.bw, h) if use_x else (fg.bh, w)
    t = torch.floor(dr.level_dev * (extent * float(_r(3.0))) * float(_r(10.0))) * dr.sign_dev
    return [(1 if use_x else 0, t[None, :].expand(n, g))]


def _bb_geo(img: torch.Tensor, family: int, fg: _FgInfo, dr: _OpDraws):
    """bboxes_only rotate (0), shear (1) and translate (2) on kernel B5: each
    pixel moves with its strongest box (``best_id``), blended by ``cover``."""
    out = img
    for axis, p in _bb_tables(family, fg, dr, img.shape[0], img.shape[1]):
        out = piecewise_shift_rows(out, fg.best_id, p, _BB_MAX_SHIFT[axis], axis=axis)
    return _pw_finish(img.float(), out, fg)


# The gather path of the per-box warps (``geo_pw=False``): forward affines
# per box, inverted, gathered per pixel by ``best_id`` and resampled in two
# axis-aligned passes. Plain tensor code in the JAX package too.

def _op_matrices(family: int, boxes: torch.Tensor, img_shape, level: torch.Tensor,
                 sign: torch.Tensor, use_x: bool, is_bg: bool = False) -> torch.Tensor:
    """Forward 2x3 affines (G, 2, 3) of one geometric family (0 rotate, 1
    shear_xy, 2 translate_xy) from per-box levels and signs and the call's
    axis coin (``:220-283``): about the box centres and scaled by the box
    extents for bboxes_only, about the image centre and scaled by the image
    for ``is_bg``."""
    h, w = float(img_shape[0]), float(img_shape[1])
    g = boxes.shape[0]
    full = lambda v: torch.full((g,), v, dtype=torch.float32, device=boxes.device)
    if is_bg:
        cx, cy, bw, bh = full(w / 2.0), full(h / 2.0), full(w), full(h)
    else:
        cx = (boxes[:, 0] + boxes[:, 2]) / 2.0
        cy = (boxes[:, 1] + boxes[:, 3]) / 2.0
        bw = boxes[:, 2] - boxes[:, 0] + 1
        bh = boxes[:, 3] - boxes[:, 1] + 1
    zeros, ones = full(0.0), full(1.0)
    rows = lambda a, b, c, d, e, f: torch.stack(
        [torch.stack([a, b, c], -1), torch.stack([d, e, f], -1)], -2)
    if family == 0:
        deg = torch.floor(level * float(_k(30.0, _r(10.0)))) * sign
        rad = deg * (math.pi / 180)
        ca, sa = torch.cos(rad), torch.sin(rad)
        return rows(ca, sa, (1 - ca) * cx - sa * cy, -sa, ca, sa * cx + (1 - ca) * cy)
    if family == 1:
        sh = level * float(_k(0.3, _r(10.0))) * sign
        if use_x:
            return rows(ones, -sh, zeros if is_bg else sh * cy, zeros, ones, zeros)
        return rows(ones, zeros, zeros, -sh, ones, zeros if is_bg else sh * cx)
    if use_x:
        shift = torch.floor(level * (bw * float(_r(3.0))) * float(_r(10.0))) * sign
        return rows(ones, zeros, -shift, zeros, ones, zeros)
    shift = torch.floor(level * (bh * float(_r(3.0))) * float(_r(10.0))) * sign
    return rows(ones, zeros, zeros, zeros, ones, -shift)


def _invert_2x3(m: torch.Tensor) -> torch.Tensor:
    """The inverse of (..., 2, 3) affines (``:286-294``)."""
    a, b, tx = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    c, d, ty = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    det = a * d - b * c
    det = torch.where(det.abs() < 1e-12, torch.full_like(det, 1e-12), det)
    ia, ib, ic, id_ = d / det, -b / det, -c / det, a / det
    return torch.stack([torch.stack([ia, ib, -(ia * tx + ib * ty)], -1),
                        torch.stack([ic, id_, -(ic * tx + id_ * ty)], -1)], -2)


def _lerp_axis(img: torch.Tensor, idx: torch.Tensor, frac: torch.Tensor,
               axis: int) -> torch.Tensor:
    """Two-tap interpolation of ``img`` (H, W, C) along ``axis`` at the
    per-pixel positions ``idx + frac``, zeros outside (``:344-358``). The JAX
    package reads both taps from a channel-paired table at ``clip(idx)``, so
    at ``idx == -1`` its second tap is pixel 1, not pixel 0; the port reads
    the same pixels."""
    h, w, c = img.shape
    limit = img.shape[axis]
    at = lambda i: torch.gather(img, axis, i[..., None].expand(h, w, c))
    base = idx.clamp(0, limit - 1)
    ok = (idx >= -1) & (idx <= limit - 1)
    zero = torch.zeros((), device=img.device)
    a = torch.where((ok & (idx >= 0))[..., None], at(base), zero)
    b = torch.where((ok & (idx + 1 <= limit - 1))[..., None],
                    at((base + 1).clamp(max=limit - 1)), zero)
    f = frac[..., None]
    return fma(a, 1 - f, b * f)


def _resample_2pass(img: torch.Tensor, gx: torch.Tensor, sy: torch.Tensor) -> torch.Tensor:
    """A row pass at the source columns ``gx`` (H, W), then a column pass at
    the source rows ``sy``."""
    x0 = torch.floor(gx)
    tmp = _lerp_axis(img, x0.long(), gx - x0, 1)
    y0 = torch.floor(sy)
    return _lerp_axis(tmp, y0.long(), sy - y0, 0)


def _grid(h: int, w: int, device):
    return (torch.arange(w, dtype=torch.float32, device=device)[None, :],
            torch.arange(h, dtype=torch.float32, device=device)[:, None])


def _warp_affine_2pass(img: torch.Tensor, inv: torch.Tensor) -> torch.Tensor:
    """Affine warp of (H, W, C) by the 2x3 output-to-source map ``inv`` as a
    horizontal then a vertical resampling (Catmull-Smith, ``:361-399``)."""
    img = img.float()
    h, w = img.shape[0], img.shape[1]
    a, b, cc = inv[0, 0], inv[0, 1], inv[0, 2]
    d, e, f = inv[1, 0], inv[1, 1], inv[1, 2]
    e_safe = torch.where(e.abs() < 1e-3, torch.full_like(e, 1e-3), e)
    xo, yo = _grid(h, w, img.device)
    gx = (a - b * d / e_safe) * xo + (b / e_safe) * yo + (cc - b * f / e_safe)
    return _resample_2pass(img, gx.expand(h, w), (d * xo + e * yo + f).expand(h, w))


def _warp_by_pixel_matrices(img: torch.Tensor, inv_map: torch.Tensor) -> torch.Tensor:
    """Bilinear sampling with per-pixel inverse affines ``inv_map`` (H, W, 6)
    rows [ia, ib, itx, ic, id, ity]; zeros outside (``:297-339``). The second
    x tap is read beside the clipped first one, as the JAX package's paired
    table gives it."""
    img = img.float()
    h, w, c = img.shape
    xs, ys = _grid(h, w, img.device)
    sx = inv_map[..., 0] * xs + inv_map[..., 1] * ys + inv_map[..., 2]
    sy = inv_map[..., 3] * xs + inv_map[..., 4] * ys + inv_map[..., 5]
    x0, y0 = torch.floor(sx), torch.floor(sy)
    fx, fy = (sx - x0)[..., None], (sy - y0)[..., None]
    x0i, y0i = x0.long(), y0.long()
    inx = (x0i >= 0) & (x0i < w)
    inx1 = (x0i + 1 >= 0) & (x0i + 1 < w)
    xa = x0i.clamp(0, w - 1)
    xb = (xa + 1).clamp(max=w - 1)
    zero = torch.zeros((), device=img.device)

    def tap(yi):
        iny = (yi >= 0) & (yi < h)
        yc = yi.clamp(0, h - 1)
        return (torch.where((iny & inx)[..., None], img[yc, xa], zero),
                torch.where((iny & inx1)[..., None], img[yc, xb], zero))

    v00, v01 = tap(y0i)
    v10, v11 = tap(y0i + 1)
    return (v00 * (1 - fx) + v01 * fx) * (1 - fy) + (v10 * (1 - fx) + v11 * fx) * fy


def _apply_geo_bboxes_only(img: torch.Tensor, fg: _FgInfo, inv_boxes: torch.Tensor):
    """bboxes_only_* on the gather path (``:573-613``): each pixel takes the
    inverse affine of its strongest box (the identity for the sentinel id)
    into one two-pass resampling, blended by ``cover``."""
    img = img.float()
    h, w = img.shape[0], img.shape[1]
    ident = torch.tensor([[1.0, 0.0, 0.0, 0.0, 1.0, 0.0]], device=img.device)
    m = torch.cat([inv_boxes, ident])[fg.best_id.long()]          # (H, W, 6)
    xo, u = _grid(h, w, img.device)
    e = torch.where(m[..., 4].abs() < 1e-3, torch.full_like(m[..., 4], 1e-3), m[..., 4])
    gx = ((m[..., 0] - m[..., 1] * m[..., 3] / e) * xo + (m[..., 1] / e) * u
          + (m[..., 2] - m[..., 1] * m[..., 5] / e))
    warped = _resample_2pass(img, gx, m[..., 3] * xo + m[..., 4] * u + m[..., 5])
    return _pw_finish(img, warped, fg)


def _bb_geo_gather(img: torch.Tensor, family: int, fg: _FgInfo, dr: _OpDraws):
    """bboxes_only rotate (0), shear (1) and translate (2) on the gather path
    (``_geo_gather``, ``:969-973``)."""
    mats = _op_matrices(family, fg.boxes, img.shape[:2], dr.level_dev, dr.sign_dev,
                        dr.coin < 0.5)
    return _apply_geo_bboxes_only(img, fg, _invert_2x3(mats).reshape(-1, 6))


def _with_alpha(x: torch.Tensor, fg: _FgInfo) -> torch.Tensor:
    """The float32 image with the fg-union alpha ``bf16(union * 255)`` as a
    fourth channel: what the background warps move."""
    return torch.cat([x, (fg.union.float() * 255.0).to(torch.bfloat16).float()[..., None]], -1)


def _bg_finish(x: torch.Tensor, w4: torch.Tensor, fg: _FgInfo) -> torch.Tensor:
    """The warped background ``w4[..., :3]`` where neither the fg union nor
    its warp ``w4[..., 3] / 255`` holds, the image ``x`` elsewhere."""
    kept = torch.maximum(fg.union.float(), w4[..., 3] * float(_r(255.0)))[..., None]
    return torch.clamp(torch.round(fma(kept, x, (1.0 - kept) * w4[..., :3])), 0, 255)


def _bg_geo(img: torch.Tensor, family: int, fg: _FgInfo, dr: _OpDraws):
    """bg_only rotate (0), shear (1) and translate (2) on kernel B4 (``:990-1054``):
    the image and its alpha warp as one 4-channel image."""
    h, w = img.shape[0], img.shape[1]
    imgw = img.float()
    x4 = _with_alpha(imgw, fg)
    lvl, sign = dr.level[0], dr.sign[0]
    use_x = dr.coin < 0.5
    if family == 0:
        deg = np.floor(lvl * _k(30.0, _r(10.0))) * sign
        rad = _f32(torch.deg2rad(torch.tensor(deg, dtype=torch.float32)))
        w4 = warp_rotate(x4, rad, w / 2.0, h / 2.0, int(0.27 * h / 2) + 4,
                         int(0.50 * w / 2) + 4)
    elif family == 1:
        s = lvl * _k(0.3, _r(10.0)) * sign
        w4 = (warp_shear_x(x4, s, 0.0, 0.0, int(0.3 * h) + 4) if use_x else
              warp_shear_y(x4, s, 0.0, 0.0, int(0.3 * w) + 4))
    else:
        if use_x:
            tx = np.floor(lvl * _k(w / 3.0, _r(10.0))) * sign
            w4 = warp_translate_x(x4, tx, w // 3 + 4)
        else:
            ty = np.floor(lvl * _k(h / 3.0, _r(10.0))) * sign
            w4 = warp_translate_y(x4, ty, h // 3 + 4)
    return _bg_finish(imgw, w4, fg)


def _enhance_factor(level) -> np.float32:
    """``level * 1.8 / 10 + 0.1`` of the PIL enhance ops."""
    return _f32(fma(float(level), float(_k(1.8, _r(10.0))), float(_f32(0.1))))


def _posterize_bits(level) -> int:
    return max(4 - int(np.floor(level * _k(4.0, _r(10.0)))), 1)


def _solarize_threshold(level) -> float:
    return float(256 - int(np.floor(level * _k(256.0, _r(10.0)))))


def _aug_once(img: torch.Tensor, op: int, fg: _FgInfo, dr: _OpDraws,
              version: str, geo_pw: bool = True) -> torch.Tensor:
    """One reference ``aug()`` call on the uint8 chain state: the op of index
    ``op`` in ``get_aug_list`` order (photometric ops, then bboxes_only
    rotate / shear_xy / translate_xy, then bg_only rotate / shear_xy /
    translate_xy), applied to the whole image -> uint8. ``geo_pw=False``
    sends the bboxes_only ops down the gather path."""
    n_photo = num_photometric(version)
    lvl = dr.level[0]
    if op >= n_photo + 3:
        out = _bg_geo(img, op - n_photo - 3, fg, dr)
    elif op >= n_photo:
        out = (_bb_geo if geo_pw else _bb_geo_gather)(img, op - n_photo, fg, dr)
    elif op == 0:
        out = autocontrast(img)
    elif op == 1:
        out = equalize(img)
    elif op == 2:
        out = posterize(img, _posterize_bits(lvl))
    elif op == 3:
        out = solarize(img, _solarize_threshold(lvl))
    elif op == 4:
        out = invert(img)
    else:
        out = (enhance_color, enhance_contrast, enhance_brightness,
               enhance_sharpness)[op - 5](img, _enhance_factor(lvl))
    return torch.clamp(out, 0, 255).to(torch.uint8)


# --------------------------------------------------------- merged chain ----

class _MergedCtx(NamedTuple):
    """Per-view constants of the merged depth step (``_merged_ctx``,
    ``:618-635``)."""
    in_slot: List[torch.Tensor]   # per slot the (H, W) bool map of its pixels
    no_bb: Dict[int, torch.Tensor]   # zero (keys, G) tables by axis, for bg trios
    no_sl: Dict[int, torch.Tensor]   # zero (keys, 1) tables by axis, for bb trios


def _merged_ctx(fg: _FgInfo, rects: Sequence, h: int, w: int) -> _MergedCtx:
    """The slot-id map from the hard multilevel boxes (the boxes partition
    the image: slot 0 wins over slot 1, the complement is the last slot) and
    what every warp trio of the view shares."""
    dev = fg.boxes.device
    g = fg.boxes.shape[0]
    slot_id = torch.full((h, w), len(rects), dtype=torch.int8, device=dev)
    for s in range(len(rects) - 1, -1, -1):
        if rects[s] is not None:
            r = rects[s]
            slot_id[r[0]:r[1], r[2]:r[3]] = s
    zeros = lambda n, k: torch.zeros((n, k), device=dev)
    return _MergedCtx([slot_id == s for s in range(len(rects) + 1)],
                      {1: zeros(h, g), 0: zeros(w, g)}, {1: zeros(h, 1), 0: zeros(w, 1)})


def _bg_tables(family: int, dr: _OpDraws, h: int, w: int, device):
    """The shift passes of a bg_only rotate (0), shear (1) or translate (2)
    of the merged chain, as (axis, table (keys, 1)) pairs clipped to the
    bounds of the slots chain's background warps (``:799-802, 857-868``)."""
    ys = torch.arange(h, dtype=torch.float32, device=device)[:, None]
    xs = torch.arange(w, dtype=torch.float32, device=device)[:, None]
    lvl, sign = dr.level[0], dr.sign[0]
    use_x = dr.coin < 0.5
    if family == 0:
        msx, msy = int(0.27 * h / 2) + 4, int(0.50 * w / 2) + 4
        q1 = torch.clamp(float(dr.rot_a_host) * (ys - h / 2.0), -msx, msx)
        q2 = torch.clamp(float(dr.rot_b_host) * (xs - w / 2.0), -msy, msy)
        return [(1, q1), (0, q2), (1, q1)]
    if family == 1:
        sh = float(lvl * _k(0.3, _r(10.0)) * sign)
        if use_x:
            ms = int(0.3 * h) + 4
            return [(1, torch.clamp(sh * ys, -ms, ms))]
        ms = int(0.3 * w) + 4
        return [(0, torch.clamp(sh * xs, -ms, ms))]
    if use_x:
        t = float(np.clip(np.floor(lvl * _k(w / 3.0, _r(10.0))) * sign, -(w // 3 + 4),
                          w // 3 + 4))
        return [(1, torch.full((h, 1), t, device=device))]
    t = float(np.clip(np.floor(lvl * _k(h / 3.0, _r(10.0))) * sign, -(h // 3 + 4), h // 3 + 4))
    return [(0, torch.full((w, 1), t, device=device))]


def _depth_step_merged(img: torch.Tensor, ops: Sequence[int], active: Sequence[bool],
                       draws: Sequence[_OpDraws], fg: _FgInfo, ctx: _MergedCtx,
                       version: str) -> torch.Tensor:
    """One depth step of the merged chain on the uint8 state (``:638-897``):
    every active slot's drawn op, selected per pixel by the slot map.

    All slots read the same input, so the photometric family shares one set
    of image statistics: one pair of autocontrast extremes and ONE equalize
    histogram (kernel B6) however many slots drew them; posterize, solarize
    and the enhance ops take their per-slot scalars per pixel through the
    slot map. Each slot that drew a geometric op runs one X Y X trio of
    kernel B7 on the 4-channel image (rgb + alpha) with S = 1 and ``best_id``
    as the composite id: a bboxes_only op shifts per box and blends by
    ``cover``, a bg_only op shifts the whole image and blends through the
    warped fg union. Which ops were drawn is known on the host, so only the
    drawn candidates are computed and the passes whose tables are zero (two
    of three for shear and translate; a zero shift is an exact identity) are
    not launched. -> uint8."""
    h, w = img.shape[0], img.shape[1]
    n_photo = num_photometric(version)
    slots = [s for s in range(len(ops)) if active[s]]
    x = img.float()                     # the state holds integers in [0, 255]
    lvl0 = [dr.level[0] for dr in draws]

    def px(vals, dtype=torch.float32):
        """Per-slot scalars as an (H, W, 1) map."""
        o = torch.full((h, w), vals[-1], dtype=dtype, device=img.device)
        for s in range(len(vals) - 2, -1, -1):
            o = torch.where(ctx.in_slot[s], vals[s], o)
        return o[..., None]

    factor = None
    out = x
    for op in sorted({ops[s] for s in slots if ops[s] < n_photo}):
        if op == 0:
            cand = autocontrast(x)
        elif op == 1:
            cand = equalize(img)
        elif op == 2:
            masks = [(255 << (8 - _posterize_bits(l))) & 255 for l in lvl0]
            cand = (img.to(torch.int32) & px(masks, torch.int32)).float()
        elif op == 3:
            cand = torch.where(x < px([_solarize_threshold(l) for l in lvl0]), x, 255.0 - x)
        elif op == 4:
            cand = invert(x)
        else:
            if factor is None:
                factor = px([float(_enhance_factor(l)) for l in lvl0])
            degenerate = (color_degenerate, contrast_degenerate, torch.zeros_like,
                          sharpness_degenerate)[op - 5](x)
            cand = blend(degenerate, x, factor)
        drew = [ctx.in_slot[s] for s in slots if ops[s] == op]
        out = torch.where(functools.reduce(torch.logical_or, drew)[..., None], cand, out)

    x4 = None
    for s in slots:
        family = ops[s] - n_photo
        if family < 0:
            continue
        if x4 is None:
            x4 = _with_alpha(x, fg)
        is_bb = family < 3
        if is_bb:
            passes = [(axis, torch.clamp(p, -_BB_MAX_SHIFT[axis], _BB_MAX_SHIFT[axis]))
                      for axis, p in _bb_tables(family, fg, draws[s], h, w)]
        else:
            passes = _bg_tables(family - 3, draws[s], h, w, img.device)
        warped = x4
        for axis, table in passes:
            p_bb, p_sl = (table, ctx.no_sl[axis]) if is_bb else (ctx.no_bb[axis], table)
            warped = merged_shift_rows(warped, fg.best_id, p_bb, p_sl, [is_bb], [not is_bb],
                                       axis=axis)
        geo = _pw_finish(x, warped[..., :3], fg) if is_bb else _bg_finish(x, warped, fg)
        out = torch.where(ctx.in_slot[s][..., None], geo, out)
    return torch.clamp(torch.round(out), 0, 255).to(torch.uint8)


# ------------------------------------------------------------- one view ----

class _Knobs(NamedTuple):
    """How ``oamix_batch`` was asked to run (see the module docstring)."""
    chain: str = "slots"
    geo_pw: bool = True
    skip_chain: bool = False
    skip_mix: bool = False


def _oamix_single(img: torch.Tensor, gt: torch.Tensor, gt_valid: torch.Tensor,
                  host: Dict[str, np.ndarray], dev: Dict[str, torch.Tensor],
                  cfg: Dict, knobs: _Knobs = _Knobs()):
    """One augmented view of one (H, W, 3) uint8 image (BGR, as the
    reference). ``host`` and ``dev`` are this view's rows of the draw table.
    -> (aug uint8, ml_boxes, ml_valid, oa_boxes, oa_valid)."""
    h, w = img.shape[0], img.shape[1]
    sigma_ratio = float(cfg.get("sigma_ratio", 0.3))
    version = cfg.get("version", "augmix")
    score_thr = float(cfg.get("score_thresh", 10))
    max_fg = int(cfg.get("max_fg", MAX_FG))
    width = host["ws"].shape[0]
    imgf = img.float()

    fg_boxes, fg_valid = gt[:max_fg].float(), gt_valid[:max_fg]
    g = fg_boxes.shape[0]
    if "fg_scores" in dev:
        scores = dev["fg_scores"][:g]
    else:
        scores = saliency_score(imgf, fg_boxes, min_size=int(cfg.get("spatial_ratio", 4)))
    scores = torch.where(fg_valid, scores, torch.full_like(scores, -1.0))
    fx, fy = _blurred_profiles(fg_boxes, h, w, sigma_ratio)
    fg = _precompute_fg(fg_boxes, fg_valid, fx, fy)

    # the multilevel boxes' slots: hard floored boxes, then the complement
    rects = []
    for s in range(MAX_ML):
        if host["ml_valid"][s]:
            x1, y1, x2, y2 = (int(v) for v in np.floor(host["ml_boxes"][s]))
            rects.append((max(y1, 0), max(y2, 0), max(x1, 0), max(x2, 0)))
        else:
            rects.append(None)

    def draws(i, d, s):
        return _OpDraws(host["op_level"][i, d, s, :g], host["op_sign"][i, d, s, :g],
                        float(host["op_coin"][i, d, s]), dev["op_level"][i, d, s, :g],
                        dev["op_sign"][i, d, s, :g], dev["rot_a"][i, d, s, :g],
                        dev["rot_b"][i, d, s, :g], float(host["rot_a"][i, d, s, 0]),
                        float(host["rot_b"][i, d, s, 0]))

    def slots_step(x, i, d):
        outs = [None if rects[s] is None else
                _aug_once(x, int(host["op_idx"][i, d, s]), fg, draws(i, d, s), version,
                          knobs.geo_pw)
                for s in range(MAX_ML)]
        nxt = _aug_once(x, int(host["op_idx"][i, d, MAX_ML]), fg, draws(i, d, MAX_ML),
                        version, knobs.geo_pw)
        for s, r in enumerate(rects):               # the complement everywhere else
            if r is not None:
                nxt[r[0]:r[1], r[2]:r[3]] = outs[s][r[0]:r[1], r[2]:r[3]]
        return nxt

    active = [r is not None for r in rects] + [True]
    mctx = _merged_ctx(fg, rects, h, w) if knobs.chain == "merged" else None

    def merged_step(x, i, d):
        return _depth_step_merged(x, [int(o) for o in host["op_idx"][i, d]], active,
                                  [draws(i, d, s) for s in range(N_SLOTS)], fg, mctx,
                                  version)

    if knobs.skip_chain:
        mixed = imgf * float(_f32(1.0000001))
    else:
        step = merged_step if knobs.chain == "merged" else slots_step
        mixed = torch.zeros((h, w, 3), device=img.device)
        for i in range(width):
            x = img
            for d in range(int(host["depth"][i])):
                x = step(x, i, d)
            mixed = fma(float(host["ws"][i]), x.float(), mixed)

    # object-aware mixing (``:1267-1379``): low-saliency gts and random boxes
    low_sal = fg_valid & (scores <= score_thr)
    oa_boxes = dev["oa_boxes"]
    if "oa_valid" in dev:
        oa_valid = dev["oa_valid"] > 0.5
    else:
        n_low = torch.clamp(low_sal.sum(), 1, MAX_OA)
        oa_valid = (dev["oa_valid0"] > 0.5) & (
            torch.arange(MAX_OA, device=img.device) < n_low)
    iw = torch.minimum(oa_boxes[:, None, 2], fg_boxes[None, :, 2]) - \
        torch.maximum(oa_boxes[:, None, 0], fg_boxes[None, :, 0])
    ih = torch.minimum(oa_boxes[:, None, 3], fg_boxes[None, :, 3]) - \
        torch.maximum(oa_boxes[:, None, 1], fg_boxes[None, :, 1])
    inter = torch.clamp(iw, min=0) * torch.clamp(ih, min=0)
    real = fg_valid & ((fg_boxes[:, 2] - fg_boxes[:, 0]) >= 1) & \
        ((fg_boxes[:, 3] - fg_boxes[:, 1]) >= 1)
    ovl = (inter > 1e-6) & real[None, :]
    oa_scores = torch.where(ovl, scores[None, :], torch.full_like(inter, math.inf)).amin(1)

    hx, hy = _hard_profiles(oa_boxes, h, w)
    rfx, rfy = torch.cat([fx, hx]), torch.cat([fy, hy])
    region_valid = torch.cat([low_sal, oa_valid])
    region_scores = torch.cat([scores, oa_scores])
    mix_us = dev["mix_us"]
    m_oa = torch.where(region_scores <= score_thr, mix_us[:g + MAX_OA] * 0.5,
                       mix_us[:g + MAX_OA])
    a_w = torch.zeros((h, w), device=img.device)
    b_w = torch.zeros((h, w), device=img.device)
    mask_sum = torch.zeros((h, w), device=img.device)
    for r in range(0 if knobs.skip_mix else g + MAX_OA):
        m = torch.where(region_valid[r], rfy[r][:, None] * rfx[r][None, :],
                        torch.zeros((), device=img.device))
        wgt = m - torch.minimum(mask_sum, m) * 0.5
        a_w = fma(1.0 - m_oa[r], wgt, a_w)
        b_w = fma(m_oa[r], wgt, b_w)
        mask_sum = torch.maximum(mask_sum, m)
    m_global = dev["m_global"]
    rest = 1.0 - mask_sum
    ow = fma(1.0 - m_global, rest, a_w)
    aw = fma(m_global, rest, b_w)
    out = fma(imgf, ow[..., None], mixed * aw[..., None])
    aug = torch.floor(torch.clamp(out, 0, 255)).to(torch.uint8)
    return aug, dev["ml_boxes"], dev["ml_valid"] > 0.5, oa_boxes, oa_valid


def _env_flag(name: str) -> bool:
    return bool(os.environ.get(name))


def oamix_batch(img_raw: torch.Tensor, gt_bboxes: torch.Tensor, gt_valid: torch.Tensor,
                img_shape, cfg: Dict, draws: Optional[Dict] = None,
                generator: Optional[torch.Generator] = None, *,
                chain: Optional[str] = None, geo_pw: Optional[bool] = None,
                force_op: Optional[int] = None, skip_chain: Optional[bool] = None,
                skip_mix: Optional[bool] = None) -> Dict[str, torch.Tensor]:
    """Batched multi-view OA-Mix (``:1382-1443``).

    Args:
        img_raw: (B, H, W, 3) uint8 (or integer-valued float) images, BGR.
        gt_bboxes / gt_valid: (B, G, 4) / (B, G) on the images' device.
        img_shape: (B, 2) valid (h, w) on the host (numpy or a CPU tensor);
            the random boxes are drawn from it.
        cfg: the OA-Mix config (``oamix_config`` of an OA-DG config).
        draws: a draw table with leading (B, V-1) dims, or None to draw one
            from ``generator`` (a CPU ``torch.Generator``).
        chain: ``"slots"`` or ``"merged"``; None reads ``OAMIX_CHAIN``
            (default ``slots``). One draw table drives either chain.
        geo_pw: False sends the slots chain's bboxes_only ops down the
            gather path; None reads ``OAMIX_GEO_PW`` (only ``0`` is False).
        force_op: every op index of the table becomes this one; None reads
            ``OAMIX_FORCE_OP``.
        skip_chain / skip_mix: profiling knobs: the chain's result becomes
            ``img * 1.0000001``, the object-aware regions are left out; None
            reads ``OAMIX_SKIP_CHAIN`` / ``OAMIX_SKIP_MIX`` (set means True).

    Returns ``aug`` (B, V-1, H, W, 3) uint8, ``multilevel_boxes`` (B, MAX_ML,
    4) + ``multilevel_valid``, ``oamix_boxes`` (B, MAX_OA, 4) +
    ``oamix_valid`` (the last view's, as the reference keeps them), and
    ``draws``, the host table the call ran on.
    """
    b = img_raw.shape[0]
    dev_ = img_raw.device
    n_aug = max(int(cfg.get("num_views", 2)) - 1, 0)
    img_u8 = img_raw if img_raw.dtype == torch.uint8 else \
        torch.clamp(img_raw.float(), 0, 255).to(torch.uint8)
    knobs = _Knobs(
        os.environ.get("OAMIX_CHAIN", "slots") if chain is None else chain,
        os.environ.get("OAMIX_GEO_PW", "1") != "0" if geo_pw is None else bool(geo_pw),
        _env_flag("OAMIX_SKIP_CHAIN") if skip_chain is None else bool(skip_chain),
        _env_flag("OAMIX_SKIP_MIX") if skip_mix is None else bool(skip_mix))
    if knobs.chain not in ("slots", "merged"):
        raise ValueError(f"chain must be 'slots' or 'merged', got {knobs.chain!r}")
    if force_op is None and os.environ.get("OAMIX_FORCE_OP") is not None:
        force_op = int(os.environ["OAMIX_FORCE_OP"])
    if draws is None:
        draws = draw_table(np.asarray(img_shape), cfg, generator)
    if force_op is not None and "op_idx" in draws:
        n_ops = num_photometric(cfg.get("version", "augmix")) + 6
        if not 0 <= int(force_op) < n_ops:
            raise ValueError(f"force_op must be in [0, {n_ops}), got {force_op}")
        draws = dict(draws, op_idx=np.full_like(np.asarray(draws["op_idx"]), int(force_op)))
    host = {k: np.asarray(v) for k, v in draws.items()}
    dev = {}
    if n_aug:
        host["rot_a"], host["rot_b"] = _rotation_params(host["op_level"], host["op_sign"])
        dev = _upload(host, dev_)
    augs, ml, oa = [], [], []
    for i in range(b):
        views = []
        for v in range(n_aug):
            out = _oamix_single(img_u8[i], gt_bboxes[i], gt_valid[i],
                                {k: a[i, v] for k, a in host.items()},
                                {k: a[i, v] for k, a in dev.items()}, cfg, knobs)
            views.append(out[0])
            ml_i, oa_i = out[1:3], out[3:5]
        if not views:
            views = [img_u8[i]]
            ml_i = (torch.zeros((MAX_ML, 4), device=dev_),
                    torch.zeros((MAX_ML,), dtype=torch.bool, device=dev_))
            oa_i = (torch.zeros((MAX_OA, 4), device=dev_),
                    torch.zeros((MAX_OA,), dtype=torch.bool, device=dev_))
        augs.append(torch.stack(views))
        ml.append(ml_i)
        oa.append(oa_i)
    return dict(aug=torch.stack(augs),
                multilevel_boxes=torch.stack([m[0] for m in ml]),
                multilevel_valid=torch.stack([m[1] for m in ml]),
                oamix_boxes=torch.stack([o[0] for o in oa]),
                oamix_valid=torch.stack([o[1] for o in oa]),
                draws=draws)
