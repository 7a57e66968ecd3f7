"""On-device OA-Mix (port of the production path of ``oadg_tpu/ops/oamix_device.py``).

Per image and augmented view (``_oamix_single``, ``:1090-1379``):

1. multilevel random boxes (hard masks) partition the image into slots;
2. per-gt saliency scores (``ops.saliency``) and the foreground maps of the
   blurred gt masks, kernel B3 (``_precompute_fg_maps``, ``:421-454``);
3. the AugMix chain: ``mixture_width`` chains of ``depth`` steps; each step
   applies one drawn op per active slot to the whole image and keeps it
   inside the slot (``_aug_once``, ``:900-1085``, the op order of
   ``get_aug_list``): PIL photometric ops (``ops.photometric``; equalize on
   kernel B6), per-box geometric ops on the piecewise row shift B5
   (``_pw_rotate/_pw_shear/_pw_translate``, ``:457-570``) and background
   geometric ops on the row shift B4 blended through the fg union
   (``_bg_blend``); the chain state is uint8 between ops;
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

Not ported: the CPU gather path (``_op_matrices``, ``_invert_2x3``,
``_warp_by_pixel_matrices``, ``_lerp_axis``, ``_warp_affine_2pass``,
``_apply_geo_bboxes_only``), the merged chain (``_merged_ctx``,
``_depth_step_merged``, kernel B7) and the profiling and lane knobs
(``OAMIX_FORCE_OP``, ``OAMIX_SKIP_*``, ``OAMIX_LANES``, ``OAMIX_GEO_PW``).
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from .fg_maps import fg_maps
from .photometric import (autocontrast, enhance_brightness, enhance_color,
                          enhance_contrast, enhance_sharpness, equalize, invert,
                          posterize, solarize)
from .saliency import saliency_score
from .warp import (fma, piecewise_shift_rows, warp_rotate, warp_shear_x, warp_shear_y,
                   warp_translate_x, warp_translate_y)

__all__ = ["MAX_ML", "MAX_OA", "MAX_FG", "ATTEMPTS", "MAX_DEPTH", "N_SLOTS",
           "num_photometric", "draw_table", "oamix_batch"]

MAX_ML = 2          # multilevel random boxes
MAX_OA = 5          # object-aware random boxes
MAX_FG = 16         # gts taking part in the per-box warps and the mixing
ATTEMPTS = 8        # draws per random-box slot
MAX_DEPTH = 3
N_SLOTS = MAX_ML + 1
BB_MAX_SHIFT_X, BB_MAX_SHIFT_Y = 512, 768     # per-box pass clamps


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


def _pw_finish(img, warped, fg: _FgInfo):
    cov = fg.cover.float()[..., None]
    return torch.clamp(torch.round(fma(img, 1.0 - cov, warped * cov)), 0, 255)


def _bb_geo(img: torch.Tensor, family: int, fg: _FgInfo, dr: _OpDraws):
    """bboxes_only rotate (0), shear (1) and translate (2) on kernel B5: each
    pixel moves with its strongest box (``best_id``), blended by ``cover``."""
    h, w = img.shape[0], img.shape[1]
    g = fg.boxes.shape[0]
    ys = torch.arange(h, dtype=torch.float32, device=img.device)[:, None]
    xs = torch.arange(w, dtype=torch.float32, device=img.device)[:, None]
    pass_x = lambda im, p: piecewise_shift_rows(im, fg.best_id, p, BB_MAX_SHIFT_X, axis=1)
    pass_y = lambda im, p: piecewise_shift_rows(im, fg.best_id, p, BB_MAX_SHIFT_Y, axis=0)
    use_x = dr.coin < 0.5
    if family == 0:                     # Paeth X(a1) Y(b2) X(a1)
        p1 = dr.rot_a[None, :] * (ys - fg.cy[None, :])
        out = pass_x(img, p1)
        out = pass_y(out, dr.rot_b[None, :] * (xs - fg.cx[None, :]))
        out = pass_x(out, p1)
    elif family == 1:
        sh = dr.level_dev * float(_k(0.3, _r(10.0))) * dr.sign_dev
        out = (pass_x(img, sh[None, :] * (ys - fg.cy[None, :])) if use_x else
               pass_y(img, sh[None, :] * (xs - fg.cx[None, :])))
    else:
        if use_x:
            t = torch.floor(dr.level_dev * (fg.bw * float(_r(3.0))) * float(_r(10.0))) \
                * dr.sign_dev
            out = pass_x(img, t[None, :].expand(h, g))
        else:
            t = torch.floor(dr.level_dev * (fg.bh * float(_r(3.0))) * float(_r(10.0))) \
                * dr.sign_dev
            out = pass_y(img, t[None, :].expand(w, g))
    return _pw_finish(img.float(), out, fg)


def _bg_geo(img: torch.Tensor, family: int, fg: _FgInfo, dr: _OpDraws):
    """bg_only rotate (0), shear (1) and translate (2) on kernel B4 (``:990-1054``):
    the image and the alpha ``bf16(union * 255)`` warp as one 4-channel
    image; the warped background shows where neither the fg union nor its
    warp holds."""
    h, w = img.shape[0], img.shape[1]
    imgw = img.float()
    un = fg.union.float()
    x4 = torch.cat([imgw, (un * 255.0).to(torch.bfloat16).float()[..., None]], -1)
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
    kept = torch.maximum(un, w4[..., 3] * float(_r(255.0)))[..., None]
    return torch.clamp(torch.round(fma(kept, imgw, (1.0 - kept) * w4[..., :3])), 0, 255)


def _aug_once(img: torch.Tensor, op: int, fg: _FgInfo, dr: _OpDraws,
              version: str) -> torch.Tensor:
    """One reference ``aug()`` call on the uint8 chain state: the op of index
    ``op`` in ``get_aug_list`` order (photometric ops, then bboxes_only
    rotate / shear_xy / translate_xy, then bg_only rotate / shear_xy /
    translate_xy), applied to the whole image -> uint8."""
    n_photo = num_photometric(version)
    lvl = dr.level[0]
    factor = _f32(fma(float(lvl), float(_k(1.8, _r(10.0))), float(_f32(0.1))))
    if op >= n_photo + 3:
        out = _bg_geo(img, op - n_photo - 3, fg, dr)
    elif op >= n_photo:
        out = _bb_geo(img, op - n_photo, fg, dr)
    elif op == 0:
        out = autocontrast(img)
    elif op == 1:
        out = equalize(img)
    elif op == 2:
        out = posterize(img, max(4 - int(np.floor(lvl * _k(4.0, _r(10.0)))), 1))
    elif op == 3:
        out = solarize(img, float(256 - int(np.floor(lvl * _k(256.0, _r(10.0))))))
    elif op == 4:
        out = invert(img)
    else:
        out = (enhance_color, enhance_contrast, enhance_brightness,
               enhance_sharpness)[op - 5](img, factor)
    return torch.clamp(out, 0, 255).to(torch.uint8)


# ------------------------------------------------------------- one view ----

def _oamix_single(img: torch.Tensor, gt: torch.Tensor, gt_valid: torch.Tensor,
                  host: Dict[str, np.ndarray], dev: Dict[str, torch.Tensor],
                  cfg: Dict):
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
                        dev["rot_b"][i, d, s, :g])

    mixed = torch.zeros((h, w, 3), device=img.device)
    for i in range(width):
        x = img
        for d in range(int(host["depth"][i])):
            outs = [None if rects[s] is None else
                    _aug_once(x, int(host["op_idx"][i, d, s]), fg, draws(i, d, s), version)
                    for s in range(MAX_ML)]
            nxt = _aug_once(x, int(host["op_idx"][i, d, MAX_ML]), fg,
                            draws(i, d, MAX_ML), version)
            for s, r in enumerate(rects):           # the complement everywhere else
                if r is not None:
                    nxt[r[0]:r[1], r[2]:r[3]] = outs[s][r[0]:r[1], r[2]:r[3]]
            x = nxt
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
    for r in range(g + MAX_OA):
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


def oamix_batch(img_raw: torch.Tensor, gt_bboxes: torch.Tensor, gt_valid: torch.Tensor,
                img_shape, cfg: Dict, draws: Optional[Dict] = None,
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
    """Batched multi-view OA-Mix (``:1382-1443``).

    Args:
        img_raw: (B, H, W, 3) uint8 (or integer-valued float) images, BGR.
        gt_bboxes / gt_valid: (B, G, 4) / (B, G) on the images' device.
        img_shape: (B, 2) valid (h, w) on the host (numpy or a CPU tensor);
            the random boxes are drawn from it.
        cfg: the OA-Mix config (``oamix_config`` of an OA-DG config).
        draws: a draw table with leading (B, V-1) dims, or None to draw one
            from ``generator`` (a CPU ``torch.Generator``).

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
    if draws is None:
        draws = draw_table(np.asarray(img_shape), cfg, generator)
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
                                {k: a[i, v] for k, a in dev.items()}, cfg)
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
