"""Multilevel RoIAlign (port of oadg_tpu/ops/roi_align.py).

Counterparts:
- ``map_roi_levels`` <- ``oadg_tpu/ops/roi_align.py:123``;
- ``roi_align_multilevel_ref`` <- ``_roi_align_multilevel_impl`` (``:135-243``),
  the plain PyTorch version;
- ``roi_align_multilevel`` <- the forward of ``roi_align_multilevel``
  (``:826``), whose TPU path is the Pallas window kernel
  ``oadg_tpu/ops/pallas_roi_bwd.py:roi_fwd_window_pallas`` reached through
  ``_roi_align_forward`` (``:351-415``).

Rules held to the JAX package: static ``sampling_ratio=2``, ``aligned=True``
(``x * f32(1/stride) - 0.5``), a sample outside ``(-1, W) x (-1, H)`` adds 0 and
an inside one is clamped to the map with the high tap saturating, the level is
``floor(log2(sqrt(area) / finest_scale + 1e-6))`` clamped to the pyramid, and
each bin is the mean of its 2x2 samples. The TPU's window classes, violator
passes and exact-tap loop (``:435-820``) have no counterpart: the CUDA kernel
reads every tap directly.

Layout: level maps are NCHW tensors (channels-last memory on the card); the
output is ``(R, C, out, out)`` float32, the mmdet layout that the box head's
first FC flattens.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import numpy as np
import torch

from ._kernels import CudaLibrary

__all__ = ["map_roi_levels", "roi_align_multilevel", "roi_align_multilevel_ref",
           "RoIAlignForward", "ROI_ALIGN_FWD"]


def _recip(v) -> float:
    """float32(1 / v), the reciprocal XLA multiplies by for a division by the
    constant ``v``."""
    return float(np.float32(1.0 / v))


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` with one rounding, as XLA fuses it: the float64
    product of float32 values is exact."""
    return (a.double() * b + c).float()


def map_roi_levels(rois: torch.Tensor, num_levels: int,
                   finest_scale: int = 56) -> torch.Tensor:
    """FPN level per roi, int64 (R,): floor(log2(sqrt(area) / finest_scale
    + 1e-6)) clamped to the pyramid, rounded as XLA evaluates it."""
    scale = torch.sqrt((rois[:, 3] - rois[:, 1]) * (rois[:, 4] - rois[:, 2]))
    lvl = torch.floor(torch.log2(_fma(scale, _recip(finest_scale),
                                      float(np.float32(1e-6)))))
    lvl = torch.nan_to_num(lvl.clamp(0, num_levels - 1), nan=0.0)
    return lvl.long()


def _level_scales(featmap_strides: Sequence[int]):
    return [_recip(s) for s in featmap_strides]


_CHUNK = 256      # rois per gather pass of the plain version (bounds memory)


def roi_align_multilevel_ref(feats: Sequence[torch.Tensor], rois: torch.Tensor,
                             output_size: int = 7,
                             featmap_strides: Sequence[int] = (4, 8, 16, 32),
                             sampling_ratio: int = 2,
                             finest_scale: int = 56) -> torch.Tensor:
    """Plain PyTorch RoIAlign over the pyramid: one gather table of every
    level, rois processed ``_CHUNK`` at a time to bound the gathered memory.

    Args:
        feats: (B, C, H_l, W_l) maps, fine to coarse, any memory format.
        rois: (R, 5) float32 [batch_idx, x1, y1, x2, y2] in image pixels.

    Returns: (R, C, output_size, output_size) float32.
    """
    num_levels = len(feats)
    b, c = feats[0].shape[:2]
    out, sr = output_size, max(int(sampling_ratio), 1)
    dev = rois.device
    hs = torch.tensor([f.shape[2] for f in feats], device=dev)
    ws = torch.tensor([f.shape[3] for f in feats], device=dev)
    level_off = torch.cumsum(b * hs * ws, 0) - b * hs * ws
    table = torch.cat([f.permute(0, 2, 3, 1).reshape(-1, c).float()
                       for f in feats])
    scales = torch.tensor(_level_scales(featmap_strides), device=dev)
    # sample s of bin o sits at x1 + pos * bin_w, pos = o + (s + 0.5) / sr
    pos = (np.arange(out, dtype=np.float32)[:, None]
           + (np.arange(sr, dtype=np.float32) + np.float32(0.5)) / np.float32(sr))
    pos = torch.from_numpy(pos.reshape(1, -1)).to(dev).double()   # (1, S)
    inv_out = _recip(out)

    def one_chunk(rc):
        lvl = map_roi_levels(rc, num_levels, finest_scale)
        sc = scales[lvl]
        fh, fw = hs[lvl], ws[lvl]
        off = level_off[lvl]
        bidx = rc[:, 0].long().clamp(0, b - 1)
        x1 = rc[:, 1] * sc - 0.5
        y1 = rc[:, 2] * sc - 0.5
        x2 = rc[:, 3] * sc - 0.5
        y2 = rc[:, 4] * sc - 0.5
        bin_w = (x2 - x1) * inv_out
        bin_h = (y2 - y1) * inv_out
        xs = _fma(bin_w[:, None], pos, x1[:, None].double())     # (Rc, S)
        ys = _fma(bin_h[:, None], pos, y1[:, None].double())
        fwf, fhf = fw[:, None].float(), fh[:, None].float()
        okx = (xs > -1.0) & (xs < fwf)
        oky = (ys > -1.0) & (ys < fhf)
        px = torch.minimum(xs.clamp(min=0.0), fwf - 1)
        py = torch.minimum(ys.clamp(min=0.0), fhf - 1)
        x0i = torch.floor(px).long()
        y0i = torch.floor(py).long()
        wx = (px - x0i)[:, None, :, None]
        wy = (py - y0i)[:, :, None, None]
        x1i = torch.minimum(x0i + 1, fw[:, None] - 1)
        y1i = torch.minimum(y0i + 1, fh[:, None] - 1)

        def gather(yi, xi):
            lin = (off[:, None, None]
                   + (bidx[:, None, None] * fh[:, None, None] + yi[:, :, None])
                   * fw[:, None, None] + xi[:, None, :])
            return table[lin.reshape(-1)].reshape(*lin.shape, c)

        v00, v01 = gather(y0i, x0i), gather(y0i, x1i)
        v10, v11 = gather(y1i, x0i), gather(y1i, x1i)
        val = ((v00 * (1 - wx) + v01 * wx) * (1 - wy)
               + (v10 * (1 - wx) + v11 * wx) * wy)              # (Rc, S, S, C)
        ok = (oky[:, :, None] & okx[:, None, :])[..., None]
        val = torch.where(ok, val, torch.zeros((), device=dev))
        val = val.reshape(-1, out, sr, out, sr, c).mean(dim=(2, 4))
        return val.permute(0, 3, 1, 2)                          # (Rc, C, out, out)

    rois = rois.float()
    parts = [one_chunk(rois[i:i + _CHUNK])
             for i in range(0, rois.shape[0], _CHUNK)]
    if not parts:
        return torch.zeros((0, c, out, out), device=dev)
    return torch.cat(parts).contiguous()


_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_LEVELS = 4


class RoIAlignForward:
    """Wrapper of ``csrc/roi_align_fwd.cu``: checks its inputs, allocates the
    output, launches on the current stream and counts launches.

    Takes channels-last float32 or bfloat16 level maps on one CUDA device, 7x7
    bins and ``sampling_ratio=2`` only; raises on anything else.
    """

    def __init__(self):
        self.launches = 0
        self.library = CudaLibrary("roi_align_fwd.cu", {
            "oadg_roi_align_fwd": (ctypes.c_int, (
                ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_float),
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                ctypes.c_void_p, ctypes.c_void_p)),
        })

    def __call__(self, feats: Sequence[torch.Tensor], rois: torch.Tensor,
                 output_size: int = 7,
                 featmap_strides: Sequence[int] = (4, 8, 16, 32),
                 sampling_ratio: int = 2,
                 finest_scale: int = 56) -> torch.Tensor:
        feats = list(feats)
        n = len(feats)
        if output_size != 7 or sampling_ratio != 2:
            raise ValueError("the CUDA RoIAlign kernel is built for 7x7 bins "
                             f"and sampling_ratio=2, got {output_size}, "
                             f"{sampling_ratio}")
        if not 1 <= n <= _MAX_LEVELS or len(featmap_strides) != n:
            raise ValueError(f"need 1..{_MAX_LEVELS} levels with one stride "
                             f"each, got {n} maps and {len(featmap_strides)} strides")
        f0 = feats[0]
        dev = f0.device
        if dev.type != "cuda":
            raise ValueError(f"the CUDA RoIAlign kernel needs CUDA tensors, got {dev}")
        if f0.dtype not in _DTYPE_CODES:
            raise TypeError(f"feature dtype {f0.dtype} is not float32 or bfloat16")
        b, c = f0.shape[:2]
        for f in feats:
            if f.dim() != 4 or f.shape[:2] != (b, c):
                raise ValueError(f"level map of shape {tuple(f.shape)} does not "
                                 f"match batch {b} and channels {c}")
            if f.device != dev or f.dtype != f0.dtype:
                raise ValueError("level maps differ in device or dtype")
            if not f.is_contiguous(memory_format=torch.channels_last):
                raise ValueError("level maps must be channels-last contiguous")
        if (rois.dim() != 2 or rois.shape[1] != 5 or rois.dtype != torch.float32
                or rois.device != dev or not rois.is_contiguous()):
            raise ValueError("rois must be a contiguous float32 (R, 5) tensor "
                             "on the features' device")
        r = rois.shape[0]
        out = torch.empty((r, c, 7, 7), device=dev, dtype=torch.float32)
        if r == 0:
            return out
        lib = self.library.load()
        ptrs = (ctypes.c_void_p * n)(*[f.data_ptr() for f in feats])
        heights = (ctypes.c_int * n)(*[f.shape[2] for f in feats])
        widths = (ctypes.c_int * n)(*[f.shape[3] for f in feats])
        scales = (ctypes.c_float * n)(*_level_scales(featmap_strides))
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.oadg_roi_align_fwd(
                ptrs, heights, widths, scales, n, b, c, _DTYPE_CODES[f0.dtype],
                rois.data_ptr(), r, float(finest_scale), out.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(f"roi_align_fwd launch failed with cudaError_t {err}")
        self.launches += 1
        return out


ROI_ALIGN_FWD = RoIAlignForward()


def roi_align_multilevel(feats: Sequence[torch.Tensor], rois: torch.Tensor,
                         output_size: int = 7,
                         featmap_strides: Sequence[int] = (4, 8, 16, 32),
                         sampling_ratio: int = 2,
                         finest_scale: int = 56) -> torch.Tensor:
    """RoIAlign over the pyramid -> (R, C, out, out) float32.

    CUDA tensors go to the hand-written kernel (which raises on what it does
    not take); CPU tensors go to :func:`roi_align_multilevel_ref`.
    """
    dev = feats[0].device
    if dev.type == "cuda":
        return ROI_ALIGN_FWD(feats, rois, output_size, featmap_strides,
                             sampling_ratio, finest_scale)
    if dev.type == "cpu":
        return roi_align_multilevel_ref(feats, rois, output_size,
                                        featmap_strides, sampling_ratio,
                                        finest_scale)
    raise ValueError(f"roi_align_multilevel has no path for device {dev}")
