"""Multilevel RoIAlign (port of oadg_tpu/ops/roi_align.py).

Counterparts:
- ``map_roi_levels`` <- ``oadg_tpu/ops/roi_align.py:123``;
- ``roi_align_multilevel_ref`` <- ``_roi_align_multilevel_impl`` (``:135-243``),
  the plain PyTorch version of the forward;
- ``roi_align_multilevel_ref_backward`` <- the tap scatter of ``_ml_bwd``
  (``tap_scatter_masked``, ``:705-719``, over ``_ml_tap_geometry``,
  ``:258-309``), the plain version of the backward;
- ``roi_align_multilevel`` <- ``roi_align_multilevel`` (``:826``), the
  custom-VJP op: ``RoIAlignFunction`` runs the forward kernel B1 (TPU:
  ``oadg_tpu/ops/pallas_roi_bwd.py:roi_fwd_window_pallas``) and the backward
  kernel B2 (TPU: ``roi_bwd_window_pallas``) on CUDA tensors, the plain
  versions on CPU tensors. Rois get no gradient (``:806,820``).

Rules held to the JAX package: static ``sampling_ratio=2``, ``aligned=True``
(``x * f32(1/stride) - 0.5``), a sample outside ``(-1, W) x (-1, H)`` adds 0 and
an inside one is clamped to the map with the high tap saturating, the level is
``floor(log2(sqrt(area) / finest_scale + 1e-6))`` clamped to the pyramid, and
each bin is the mean of its 2x2 samples. The TPU's window classes, violator
passes and exact-tap loop (``:435-820``) have no counterpart: the CUDA kernels
read and write every tap directly.

Layout: level maps are NCHW tensors (channels-last memory on the card); the
output is ``(R, C, out, out)`` float32, the mmdet layout that the box head's
first FC flattens. The kernels take ``out`` 7 (the box head) and 14 (the mask
head), as the TPU kernels take any ``out``; the plain versions take any. Level gradients are accumulated in float32 and rounded
once to the maps' dtype (the JAX package accumulates bf16 maps in a bf16
table, ``:691-701``; the port is held to its f32 path). The backward kernel
bins rois into 8x8-cell tiles by the extent of their taps, whose plain twin
is ``_tap_extent``.
"""
from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Sequence

import numpy as np
import torch

from ._kernels import CudaLibrary

__all__ = ["map_roi_levels", "roi_align_multilevel", "roi_align_multilevel_ref",
           "roi_align_multilevel_ref_backward", "RoIAlignFunction",
           "RoIAlignForward", "RoIAlignBackward", "ROI_ALIGN_FWD", "ROI_ALIGN_BWD"]


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


_CHUNK = 256      # rois per gather or scatter pass of the plain versions


class _Pyramid:
    """The level maps' geometry as one flat channels-last table of every
    level: level ``l``, image ``b``, cell ``(y, x)`` is row
    ``level_off[l] + (b * H_l + y) * W_l + x``."""

    def __init__(self, shapes, featmap_strides, dev):
        self.shapes = [tuple(s) for s in shapes]
        self.b, self.c = self.shapes[0][:2]
        self.hs = torch.tensor([s[2] for s in shapes], device=dev)
        self.ws = torch.tensor([s[3] for s in shapes], device=dev)
        sizes = self.b * self.hs * self.ws
        self.level_off = torch.cumsum(sizes, 0) - sizes
        self.rows = sum(self.b * s[2] * s[3] for s in self.shapes)
        self.scales = torch.tensor(_level_scales(featmap_strides), device=dev)

    def split(self, table: torch.Tensor):
        """(rows, C) table -> per-level (B, C, H_l, W_l) views, channels-last
        memory."""
        out, start = [], 0
        for b, c, h, w in self.shapes:
            out.append(table[start:start + b * h * w].view(b, h, w, c)
                       .permute(0, 3, 1, 2))
            start += b * h * w
        return out


class _Geometry(NamedTuple):
    """The bilinear taps of every sample of a roi chunk (S = out * sr):
    table rows of the low / high tap per axis, (Rc, S, S) after
    ``rows(y, x)``; the high taps' weights ``wx`` (Rc, 1, S) and ``wy``
    (Rc, S, 1); ``ok`` (Rc, S, S), the samples inside the map."""
    base: torch.Tensor
    row_b: torch.Tensor
    fw: torch.Tensor
    y0: torch.Tensor
    y1: torch.Tensor
    x0: torch.Tensor
    x1: torch.Tensor
    wx: torch.Tensor
    wy: torch.Tensor
    ok: torch.Tensor

    def rows(self, yi, xi):
        return self.base + (self.row_b + yi[:, :, None]) * self.fw + xi[:, None, :]


def _sample_positions(out: int, sr: int, dev) -> torch.Tensor:
    """(1, S) float64: sample s of bin o sits at lo + pos * bin,
    pos = o + (s + 0.5) / sr."""
    pos = (np.arange(out, dtype=np.float32)[:, None]
           + (np.arange(sr, dtype=np.float32) + np.float32(0.5)) / np.float32(sr))
    return torch.from_numpy(pos.reshape(1, -1)).to(dev).double()


def _axis_taps(lo, hi, size, pos, inv_out):
    """One axis of the samples of rois whose box spans [lo, hi] (Rc,) in
    level cells (already ``x * scale - 0.5``) at a level of ``size`` (Rc,)
    cells: in range (Rc, S), low and high tap, the high tap's weight."""
    p = _fma(((hi - lo) * inv_out)[:, None], pos, lo[:, None].double())   # (Rc, S)
    sz = size[:, None].float()
    ok = (p > -1.0) & (p < sz)
    pc = torch.minimum(p.clamp(min=0.0), sz - 1)
    i0 = torch.floor(pc).long()
    return ok, i0, torch.minimum(i0 + 1, size[:, None] - 1), pc - i0


def _geometry(pyr: _Pyramid, rc: torch.Tensor, out: int, sr: int,
              finest_scale: int) -> _Geometry:
    """Tap geometry of the rois ``rc`` (Rc, 5), rounded as XLA evaluates the
    JAX package's formula (``_roi_align_multilevel_impl``,
    ``_ml_tap_geometry``)."""
    lvl = map_roi_levels(rc, len(pyr.shapes), finest_scale)
    sc = pyr.scales[lvl]
    fh, fw = pyr.hs[lvl], pyr.ws[lvl]
    bidx = rc[:, 0].long().clamp(0, pyr.b - 1)
    pos, inv_out = _sample_positions(out, sr, rc.device), _recip(out)
    okx, x0, x1, wx = _axis_taps(rc[:, 1] * sc - 0.5, rc[:, 3] * sc - 0.5, fw, pos, inv_out)
    oky, y0, y1, wy = _axis_taps(rc[:, 2] * sc - 0.5, rc[:, 4] * sc - 0.5, fh, pos, inv_out)
    return _Geometry(
        base=pyr.level_off[lvl][:, None, None],
        row_b=(bidx * fh)[:, None, None], fw=fw[:, None, None],
        y0=y0, y1=y1, x0=x0, x1=x1,
        wx=wx[:, None, :], wy=wy[:, :, None],
        ok=oky[:, :, None] & okx[:, None, :])


def _tap_extent(pyr: _Pyramid, rc: torch.Tensor, out: int, sr: int,
                finest_scale: int) -> torch.Tensor:
    """Plain twin of ``tap_extent`` in ``csrc/roi_align_geometry.cuh``, the
    extent by which the backward kernel bins rois into tiles: per roi of
    ``rc`` (Rc, 5), the first and last row and column read by the taps of
    its in-range samples at its level, (Rc, 4) int64 ``[y_first, y_last,
    x_first, x_last]``; first > last on an axis with no sample in range."""
    lvl = map_roi_levels(rc, len(pyr.shapes), finest_scale)
    sc = pyr.scales[lvl]
    pos, inv_out = _sample_positions(out, sr, rc.device), _recip(out)
    cols = []
    for lo, hi, size in ((rc[:, 2], rc[:, 4], pyr.hs[lvl]), (rc[:, 1], rc[:, 3], pyr.ws[lvl])):
        ok, i0, i1, _ = _axis_taps(lo * sc - 0.5, hi * sc - 0.5, size, pos, inv_out)
        cols.append(torch.where(ok, i0, size[:, None]).amin(1))
        cols.append(torch.where(ok, i1, -1).amax(1))
    return torch.stack(cols, 1)


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
    out, sr = output_size, max(int(sampling_ratio), 1)
    dev = rois.device
    pyr = _Pyramid([f.shape for f in feats], featmap_strides, dev)
    c = pyr.c
    table = torch.cat([f.permute(0, 2, 3, 1).reshape(-1, c).float()
                       for f in feats])

    def one_chunk(rc):
        g = _geometry(pyr, rc, out, sr, finest_scale)

        def gather(yi, xi):
            lin = g.rows(yi, xi)
            return table[lin.reshape(-1)].reshape(*lin.shape, c)

        wx, wy = g.wx[..., None], g.wy[..., None]
        v00, v01 = gather(g.y0, g.x0), gather(g.y0, g.x1)
        v10, v11 = gather(g.y1, g.x0), gather(g.y1, g.x1)
        val = ((v00 * (1 - wx) + v01 * wx) * (1 - wy)
               + (v10 * (1 - wx) + v11 * wx) * wy)              # (Rc, S, S, C)
        val = torch.where(g.ok[..., None], val, torch.zeros((), device=dev))
        val = val.reshape(-1, out, sr, out, sr, c).mean(dim=(2, 4))
        return val.permute(0, 3, 1, 2)                          # (Rc, C, out, out)

    rois = rois.float()
    parts = [one_chunk(rois[i:i + _CHUNK])
             for i in range(0, rois.shape[0], _CHUNK)]
    if not parts:
        return torch.zeros((0, c, out, out), device=dev)
    return torch.cat(parts).contiguous()


def roi_align_multilevel_ref_backward(
        grad_out: torch.Tensor, feat_shapes: Sequence[Sequence[int]],
        rois: torch.Tensor, output_size: int = 7,
        featmap_strides: Sequence[int] = (4, 8, 16, 32),
        sampling_ratio: int = 2, finest_scale: int = 56) -> List[torch.Tensor]:
    """Plain PyTorch gradient of :func:`roi_align_multilevel_ref` with
    respect to the maps: each sample's ``dy / (sr * sr)`` times its four tap
    weights, ``index_add_``ed into one flat float32 table of every level,
    ``_CHUNK`` rois at a time (the JAX package's ``tap_scatter_masked``).

    Args:
        grad_out: (R, C, out, out) gradient of the forward's output.
        feat_shapes: the (B, C, H_l, W_l) shape of each level map.
        rois: (R, 5) float32, as the forward took them.

    Returns: per level a (B, C, H_l, W_l) float32 gradient, channels-last
    memory.
    """
    out, sr = output_size, max(int(sampling_ratio), 1)
    dev = grad_out.device
    pyr = _Pyramid(feat_shapes, featmap_strides, dev)
    c = pyr.c
    table = torch.zeros((pyr.rows, c), device=dev)
    rois = rois.float()
    gpt = grad_out.float().permute(0, 2, 3, 1) * (1.0 / (sr * sr))  # (R, out, out, C)
    for i in range(0, rois.shape[0], _CHUNK):
        g = _geometry(pyr, rois[i:i + _CHUNK], out, sr, finest_scale)
        gs = gpt[i:i + _CHUNK].repeat_interleave(sr, 1).repeat_interleave(sr, 2)
        okf = g.ok.float()
        taps = ((g.rows(g.y0, g.x0), okf * (1 - g.wy) * (1 - g.wx)),
                (g.rows(g.y0, g.x1), okf * (1 - g.wy) * g.wx),
                (g.rows(g.y1, g.x0), okf * g.wy * (1 - g.wx)),
                (g.rows(g.y1, g.x1), okf * g.wy * g.wx))
        rows = torch.cat([ri.reshape(-1) for ri, _ in taps])
        upds = torch.cat([(gs * w[..., None]).reshape(-1, c) for _, w in taps])
        table.index_add_(0, rows, upds)
    return pyr.split(table)


_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_LEVELS = 4
KERNEL_OUTPUT_SIZES = (7, 14)   # the box head's bins and the mask head's


def _check_kernel_args(feats, rois, output_size, featmap_strides,
                       sampling_ratio, what):
    """What both kernels take: 7x7 or 14x14 bins, sampling_ratio 2, 1..4
    channels-last float32 or bfloat16 maps of one batch, channel count, dtype
    and CUDA device, and contiguous float32 (R, 5) rois there."""
    n = len(feats)
    if output_size not in KERNEL_OUTPUT_SIZES or sampling_ratio != 2:
        raise ValueError(f"the CUDA RoIAlign {what} kernel is built for 7x7 and "
                         f"14x14 bins and sampling_ratio=2, got {output_size}, "
                         f"{sampling_ratio}")
    if not 1 <= n <= _MAX_LEVELS or len(featmap_strides) != n:
        raise ValueError(f"need 1..{_MAX_LEVELS} levels with one stride "
                         f"each, got {n} maps and {len(featmap_strides)} strides")
    f0 = feats[0]
    dev = f0.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA RoIAlign {what} kernel needs CUDA tensors, "
                         f"got {dev}")
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
    return b, c


def _level_args(shapes, featmap_strides):
    n = len(shapes)
    return ((ctypes.c_int * n)(*[s[2] for s in shapes]),
            (ctypes.c_int * n)(*[s[3] for s in shapes]),
            (ctypes.c_float * n)(*_level_scales(featmap_strides)))


class _LaunchCounts:
    """A wrapper's launch counts: ``launches`` in all, ``launches_by_shape``
    per (bin count, level count), and ``launches_by_size`` per bin count
    (read from the former)."""

    def __init__(self):
        self.launches = 0
        self.launches_by_shape = {}

    def _count(self, output_size: int, levels: int):
        self.launches += 1
        shape = (output_size, levels)
        self.launches_by_shape[shape] = self.launches_by_shape.get(shape, 0) + 1

    @property
    def launches_by_size(self):
        out = dict.fromkeys(KERNEL_OUTPUT_SIZES, 0)
        for (size, _), n in self.launches_by_shape.items():
            out[size] += n
        return out


class RoIAlignForward(_LaunchCounts):
    """Wrapper of ``csrc/roi_align_fwd.cu`` (kernel B1): checks its inputs,
    allocates the output and the kernel's per-roi geometry scratch, launches
    on the current stream and counts launches: ``launches`` in all,
    ``launches_by_size`` per bin count, and ``launches_by_shape`` per (bin
    count, level count).

    Takes channels-last float32 or bfloat16 level maps on one CUDA device, 7x7
    or 14x14 bins and ``sampling_ratio=2`` only; raises on anything else.
    """

    def __init__(self):
        super().__init__()
        self.library = CudaLibrary("roi_align_fwd.cu", {
            "oadg_roi_align_fwd": (ctypes.c_int, (
                ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_float),
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                ctypes.c_void_p)),
            "oadg_roi_align_fwd_scratch_bytes": (ctypes.c_longlong, (ctypes.c_int,
                                                                     ctypes.c_int)),
        })

    def __call__(self, feats: Sequence[torch.Tensor], rois: torch.Tensor,
                 output_size: int = 7,
                 featmap_strides: Sequence[int] = (4, 8, 16, 32),
                 sampling_ratio: int = 2,
                 finest_scale: int = 56) -> torch.Tensor:
        feats = list(feats)
        b, c = _check_kernel_args(feats, rois, output_size, featmap_strides,
                                  sampling_ratio, "forward")
        dev = feats[0].device
        r = rois.shape[0]
        out = torch.empty((r, c, output_size, output_size), device=dev,
                          dtype=torch.float32)
        if r == 0:
            return out
        lib = self.library.load()
        n = len(feats)
        nbytes = lib.oadg_roi_align_fwd_scratch_bytes(r, output_size)
        scratch = torch.empty(nbytes, device=dev, dtype=torch.uint8)
        ptrs = (ctypes.c_void_p * n)(*[f.data_ptr() for f in feats])
        heights, widths, scales = _level_args([f.shape for f in feats],
                                              featmap_strides)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.oadg_roi_align_fwd(
                ptrs, heights, widths, scales, n, b, c,
                _DTYPE_CODES[feats[0].dtype], output_size, rois.data_ptr(), r,
                float(finest_scale), out.data_ptr(), scratch.data_ptr(), nbytes,
                stream)
        if err != 0:
            raise RuntimeError(f"roi_align_fwd launch failed with cudaError_t {err}")
        self._count(output_size, n)
        return out


class RoIAlignBackward(_LaunchCounts):
    """Wrapper of ``csrc/roi_align_bwd.cu`` (kernel B2): the gradient of
    :class:`RoIAlignForward` with respect to the maps.

    Takes the forward's maps (for their shapes, dtype and device; they are
    not read), rois and bin layout, and a contiguous float32 (R, C, out, out)
    ``grad_out``; allocates the channels-last gradient maps in the features'
    dtype (uninitialised: the kernel writes every cell, bfloat16 rounded once
    from its float32 sum) and the kernel's int32 scratch, launches on the
    current stream and counts launches (``launches``, ``launches_by_size``
    per bin count, ``launches_by_shape`` per (bin count, level count)).
    Reads nothing back to the host.
    """

    def __init__(self):
        super().__init__()
        self.library = CudaLibrary("roi_align_bwd.cu", {
            "oadg_roi_align_bwd": (ctypes.c_int, (
                ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_float),
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                ctypes.c_void_p)),
            "oadg_roi_align_bwd_scratch_ints": (ctypes.c_longlong, (
                ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
                ctypes.c_int, ctypes.c_int, ctypes.c_int)),
        })

    def __call__(self, feats: Sequence[torch.Tensor], rois: torch.Tensor,
                 grad_out: torch.Tensor, output_size: int = 7,
                 featmap_strides: Sequence[int] = (4, 8, 16, 32),
                 sampling_ratio: int = 2,
                 finest_scale: int = 56) -> List[torch.Tensor]:
        feats = list(feats)
        b, c = _check_kernel_args(feats, rois, output_size, featmap_strides,
                                  sampling_ratio, "backward")
        dev = feats[0].device
        r = rois.shape[0]
        o = output_size
        if (grad_out.shape != (r, c, o, o) or grad_out.dtype != torch.float32
                or grad_out.device != dev or not grad_out.is_contiguous()):
            raise ValueError(f"grad_out must be a contiguous float32 ({r}, {c}, "
                             f"{o}, {o}) tensor on the features' device, got "
                             f"{tuple(grad_out.shape)} {grad_out.dtype}")
        if r == 0:
            return [torch.zeros((b, f.shape[2], f.shape[3], c), device=dev,
                                dtype=f.dtype).permute(0, 3, 1, 2) for f in feats]
        lib = self.library.load()
        n = len(feats)
        heights, widths, scales = _level_args([f.shape for f in feats],
                                              featmap_strides)
        ints = lib.oadg_roi_align_bwd_scratch_ints(heights, widths, n, b, r)
        if ints < 0:
            raise ValueError(f"roi_align_bwd refuses level maps of shapes "
                             f"{[tuple(f.shape) for f in feats]}")
        grads = [torch.empty((b, f.shape[2], f.shape[3], c), device=dev,
                             dtype=f.dtype).permute(0, 3, 1, 2) for f in feats]
        scratch = torch.empty(ints, device=dev, dtype=torch.int32)
        ptrs = (ctypes.c_void_p * n)(*[g.data_ptr() for g in grads])
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.oadg_roi_align_bwd(
                ptrs, heights, widths, scales, n, b, c,
                _DTYPE_CODES[feats[0].dtype], output_size, rois.data_ptr(), r,
                float(finest_scale), grad_out.data_ptr(), scratch.data_ptr(),
                ints, stream)
        if err != 0:
            raise RuntimeError(f"roi_align_bwd launch failed with "
                               f"cudaError_t {err}")
        self._count(output_size, n)
        return grads


ROI_ALIGN_FWD = RoIAlignForward()
ROI_ALIGN_BWD = RoIAlignBackward()


class RoIAlignFunction(torch.autograd.Function):
    """Multilevel RoIAlign with its gradient with respect to the maps:
    kernels B1 and B2 for CUDA tensors, the plain versions for CPU tensors.
    Rois get no gradient, like the JAX package's ``jnp.zeros_like(rois)``.

    ``apply(rois, (output_size, featmap_strides, sampling_ratio,
    finest_scale), *feats)``.
    """

    @staticmethod
    def forward(ctx, rois, cfg, *feats):
        dev = feats[0].device
        ctx.cfg = cfg
        ctx.save_for_backward(rois, *feats)
        if dev.type == "cuda":
            return ROI_ALIGN_FWD(feats, rois, *cfg)
        if dev.type == "cpu":
            return roi_align_multilevel_ref(feats, rois, *cfg)
        raise ValueError(f"roi_align_multilevel has no path for device {dev}")

    @staticmethod
    def backward(ctx, grad_out):
        rois, *feats = ctx.saved_tensors
        if feats[0].device.type == "cuda":
            grads = ROI_ALIGN_BWD(feats, rois, grad_out.contiguous(), *ctx.cfg)
        else:
            grads = [g.to(f.dtype) for g, f in zip(
                roi_align_multilevel_ref_backward(
                    grad_out, [f.shape for f in feats], rois, *ctx.cfg), feats)]
        return (None, None, *grads)


def roi_align_multilevel(feats: Sequence[torch.Tensor], rois: torch.Tensor,
                         output_size: int = 7,
                         featmap_strides: Sequence[int] = (4, 8, 16, 32),
                         sampling_ratio: int = 2,
                         finest_scale: int = 56) -> torch.Tensor:
    """RoIAlign over the pyramid -> (R, C, out, out) float32, differentiable
    with respect to ``feats``.

    CUDA tensors go to the hand-written kernels (which raise on what they do
    not take); CPU tensors go to the plain versions.
    """
    cfg = (output_size, tuple(featmap_strides), sampling_ratio, finest_scale)
    return RoIAlignFunction.apply(rois, cfg, *feats)
