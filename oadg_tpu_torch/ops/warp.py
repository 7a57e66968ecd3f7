"""Row-shift warps of OA-Mix (port of ``oadg_tpu/ops/pallas_warp.py``,
kernels B4, B5 and B7).

- ``shear_rows(img, shifts, fracs, max_shift, axis)`` (B4): every line of
  the pass shifts by one amount, ``out = img[q] * (1 - f) + img[q + 1] * f``
  (one fused multiply-add over the rounded second product, as XLA compiles
  the JAX package's lerp)
  with ``q = pos + shift`` and reads outside the image giving 0; shifts are
  clamped to +-``max_shift``. ``axis=1`` shifts along x, one amount per row;
  ``axis=0`` along y, one amount per column (the JAX package transposes
  around its y passes, ``:347-363, 380-383``; the values are the same). The
  JAX counterparts are ``shear_rows_v4``, ``shear_rows_v3``, ``shear_rows``
  and ``shear_rows_block`` (``:131, 169, 275, 239``), one contract in four
  TPU layouts; the plain version is ``shear_rows_xla`` (``:315-328``).
- ``piecewise_shift_rows(img, bid, shifts, max_shift, axis)`` (B5): each
  pixel shifts by the amount of its box, ``shifts[key, bid[y, x]]``, split
  into floor and fraction after clamping; ``bid == G`` keeps the source
  pixel. The plain version is the CPU branch of ``:647`` (``:662-675``).
- ``merged_shift_rows(img, cid, p_bb, p_sl, is_bb, is_bg, axis)`` (B7): each
  pixel shifts by the amount of its composite id ``cid = slot * G + box``:
  ``p_bb[key, cid]`` where the pixel's slot drew a per-box op,
  ``p_sl[key, slot]`` where it drew a background op, 0 otherwise; no clamp
  (the caller clips its tables). The plain version is the CPU branch of
  ``:564`` (``:580-601``).

All take (H, W, C) uint8 or float32 images (C <= 4) and return float32, as
the JAX package's CPU path does (on the TPU it rounds to bf16 lanes). CUDA
tensors go to ``csrc/shift_rows.cu``, CPU tensors to the plain versions.
B5 and B7 have two kernels there, one specialised for OA-Mix's shapes and a
generic one (the source's note says which shapes go where); both give the
plain versions' bits, and the wrappers count which was launched (``routes``).

The wrappers ``warp_shear_x/y``, ``warp_translate_x/y`` and ``warp_rotate``
(the Paeth 3-shear) take host scalars and derive each line's shift with
``_row_shift_params`` (``:333-385``).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ._kernels import CudaLibrary

__all__ = ["shear_rows", "shear_rows_ref", "piecewise_shift_rows",
           "piecewise_shift_rows_ref", "merged_shift_rows", "merged_shift_rows_ref",
           "warp_shear_x", "warp_shear_y", "warp_translate_x", "warp_translate_y",
           "warp_rotate", "SHEAR_ROWS", "PIECEWISE_SHIFT_ROWS", "MERGED_SHIFT_ROWS"]

_DTYPE_CODES = {torch.uint8: 0, torch.float32: 1}


def fma(a, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once, as XLA compiles the JAX
    package's ``a * b + c``: the float64 product of float32 values is exact
    and the sum is rounded to float64 and then to float32, which differs
    from one rounding only where the float64 sum ties in float32."""
    return (torch.as_tensor(a).double() * torch.as_tensor(b).double()
            + torch.as_tensor(c).double()).float()


def _lerp_ref(img: torch.Tensor, s: torch.Tensor, f: torch.Tensor,
              axis: int) -> torch.Tensor:
    """Plain lerp of every pixel with its own integer shift ``s`` and
    fraction ``f`` (both (H, W)) along ``axis``; zero outside."""
    x = img.float()
    h, w, c = x.shape
    n = w if axis == 1 else h
    pos = torch.arange(n, device=x.device)
    pos = pos[None, :] if axis == 1 else pos[:, None]

    def tap(q):
        ok = (q >= 0) & (q < n)
        v = torch.gather(x, axis, q.clamp(0, n - 1)[..., None].expand(h, w, c).long())
        return torch.where(ok[..., None], v, torch.zeros((), device=x.device))

    q = pos + s
    f = f[..., None]
    return fma(tap(q), 1.0 - f, tap(q + 1) * f)


def _line(v: torch.Tensor, axis: int, h: int, w: int) -> torch.Tensor:
    """A per-line vector (H,) for axis 1 or (W,) for axis 0 as (H, W)."""
    return (v[:, None] if axis == 1 else v[None, :]).expand(h, w)


def shear_rows_ref(img, shifts, fracs, max_shift: int, axis: int = 1):
    """Plain version of B4."""
    h, w, _ = img.shape
    s = torch.clamp(shifts.long(), -max_shift, max_shift)
    return _lerp_ref(img, _line(s, axis, h, w), _line(fracs.float(), axis, h, w), axis)


def piecewise_shift_rows_ref(img, bid, shifts, max_shift: float, axis: int = 1):
    """Plain version of B5: the shift of each pixel's box, then one lerp."""
    h, w, _ = img.shape
    g = shifts.shape[1]
    p = torch.clamp(shifts.float(), -max_shift, max_shift)
    s_all = torch.floor(p)
    f_all = p - s_all
    b = bid.long().clamp(max=g - 1)
    table = lambda t: (torch.gather(t, 1, b) if axis == 1 else
                       torch.gather(t.T, 0, b))                  # (H, W)
    out = _lerp_ref(img, table(s_all).long(), table(f_all), axis)
    return torch.where((bid.long() < g)[..., None], out, img.float())


def _slot_flags(flags, n_slots: int, what: str) -> np.ndarray:
    """The per-slot draw flags of B7 as (S,) host booleans. They steer which
    table a pixel reads, and OA-Mix knows them from its host draw table, so
    they are host values: a CUDA tensor would have to be read back."""
    if isinstance(flags, torch.Tensor):
        if flags.device.type != "cpu":
            raise ValueError(f"{what} is a host value (a sequence, a numpy array or a "
                             f"CPU tensor), got a tensor on {flags.device}")
        flags = flags.numpy()
    flags = np.asarray(flags).astype(bool).reshape(-1)
    if flags.shape != (n_slots,):
        raise ValueError(f"{what} must hold {n_slots} flags, got {flags.shape}")
    return flags


def _merged_table(p_bb: torch.Tensor, p_sl: torch.Tensor, is_bb: np.ndarray,
                  is_bg: np.ndarray) -> torch.Tensor:
    """The shift of every composite id, (keys, S * G + 1): column ``k`` is
    ``p_bb[:, k]`` where slot ``k // G`` has ``is_bb``, else ``p_sl[:, k // G]``
    where it has ``is_bg``, else 0; the last column serves the sentinel
    ``S * G`` and ids beyond it, which take the last slot's background shift
    (``min(cid // G, S - 1)`` in the JAX package's CPU branch)."""
    s = p_sl.shape[1]
    g = p_bb.shape[1] // s
    zero = torch.zeros_like(p_sl[:, :1])
    cols = []
    for slot in range(s):
        if is_bb[slot]:
            cols.append(p_bb[:, slot * g:(slot + 1) * g])
        else:
            cols.append((p_sl[:, slot:slot + 1] if is_bg[slot] else zero).expand(-1, g))
    cols.append(p_sl[:, s - 1:s] if is_bg[s - 1] else zero)
    return torch.cat(cols, 1)


def merged_shift_rows_ref(img, cid, p_bb, p_sl, is_bb, is_bg, axis: int = 1):
    """Plain version of B7: the shift of each pixel's composite id, split
    into floor and fraction, then one lerp."""
    s = p_sl.shape[1]
    sg = p_bb.shape[1]
    table = _merged_table(p_bb.float(), p_sl.float(), _slot_flags(is_bb, s, "is_bb"),
                          _slot_flags(is_bg, s, "is_bg"))
    s_all = torch.floor(table)
    f_all = table - s_all
    k = cid.long().clamp(0, sg)
    pick = lambda t: (torch.gather(t, 1, k) if axis == 1 else
                      torch.gather(t.T, 0, k))                   # (H, W)
    return _lerp_ref(img, pick(s_all).long(), pick(f_all), axis)


def _check_image(img: torch.Tensor, axis: int, what: str):
    if img.device.type != "cuda":
        raise ValueError(f"the CUDA {what} kernel needs CUDA tensors, got {img.device}")
    if (img.dim() != 3 or not 1 <= img.shape[2] <= 4 or img.dtype not in _DTYPE_CODES
            or not img.is_contiguous()):
        raise ValueError(f"{what} takes a contiguous uint8 or float32 (H, W, C<=4) "
                         f"image, got {tuple(img.shape)} {img.dtype}")
    if axis not in (0, 1):
        raise ValueError(f"axis must be 0 or 1, got {axis}")


def _as(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t`` as a contiguous tensor of ``dtype``; ``t`` itself where it is one."""
    if t.dtype == dtype and t.is_contiguous():
        return t
    return t.to(dtype).contiguous()


def _flag_bits(flags, n_slots: int, what: str) -> int:
    """B7's (S,) host flags as a bit mask, bit ``i`` for slot ``i``."""
    if not (isinstance(flags, (list, tuple)) and len(flags) == n_slots
            and all(type(f) is bool for f in flags)):
        flags = _slot_flags(flags, n_slots, what).tolist()
    return sum(1 << i for i, f in enumerate(flags) if f)


class _Wrapper:
    """What the three wrappers share: the entry point of ``csrc/shift_rows.cu``
    bound once, the launch on the image's device and current stream, and the
    count of launches. For B5 and B7 (``routed``) the entry point also
    reports which kernel it launched, and ``routes`` counts the launches of
    the kernel specialised for OA-Mix's shapes (``fast``) and of the
    one-pixel-a-thread kernel that takes every other shape (``generic``)."""

    symbol = ""
    routed = False

    def __init__(self, library: CudaLibrary):
        self.launches = 0
        self.routes = {"fast": 0, "generic": 0}
        self.library = library
        self._route = ctypes.c_int(0)
        self._route_ref = ctypes.byref(self._route)

    def _launch(self, img: torch.Tensor, *args):
        """The entry point on ``args``, then the stream, then the route's
        address where the entry point reports one."""
        fn = self.library.function(self.symbol)
        args += (torch.cuda.current_stream(img.device).cuda_stream,)
        if self.routed:
            args += (self._route_ref,)
        if img.device.index == torch.cuda.current_device():
            err = fn(*args)
        else:
            with torch.cuda.device(img.device):
                err = fn(*args)
        if err != 0:
            raise RuntimeError(f"{self.symbol} launch failed with cudaError_t {err}")
        self.launches += 1
        if self.routed:
            self.routes["fast" if self._route.value else "generic"] += 1


class ShearRows(_Wrapper):
    """Wrapper of ``oadg_shear_rows`` (kernel B4): checks its inputs,
    allocates the float32 output, launches on the current stream and counts
    launches."""

    symbol = "oadg_shear_rows"

    def __call__(self, img, shifts, fracs, max_shift: int, axis: int = 1):
        _check_image(img, axis, "shear_rows")
        h, w, c = img.shape
        n = h if axis == 1 else w
        shifts = _as(shifts, torch.int32)
        fracs = _as(fracs, torch.float32)
        if shifts.shape != (n,) or fracs.shape != (n,) or shifts.device != img.device \
                or fracs.device != img.device:
            raise ValueError(f"shifts and fracs must be ({n},) on the image's device")
        out = torch.empty((h, w, c), dtype=torch.float32, device=img.device)
        self._launch(img, img.data_ptr(), _DTYPE_CODES[img.dtype], h, w, c, axis,
                     shifts.data_ptr(), fracs.data_ptr(), int(max_shift), out.data_ptr())
        return out


class PiecewiseShiftRows(_Wrapper):
    """Wrapper of ``oadg_piecewise_shift_rows`` (kernel B5): int8 box ids
    (H, W) in [0, G], float32 shifts (keys, G)."""

    symbol = "oadg_piecewise_shift_rows"
    routed = True

    def __call__(self, img, bid, shifts, max_shift: float, axis: int = 1):
        _check_image(img, axis, "piecewise_shift_rows")
        h, w, c = img.shape
        n, g = shifts.shape
        bid = _as(bid, torch.int8)
        shifts = _as(shifts, torch.float32)
        if (n != (h if axis == 1 else w) or not 1 <= g <= 127 or bid.shape != (h, w)
                or bid.device != img.device or shifts.device != img.device):
            raise ValueError(f"piecewise_shift_rows needs bid ({h}, {w}) and shifts "
                             f"(keys, G<=127) on the image's device, got "
                             f"{tuple(bid.shape)} and {tuple(shifts.shape)}")
        out = torch.empty((h, w, c), dtype=torch.float32, device=img.device)
        self._launch(img, img.data_ptr(), _DTYPE_CODES[img.dtype], h, w, c, axis,
                     bid.data_ptr(), shifts.data_ptr(), g, float(max_shift),
                     out.data_ptr())
        return out


class MergedShiftRows(_Wrapper):
    """Wrapper of ``oadg_merged_shift_rows`` (kernel B7): int8 composite ids
    (H, W) in [0, S * G], float32 shifts ``p_bb`` (keys, S * G) and ``p_sl``
    (keys, S), and the (S,) host flags as two bit masks in the launch
    arguments."""

    symbol = "oadg_merged_shift_rows"
    routed = True

    def __call__(self, img, cid, p_bb, p_sl, is_bb, is_bg, axis: int = 1):
        _check_image(img, axis, "merged_shift_rows")
        h, w, c = img.shape
        n = h if axis == 1 else w
        p_bb = _as(p_bb, torch.float32)
        p_sl = _as(p_sl, torch.float32)
        if p_bb.dim() != 2 or p_sl.dim() != 2:
            raise ValueError("merged_shift_rows takes p_bb (keys, S * G) and p_sl (keys, S)")
        sg, s = p_bb.shape[1], p_sl.shape[1]
        if (p_bb.shape[0] != n or p_sl.shape[0] != n or not 1 <= s <= 32
                or not 1 <= sg <= 127 or sg % s or cid.shape != (h, w)
                or cid.device != img.device or p_bb.device != img.device
                or p_sl.device != img.device):
            raise ValueError(f"merged_shift_rows needs cid ({h}, {w}), p_bb ({n}, S * G <= "
                             f"127) and p_sl ({n}, S <= 32) on the image's device, got "
                             f"{tuple(cid.shape)}, {tuple(p_bb.shape)} and "
                             f"{tuple(p_sl.shape)}")
        bb = _flag_bits(is_bb, s, "is_bb")
        bg = _flag_bits(is_bg, s, "is_bg")
        if cid.dtype != torch.int8:         # wider ids: past the sentinel is the sentinel
            cid = cid.clamp(0, sg).to(torch.int8)
        cid = _as(cid, torch.int8)
        out = torch.empty((h, w, c), dtype=torch.float32, device=img.device)
        self._launch(img, img.data_ptr(), _DTYPE_CODES[img.dtype], h, w, c, axis,
                     cid.data_ptr(), p_bb.data_ptr(), p_sl.data_ptr(), sg, s, bb, bg,
                     out.data_ptr())
        return out


_LIBRARY = CudaLibrary("shift_rows.cu", {
    "oadg_shear_rows": (ctypes.c_int, (
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p)),
    "oadg_piecewise_shift_rows": (ctypes.c_int, (
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int))),
    "oadg_merged_shift_rows": (ctypes.c_int, (
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_uint, ctypes.c_uint, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int))),
})
SHEAR_ROWS = ShearRows(_LIBRARY)
PIECEWISE_SHIFT_ROWS = PiecewiseShiftRows(_LIBRARY)
MERGED_SHIFT_ROWS = MergedShiftRows(_LIBRARY)


def _dispatch(img, what):
    if img.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{what} has no path for device {img.device}")
    return img.device.type == "cuda"


def shear_rows(img, shifts, fracs, max_shift: int, axis: int = 1):
    """B4 on a CUDA image, its plain version on a CPU image."""
    if _dispatch(img, "shear_rows"):
        return SHEAR_ROWS(img.contiguous(), shifts, fracs, max_shift, axis)
    return shear_rows_ref(img, shifts, fracs, max_shift, axis)


def piecewise_shift_rows(img, bid, shifts, max_shift: float, axis: int = 1):
    """B5 on a CUDA image, its plain version on a CPU image."""
    if _dispatch(img, "piecewise_shift_rows"):
        return PIECEWISE_SHIFT_ROWS(img.contiguous(), bid, shifts, max_shift, axis)
    return piecewise_shift_rows_ref(img, bid, shifts, max_shift, axis)


def merged_shift_rows(img, cid, p_bb, p_sl, is_bb, is_bg, axis: int = 1):
    """B7 on a CUDA image, its plain version on a CPU image.

    ``img`` (H, W, C <= 4) uint8 or float32; ``cid`` (H, W) integer composite
    ids ``slot * G + box`` in [0, S * G], ``S * G`` being the identity
    sentinel (S * G <= 127: the ids travel as int8, the type of OA-Mix's
    ``best_id``); ``p_bb`` (keys, S * G) and ``p_sl`` (keys, S) float32 shifts,
    already clipped by the caller; ``is_bb`` / ``is_bg`` (S,) host flags. The
    keys are the rows for ``axis=1`` (a shift along x) and the columns for
    ``axis=0`` (a shift along y; the JAX package transposes instead).
    Returns float32."""
    if _dispatch(img, "merged_shift_rows"):
        return MERGED_SHIFT_ROWS(img.contiguous(), cid, p_bb, p_sl, is_bb, is_bg, axis)
    return merged_shift_rows_ref(img, cid, p_bb, p_sl, is_bb, is_bg, axis)


def _f32(v) -> np.float32:
    return np.float32(v)


def _row_shift_params(k1, k2, n: int, max_shift: int, device):
    """Offset ``o(y) = k1 * y + k2`` of each of ``n`` lines, clamped to
    +-``max_shift`` and split into an int32 shift and a float32 fraction;
    ``k1`` and ``k2`` are float32 host scalars."""
    y = torch.arange(n, dtype=torch.float32, device=device)
    off = torch.clamp(y * float(_f32(k1)) + float(_f32(k2)), -max_shift, max_shift)
    s = torch.floor(off)
    return s.to(torch.int32), off - s


def warp_shear_x(img, s, cx, cy, max_shift: int):
    """cv2-form shear_x: source x = x + s * (y - cy)."""
    shifts, fracs = _row_shift_params(s, -_f32(s) * _f32(cy), img.shape[0], max_shift,
                                      img.device)
    return shear_rows(img, shifts, fracs, max_shift, axis=1)


def warp_shear_y(img, s, cx, cy, max_shift: int):
    """Source y = y + s * (x - cx): one column pass."""
    shifts, fracs = _row_shift_params(s, -_f32(s) * _f32(cx), img.shape[1], max_shift,
                                      img.device)
    return shear_rows(img, shifts, fracs, max_shift, axis=0)


def warp_translate_x(img, tx, max_shift: int):
    shifts, fracs = _row_shift_params(0.0, tx, img.shape[0], max_shift, img.device)
    return shear_rows(img, shifts, fracs, max_shift, axis=1)


def warp_translate_y(img, ty, max_shift: int):
    shifts, fracs = _row_shift_params(0.0, ty, img.shape[1], max_shift, img.device)
    return shear_rows(img, shifts, fracs, max_shift, axis=0)


def warp_rotate(img, rad, cx, cy, max_shift_x: int, max_shift_y: int):
    """Rotation by ``rad`` about (cx, cy) as three shears (Paeth):
    x by -tan(rad / 2), y by sin(rad), x again; three passes."""
    rad = torch.tensor(_f32(rad))                  # float32 tan and sin on the host
    a = _f32(-torch.tan(rad / 2.0))
    b = _f32(torch.sin(rad))
    h, w = img.shape[0], img.shape[1]
    s1, f1 = _row_shift_params(a, -a * _f32(cy), h, max_shift_x, img.device)
    out = shear_rows(img, s1, f1, max_shift_x, axis=1)
    s2, f2 = _row_shift_params(b, -b * _f32(cx), w, max_shift_y, img.device)
    out = shear_rows(out, s2, f2, max_shift_y, axis=0)
    return shear_rows(out, s1, f1, max_shift_x, axis=1)
