"""OA-Mix foreground maps (port of ``oadg_tpu/ops/pallas_fg.py``, kernel B3).

``fg_maps(fx, fy, h, w)`` takes the G gated 1-D profiles of the blurred box
masks, fx (G, W) and fy (G, H) float32, and returns three (H, W) maps over
m_i = fy_i (x) fx_i: ``best_id`` int8 (the argmax, ties to the lowest index,
and the identity sentinel G where the best mask is below ``BID_EPS``),
``cover = clip(1 - prod(1 - m_i), 0, 1)`` and ``union = max m_i``, both
rounded to bfloat16 as the JAX package keeps them. A CUDA tensor goes to
``csrc/fg_maps.cu``; a CPU tensor to the plain version ``fg_maps_ref``
(``fg_maps_xla``, ``:83-91``).
"""
from __future__ import annotations

import ctypes

import torch

from ._kernels import CudaLibrary, current_stream

__all__ = ["BID_EPS", "fg_maps", "fg_maps_ref", "FG_MAPS"]

BID_EPS = 1e-5


def fg_maps_ref(fx: torch.Tensor, fy: torch.Tensor, h: int, w: int):
    """Plain version: the (G, H, W) masks materialized; the coverage product
    taken in box order, as the kernel takes it."""
    g = fx.shape[0]
    m = fy[:, :, None] * fx[:, None, :]
    best, arg = m.max(dim=0)
    best_id = torch.where(best >= BID_EPS, arg, torch.full_like(arg, g)).to(torch.int8)
    one_minus = torch.ones((h, w), device=fx.device)
    for i in range(g):
        one_minus = one_minus * (1.0 - m[i])
    cover = torch.clamp(1.0 - one_minus, 0.0, 1.0)
    return best_id, cover.to(torch.bfloat16), best.to(torch.bfloat16)


def _live_boxes(fx: torch.Tensor, fy: torch.Tensor, tile_h: int, tile_w: int) -> torch.Tensor:
    """Plain twin of B3's culling: (ceil(H / tile_h), ceil(W / tile_w), G)
    bool, True where box i is live in the tile, that is where fy[i] is
    non-zero on one of the tile's rows and fx[i] on one of its columns (the
    last tiles are ragged). Every other box gives m = 0 over the tile. The
    kernel's block owns 16 rows x 256 columns: each row loops over the boxes
    of ``_live_boxes(fx, fy, 1, 256)``, and a lane skips those whose fx is 0
    on its 8 pixels, leaving ``_live_boxes(fx, fy, 1, 8)``."""
    def any_per_tile(prof, size):
        g, n = prof.shape
        nz = torch.zeros((g, -(-n // size) * size), dtype=torch.bool, device=prof.device)
        nz[:, :n] = prof != 0
        return nz.reshape(g, -1, size).any(2)                 # (G, tiles)
    live_y, live_x = any_per_tile(fy, tile_h), any_per_tile(fx, tile_w)
    return live_y.T[:, None, :] & live_x.T[None, :, :]


class FgMaps:
    """Wrapper of ``csrc/fg_maps.cu`` (kernel B3): checks the profiles,
    allocates the three maps (cover and union in one allocation), launches
    on the current stream, counts launches."""

    def __init__(self):
        self.launches = 0
        self.library = CudaLibrary("fg_maps.cu", {
            "oadg_fg_maps": (ctypes.c_int, (ctypes.c_void_p, ctypes.c_void_p,
                                            ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                            ctypes.c_void_p, ctypes.c_void_p,
                                            ctypes.c_void_p, ctypes.c_void_p)),
        })

    def __call__(self, fx: torch.Tensor, fy: torch.Tensor, h: int, w: int):
        g = fx.shape[0]
        if fx.device.type != "cuda" or fy.device != fx.device:
            raise ValueError("the CUDA fg_maps kernel needs both profiles on one CUDA device")
        if (fx.shape != (g, w) or fy.shape != (g, h) or not 1 <= g <= 127
                or fx.dtype != torch.float32 or fy.dtype != torch.float32
                or not (fx.is_contiguous() and fy.is_contiguous())):
            raise ValueError(f"fg_maps takes contiguous float32 fx (G, {w}) and "
                             f"fy (G, {h}) with 1 <= G <= 127, got "
                             f"{tuple(fx.shape)} and {tuple(fy.shape)}")
        dev = fx.device
        best_id = torch.empty((h, w), dtype=torch.int8, device=dev)
        cover, union = torch.empty((2, h, w), dtype=torch.bfloat16, device=dev).unbind(0)
        fn = self.library.function("oadg_fg_maps")
        args = (fx.data_ptr(), fy.data_ptr(), g, h, w, best_id.data_ptr(),
                cover.data_ptr(), union.data_ptr(), current_stream(dev))
        if dev.index == torch.cuda.current_device():
            err = fn(*args)
        else:
            with torch.cuda.device(dev):
                err = fn(*args)
        if err != 0:
            raise RuntimeError(f"fg_maps launch failed with cudaError_t {err}")
        self.launches += 1
        return best_id, cover, union


FG_MAPS = FgMaps()


def fg_maps(fx: torch.Tensor, fy: torch.Tensor, h: int, w: int):
    """-> (best_id int8, cover bf16, union bf16), each (H, W)."""
    if fx.device.type == "cuda":
        return FG_MAPS(fx.contiguous(), fy.contiguous(), h, w)
    if fx.device.type == "cpu":
        return fg_maps_ref(fx, fy, h, w)
    raise ValueError(f"fg_maps has no path for device {fx.device}")
