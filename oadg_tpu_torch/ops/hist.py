"""256-bin histograms for equalize (port of ``oadg_tpu/ops/pallas_hist.py:73-98``,
kernel B6).

``hist256(x)`` counts the values of ``x`` (any shape, truncated to integers
in [0, 255]) into (256,) int32; ``image_hist256(img)`` counts each channel
of an (H, W, C) image into (C, 256) int32. On a CUDA tensor both launch
``csrc/hist256.cu`` once (all channels in one launch); on a CPU tensor they
run the plain version, ``hist256_ref``. The JAX package's equalize takes its
histogram from the XLA ``hist256_nibble``; the port's takes it from B6.
"""
from __future__ import annotations

import ctypes

import torch

from ._kernels import CudaLibrary, current_stream

__all__ = ["as_bins", "hist256", "image_hist256", "hist256_ref", "HIST256"]


def as_bins(x: torch.Tensor) -> torch.Tensor:
    """Values truncated to integers in [0, 255] as uint8 (uint8 stays)."""
    if x.dtype == torch.uint8:
        return x
    return torch.trunc(torch.clamp(x.float(), 0, 255)).to(torch.uint8)


def hist256_ref(x: torch.Tensor, c: int = 1) -> torch.Tensor:
    """Plain version: (c, 256) int32 counts of the uint8 values of ``x``,
    value ``i`` of the flattened tensor belonging to channel ``i % c``."""
    v = x.reshape(-1, c).T.long()                             # (c, n / c)
    counts = torch.zeros((c, 256), dtype=torch.int64, device=x.device)
    counts.scatter_add_(1, v, torch.ones_like(v))
    return counts.to(torch.int32)


def _hist_split(offset: int, n: int):
    """Plain twin of the split in ``csrc/hist256.cu``'s launch, for ``n``
    values whose first lies ``offset`` bytes past a 16-byte boundary. ->
    (head, words, tail): ``head`` bytes up to the boundary, then ``words``
    8-byte words, then ``tail`` (< 8) bytes."""
    head = min(n, (16 - offset % 16) % 16)
    words = (n - head) // 8
    return head, words, n - head - 8 * words


def _hist_channels(offset: int, n: int, c: int, threads: int) -> torch.Tensor:
    """Plain twin of the kernel's channel map on a grid of ``threads``
    threads: the channel it counts each of the ``n`` values in, (n,) int64.
    Head byte i: i % c. Word k goes to thread t = k % threads, whose byte j
    of every word it reads has channel (head + 8 (t % c) + j) % c. Tail byte
    j: ((n - tail) + j) % c."""
    head, words, tail = _hist_split(offset, n)
    t = torch.arange(words)[:, None] % threads
    body = (head + 8 * (t % c) + torch.arange(8)[None, :]) % c
    return torch.cat([torch.arange(head) % c, body.reshape(-1),
                      (n - tail + torch.arange(tail)) % c])


class Hist256:
    """Wrapper of ``csrc/hist256.cu`` (kernel B6): takes a contiguous uint8
    CUDA tensor whose flattened values interleave ``c`` channels (1..4),
    allocates the (c, 256) int32 table (the kernel writes every bin, so no
    zero fill), launches on the current stream and counts launches."""

    def __init__(self):
        self.launches = 0
        self.library = CudaLibrary("hist256.cu", {
            "oadg_hist256": (ctypes.c_int, (ctypes.c_void_p, ctypes.c_longlong,
                                            ctypes.c_int, ctypes.c_void_p,
                                            ctypes.c_void_p)),
        })

    def __call__(self, x: torch.Tensor, c: int = 1) -> torch.Tensor:
        if x.device.type != "cuda":
            raise ValueError(f"the CUDA hist256 kernel needs a CUDA tensor, got {x.device}")
        if x.dtype != torch.uint8 or not x.is_contiguous():
            raise ValueError("hist256 takes a contiguous uint8 tensor")
        if not 1 <= c <= 4 or x.numel() % c:
            raise ValueError(f"{x.numel()} values do not split into {c} channels (1..4)")
        out = torch.empty((c, 256), dtype=torch.int32, device=x.device)
        fn = self.library.function("oadg_hist256")
        args = (x.data_ptr(), x.numel(), c, out.data_ptr(), current_stream(x.device))
        if x.device.index == torch.cuda.current_device():
            err = fn(*args)
        else:
            with torch.cuda.device(x.device):
                err = fn(*args)
        if err != 0:
            raise RuntimeError(f"hist256 launch failed with cudaError_t {err}")
        self.launches += 1
        return out


HIST256 = Hist256()


def _counts(x: torch.Tensor, c: int) -> torch.Tensor:
    x = as_bins(x).contiguous()
    if x.device.type == "cuda":
        return HIST256(x, c)
    if x.device.type == "cpu":
        return hist256_ref(x, c)
    raise ValueError(f"hist256 has no path for device {x.device}")


def hist256(x: torch.Tensor) -> torch.Tensor:
    """256-bin histogram of ``x`` (any shape) -> (256,) int32."""
    return _counts(x, 1)[0]


def image_hist256(img: torch.Tensor) -> torch.Tensor:
    """Per-channel histograms of an (H, W, C) image -> (C, 256) int32."""
    return _counts(img, img.shape[-1])
