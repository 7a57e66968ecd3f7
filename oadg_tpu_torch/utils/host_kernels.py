"""ctypes bindings of the port's host kernels (``csrc/host_kernels.cpp``):
the evaluation matchers of ``oadg_tpu/core/evaluation/native.py`` (called by
``core/evaluation/``), the PNG row unfilter of ``data/pipelines/image_io.py``
and the JPEG scan decoder of ``utils/jpeg.py``. It lives under ``utils`` because both the
data layer and the evaluation call it.

The library is compiled with ``g++ -O3 -shared -fPIC`` at first use into
``oadg_tpu_torch/_build/`` (git-ignored); its file name carries a hash of
the source, the flags and the machine, so an edited source is rebuilt. On
x86-64 it is built with ``-mfma``: the compiler then fuses the IoUs'
multiply-adds as in the JAX package's prebuilt library, and the two give
equal bits. A missing compiler or a failed build raises: unlike the JAX
package's bindings there is no quiet numpy fallback. The numpy versions
stay beside each caller as the plain versions, selected with
``native=False``.

ctypes releases the interpreter lock for the length of each call, so the
loader's threads decode images in parallel.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parent / "csrc" / "host_kernels.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17") + (
    ("-mfma",) if platform.machine() in ("x86_64", "AMD64") else ())

_F32P = ctypes.POINTER(ctypes.c_float)
_U8P = ctypes.POINTER(ctypes.c_uint8)
_I32P = ctypes.POINTER(ctypes.c_int32)
_I64 = ctypes.c_int64
_SIGNATURES = {
    "iou_xyxy": (None, [_F32P, _I64, _F32P, _I64, ctypes.c_float, _F32P]),
    "tpfp_greedy": (None, [_F32P, _F32P, _I64, _I64, _U8P, ctypes.c_float,
                           _F32P, _F32P]),
    "coco_match": (None, [_F32P, _I64, _I64, _U8P, _U8P, _F32P, _I64, _I32P,
                          _U8P]),
    "png_unfilter": (_I64, [_U8P, _I64, _I64, _I64, _U8P]),
    "jpeg_decode_scan": (_I64, [_U8P, _I64, _I32P, _I64, _U8P, _I64, _I64, _I64,
                                ctypes.POINTER(ctypes.c_void_p)]),
}

_LIB = None
_LOCK = threading.Lock()


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    digest.update(platform.machine().encode())
    return BUILD_DIR / f"host_kernels_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the source unless the library for its hash exists."""
    so = library_path()
    if so.is_file():
        return so
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found on PATH: the port's host kernels "
                           f"({SOURCE.name}) cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.{threading.get_ident()}.tmp.so")
    res = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"{cxx} failed with exit code {res.returncode} for "
                           f"{SOURCE.name}:\n{res.stdout}{res.stderr}")
    os.replace(tmp, so)      # atomic: a concurrent builder never sees a partial file
    return so


def load() -> ctypes.CDLL:
    """The library, built and bound on the first call (thread-safe)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            for name, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype = restype
                fn.argtypes = argtypes
            _LIB = lib
        return _LIB


def _f32(a):
    return np.ascontiguousarray(a, np.float32)


def _ptr(a, tp):
    return a.ctypes.data_as(tp)


def iou_xyxy(dets: np.ndarray, gts: np.ndarray,
             use_legacy_coordinate: bool = False) -> np.ndarray:
    """(D, 4) x (G, 4) xyxy boxes -> (D, G) float32 IoU; +1 widths with
    ``use_legacy_coordinate``."""
    lib = load()
    dets, gts = _f32(dets).reshape(-1, 4), _f32(gts).reshape(-1, 4)
    out = np.empty((len(dets), len(gts)), np.float32)
    lib.iou_xyxy(_ptr(dets, _F32P), len(dets), _ptr(gts, _F32P), len(gts),
                 1.0 if use_legacy_coordinate else 0.0, _ptr(out, _F32P))
    return out


def tpfp_greedy(ious: np.ndarray, scores: np.ndarray, gt_ignore,
                iou_thr: float) -> Tuple[np.ndarray, np.ndarray]:
    """VOC greedy matching of (D, G) IoUs in score order -> float32 tp, fp."""
    lib = load()
    ious, scores = _f32(ious), _f32(scores)
    d, g = ious.shape
    tp = np.zeros(d, np.float32)
    fp = np.zeros(d, np.float32)
    gi = np.ascontiguousarray(gt_ignore if gt_ignore is not None
                              else np.zeros(g, np.uint8), np.uint8)
    lib.tpfp_greedy(_ptr(ious, _F32P), _ptr(scores, _F32P), d, g, _ptr(gi, _U8P),
                    float(iou_thr), _ptr(tp, _F32P), _ptr(fp, _F32P))
    return tp, fp


def coco_match(ious: np.ndarray, gt_ignore: np.ndarray, gt_crowd: np.ndarray,
               thrs: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """COCO matching of score-sorted dets against ignore-last gts at each
    threshold -> matched gt index (T, D) int32 (-1: none), det-ignore (T, D)."""
    lib = load()
    ious, thrs = _f32(ious), _f32(thrs)
    d, g = ious.shape
    dt_match = np.full((len(thrs), d), -1, np.int32)
    dt_ignore = np.zeros((len(thrs), d), np.uint8)
    gi = np.ascontiguousarray(gt_ignore, np.uint8)
    gc = np.ascontiguousarray(gt_crowd, np.uint8)
    lib.coco_match(_ptr(ious, _F32P), d, g, _ptr(gi, _U8P), _ptr(gc, _U8P),
                   _ptr(thrs, _F32P), len(thrs), _ptr(dt_match, _I32P),
                   _ptr(dt_ignore, _U8P))
    return dt_match, dt_ignore


def png_unfilter(filtered: np.ndarray, bpp: int) -> np.ndarray:
    """(H, 1 + stride) uint8 scanlines, each led by its filter type ->
    (H, stride) reconstructed bytes. Raises on an unknown filter type."""
    lib = load()
    filtered = np.ascontiguousarray(filtered, np.uint8)
    h, stride = filtered.shape[0], filtered.shape[1] - 1
    out = np.empty((h, stride), np.uint8)
    bad = lib.png_unfilter(_ptr(filtered, _U8P), h, stride, bpp, _ptr(out, _U8P))
    if bad:
        raise ValueError(f"PNG row {bad - 1} has filter type "
                         f"{filtered[bad - 1, 0]}, not one of 0-4")
    return out


def jpeg_decode_scan(data: bytes, comps: np.ndarray, tables: np.ndarray,
                     mcus_x: int, mcus_y: int, restart_interval: int,
                     coefs) -> int:
    """Decode one baseline Huffman scan into the int16 coefficient arrays
    ``coefs`` (in place); the arguments and the returned code are those of
    ``utils.jpeg.decode_scan_numpy``, its plain twin."""
    lib = load()
    buf = np.frombuffer(data, np.uint8)
    comps = np.ascontiguousarray(comps, np.int32)
    tables = np.ascontiguousarray(tables, np.uint8)
    if tables.shape != (8, 272) or comps.ndim != 2 or comps.shape[1] != 5 \
            or len(comps) != len(coefs):
        raise ValueError("jpeg_decode_scan: malformed component or table arrays")
    ptrs = (ctypes.c_void_p * len(coefs))(*[a.ctypes.data for a in coefs])
    return int(lib.jpeg_decode_scan(_ptr(buf, _U8P), len(buf), _ptr(comps, _I32P),
                                    len(comps), _ptr(tables, _U8P), mcus_x, mcus_y,
                                    restart_interval, ptrs))
