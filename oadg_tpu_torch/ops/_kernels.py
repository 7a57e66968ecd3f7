"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` file has a plain C interface. At first use it is compiled
with ``nvcc`` for Hopper (``sm_90a``) into a shared library under
``oadg_tpu_torch/_build/`` (listed in ``.gitignore``) and loaded with
``ctypes``. The library's file name carries a hash of its source, the
``csrc/*.cuh`` headers and the flags, so an edited source is rebuilt and a
fresh checkout builds from its own sources. A missing ``nvcc`` or a failed
build raises; nothing falls back.

Nothing here runs at import time: the CPU tests import every module of the
package on a machine without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")


def find_nvcc() -> str:
    """``nvcc`` on PATH, else under ``$CUDA_HOME`` (default /usr/local/cuda)."""
    found = shutil.which("nvcc")
    if found:
        return found
    candidate = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    raise RuntimeError("nvcc not found on PATH or under $CUDA_HOME; the CUDA "
                       "kernels of oadg_tpu_torch cannot be built")


class CudaLibrary:
    """One ``csrc/<source>`` compiled into a ctypes library on first use.

    ``signatures`` maps each exported C function to ``(restype, argtypes)``;
    every function is declared before it can be called.
    """

    def __init__(self, source: str,
                 signatures: Dict[str, Tuple[object, Sequence[object]]]):
        self.source = CSRC_DIR / source
        self.signatures = dict(signatures)
        self.build_log = ""                 # nvcc's output when this process built it
        self._lib: Optional[ctypes.CDLL] = None

    def library_path(self) -> Path:
        digest = hashlib.sha256(self.source.read_bytes())
        for header in sorted(CSRC_DIR.glob("*.cuh")):
            digest.update(header.read_bytes())
        digest.update(" ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"{self.source.stem}_{digest.hexdigest()[:16]}.so"

    def build(self) -> Path:
        """Compile the source unless the library for its hash exists."""
        so = self.library_path()
        if so.is_file():
            return so
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed with exit code {res.returncode} "
                               f"for {self.source.name}:\n{res.stdout}{res.stderr}")
        os.replace(tmp, so)   # atomic: concurrent builders never see a partial file
        self.build_log = res.stdout + res.stderr
        return so

    def load(self) -> ctypes.CDLL:
        if self._lib is None:
            lib = ctypes.CDLL(str(self.build()))
            for name, (restype, argtypes) in self.signatures.items():
                fn = getattr(lib, name)
                fn.restype = restype
                fn.argtypes = list(argtypes)
            self._lib = lib
        return self._lib
