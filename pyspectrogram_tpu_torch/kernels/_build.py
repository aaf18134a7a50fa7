"""Build and load the port's CUDA kernels (``pyspectrogram_tpu_torch/csrc``).

Every ``*.cu`` source compiles in one ``nvcc`` call into a shared library
with a plain C interface for Hopper (``sm_90a``), loaded with ctypes — the
same pattern as the JAX package's native ingest (native/ingest.py). The
build runs at the first CUDA use, never at import (a CPU-only machine has
no ``nvcc``), and is keyed by a hash of the sources and flags, into the
checkout's ``build/kernels`` directory (``PSTORCH_BUILD_DIR`` overrides).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parents[1] / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
#: wall seconds the last build took in this process (0.0 when the library
#: came from the build directory) and the compiler's output (ptxas
#: registers, shared memory and spills per kernel)
build_seconds = 0.0
build_log = ""


def _build_dir() -> Path:
    d = os.environ.get("PSTORCH_BUILD_DIR", "")
    return Path(d) if d else CSRC.parents[1] / "build" / "kernels"


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (Path(home) / "bin" / "nvcc", shutil.which("nvcc")):
        if cand and Path(cand).exists():
            return str(cand)
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                       "build on first use on a machine with the toolkit")


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _LIB, build_seconds, build_log
    with _LOCK:
        if _LIB is not None:
            return _LIB
        srcs = _sources()
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for p in srcs:
            h.update(p.name.encode())
            h.update(p.read_bytes())
        out = _build_dir() / f"libpstorch-{h.hexdigest()[:16]}.so"
        if not out.exists():
            out.parent.mkdir(parents=True, exist_ok=True)
            # compile to a private name, then publish atomically, so a
            # concurrent process never loads a half-written library
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                   *[str(p) for p in srcs if p.suffix == ".cu"]]
            t0 = time.perf_counter()
            res = subprocess.run(cmd, capture_output=True, text=True,
                                 timeout=900)
            build_seconds = time.perf_counter() - t0
            build_log = res.stdout + res.stderr
            if res.returncode:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                                   f"{build_log}")
            os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.pst_sti_psd.argtypes = [vp, i32, i64, i32, vp, i32, i32, i32,
                                    vp, vp, ctypes.c_float, vp, vp, vp]
        lib.pst_sti_psd.restype = i32
        lib.pst_median.argtypes = [vp, i32, i64, vp, vp]
        lib.pst_median.restype = i32
        _LIB = lib
        return _LIB


def check(rc: int, what: str) -> None:
    """Raise on a non-zero ``cudaGetLastError()`` code from a launch."""
    if rc:
        raise RuntimeError(f"{what}: CUDA launch failed with error {rc}")
