"""Build and load the port's CUDA kernels (``pyspectrogram_tpu_torch/csrc``),
and the checks and constants the PSD kernels' wrappers share.

Each ``*.cu`` source compiles in its own ``nvcc`` process, all of them at
once, into an object for Hopper (``sm_90a``); one more call links them into
a shared library with a plain C interface, loaded with ctypes — the same
pattern as the JAX package's native ingest (native/ingest.py). The build
runs at the first CUDA use, never at import (a CPU-only machine has no
``nvcc``), and is keyed by a hash of the sources and flags, into the
checkout's ``build/kernels`` directory (``PSTORCH_BUILD_DIR`` overrides).
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from pyspectrogram_tpu_torch.ops.plain import psd_constants

CSRC = Path(__file__).resolve().parents[1] / "csrc"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()
_TALLY = threading.local()
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


def _run(cmd) -> subprocess.CompletedProcess:
    return subprocess.run(cmd, capture_output=True, text=True, timeout=900)


def _compile(out: Path, srcs) -> None:
    """nvcc every .cu source in parallel, then link the objects into
    ``out`` (through a private name, published atomically, so a concurrent
    process never loads a half-written library)."""
    global build_seconds, build_log
    nvcc = _nvcc()
    cus = [p for p in srcs if p.suffix == ".cu"]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        objs = [Path(tmp) / f"{p.stem}.o" for p in cus]
        with ThreadPoolExecutor(max_workers=len(cus)) as ex:
            results = list(ex.map(
                lambda po: _run([nvcc, *NVCC_FLAGS, "-c", "-o", str(po[1]),
                                 str(po[0])]), zip(cus, objs)))
        lib = Path(tmp) / out.name
        if all(r.returncode == 0 for r in results):
            results.append(_run([nvcc, *ARCH, "-shared", "-o", str(lib),
                                 *map(str, objs)]))
        build_seconds = time.perf_counter() - t0
        build_log = "".join(r.stdout + r.stderr for r in results)
        bad = [r.returncode for r in results if r.returncode]
        if bad:
            raise RuntimeError(f"nvcc failed ({bad[0]}):\n{build_log}")
        os.replace(lib, out)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _LIB
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
            _compile(out, srcs)
        lib = ctypes.CDLL(str(out))
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.pst_sti_psd.argtypes = [vp, i32, i64, i32, vp, i32, i32, i32,
                                    vp, vp, ctypes.c_float, vp, vp]
        lib.pst_four_step_cols.argtypes = [vp, i32, i64, i32, vp, i32, i32,
                                           i32, vp, vp, vp, vp]
        lib.pst_four_step_rows.argtypes = [vp, i32, i32, i32, i32, vp,
                                           ctypes.c_float, vp, vp]
        lib.pst_stream_psd.argtypes = [vp, i64, i32, i32, i32, i32, i32, vp,
                                       vp, ctypes.c_float, vp, vp, vp]
        lib.pst_median_tile.argtypes = [vp, i32, i32, i64, vp, vp]
        lib.pst_median_radix.argtypes = [vp, i32, i32, i64, i32, i32, vp, vp,
                                         vp, vp, vp, vp]
        for fn in (lib.pst_sti_psd, lib.pst_four_step_cols,
                   lib.pst_four_step_rows, lib.pst_stream_psd,
                   lib.pst_median_tile, lib.pst_median_radix):
            fn.restype = i32
        _LIB = lib
        return _LIB


def check(rc: int, what: str) -> None:
    """Raise on a non-zero ``cudaGetLastError()`` code from a launch."""
    if rc:
        raise RuntimeError(f"{what}: CUDA launch failed with error {rc}")


def count(fn, attr: str = "launches", n: int = 1) -> None:
    """Add ``n`` to a wrapper's launch counter ``fn.<attr>``, under a lock:
    processors on several threads launch the same kernels. A launch
    recorded into a CUDA graph being captured runs only when the graph
    replays, so it is not counted here: the graph's owner counts, at each
    replay, what a :func:`tally` of its warm-up counted."""
    cuda = torch.cuda
    if cuda.is_initialized() and cuda.is_current_stream_capturing():
        return
    with _COUNT_LOCK:
        setattr(fn, attr, getattr(fn, attr) + n)
    tallied = getattr(_TALLY, "counts", None)
    if tallied is not None:
        tallied[fn, attr] = tallied.get((fn, attr), 0) + n


@contextlib.contextmanager
def tally():
    """The counts this thread adds inside the block, as ``{(wrapper,
    counter): n}`` (other threads' launches are not in it)."""
    outer = getattr(_TALLY, "counts", None)
    _TALLY.counts = counts = {}
    try:
        yield counts
    finally:
        _TALLY.counts = outer
        if outer is not None:
            for k, n in counts.items():
                outer[k] = outer.get(k, 0) + n


def stream_of(t: torch.Tensor) -> int:
    """The handle of ``t``'s device's current stream, for a launch."""
    return torch.cuda.current_stream(t.device).cuda_stream


#: the four-step splits N1 x N2 of csrc (big_psd.cu PST_FOUR_STEP): B1 and
#: B3 at 32768, B4 above; smaller sizes run the one-block kernel
FOUR_STEP = {1 << 15: (128, 256), 1 << 16: (256, 256), 1 << 17: (512, 256),
             1 << 18: (512, 512), 1 << 19: (1024, 512),
             1 << 20: (1024, 1024)}


def twiddle_table(nfft: int) -> np.ndarray:
    """The kernels' twiddles in complex128: W_N^m for m < N/2 (the one-block
    kernel), or for a four-step size N = N1*N2 three small tables one after
    the other, W_N1^m (m < N1/2), W_N2^m (m < N2/2) and W_N^l (l < N2)."""
    def w(n, count):
        return np.exp(-2j * np.pi * np.arange(count) / n)

    if nfft not in FOUR_STEP:
        return w(nfft, nfft // 2)
    n1, n2 = FOUR_STEP[nfft]
    return np.concatenate([w(n1, n1 // 2), w(n2, n2 // 2), w(nfft, n2)])


@functools.lru_cache(maxsize=64)
def psd_device_constants(nfft, nint, mode, window, ref, device):
    """(window, twiddle_table(nfft), scale 1/((sum w)^2 ref^2 nseg)) —
    float64 on the host like the JAX kernel's (sti_pallas.py:451-456),
    cast to float32 on ``device``."""
    win, scale = psd_constants(window, nfft, ref)
    nseg = nint if mode == "welch" else 1
    tw = twiddle_table(nfft).astype(np.complex64)
    return (torch.from_numpy(win).to(device),
            torch.from_numpy(tw.view(np.float32)).to(device),
            float(np.float32(scale / nseg)))


def check_psd_args(samples_pm: torch.Tensor, mode: str, dtypes,
                   what: str) -> None:
    """Raise unless ``samples_pm`` is a contiguous plane-major CUDA tensor
    of one of ``dtypes`` and ``mode`` is a PSD mode (``what`` names the
    kernel in the messages)."""
    if samples_pm.device.type != "cuda":
        raise ValueError(f"no {what} kernel for device {samples_pm.device}")
    if mode not in ("parity", "welch"):
        raise ValueError(f"mode must be 'parity' or 'welch', got {mode!r}")
    if samples_pm.dtype not in dtypes:
        raise TypeError(f"samples must be {' or '.join(map(str, dtypes))} "
                        f"planes, got {samples_pm.dtype}")
    if samples_pm.dim() != 2 or samples_pm.shape[0] % 2 \
            or not samples_pm.is_contiguous():
        raise ValueError("samples must be a contiguous (nsub*2, nsamp) "
                         f"plane-major tensor, got {tuple(samples_pm.shape)}")


def check_starts(starts: torch.Tensor, samples_pm: torch.Tensor) -> None:
    if starts.dtype != torch.int32 or starts.dim() != 1 \
            or not starts.is_contiguous() \
            or starts.device != samples_pm.device:
        raise ValueError("starts must be a contiguous (ntime,) int32 tensor "
                         "on the samples' device")
