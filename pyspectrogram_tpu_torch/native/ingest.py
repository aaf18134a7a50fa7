"""ctypes bindings for the native ingest kernels (native/pstpu_ingest.cpp).

The shared library is built on demand with g++ into the checkout's
``build/native`` directory (``PSTORCH_NATIVE_DIR`` overrides). Every entry
point has a numpy fallback so the framework works on machines without a
toolchain; ``native_available()`` reports which path is active.

Copy of pyspectrogram_tpu/native/ingest.py and its C++ source: the port
imports nothing of that package. Only the source and build paths differ.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False

# the port's own copy of the source, inside the package
_SRC = Path(__file__).resolve().parent / "pstpu_ingest.cpp"


def _cache_dir() -> Path:
    d = os.environ.get("PSTORCH_NATIVE_DIR", "")
    if d:
        return Path(d)
    return Path(__file__).resolve().parents[2] / "build" / "native"


def _build() -> Optional[Path]:
    if not _SRC.exists():
        return None
    import hashlib

    # content-hash key: two checkouts sharing one cache dir get their own
    # binaries, and a source change can never load a stale .so (the old
    # mtime compare raced pip's mtime preservation)
    tag = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    out = _cache_dir() / f"libpstpu_ingest-{tag}.so"
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    # compile to a private temp name, then atomically publish: concurrent
    # processes (bench + GUI, parallel test runs) must never dlopen a
    # half-written ELF or interleave g++ output on the same file
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = ["g++", "-O3", "-march=native", "-fPIC", "-shared",
           "-o", str(tmp), str(_SRC)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)
    except Exception:
        tmp.unlink(missing_ok=True)
        return None
    return out


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    with _LOCK:
        if _TRIED:
            return _LIB
        _TRIED = True
        path = _build()
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(str(path))
            # explicit check, not assert: `python -O` strips asserts and
            # a mismatched binary would then be called through wrong
            # argtypes (memory corruption, not an error)
            if lib.pstpu_ingest_abi_version() != 1:
                return None
        except Exception:
            return None
        i64 = ctypes.c_int64
        i32 = ctypes.c_int32
        fp = ctypes.POINTER(ctypes.c_float)
        sp = ctypes.POINTER(ctypes.c_int16)
        ip = ctypes.POINTER(ctypes.c_int64)
        lib.assemble_pm_c64.argtypes = [fp, i64, i32, ip, i32, i64, fp]
        lib.assemble_pm_i16.argtypes = [sp, i64, i32, ip, i32, i64, sp]
        lib.deinterleave_c64.argtypes = [fp, i64, i32, fp]
        _LIB = lib
        return _LIB


def native_available() -> bool:
    return _load() is not None


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def assemble_plane_major(span: np.ndarray, starts_rel: np.ndarray,
                         frame_len: int) -> np.ndarray:
    """Span (span_len, nsub) complex64 or int16-compound -> plane-major
    (nsub*2, ntime*frame_len) frames buffer for the device.

    starts_rel are frame starts relative to the span. Uses the C++ kernel
    when available, numpy otherwise (identical results).
    """
    starts = np.ascontiguousarray(starts_rel, np.int64)
    ntime = len(starts)
    nsub = span.shape[1]
    # validate HERE, where both paths share it: the C kernels trust
    # starts (a silent heap overread on bad input) while the numpy path
    # fails with an obscure broadcast error — one explicit contract
    if ntime and (int(starts.min()) < 0
                  or int(starts.max()) + frame_len > span.shape[0]):
        raise ValueError(
            f"frame starts out of span: starts in "
            f"[{int(starts.min())}, {int(starts.max())}] + frame_len "
            f"{frame_len} vs span_len {span.shape[0]}")
    lib = _load()

    if span.dtype == np.complex64:
        span_c = np.ascontiguousarray(span)
        out = np.empty((nsub * 2, ntime * frame_len), np.float32)
        if lib is not None:
            lib.assemble_pm_c64(
                _ptr(span_c.view(np.float32), ctypes.c_float),
                span_c.shape[0], nsub, _ptr(starts, ctypes.c_int64),
                ntime, frame_len, _ptr(out, ctypes.c_float))
            return out
        return _assemble_pm_numpy(span_c, starts, frame_len, out)
    if span.dtype.names is not None and span.dtype["r"] == np.int16:
        span_c = np.ascontiguousarray(span)
        out = np.empty((nsub * 2, ntime * frame_len), np.int16)
        if lib is not None:
            lib.assemble_pm_i16(
                _ptr(span_c.view(np.int16), ctypes.c_int16),
                span_c.shape[0], nsub, _ptr(starts, ctypes.c_int64),
                ntime, frame_len, _ptr(out, ctypes.c_int16))
            return out
        ri = span_c.view(np.int16).reshape(span_c.shape[0], nsub, 2)
        return _assemble_pm_numpy_planes(ri, starts, frame_len, out)
    # generic fallback: convert to complex64 first
    return assemble_plane_major(to_complex64(span), starts, frame_len)


def to_complex64(raw: np.ndarray) -> np.ndarray:
    """Storage-dtype block -> complex64. Compound ('r','i') integer
    dtypes other than int16 (int8/int32/int64 — all legal Digital RF
    storage, io.drf_format) convert FIELD-WISE: numpy cannot astype a
    structured dtype to complex (TypeError), which crashed every ingest
    route for those captures. int32/int64 lose low-order bits to the
    float32 planes exactly like the rest of the f32 compute path."""
    if raw.dtype == np.complex64:
        return raw
    if raw.dtype.names is not None:
        out = np.empty(raw.shape, np.complex64)
        out.real = raw["r"]
        out.imag = raw["i"]
        return out
    return raw.astype(np.complex64)


def _assemble_pm_numpy(span_c64: np.ndarray, starts, frame_len, out):
    nsub = span_c64.shape[1]
    ri = span_c64.view(np.float32).reshape(span_c64.shape[0], nsub, 2)
    return _assemble_pm_numpy_planes(ri, starts, frame_len, out)


def _assemble_pm_numpy_planes(ri: np.ndarray, starts, frame_len, out):
    ntime = len(starts)
    nsub = ri.shape[1]
    for t, s in enumerate(starts):
        fr = ri[s : s + frame_len]                   # (frame_len, nsub, 2)
        sl = slice(t * frame_len, (t + 1) * frame_len)
        for sub in range(nsub):
            out[2 * sub, sl] = fr[:, sub, 0]
            out[2 * sub + 1, sl] = fr[:, sub, 1]
    return out


def deinterleave_plane_major(x: np.ndarray) -> np.ndarray:
    """(n, nsub) complex64 -> (nsub*2, n) float32 planes."""
    x = np.ascontiguousarray(x, np.complex64)
    n, nsub = x.shape
    out = np.empty((nsub * 2, n), np.float32)
    lib = _load()
    if lib is not None:
        lib.deinterleave_c64(_ptr(x.view(np.float32), ctypes.c_float),
                             n, nsub, _ptr(out, ctypes.c_float))
        return out
    ri = x.view(np.float32).reshape(n, nsub, 2)
    for sub in range(nsub):
        out[2 * sub] = ri[:, sub, 0]
        out[2 * sub + 1] = ri[:, sub, 1]
    return out
