"""GEMM-formulated FFT — the port of pyspectrogram_tpu/kernels/gemm_fft.py.

For N = N1*N2, index n = N2*p + q, k = N1*k2 + k1, with x2[p, q] = x[N2*p + q]:

    Y  = D1 @ x2          (N1,N1)@(N1,N2) — stage-1 DFT along p
    Z  = Y * T            twiddle T[k1, q] = W_N^(q*k1)
    Xm = Z @ D2           (N1,N2)@(N2,N2) — stage-2 DFT along q
    X[N1*k2 + k1] = Xm[k1, k2]   (i.e. flatten Xm transposed)

The JAX package computes this with XLA matmuls, outside any Pallas kernel
(``make_sti_fn(fft_impl="gemm")``), so the port's :func:`make_gemm_fft` is
two complex torch.matmul calls plus the twiddle, on the input's device,
with no kernel of its own.

:class:`FFTPlan`, :func:`dft_mat`, :func:`twiddle_mat`,
:func:`split_factors`, :func:`make_plan` and :func:`gemm_fft_numpy` are
copies of pyspectrogram_tpu/kernels/gemm_fft.py's host planning: the port
imports nothing of that package.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch


class FFTPlan(NamedTuple):
    nfft: int
    n1: int
    n2: int
    d1r: np.ndarray  # (n1, n1) stage-1 DFT real
    d1i: np.ndarray  # (n1, n1) stage-1 DFT imag
    d2r: np.ndarray  # (n2, n2) stage-2 DFT real
    d2i: np.ndarray  # (n2, n2) stage-2 DFT imag
    twr: np.ndarray  # (n1, n2) twiddle real
    twi: np.ndarray  # (n1, n2) twiddle imag


def dft_mat(n: int) -> np.ndarray:
    """Dense n-point DFT matrix W[j, k] = exp(-2pi*i*jk/n), complex128.
    The single shared builder behind every GEMM-FFT plan in the package
    (this module, kernels.sti_pallas plans, parallel.big_sti local
    stages, parallel.dist_fft)."""
    k = np.arange(n)
    return np.exp(-2j * np.pi * np.outer(k, k) / n)


def twiddle_mat(n1: int, n2: int, nfft: int | None = None) -> np.ndarray:
    """Twiddle T[p, q] = exp(-2pi*i*pq/nfft) for the split N = n1*n2
    (``nfft`` defaults to n1*n2; pass it explicitly for nested splits
    like the 3-stage kernel's T1), complex128."""
    if nfft is None:
        nfft = n1 * n2
    return np.exp(
        -2j * np.pi * np.outer(np.arange(n1), np.arange(n2)) / nfft)


def split_factors(nfft: int) -> Tuple[int, int]:
    """(n1, n2) with n1*n2 == nfft, n1 as close to 128 as possible (MXU
    width) and both powers of two."""
    if nfft & (nfft - 1):
        raise ValueError("GEMM FFT requires power-of-two nfft")
    n1 = min(128, nfft)
    while nfft // n1 > 512:  # keep n2 manageable for VMEM
        n1 *= 2
    return n1, nfft // n1


@functools.lru_cache(maxsize=32)
def make_plan(nfft: int, dtype=np.float32) -> FFTPlan:
    n1, n2 = split_factors(nfft)
    d1 = dft_mat(n1)               # D1[k1, p]
    d2 = dft_mat(n2)               # D2[q, k2] (symmetric)
    tw = twiddle_mat(n1, n2)       # T[k1, q]
    return FFTPlan(
        nfft, n1, n2,
        d1.real.astype(dtype), d1.imag.astype(dtype),
        d2.real.astype(dtype), d2.imag.astype(dtype),
        tw.real.astype(dtype), tw.imag.astype(dtype),
    )


def gemm_fft_numpy(xr: np.ndarray, xi: np.ndarray, plan: FFTPlan
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Reference implementation of the factorized FFT for (..., nfft)
    real/imag planes; returns (Xr, Xi) in natural bin order. Used to
    validate the plan and as the oracle for the Pallas kernel."""
    n1, n2 = plan.n1, plan.n2
    sh = xr.shape[:-1]
    x2r = xr.reshape(sh + (n1, n2))
    x2i = xi.reshape(sh + (n1, n2))
    yr = np.einsum("kp,...pq->...kq", plan.d1r, x2r) - np.einsum(
        "kp,...pq->...kq", plan.d1i, x2i)
    yi = np.einsum("kp,...pq->...kq", plan.d1r, x2i) + np.einsum(
        "kp,...pq->...kq", plan.d1i, x2r)
    zr = yr * plan.twr - yi * plan.twi
    zi = yr * plan.twi + yi * plan.twr
    xmr = zr @ plan.d2r - zi @ plan.d2i
    xmi = zr @ plan.d2i + zi @ plan.d2r
    # X[N1*k2 + k1] = Xm[k1, k2]
    Xr = np.swapaxes(xmr, -1, -2).reshape(sh + (plan.nfft,))
    Xi = np.swapaxes(xmi, -1, -2).reshape(sh + (plan.nfft,))
    return Xr, Xi


@functools.lru_cache(maxsize=64)
def _device_plan(nfft: int, device: torch.device):
    """(D1, D2, T) of :func:`make_plan` as complex128 tensors on
    ``device``, rounded to complex64 first as the JAX package's constants
    are."""
    plan = make_plan(nfft)
    mats = ((plan.d1r, plan.d1i), (plan.d2r, plan.d2i), (plan.twr, plan.twi))
    return tuple(
        torch.from_numpy((re + 1j * im).astype(np.complex64)).to(
            device=device, dtype=torch.complex128)
        for re, im in mats)


def make_gemm_fft(nfft: int):
    """The factorized complex FFT (the XLA path with fft_impl="gemm"):
    input (..., nfft) complex64 or complex128 on any device, output the
    same dtype, in natural bin order.

    The JAX package pins Precision.HIGHEST on its matmuls. A card's
    float32 matmuls may run in TF32 (~1e-3 relative error) whenever the
    caller allows it (``torch.backends.cuda.matmul.allow_tf32``,
    ``set_float32_matmul_precision`` or ``fp32_precision``), and torch has
    no per-call precision: switching the global setting for the call
    would race other threads and, once a caller mixes torch's two
    precision APIs, reading it raises. So the two matmuls run in
    complex128, which no TF32 setting touches, and round back to the
    input's dtype (the H100's published float64 tensor-core peak equals
    its float32 peak, 67 TFLOP/s)."""
    plan = make_plan(nfft)
    n1, n2 = plan.n1, plan.n2

    def fft(x: torch.Tensor) -> torch.Tensor:
        d1, d2, tw = _device_plan(nfft, x.device)
        sh = x.shape[:-1]
        x2 = x.reshape(sh + (n1, n2)).to(torch.complex128)
        xm = torch.matmul(torch.matmul(d1, x2) * tw, d2)
        return xm.transpose(-1, -2).reshape(sh + (nfft,)).to(x.dtype)

    return fft
