"""Plain torch versions of the port's kernels, and the dB conversion.

:func:`psd_torch` is kernel B1's plain version (the port of make_xla_psd,
ops/stft.py:372-406 of the JAX package) and the PSD path for every config
the kernel does not cover; :func:`median_bisect` is kernel B2's. Both run
on any device, and the kernel wrappers (kernels.sti_cuda,
kernels.median_cuda) call them for a CPU tensor. This module sits below
kernels/, display/ and ops.stft, so every import among them runs one way.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from pyspectrogram_tpu_torch.ops.windows import WindowSpec, get_window

#: float32 log10(e). The JAX reference's log10 is log(x) times this
#: constant (jnp.log10 lowers to a log and a multiply), so computing dB the
#: same way keeps the port within an ulp of log of the reference, and the
#: uint8 display levels equal to it.
LOG10_E = float(np.float32(1.0 / np.log(10.0)))


@functools.lru_cache(maxsize=64)
def psd_constants(window: WindowSpec, nfft: int, ref: float):
    """(window float32, power scale 1/((sum w)^2 * ref^2)) from the float64
    host window (ops/stft.py:385-387 of the JAX package)."""
    win64 = get_window(window, nfft)
    inv_scale = 1.0 / (float(win64.sum()) ** 2 * float(ref) ** 2)
    return win64.astype(np.float32), inv_scale


@functools.lru_cache(maxsize=64)
def _device_window(window: WindowSpec, nfft: int, device: torch.device):
    return torch.from_numpy(psd_constants(window, nfft, 1.0)[0]).to(device)


def psd_torch(samples_pm: torch.Tensor, starts: torch.Tensor, *, nfft: int,
              nint: int = 1, mode: str = "welch",
              window: WindowSpec = ("kaiser", 1.7),
              ref: float = 1.0) -> torch.Tensor:
    """Plane-major samples (nsub*2, nsamp) float32 or int16 + (ntime,)
    frame starts -> fftshifted LINEAR power (ntime, nsub, nfft) float32,
    with torch.fft. A start is clamped into the buffer the way
    jax.lax.dynamic_slice clamps it."""
    if mode not in ("parity", "welch"):
        raise ValueError(f"mode must be 'parity' or 'welch', got {mode!r}")
    frame_len = nfft * nint if mode == "welch" else nfft
    nsamp = samples_pm.shape[1]
    if nsamp < frame_len:
        raise ValueError(f"buffer of {nsamp} samples is shorter than one "
                         f"{frame_len}-sample frame")
    _, inv_scale = psd_constants(window, nfft, ref)
    dev = samples_pm.device
    st = starts.to(device=dev, dtype=torch.int64).clamp(0, nsamp - frame_len)
    idx = st[:, None] + torch.arange(frame_len, device=dev)
    fr = samples_pm[:, idx].to(torch.float32)     # (nsub*2, ntime, L)
    c = torch.complex(fr[0::2], fr[1::2]).transpose(0, 1)
    win = _device_window(window, nfft, dev)
    if mode == "welch":
        c = c.reshape(c.shape[0], c.shape[1], nint, nfft)
        p = _psd_frames(c, win, inv_scale).mean(dim=2)
    else:
        p = _psd_frames(c, win, inv_scale)
    return torch.fft.fftshift(p, dim=-1)


def _psd_frames(frames, win, power_scale: float):
    """Windowed two-sided 'spectrum'-scaled periodogram of (..., nfft)
    complex frames (psd_frames of the JAX package)."""
    X = torch.fft.fft(frames * win)
    return (X.real.square() + X.imag.square()) * power_scale


def _float_order_key(x: torch.Tensor) -> torch.Tensor:
    """float32 -> int32 key with the same total order (sign-magnitude to
    two's-complement flip; an involution)."""
    b = x.view(torch.int32)
    return b ^ ((b >> 31) & 0x7FFFFFFF)


def _kth_smallest_f32(x: torch.Tensor, k: int) -> torch.Tensor:
    """Exact k-th smallest (1-indexed) along axis 0 by a 33-step bisection
    on the float bit pattern (ops/stft.py:184-214 of the JAX package)."""
    kb = _float_order_key(x)
    lo = torch.full(x.shape[1:], -0x7F800001, dtype=torch.int32,
                    device=x.device)
    hi = torch.full(x.shape[1:], 0x7F800000, dtype=torch.int32,
                    device=x.device)
    # 33 halvings shrink the full key span (~2^32) to 0, leaving
    # lo == hi == the answer's key
    for _ in range(33):
        mid = (lo & hi) + ((lo ^ hi) >> 1)
        go_hi = (kb <= mid).sum(dim=0) >= k
        lo, hi = torch.where(go_hi, lo, mid + 1), torch.where(go_hi, mid, hi)
    return (hi ^ ((hi >> 31) & 0x7FFFFFFF)).view(torch.float32)


def median_bisect(p: torch.Tensor) -> torch.Tensor:
    """Exact float32 median over axis 0 — kernel B2's plain version: the
    bisection plus, for even n, the count/min step that makes it the mean
    of the two middles (ops/stft.py:299-306 of the JAX package)."""
    n = p.shape[0]
    k = (n + 1) // 2
    v1 = _kth_smallest_f32(p, k)
    if n % 2:
        return v1
    cnt_le = (p <= v1).sum(dim=0)
    bigger = torch.where(p > v1, p, torch.full_like(p, float("inf")))
    v2 = torch.where(cnt_le > k, v1, bigger.amin(dim=0))
    return 0.5 * (v1 + v2)


def to_dbfs(x: torch.Tensor, eps: float = 1e-15) -> torch.Tensor:
    """10*log10(x + eps) — the reference's dB conversion
    (reference: drfProc.py:308-310). float32 as ``jnp.log10`` lowers
    (:data:`LOG10_E`); float64 (the complex128 path of ops.stft.make_sti_fn)
    with torch.log10, whose float64 result the float32 constant would cut
    to ~1e-8."""
    if x.dtype == torch.float64:
        return 10.0 * torch.log10(x + eps)
    return 10.0 * (torch.log(x + eps) * LOG10_E)
