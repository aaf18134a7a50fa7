"""Kernel B1: the fused STI PSD on the card (csrc/sti_psd.cu).

Replaces pyspectrogram_tpu/kernels/sti_pallas.py::make_pallas_sti_psd over
its range, power-of-two nfft from 256 to 32768: per (column, subchannel)
thread block, window -> radix-2 Stockham FFT in shared memory -> |X|^2
summed over the segments -> scale -> fftshift. 32768 points do not fit one
block and run as a four-step split over two launches through a workspace.
The source says what bounds it and why.

:func:`sti_psd_cuda` launches the kernel for a CUDA tensor and raises on
anything the kernel does not take; a CPU tensor takes the plain version,
ops.plain.psd_torch, which has the same arguments.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from pyspectrogram_tpu_torch.kernels import _build
from pyspectrogram_tpu_torch.ops.plain import psd_constants, psd_torch

MIN_NFFT = 256
MAX_NFFT = 32768
#: 16384 complex float32 values are 128 KB, the most one block's shared
#: memory holds; above it the kernel takes the two-launch four-step split
ONE_BLOCK_MAX_NFFT = 16384


def supported(nfft: int) -> bool:
    return MIN_NFFT <= nfft <= MAX_NFFT and not nfft & (nfft - 1)


def check_supported(nfft: int) -> None:
    """Raise unless the kernel covers ``nfft``."""
    if not supported(nfft):
        raise ValueError(f"the CUDA STI kernel covers power-of-two nfft in "
                         f"[{MIN_NFFT}, {MAX_NFFT}], got {nfft}")


@functools.lru_cache(maxsize=64)
def _device_constants(nfft, nint, mode, window, ref, device):
    """(window, twiddles W_N^m for m < N/2, scale 1/((sum w)^2 ref^2 nseg))
    — float64 on the host like the JAX kernel's (sti_pallas.py:451-456),
    cast to float32 on ``device``."""
    win, scale = psd_constants(window, nfft, ref)
    nseg = nint if mode == "welch" else 1
    tw = np.exp(-2j * np.pi * np.arange(nfft // 2) / nfft).astype(np.complex64)
    return (torch.from_numpy(win).to(device),
            torch.from_numpy(tw.view(np.float32)).to(device),
            float(np.float32(scale / nseg)))


def sti_psd_cuda(samples_pm: torch.Tensor, starts: torch.Tensor, *,
                 nfft: int, nint: int = 1, mode: str = "welch",
                 window=("kaiser", 1.7), ref: float = 1.0) -> torch.Tensor:
    """Plane-major samples (nsub*2, nsamp) float32 or int16 + (ntime,)
    int32 frame starts -> fftshifted linear power (ntime, nsub, nfft).

    Welch mode averages nint segments per column, parity uses the first
    (the reference's truncation, drfProc.py:387-396). Launches on the
    current stream without synchronising."""
    if samples_pm.device.type == "cpu":
        return psd_torch(samples_pm, starts, nfft=nfft, nint=nint, mode=mode,
                         window=window, ref=ref)
    if samples_pm.device.type != "cuda":
        raise ValueError(f"no STI kernel for device {samples_pm.device}")
    check_supported(nfft)
    if mode not in ("parity", "welch"):
        raise ValueError(f"mode must be 'parity' or 'welch', got {mode!r}")
    if samples_pm.dtype not in (torch.float32, torch.int16):
        raise TypeError(f"samples must be float32 or int16 planes, got "
                        f"{samples_pm.dtype}")
    if samples_pm.dim() != 2 or samples_pm.shape[0] % 2 \
            or not samples_pm.is_contiguous():
        raise ValueError("samples must be a contiguous (nsub*2, nsamp) "
                         f"plane-major tensor, got {tuple(samples_pm.shape)}")
    if starts.dtype != torch.int32 or starts.dim() != 1 \
            or not starts.is_contiguous() \
            or starts.device != samples_pm.device:
        raise ValueError("starts must be a contiguous (ntime,) int32 tensor "
                         "on the samples' device")
    nsub = samples_pm.shape[0] // 2
    nsamp = samples_pm.shape[1]
    ntime = starts.shape[0]
    nseg = nint if mode == "welch" else 1
    if nsamp < nseg * nfft:
        raise ValueError(f"buffer of {nsamp} samples is shorter than one "
                         f"{nseg * nfft}-sample frame")
    win, tw, inv_scale = _device_constants(nfft, nint, mode, window, ref,
                                           samples_pm.device)
    out = torch.empty((ntime, nsub, nfft), dtype=torch.float32,
                      device=samples_pm.device)
    if ntime == 0:
        return out
    work = None
    if nfft > ONE_BLOCK_MAX_NFFT:
        # the four-step split's per-segment intermediate (complex float32)
        work = torch.empty((ntime, nsub, nseg, nfft, 2), dtype=torch.float32,
                           device=samples_pm.device)
    rc = _build.library().pst_sti_psd(
        samples_pm.data_ptr(), 0 if samples_pm.dtype == torch.float32 else 1,
        nsamp, nsub, starts.data_ptr(), ntime, nfft, nseg, win.data_ptr(),
        tw.data_ptr(), inv_scale, None if work is None else work.data_ptr(),
        out.data_ptr(),
        torch.cuda.current_stream(samples_pm.device).cuda_stream)
    _build.check(rc, "sti_psd")
    sti_psd_cuda.launches += 1
    return out


#: kernel launches in this process (set to 0 to count a run's own)
sti_psd_cuda.launches = 0
