"""Kernel B1: the fused STI PSD on the card (csrc/sti_psd.cu), and the
entry point for every power-of-two nfft from 256 to 2^20.

Replaces pyspectrogram_tpu/kernels/sti_pallas.py::make_pallas_sti_psd
over its range, power-of-two nfft from 256 to 32768: per (column,
subchannel) thread block, window -> FFT in register-resident radix-16
passes that exchange the segment through shared memory -> |X|^2 summed
over the segments -> scale -> fftshift. 32768 points do not fit one block
and run as B4's four-step split (kernels.big_cuda.four_step_psd: two
launches per chunk of columns through a workspace). At nfft >= 65536
:func:`sti_psd_cuda` hands the call to kernel B4 (kernels.big_cuda), as
make_pallas_sti_psd hands it to
_make_big3_sti_psd (sti_pallas.py:442). The source says what bounds it and
why.

:func:`sti_psd_cuda` launches the kernel for a CUDA tensor and raises on
anything the kernels do not take; a CPU tensor takes the plain version,
ops.plain.psd_torch, which has the same arguments.
"""

from __future__ import annotations

import torch

from pyspectrogram_tpu_torch.kernels import _build, big_cuda
from pyspectrogram_tpu_torch.ops.plain import psd_torch

MIN_NFFT = 256
#: the widest reference nfft (utils/config.py NFFT_RANGE), through B4
MAX_NFFT = 1 << 20
#: the one-block register-pass kernel's largest size (its exchange buffer
#: is 136 KiB); above it the kernel takes the two-launch four-step split
ONE_BLOCK_MAX_NFFT = 16384
#: B1's own range ends here; kernel B4 takes the larger sizes
B1_MAX_NFFT = 32768


def supported(nfft: int) -> bool:
    return MIN_NFFT <= nfft <= MAX_NFFT and not nfft & (nfft - 1)


def check_supported(nfft: int) -> None:
    """Raise unless the kernels cover ``nfft``."""
    if not supported(nfft):
        raise ValueError(f"the CUDA STI path (kernels B1, B4) covers "
                         f"power-of-two nfft in "
                         f"[{MIN_NFFT}, {MAX_NFFT}], got {nfft}")


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
    check_supported(nfft)
    if nfft > B1_MAX_NFFT:
        return big_cuda.big_psd_cuda(samples_pm, starts, nfft=nfft,
                                     nint=nint, mode=mode, window=window,
                                     ref=ref)
    _build.check_psd_args(samples_pm, mode, (torch.float32, torch.int16),
                          "STI")
    _build.check_starts(starts, samples_pm)
    nsub = samples_pm.shape[0] // 2
    nsamp = samples_pm.shape[1]
    ntime = starts.shape[0]
    nseg = nint if mode == "welch" else 1
    if nsamp < nseg * nfft:
        raise ValueError(f"buffer of {nsamp} samples is shorter than one "
                         f"{nseg * nfft}-sample frame")
    if nfft > ONE_BLOCK_MAX_NFFT:
        # the four-step split over chunks of columns (B4's loop)
        return big_cuda.four_step_psd(samples_pm, starts, nfft=nfft,
                                      nint=nint, mode=mode, window=window,
                                      ref=ref, counter=sti_psd_cuda)
    win, tw, inv_scale = _build.psd_device_constants(
        nfft, nint, mode, window, ref, samples_pm.device)
    out = torch.empty((ntime, nsub, nfft), dtype=torch.float32,
                      device=samples_pm.device)
    if ntime == 0:
        return out
    rc = _build.library().pst_sti_psd(
        samples_pm.data_ptr(), 0 if samples_pm.dtype == torch.float32 else 1,
        nsamp, nsub, starts.data_ptr(), ntime, nfft, nseg, win.data_ptr(),
        tw.data_ptr(), inv_scale, out.data_ptr(),
        _build.stream_of(samples_pm))
    _build.check(rc, "sti_psd")
    _build.count(sti_psd_cuda)
    return out


#: kernel launches in this process (set to 0 to count a run's own)
sti_psd_cuda.launches = 0
