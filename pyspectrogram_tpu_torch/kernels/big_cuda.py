"""Kernel B4: the STI PSD at nfft >= 65536 on the card (csrc/big_psd.cu).

Replaces pyspectrogram_tpu/kernels/sti_pallas.py::_make_big3_sti_psd over
its range, power-of-two nfft from 65536 to 2^20, with B1's contract:
gathered or contiguous frame starts, float32 or int16 planes, welch or
parity. The transform is a four-step split N = N1 * N2 (N1 >= N2 in
{256, 512, 1024}) in two launches through a workspace of 8 bytes per sample
per segment, which :func:`big_psd_cuda` allocates and keeps within
:data:`WORKSPACE_MAX_BYTES` by launching over chunks of columns. The source
says what bounds it and why.

:func:`big_psd_cuda` launches the kernel for a CUDA tensor and raises on
anything the kernel does not take; a CPU tensor takes the plain version,
ops.plain.psd_torch, which has the same arguments. kernels.sti_cuda hands
it every call at nfft >= 65536.
"""

from __future__ import annotations

import torch

from pyspectrogram_tpu_torch.kernels import _build
from pyspectrogram_tpu_torch.ops.plain import psd_torch

MIN_NFFT = 1 << 16
MAX_NFFT = 1 << 20
#: the most workspace one launch pair may use; larger requests go in
#: column chunks (at least one column each)
WORKSPACE_MAX_BYTES = 1 << 30


def big_psd_cuda(samples_pm: torch.Tensor, starts: torch.Tensor, *,
                 nfft: int, nint: int = 1, mode: str = "welch",
                 window=("kaiser", 1.7), ref: float = 1.0) -> torch.Tensor:
    """Plane-major samples (nsub*2, nsamp) float32 or int16 + (ntime,)
    int32 frame starts -> fftshifted linear power (ntime, nsub, nfft), for
    power-of-two 65536 <= nfft <= 2^20. Launches on the current stream
    without synchronising."""
    if samples_pm.device.type == "cpu":
        return psd_torch(samples_pm, starts, nfft=nfft, nint=nint, mode=mode,
                         window=window, ref=ref)
    if not (MIN_NFFT <= nfft <= MAX_NFFT) or nfft & (nfft - 1):
        raise ValueError(f"kernel B4 covers power-of-two nfft in "
                         f"[{MIN_NFFT}, {MAX_NFFT}], got {nfft}")
    _build.check_psd_args(samples_pm, mode, (torch.float32, torch.int16),
                          "big STI")
    _build.check_starts(starts, samples_pm)
    nsub = samples_pm.shape[0] // 2
    nsamp = samples_pm.shape[1]
    ntime = starts.shape[0]
    nseg = nint if mode == "welch" else 1
    if nsamp < nseg * nfft:
        raise ValueError(f"buffer of {nsamp} samples is shorter than one "
                         f"{nseg * nfft}-sample frame")
    win, tw, inv_scale = _build.psd_device_constants(
        nfft, nint, mode, window, ref, samples_pm.device)
    out = torch.empty((ntime, nsub, nfft), dtype=torch.float32,
                      device=samples_pm.device)
    if ntime == 0:
        return out
    col_bytes = nsub * nseg * nfft * 8
    chunk = max(1, min(ntime, WORKSPACE_MAX_BYTES // col_bytes))
    work = torch.empty((chunk, nsub, nseg, nfft, 2), dtype=torch.float32,
                       device=samples_pm.device)
    lib = _build.library()
    dtype = 0 if samples_pm.dtype == torch.float32 else 1
    for c0 in range(0, ntime, chunk):
        n = min(chunk, ntime - c0)
        rc = lib.pst_big_psd(
            samples_pm.data_ptr(), dtype, nsamp, nsub,
            starts[c0:].data_ptr(), n, nfft, nseg, win.data_ptr(),
            tw.data_ptr(), inv_scale, work.data_ptr(),
            out[c0:].data_ptr(), _build.stream_of(samples_pm))
        _build.check(rc, "big_psd")
        _build.count(big_psd_cuda)
    return out


#: kernel launches in this process, one per column chunk (set to 0 to count
#: a run's own)
big_psd_cuda.launches = 0
