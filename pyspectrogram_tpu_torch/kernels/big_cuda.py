"""Kernel B4: the STI PSD at nfft >= 65536 on the card (csrc/big_psd.cu),
and the four-step split it shares with kernel B1 at nfft 32768.

Replaces pyspectrogram_tpu/kernels/sti_pallas.py::_make_big3_sti_psd over
its range, power-of-two nfft from 65536 to 2^20, with B1's contract:
gathered or contiguous frame starts, float32 or int16 planes, welch or
parity. The transform is a four-step split N = N1 * N2 in two launches
through a workspace of 8 bytes per sample per segment: launch 1 (columns)
writes it, launch 2 (rows) reads it back and writes the power.
:func:`four_step_psd` runs them over chunks of columns, each chunk's
workspace at most :data:`WORKSPACE_MAX_BYTES` (at least one column). Chunks
of half the L2, so that launch 2 would find what launch 1 wrote in the L2,
were measured on an H100 and were slower (kernel_times.py, PERF.md): each
chunk's launches are too small to fill the card. The source says what
bounds it and why.

:func:`big_psd_cuda` launches the kernel for a CUDA tensor and raises on
anything the kernel does not take; a CPU tensor takes the plain version,
ops.plain.psd_torch, which has the same arguments. kernels.sti_cuda hands
it every call at nfft >= 65536, and runs its own 32768-point calls through
:func:`four_step_psd`.
"""

from __future__ import annotations

import torch

from pyspectrogram_tpu_torch.kernels import _build
from pyspectrogram_tpu_torch.ops.plain import psd_torch

MIN_NFFT = 1 << 16
MAX_NFFT = 1 << 20
#: the most workspace one launch pair may use; larger requests go in
#: column chunks
WORKSPACE_MAX_BYTES = 1 << 30


def chunk_columns(ntime: int, col_bytes: int, budget: int) -> int:
    """Columns per launch pair: as many as fit ``budget`` bytes of
    workspace at ``col_bytes`` each, at least one, at most ``ntime``."""
    return max(1, min(ntime, budget // col_bytes))


def launch_cols(samples_pm, starts, nfft, nseg, win, tw, work) -> None:
    """Launch 1 over the len(starts) columns of ``starts`` into ``work``
    (at least len(starts) * nsub * nseg * nfft complex values)."""
    rc = _build.library().pst_four_step_cols(
        samples_pm.data_ptr(), 0 if samples_pm.dtype == torch.float32 else 1,
        samples_pm.shape[1], samples_pm.shape[0] // 2, starts.data_ptr(),
        starts.shape[0], nfft, nseg, win.data_ptr(), tw.data_ptr(),
        work.data_ptr(), _build.stream_of(samples_pm))
    _build.check(rc, "four_step_cols")


def launch_rows(work, nsub, ntime, nfft, nseg, tw, inv_scale, out) -> None:
    """Launch 2: the first ``ntime`` columns of ``out`` from ``work``."""
    rc = _build.library().pst_four_step_rows(
        work.data_ptr(), nsub, ntime, nfft, nseg, tw.data_ptr(), inv_scale,
        out.data_ptr(), _build.stream_of(out))
    _build.check(rc, "four_step_rows")


def four_step_psd(samples_pm: torch.Tensor, starts: torch.Tensor, *,
                  nfft: int, nint: int, mode: str, window, ref: float,
                  counter) -> torch.Tensor:
    """The four-step split's launch pairs over chunks of columns, for
    checked arguments: (ntime, nsub, nfft) power. The workspace is
    allocated once for the largest chunk; each launch pair adds one to the
    launch count of ``counter``, the wrapper that called."""
    nsub = samples_pm.shape[0] // 2
    ntime = starts.shape[0]
    nseg = nint if mode == "welch" else 1
    win, tw, inv_scale = _build.psd_device_constants(
        nfft, nint, mode, window, ref, samples_pm.device)
    out = torch.empty((ntime, nsub, nfft), dtype=torch.float32,
                      device=samples_pm.device)
    if ntime == 0:
        return out
    chunk = chunk_columns(ntime, nsub * nseg * nfft * 8, WORKSPACE_MAX_BYTES)
    work = torch.empty((chunk, nsub, nseg, nfft, 2), dtype=torch.float32,
                       device=samples_pm.device)
    for c0 in range(0, ntime, chunk):
        n = min(chunk, ntime - c0)
        st, o = (starts, out) if n == ntime else (starts[c0:c0 + n], out[c0:])
        launch_cols(samples_pm, st, nfft, nseg, win, tw, work)
        launch_rows(work, nsub, n, nfft, nseg, tw, inv_scale, o)
        _build.count(counter)
    return out


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
    nseg = nint if mode == "welch" else 1
    if samples_pm.shape[1] < nseg * nfft:
        raise ValueError(f"buffer of {samples_pm.shape[1]} samples is "
                         f"shorter than one {nseg * nfft}-sample frame")
    return four_step_psd(samples_pm, starts, nfft=nfft, nint=nint,
                         mode=mode, window=window, ref=ref,
                         counter=big_psd_cuda)


#: launch pairs in this process, one per column chunk (set to 0 to count a
#: run's own)
big_psd_cuda.launches = 0
