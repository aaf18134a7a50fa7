"""Kernel B2: the exact time-median on the card (csrc/median.cu).

Replaces pyspectrogram_tpu/kernels/median_pallas.py::median_over_time_pallas
for every n: 33-step bisection on order-preserving int32 keys, plus the
count/min step for even n, one thread per output bin. There is no size
gate: each thread walks its own column.

:func:`median_over_time_cuda` launches the kernel for a CUDA tensor and
raises on anything the kernel does not take; a CPU tensor takes the plain
version, ops.plain.median_bisect.
"""

from __future__ import annotations

import torch

from pyspectrogram_tpu_torch.kernels import _build
from pyspectrogram_tpu_torch.ops.plain import median_bisect


def median_over_time_cuda(p: torch.Tensor) -> torch.Tensor:
    """Exact median over axis 0 of a float32 (n, ..., nfft) tensor ->
    (..., nfft); for even n the mean of the two middles, bit-equal to
    np.median. Launches on the current stream without synchronising."""
    if p.device.type == "cpu":
        return median_bisect(p)
    if p.device.type != "cuda":
        raise ValueError(f"no median kernel for device {p.device}")
    if p.dtype != torch.float32:
        raise TypeError(f"median kernel takes float32, got {p.dtype}")
    if p.dim() < 2 or p.shape[0] < 1 or not p.is_contiguous():
        raise ValueError("median kernel takes a contiguous (n, ..., nfft) "
                         f"tensor, got {tuple(p.shape)}")
    n = p.shape[0]
    out = torch.empty(p.shape[1:], dtype=torch.float32, device=p.device)
    if out.numel() == 0:
        return out
    rc = _build.library().pst_median(
        p.data_ptr(), n, out.numel(), out.data_ptr(), _build.stream_of(p))
    _build.check(rc, "median")
    median_over_time_cuda.launches += 1
    return out


#: kernel launches in this process (set to 0 to count a run's own)
median_over_time_cuda.launches = 0
