"""Kernel B2: the exact time-median on the card (csrc/median.cu).

Replaces pyspectrogram_tpu/kernels/median_pallas.py::median_over_time_pallas
for every n: 33-step bisection on order-preserving int32 keys, plus the
count/min step for even n, one thread per output bin. There is no size
gate: each thread walks its own column. With ``batched=True`` one launch
takes a batch of requests' cubes (the merged multi-request launch of
models.batch, which JAX gets from ``jax.vmap(stft.median_over_time)``),
one thread per (request, bin).

:func:`median_over_time_cuda` launches the kernel for a CUDA tensor and
raises on anything the kernel does not take; a CPU tensor takes the plain
version, ops.plain.median_bisect, per request.
"""

from __future__ import annotations

import torch

from pyspectrogram_tpu_torch.kernels import _build
from pyspectrogram_tpu_torch.ops.plain import median_bisect


def median_over_time_cuda(p: torch.Tensor,
                          batched: bool = False) -> torch.Tensor:
    """Exact median over the time axis of a float32 (n, ..., nfft) tensor
    -> (..., nfft); with ``batched``, of each request of a (B, n, ...,
    nfft) tensor -> (B, ..., nfft). For even n the mean of the two
    middles, bit-equal to np.median. Launches on the current stream
    without synchronising."""
    if p.device.type == "cpu":
        if batched:
            return torch.stack([median_bisect(pb) for pb in p])
        return median_bisect(p)
    if p.device.type != "cuda":
        raise ValueError(f"no median kernel for device {p.device}")
    if p.dtype != torch.float32:
        raise TypeError(f"median kernel takes float32, got {p.dtype}")
    lead = 2 if batched else 1
    if p.dim() < lead + 1 or min(p.shape[:lead]) < 1 \
            or not p.is_contiguous():
        want = "(B, n, ..., nfft)" if batched else "(n, ..., nfft)"
        raise ValueError(f"median kernel takes a contiguous {want} tensor, "
                         f"got {tuple(p.shape)}")
    batch = p.shape[0] if batched else 1
    n = p.shape[lead - 1]
    out = torch.empty(p.shape[:lead - 1] + p.shape[lead:],
                      dtype=torch.float32, device=p.device)
    if out.numel() == 0:
        return out
    rc = _build.library().pst_median(
        p.data_ptr(), batch, n, out.numel() // batch, out.data_ptr(),
        _build.stream_of(p))
    _build.check(rc, "median")
    _build.count(median_over_time_cuda)
    if batched:
        _build.count(median_over_time_cuda, "batched_launches")
    return out


#: kernel launches in this process, and how many of them took a batch of
#: requests (set both to 0 to count a run's own)
median_over_time_cuda.launches = 0
median_over_time_cuda.batched_launches = 0
