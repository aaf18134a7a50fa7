"""Kernel B2: the exact time-median on the card (csrc/median.cu).

Replaces pyspectrogram_tpu/kernels/median_pallas.py::median_over_time_pallas
for every n, bit-equal to ops.plain.median_bisect. There is no size gate;
:func:`regime` picks one of the source's two designs from n and the
shared-memory budget: ``"tile"`` (the n x 32 column tile sits in shared
memory, 33 bisection sweeps there with 8 threads per column) or ``"radix"``
(4 streaming passes of an 8-bit radix select, row chunks spread over the
SMs, a per-column histogram and select step in a workspace this wrapper
allocates). With ``batched=True`` one launch takes a batch of requests'
cubes (the merged multi-request launch of models.batch, which JAX gets
from ``jax.vmap(stft.median_over_time)``); the request index is a grid
dimension in both designs.

:func:`median_over_time_cuda` launches the kernel for a CUDA tensor and
raises on anything the kernel does not take; a CPU tensor takes the plain
version, ops.plain.median_bisect, per request.
"""

from __future__ import annotations

import torch

from pyspectrogram_tpu_torch.kernels import _build
from pyspectrogram_tpu_torch.ops.plain import median_bisect

#: the tile design's shared memory: n rows of 32 + 4 keys must fit this
#: (TILE_STRIDE and TILE_MAX_BYTES of csrc/median.cu)
TILE_ROW_BYTES = (32 + 4) * 4
TILE_MAX_BYTES = 96 * 1024
#: radix design: columns per block tile with 16-byte loads, histogram
#: blocks queued per SM, and the fewest rows a block's chunk takes
RADIX_TILE_COLS = 128
RADIX_BLOCKS_PER_SM = 8
RADIX_MIN_ROWS = 64
#: blocks of the radix grid's y and z dimensions (CUDA's limit)
MAX_GRID_YZ = 65535


def regime(n: int) -> str:
    """'tile' when an n-row column tile fits the shared-memory budget,
    else 'radix'."""
    return "tile" if n * TILE_ROW_BYTES <= TILE_MAX_BYTES else "radix"


def radix_rows(n: int, batch: int, cols: int, sm_count: int) -> int:
    """Rows per block in the radix design: enough (column tile x row chunk
    x request) blocks for ~RADIX_BLOCKS_PER_SM per SM, no chunk under
    RADIX_MIN_ROWS rows, at most MAX_GRID_YZ chunks."""
    tiles = -(-cols // RADIX_TILE_COLS) * batch
    chunks = -(-RADIX_BLOCKS_PER_SM * sm_count // tiles)
    chunks = max(1, min(chunks, n // RADIX_MIN_ROWS))
    rows = -(-n // chunks)
    return max(rows, -(-n // MAX_GRID_YZ))


def median_over_time_cuda(p: torch.Tensor,
                          batched: bool = False) -> torch.Tensor:
    """Exact median over the time axis of a float32 (n, ..., nfft) tensor
    -> (..., nfft); with ``batched``, of each request of a (B, n, ...,
    nfft) tensor -> (B, ..., nfft). For even n the mean of the two
    middles, bit-equal to np.median. Launches on the current stream
    without synchronising, in the design :func:`regime` picks."""
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
    if batch > MAX_GRID_YZ:
        raise ValueError(f"median kernel takes at most {MAX_GRID_YZ} "
                         f"requests, got {batch}")
    design = regime(n)
    out = torch.empty(p.shape[:lead - 1] + p.shape[lead:],
                      dtype=torch.float32, device=p.device)
    if out.numel() == 0:
        return out
    cols = out.numel() // batch
    lib = _build.library()
    stream = _build.stream_of(p)
    if design == "tile":
        rc = lib.pst_median_tile(p.data_ptr(), batch, n, cols,
                                 out.data_ptr(), stream)
    else:
        sms = torch.cuda.get_device_properties(p.device).multi_processor_count
        vec4 = int(cols % 4 == 0 and p.data_ptr() % 16 == 0)
        rows = radix_rows(n, batch, cols, sms)
        i32 = dict(dtype=torch.int32, device=p.device)
        ghist = torch.zeros(batch * cols * 256, **i32)
        prefix = torch.empty(batch * cols, **i32)
        rank = torch.empty(batch * cols, **i32)
        # even n: each column's least key above the final prefix, from
        # 0xFFFFFFFF down (odd n passes none)
        gmin = torch.full((batch * cols,), -1, **i32) if n % 2 == 0 \
            else None
        rc = lib.pst_median_radix(p.data_ptr(), batch, n, cols, rows, vec4,
                                  ghist.data_ptr(), prefix.data_ptr(),
                                  rank.data_ptr(),
                                  None if gmin is None else gmin.data_ptr(),
                                  out.data_ptr(), stream)
    _build.check(rc, f"median ({design})")
    _build.count(median_over_time_cuda)
    if batched:
        _build.count(median_over_time_cuda, "batched_launches")
    return out


#: kernel launches in this process, and how many of them took a batch of
#: requests (set both to 0 to count a run's own)
median_over_time_cuda.launches = 0
median_over_time_cuda.batched_launches = 0
