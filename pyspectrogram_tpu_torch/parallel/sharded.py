"""Multi-rank STI over a (time, chan) mesh — the port of
pyspectrogram_tpu/parallel/sharded.py on torch.distributed.

Sharding layout (the JAX package's, as specs of parallel.mesh):

* sample buffer: plane-major (nsub*2, nsamp), sharded over ``chan`` rows
  (r/i plane pairs stay on one rank: nsub must divide by the chan-axis
  size); replicated over ``time`` for arbitrary frame starts, but sharded
  over ``time`` too when the block is packed contiguously
  (``contiguous=True`` — each rank holds only its own column span);
* frame starts: sharded over ``time`` — each rank computes a disjoint block
  of STI columns (independent frame starts, reference: drfProc.py:159);
* sxx output: sharded over (time, chan);
* median PSD: needs all columns per frequency bin, so the linear powers
  are all-gathered along ``time`` and reduced on each rank (replicated
  over time, sharded over chan), or, above GATHERED_MEDIAN_MAX_BYTES,
  reduced by ops.stft.median_over_time_psum with no gather.

A factory's function takes this rank's shards and returns this rank's
shards, as the JAX shard_map body does; ``fn.input_specs()`` and
``fn.output_specs`` give the layouts, and parallel.mesh.assemble_outputs
the global arrays. Per shard it launches the port's kernels on the rank's
device: B1 (B4 at nfft >= 65536) for the PSD, B2 for the median.
"""

from __future__ import annotations

import functools

import numpy as np

from pyspectrogram_tpu_torch.display import tile as display_tile
from pyspectrogram_tpu_torch.ops import stft
from pyspectrogram_tpu_torch.ops.plain import to_dbfs
from pyspectrogram_tpu_torch.ops.windows import WindowSpec, get_window
from pyspectrogram_tpu_torch.parallel import mesh as pmesh
from pyspectrogram_tpu_torch.parallel.mesh import CHAN_AXIS, TIME_AXIS

#: gathered-median budget (the JAX package's value): below this many bytes
#: for the FULL gathered power cube (ntime x nsub_l x nfft float32, held
#: by every rank of a time row), the time median all-gathers once and
#: launches kernel B2; above it, the 33-round summed bisection keeps every
#: rank at its own shard — at the reference's ntime = 1e5 ceiling with
#: nfft = 4096 the gathered cube would be 1.6 GB on every rank.
GATHERED_MEDIAN_MAX_BYTES = 256 * 1024 * 1024


def make_sharded_sti_fn(mesh, *, tile=None, **kw):
    """Multi-rank STI — see :func:`_make_sharded_sti_fn` for the full
    contract. This uncached wrapper canonicalizes the display tile's
    colour range (``TileSpec.crop_key``) before the factory cache, so
    specs differing only in cmin/cmax share one function, as in the JAX
    package."""
    return _make_sharded_sti_fn(
        mesh, tile=tile.crop_key() if tile is not None else None, **kw)


@functools.lru_cache(maxsize=64)
def _make_sharded_sti_fn(
    mesh,
    *,
    nfft: int,
    nint: int = 1,
    ntime_valid: int,
    mode: str = "welch",
    window: WindowSpec = ("kaiser", 1.7),
    ref: float = 1.0,
    eps: float = 1e-15,
    fft_impl: str = "auto",
    precision: str = "exact",
    contiguous: bool = False,
    tile=None,
):
    """Multi-rank STI (parallel/sharded.py:115 of the JAX package).

    Returned ``f(samples_pm, starts)`` (``f(samples_pm, starts, qparams)``
    when ``tile`` is set), on this rank's shards (``f.input_specs()``):
      samples_pm: (nsub*2, nsamp) float32 or int16 plane-major — nsub
                  divisible by the chan-axis size; replicated over time,
                  or with ``contiguous`` sharded over it;
      starts:     (ntime_padded,) int32, sharded over time — ntime_padded
                  divisible by the time-axis size; only the first
                  ``ntime_valid`` columns count for the median;
      qparams:    the tile's (2,) colour range, replicated.
    Returns this rank's shards (``f.output_specs``):
    {"sxx_dbfs": (ntime_padded, nsub, nfft) sharded (time, chan),
     "sxx_med_dbfs": (nsub, nfft) sharded (chan,)}.

    ``contiguous=True`` asserts the packed layout (column t's frame at
    t*frame_len, padded by mesh.pad_contiguous_block): the buffer shards
    over both axes, and each shard rebases its starts to its first
    column. ``tile`` (a display.TileSpec) quantizes each rank's own
    columns to uint8 on its device; the return then carries ``"tile"``
    instead of ``"sxx_dbfs"``.
    """
    # the per-shard PSD is the single-device policy (ops.stft.sti_psd):
    # B1, or B4 at nfft >= 65536, on a CUDA shard; int16 planes widen in
    # the kernel on the rank's device; one float32 kernel serves every
    # precision tier
    stft.check_knobs(nfft=nfft, mode=mode, precision=precision,
                     fft_impl=fft_impl)
    get_window(window, nfft)  # validate the spec eagerly
    psd_kw = dict(nfft=nfft, nint=nint, mode=mode, window=window, ref=ref)
    ndev_t = pmesh.axis_size(mesh, TIME_AXIS)

    def sharded(samples_pm, starts, qparams=None):
        if contiguous:
            # global ladder starts (t*frame_len) -> this shard's local
            # ladder; the shard's buffer begins at its first column
            starts = starts - starts[0]
        p_local = stft.sti_psd(samples_pm, starts, fft_impl=fft_impl,
                               **psd_kw)
        cube = p_local.shape[0] * ndev_t * np.prod(p_local.shape[1:]) * 4
        if cube <= GATHERED_MEDIAN_MAX_BYTES:
            # gather all columns of my channel shard for the time median
            # (one gather + one kernel B2 launch)
            p_all = pmesh.all_gather(p_local, mesh, TIME_AXIS, dim=0)
            p_med = stft.median_over_time(p_all, ntime_valid)
        else:
            # huge ntime: the summed bisection — no rank ever holds more
            # than its shard (see GATHERED_MEDIAN_MAX_BYTES)
            p_med = stft.median_over_time_psum(p_local, mesh, TIME_AXIS,
                                               ntime_valid)
        out = {"sxx_med_dbfs": to_dbfs(p_med, eps)}
        if tile is not None:
            out["tile"] = display_tile.quantize_tile_linear(
                p_local, tile, eps, qparams)
        else:
            out["sxx_dbfs"] = to_dbfs(p_local, eps)
        return out

    samples_spec = ((CHAN_AXIS, TIME_AXIS) if contiguous
                    else (CHAN_AXIS, None))
    in_specs = (samples_spec, (TIME_AXIS,))
    out_specs = {"sxx_med_dbfs": (CHAN_AXIS, None)}
    if tile is not None:
        in_specs = in_specs + ((None,),)  # qparams: replicated (2,)
        out_specs["tile"] = (TIME_AXIS, CHAN_AXIS, None)
    else:
        out_specs["sxx_dbfs"] = (TIME_AXIS, CHAN_AXIS, None)

    if tile is not None:
        # the factory caches on the canonicalized crop plan (crop_key),
        # whose own qparams are a meaningless placeholder, so there is no
        # usable default colour range
        def fn(samples_pm, starts, qparams=None):
            if qparams is None:
                raise ValueError(
                    "tile mode requires the color-range operand: call "
                    "fn(samples_pm, starts, spec.qparams)")
            return sharded(samples_pm, starts, qparams)
    else:
        def fn(samples_pm, starts):
            return sharded(samples_pm, starts)

    fn.input_specs = lambda: in_specs
    fn.output_specs = out_specs
    return fn
