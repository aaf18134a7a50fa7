"""STI for giant FFTs: the transform itself sharded over a mesh axis — the
port of pyspectrogram_tpu/parallel/big_sti.py on torch.distributed.

The per-column FFT runs as the distributed 4-step algorithm of
parallel.dist_fft: local DFT stage, twiddle, one all-to-all transpose,
local DFT stage. The rest of the STI chain (window, |X|^2, Welch average,
fftshift, median, dB) is elementwise over the sharded frequency axis, so
the all-to-all per segment is the only collective in float mode; the time
median needs none (time is unsharded).

The local stages are torch.fft.fft for every precision tier. The JAX
package runs its balanced and display tiers' stages as bf16 GEMM DFTs, a
speed choice for the TPU's matrix unit; the port's float32 FFT meets all
three tiers' accuracy specs (exact ~1e-5 dB, balanced ~7e-4 dB, display
~0.12 dB), the same decision as for kernel B1 (one float32 kernel serves
every tier). ``precision`` is accepted and checked.

Layout: a frame x reshapes to x2[p, q] = x[p*n2 + q] with the q axis
sharded (each rank holds all p for its q-slice, which makes stage 1
local). After the all-to-all a rank holds all q for a k1-slice, making
stage 2 local. Results come back as the "k-matrix" (..., n1, n2) with
X[n1*k2 + k1] = Xm[k1, k2], sharded over k1 rows; ``to_freq_order``
converts an assembled k-matrix to the natural fftshifted frequency axis.

Display tier: with ``tile`` (a display.TileSpec) each rank gathers its own
plot bins out of its k1-slice, all-gathers only those (~plot_n floats,
never the (ntime, nsub, nfft) cube), reassembles plot order with a static
index, quantizes (colour range as a runtime operand) and returns a uint8
(ntime, nsub, plot_n) tile on every rank. :func:`frames_to_x2` and
:func:`to_freq_order` are copies of pyspectrogram_tpu/parallel/big_sti.py's:
the port imports nothing of that package.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from pyspectrogram_tpu_torch.display import tile as display_tile
from pyspectrogram_tpu_torch.ops import stft
from pyspectrogram_tpu_torch.ops.plain import to_dbfs
from pyspectrogram_tpu_torch.ops.windows import WindowSpec, get_window
from pyspectrogram_tpu_torch.parallel import mesh as pmesh
from pyspectrogram_tpu_torch.parallel.dist_fft import (
    local_twiddle,
    split_for_devices,
    transpose_shards,
)


def frames_to_x2(frames_pm: np.ndarray, nfft: int, nseg: int, n1: int,
                 n2: int) -> np.ndarray:
    """Host reshape: (ntime, nsub, 2, nseg*nfft) plane-split frames ->
    (ntime, nsub, 2, nseg, n1, n2) — a free view (row-major)."""
    ntime, nsub = frames_pm.shape[:2]
    return frames_pm.reshape(ntime, nsub, 2, nseg, n1, n2)


def to_freq_order(kmatrix: np.ndarray) -> np.ndarray:
    """Assembled k-matrix (..., n1, n2) -> natural fftshifted (..., nfft).

    The distributed stages produce Xm[k1, k2] with frequency index
    k = n1*k2 + k1 (already rolled by nfft/2 along k2 on device), so the
    natural axis is the transpose-flatten.
    """
    a = np.asarray(kmatrix)
    n1, n2 = a.shape[-2:]
    return np.swapaxes(a, -1, -2).reshape(a.shape[:-2] + (n1 * n2,))


def tile_gather_tables(plot_indices, n1: int, n2: int, ndev: int):
    """(idx_mat (ndev, m_pad), reorder (plot_n,)) int64: plot bin f
    (natural fftshifted order) lives at k-matrix row k1 = f % n1 — on
    shard k1 // rows — and, in the UNROLLED power (the fftshift roll
    folded into the index), at local flat position
    (k1 % rows) * n2 + (f // n1 - n2/2) % n2. Row s of ``idx_mat`` lists
    shard s's bins (padded to the largest count); ``reorder`` takes the
    gathered (ndev * m_pad) values back to plot order."""
    f_nat = np.asarray(plot_indices, np.int64)
    rows = n1 // ndev
    k1 = f_nat % n1
    shard_of = k1 // rows
    local_flat = (k1 % rows) * n2 + (f_nat // n1 - n2 // 2) % n2
    m_pad = max(1, int(np.bincount(shard_of, minlength=ndev).max()))
    idx_mat = np.zeros((ndev, m_pad), np.int64)
    reorder = np.zeros(len(f_nat), np.int64)
    fill = np.zeros(ndev, np.int64)
    for pos, (s, lf) in enumerate(zip(shard_of, local_flat)):
        idx_mat[s, fill[s]] = lf
        reorder[pos] = s * m_pad + fill[s]
        fill[s] += 1
    return idx_mat, reorder


def make_bigfft_sti_fn(mesh, axis: str, *, tile=None, **kw):
    """Distributed-FFT STI — see :func:`_make_bigfft_sti_fn` for the full
    contract. This uncached wrapper canonicalizes the display tile's
    colour range (``TileSpec.crop_key``) before the factory cache, as in
    the JAX package."""
    return _make_bigfft_sti_fn(
        mesh, axis, tile=tile.crop_key() if tile is not None else None,
        **kw)


@functools.lru_cache(maxsize=16)
def _make_bigfft_sti_fn(
    mesh,
    axis: str,
    *,
    nfft: int,
    nint: int = 1,
    mode: str = "welch",
    window: WindowSpec = ("kaiser", 1.7),
    ref: float = 1.0,
    eps: float = 1e-15,
    precision: str = "exact",
    tile=None,
):
    """STI whose per-column FFT is distributed over ``mesh``'s ``axis``
    (parallel/big_sti.py:146 of the JAX package).

    Returned ``f(x2, qparams=None)`` on this rank's shard:
      x2: this rank's q-slice (``f.input_spec``) of the (ntime, nsub, 2,
          nseg, n1, n2) frames of :func:`frames_to_x2`, in any real dtype
          (raw int16 planes widen on the rank's device);
      qparams: the display tile's colour range (TileSpec.qparams),
          required with ``tile``.
    Without ``tile`` returns this rank's k1 rows (``f.output_specs``):
    {"sxx_dbfs": (ntime, nsub, n1, n2) k-matrix dB sharded over n1,
    "sxx_med_dbfs": (nsub, n1, n2) likewise} — convert assembled arrays
    with :func:`to_freq_order`. With ``tile`` returns {"tile": (ntime,
    nsub, plot_n) uint8, the same on every rank, "sxx_med_dbfs":
    k-matrix rows}.
    """
    stft.check_knobs(nfft=nfft, mode=mode, precision=precision,
                     fft_impl="xla")
    ndev = pmesh.axis_size(mesh, axis)
    n1, n2 = split_for_devices(nfft, ndev)
    nseg = nint if mode == "welch" else 1
    rows = n1 // ndev

    win64 = get_window(window, nfft)
    inv_scale = np.float32(
        1.0 / (float(win64.sum()) ** 2 * float(ref) ** 2 * nseg))
    win2 = win64.reshape(n1, n2).astype(np.float32)
    if tile is not None:
        idx_mat, reorder = tile_gather_tables(tile.plot_indices, n1, n2,
                                              ndev)

    @functools.lru_cache(maxsize=None)
    def constants(dev: torch.device):
        """This rank's window columns and, with ``tile``, its gather
        table and the plot-order index, on ``dev`` (built once)."""
        winr = torch.from_numpy(
            pmesh.local_shard(win2, mesh, (None, axis)).copy()).to(dev)
        if tile is None:
            return winr, None, None
        sidx = pmesh.axis_index(mesh, axis)
        return (winr, torch.from_numpy(idx_mat[sidx]).to(dev),
                torch.from_numpy(reorder).to(dev))

    def local(x2: torch.Tensor, qparams) -> dict:
        # x2 shard: (ntime, nsub, 2, nseg, n1, n2/ndev) — all p, a q-slice
        ntime, nsub = x2.shape[0], x2.shape[1]
        dev = x2.device
        winr, cols, order = constants(dev)
        tw = local_twiddle(mesh, axis, n1, n2, nfft, dev)

        def one_seg(seg: int) -> torch.Tensor:
            # raw integer planes widen here, on the rank's device (the
            # dBFS normalization rides inv_scale)
            xr = x2[:, :, 0, seg].to(torch.float32) * winr
            xi = x2[:, :, 1, seg].to(torch.float32) * winr
            # stage 1: DFT along p (full on this shard), twiddle
            z = torch.fft.fft(torch.complex(xr, xi), dim=-2) * tw
            # trade the q shard for a k1 shard: one all-to-all moves both
            # planes (the complex tensor travels as one float buffer)
            z = transpose_shards(z, mesh, axis)
            # stage 2: DFT along q (full on this shard)
            X = torch.fft.fft(z, dim=-1)
            return X.real.square() + X.imag.square()

        p = one_seg(0)
        for seg in range(1, nseg):
            p = p + one_seg(seg)
        p = p * inv_scale                  # (ntime, nsub, n1/ndev, n2)
        if tile is not None:
            # median from the unrolled power, rolled AFTER the (small)
            # time reduction — same values as roll-then-median (the roll
            # permutes k2, the median is elementwise over time)
            med = to_dbfs(torch.roll(stft.median_over_time(p), n2 // 2,
                                     dims=-1), eps)
            g = p.reshape(ntime, nsub, rows * n2)[..., cols]
            g = pmesh.all_gather(g, mesh, axis, dim=2)  # (ntime, nsub, ndev*m)
            db = to_dbfs(g[..., order], eps)
            return {"tile": display_tile.quantize_db_tile(db, tile, qparams),
                    "sxx_med_dbfs": med}
        # fftshift: k + nfft/2 <=> k2 += n2/2 — a local roll along k2
        p = torch.roll(p, n2 // 2, dims=-1)
        p_med = stft.median_over_time(p)   # (nsub, n1/ndev, n2)
        return {"sxx_dbfs": to_dbfs(p, eps),
                "sxx_med_dbfs": to_dbfs(p_med, eps)}

    if tile is None:
        def sti(x2: torch.Tensor) -> dict:
            return local(x2, None)
    else:
        def sti(x2: torch.Tensor, qparams=None) -> dict:
            # the factory's tile is crop_key-canonicalized (cmin 0,
            # cmax 1), so there is NO meaningful default color range —
            # the real range always arrives as the runtime operand
            if qparams is None:
                raise ValueError(
                    "tile mode requires the color-range operand: pass "
                    "the display TileSpec's .qparams")
            return local(x2, qparams)

    sti.input_spec = (None, None, None, None, None, axis)
    sti.output_specs = {"sxx_med_dbfs": (None, axis, None)}
    if tile is None:
        sti.output_specs["sxx_dbfs"] = (None, None, axis, None)
    else:
        sti.output_specs["tile"] = (None, None, None)
    sti.n1n2 = (n1, n2)
    sti.nseg = nseg
    return sti
