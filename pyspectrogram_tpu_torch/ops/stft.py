"""STI/PSD compute core in PyTorch — the port of pyspectrogram_tpu/ops/stft.py.

One request's device half, run eagerly on the samples' own device:

    plane-major samples + frame starts -> window -> FFT -> |X|^2 ->
    (Welch average) -> fftshift -> linear PSD ; exact median across time ;
    dBFS or the uint8 display tile

The PSD runs in kernel B1 (kernels.sti_cuda), or B4 (kernels.big_cuda) at
nfft >= 65536, on a CUDA tensor whose nfft the kernels cover, and in
ops.plain.psd_torch (torch.fft) everywhere else; a streaming push's
columns follow :func:`stream_impl`, which adds kernel B3
(kernels.stream_cuda) for overlapping hops. The median runs a Batcher
network for n <= 32 and kernel B2
(kernels.median_cuda) or its plain bisection above, for one request or,
in :func:`median_over_time_batched`, a batch of them; over a time axis
sharded across ranks, :func:`median_over_time_psum`. Host constants — the
window and the power scale — are built once in numpy float64, as the JAX
package builds them, and cast to float32 on the device.

:func:`make_sti_fn` is the JAX package's time-major complex path
((nsamp, nsub) complex or packed planes, complex64 or complex128) with
:func:`gather_frames` and :func:`psd_frames`; its FFT is torch.fft, or the
GEMM DFT of kernels.gemm_fft, the one matrix product here, which runs its
matmuls in complex128 so that no TF32 setting reaches them.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

# the module, not the name: display.tile imports ops.plain, whose package
# __init__ imports this module
from pyspectrogram_tpu_torch.display import tile as display_tile
from pyspectrogram_tpu_torch.kernels import (
    gemm_fft,
    median_cuda,
    stream_cuda,
    sti_cuda,
)
from pyspectrogram_tpu_torch.ops import plain
from pyspectrogram_tpu_torch.ops.plain import psd_torch, to_dbfs
from pyspectrogram_tpu_torch.ops.windows import WindowSpec, get_window

#: below this many rows the sorting-network median beats the 33-pass
#: bisection (ops/stft.py:239 of the JAX package)
MEDIAN_NETWORK_MAX_N = 32


def pack_complex_host(x: np.ndarray) -> np.ndarray:
    """complex (..., ) host array -> real (..., 2) plane-packed view (zero
    copy) — a copy of pack_complex_host (ops/stft.py:38 of the JAX
    package). A complex64 array's memory is (float32, float32) pairs."""
    x = np.ascontiguousarray(x)
    if x.dtype.kind != "c":
        raise ValueError(f"expected complex array, got {x.dtype}")
    real = np.dtype(f"f{x.dtype.itemsize // 2}")
    return x.view(real).reshape(x.shape + (2,))


def gather_frames(samples: torch.Tensor, starts,
                  frame_len: int) -> torch.Tensor:
    """Frames of ``frame_len`` samples at ``starts`` of a time-major buffer
    (ops/stft.py:53 of the JAX package): samples (nsamp, nsub[, 2]),
    starts (ntime,) -> (ntime, nsub, frame_len[, 2]); (nsamp,) gives
    (ntime, 1, frame_len). A start is clamped into the buffer the way
    jax.lax.dynamic_slice clamps it."""
    nsamp = samples.shape[0]
    if nsamp < frame_len:
        raise ValueError(f"buffer of {nsamp} samples is shorter than one "
                         f"{frame_len}-sample frame")
    st = torch.as_tensor(starts, device=samples.device).to(torch.int64)
    idx = st.clamp(0, nsamp - frame_len)[:, None] + torch.arange(
        frame_len, device=samples.device)
    frames = samples[idx]                        # (ntime, frame_len, ...)
    if samples.dim() == 1:
        return frames[:, None, :]
    return frames.movedim(1, 2)


def _to_complex(frames: torch.Tensor, real_dtype) -> torch.Tensor:
    """(..., 2) packed real/imag planes or a complex tensor -> complex."""
    if frames.is_complex():
        return frames
    if frames.shape[-1] != 2:
        raise ValueError(
            "real-valued sample buffers must pack planes as (..., 2); got "
            f"shape {tuple(frames.shape)} dtype {frames.dtype}")
    return torch.complex(frames[..., 0].to(real_dtype),
                         frames[..., 1].to(real_dtype))


def psd_frames(frames: torch.Tensor, window, power_scale: float,
               fft_fn=torch.fft.fft) -> torch.Tensor:
    """Windowed two-sided 'spectrum'-scaled periodogram of (..., nfft)
    complex frames (ops/stft.py:94 of the JAX package)."""
    real_dtype = (torch.float64 if frames.dtype == torch.complex128
                  else torch.float32)
    win = torch.as_tensor(window, device=frames.device).to(real_dtype)
    X = fft_fn(frames * win)
    return (X.real.square() + X.imag.square()) * power_scale


#: the compute dtypes make_sti_fn takes, and their real parts
_COMPUTE_REAL = {torch.complex64: torch.float32,
                 torch.complex128: torch.float64}


@functools.lru_cache(maxsize=256)
def make_sti_fn(
    *,
    nfft: int,
    nint: int = 1,
    mode: str = "welch",
    window: WindowSpec = ("kaiser", 1.7),
    ref: float = 1.0,
    eps: float = 1e-15,
    fft_impl: str = "xla",
    return_linear: bool = False,
    compute_dtype: torch.dtype = torch.complex64,
):
    """Time-major STI — the port of make_sti_fn (ops/stft.py:111 of the
    JAX package), with its output keys and layout.

    Returns ``f(samples, starts)``: samples (nsamp, nsub) complex, or
    (nsamp, nsub, 2) packed real/imag planes in any real dtype (e.g. raw
    int16); starts (ntime,) frame starts. Outputs ``sxx_dbfs`` (ntime,
    nsub, nfft) and ``sxx_med_dbfs`` (nsub, nfft), plus the linear ``sxx``
    and ``sxx_med`` with ``return_linear``. It runs on the samples' device;
    the median is :func:`median_over_time`, so a float32 cube on a card
    launches kernel B2. ``fft_impl="xla"`` is torch.fft (cuFFT on a card),
    ``"gemm"`` the GEMM DFT of kernels.gemm_fft (two matmuls and a
    twiddle, in complex128 whatever the caller's TF32 setting).
    ``compute_dtype`` is torch.complex64 or torch.complex128."""
    win = get_window(window, nfft)                # float64 on the host
    inv_scale = 1.0 / (float(win.sum()) ** 2 * float(ref) ** 2)
    frame_len = nfft * nint if mode == "welch" else nfft
    if mode not in ("parity", "welch"):
        raise ValueError(f"mode must be 'parity' or 'welch', got {mode!r}")
    if fft_impl == "xla":
        fft_fn = torch.fft.fft
    elif fft_impl == "gemm":
        fft_fn = gemm_fft.make_gemm_fft(nfft)
    else:
        raise ValueError(f"unknown fft_impl {fft_impl!r}")
    if compute_dtype not in _COMPUTE_REAL:
        raise ValueError("compute_dtype must be torch.complex64 or "
                         f"torch.complex128, got {compute_dtype!r}")
    real_dtype = _COMPUTE_REAL[compute_dtype]
    win = win.astype(np.float64 if real_dtype == torch.float64
                     else np.float32)

    def sti_fn(samples: torch.Tensor, starts) -> dict:
        frames = gather_frames(samples, starts, frame_len)
        x = _to_complex(frames, real_dtype).to(compute_dtype)
        if mode == "welch":
            x = x.reshape(x.shape[0], x.shape[1], nint, nfft)
            p = psd_frames(x, win, inv_scale, fft_fn).mean(dim=2)
        else:
            p = psd_frames(x, win, inv_scale, fft_fn)
        p = torch.fft.fftshift(p, dim=-1)          # (ntime, nsub, nfft)
        p_med = median_over_time(p)                # (nsub, nfft)
        out = {"sxx_dbfs": to_dbfs(p, eps),
               "sxx_med_dbfs": to_dbfs(p_med, eps)}
        if return_linear:
            out["sxx"] = p
            out["sxx_med"] = p_med
        return out

    return sti_fn


@functools.lru_cache(maxsize=64)
def _batcher_pairs(n: int):
    """Compare-exchange pairs of Batcher's odd-even mergesort for n rows
    (host-side plan; ~n log^2 n / 4 pairs)."""
    pairs = []
    p = 1
    while p < n:
        k = p
        while k >= 1:
            for j in range(k % p, n - k, 2 * k):
                for i in range(0, min(k, n - j - k)):
                    if (i + j) // (2 * p) == (i + j + k) // (2 * p):
                        pairs.append((i + j, i + j + k))
            k //= 2
        p *= 2
    return tuple(pairs)


def _median_network(rows) -> torch.Tensor:
    """Median of the n tensors ``rows`` (the time rows) by Batcher's
    network of elementwise min/max."""
    rows = list(rows)
    n = len(rows)
    for a, b in _batcher_pairs(n):
        rows[a], rows[b] = (torch.minimum(rows[a], rows[b]),
                            torch.maximum(rows[a], rows[b]))
    if n % 2:
        return rows[n // 2]
    return 0.5 * (rows[n // 2 - 1] + rows[n // 2])


def median_over_time(p: torch.Tensor,
                     ntime_valid: Optional[int] = None,
                     allow_pallas: bool = True) -> torch.Tensor:
    """Median across the leading (time) axis of (ntime, ..., nfft) — the
    reference's per-subchannel median PSD (drfProc.py:401). For even n it
    is the mean of the two middles, as np.median (torch.median returns the
    lower middle). ``ntime_valid`` restricts to a leading prefix. Above 32
    rows float32 takes kernel B2 (its plain version on a CPU tensor).
    ``allow_pallas`` is the JAX signature's switch, there only because
    GSPMD cannot partition the Pallas call inside a shard_map
    (pyspectrogram_tpu/ops/stft.py:284); the port has no such limit, and
    B2 equals np.median bit for bit, as the JAX plain route does, so the
    switch changes no result and B2 runs either way."""
    n = p.shape[0] if ntime_valid is None else int(ntime_valid)
    p = p[:n]
    if n <= MEDIAN_NETWORK_MAX_N:
        return _median_network(p[i] for i in range(n))
    if p.dtype == torch.float32:
        return median_cuda.median_over_time_cuda(p)
    s = torch.sort(p, dim=0).values
    if n % 2:
        return s[n // 2]
    return 0.5 * (s[n // 2 - 1] + s[n // 2])


def median_over_time_batched(p: torch.Tensor) -> torch.Tensor:
    """Per-request medians of a batch: (B, ntime, ..., nfft) ->
    (B, ..., nfft), what ``jax.vmap(median_over_time)`` gives the JAX
    package's merged launch (models/batch.py:122). The network runs on
    axis 1 (``p[:, i]`` is a view) for ntime <= 32; above, kernel B2 takes
    the whole batch in one launch."""
    n = p.shape[1]
    if n <= MEDIAN_NETWORK_MAX_N:
        return _median_network(p[:, i] for i in range(n))
    if p.dtype == torch.float32:
        return median_cuda.median_over_time_cuda(p.contiguous(),
                                                 batched=True)
    return torch.stack([median_over_time(pb) for pb in p])


def median_over_time_psum(p: torch.Tensor, mesh, axis: str,
                          ntime_valid: Optional[int] = None,
                          row_window: Optional[tuple] = None) -> torch.Tensor:
    """Median across a time axis SHARDED over ``axis`` of ``mesh`` — the
    port of median_over_time_psum (ops/stft.py:309-363 of the JAX
    package): ``p`` is this rank's (ntime_l, ..., nfft) float32 block of
    the row-sharded cube, and every rank gets the median.

    The same 33-step float-bit bisection as ops.plain.median_bisect, but
    each round's compare-count is summed over the axis (one all_reduce of
    a (..., nfft) int64 plane), so no rank ever holds more than its own
    block; the even-n step adds one more sum and a min. Rows at global
    index >= ``ntime_valid`` (time-axis padding) are masked out of every
    count; ``row_window=(lo, hi)`` instead restricts to an arbitrary global
    row range (the mesh batch tier's per-request column spans). A global
    row index is the rank's coordinate times its rows plus the local row.
    Exact for float32, equal to np.median bit for bit."""
    # the parallel package imports this module, so its collectives are
    # imported here, at the call
    from pyspectrogram_tpu_torch.parallel import mesh as pmesh

    ntime_l = p.shape[0]
    if row_window is None and ntime_valid is None:
        raise ValueError(
            "median_over_time_psum needs the global row span: pass "
            "ntime_valid (valid-prefix length) or row_window=(lo, hi) — "
            "the shard cannot see the global row count on its own")
    lo_r, hi_r = (0, int(ntime_valid)) if row_window is None else (
        int(row_window[0]), int(row_window[1]))
    n = hi_r - lo_r
    k = (n + 1) // 2
    idx = pmesh.axis_index(mesh, axis) * ntime_l + torch.arange(
        ntime_l, device=p.device)
    valid = ((idx >= lo_r) & (idx < hi_r)).reshape(
        (ntime_l,) + (1,) * (p.dim() - 1))
    kb = plain._float_order_key(p)
    lo = torch.full(p.shape[1:], -0x7F800001, dtype=torch.int32,
                    device=p.device)
    hi = torch.full(p.shape[1:], 0x7F800000, dtype=torch.int32,
                    device=p.device)

    def count(mask: torch.Tensor) -> torch.Tensor:
        return pmesh.all_reduce((mask & valid).sum(dim=0), mesh, axis, "sum")

    # 33 halvings shrink the full key span (~2^32) to 0
    for _ in range(33):
        mid = (lo & hi) + ((lo ^ hi) >> 1)
        go_hi = count(kb <= mid) >= k
        lo, hi = torch.where(go_hi, lo, mid + 1), torch.where(go_hi, mid, hi)
    v1 = (hi ^ ((hi >> 31) & 0x7FFFFFFF)).view(torch.float32)
    if n % 2:
        return v1
    cnt_le = count(p <= v1)
    bigger = torch.where((p > v1) & valid, p,
                         torch.full_like(p, float("inf")))
    v2 = torch.where(cnt_le > k, v1,
                     pmesh.all_reduce(bigger.amin(dim=0), mesh, axis, "min"))
    return 0.5 * (v1 + v2)


def pick_impl(nfft: int, device, fft_impl: str = "auto") -> str:
    """'cuda' | 'torch' — the PSD dispatch policy, the port's counterpart
    of sti_pallas.pick_impl, over the JAX package's ``fft_impl`` values.
    "auto" takes kernel B1 (B4 at nfft >= 65536) for a CUDA device and an
    nfft the kernels cover (kernels.sti_cuda.supported: every power of two
    256..2^20), torch.fft otherwise; "xla" is torch.fft (cuFFT on a card).
    An explicit "pallas", the hand-written kernel, is an ask, not a hint:
    outside the kernel's range it raises (on a CPU tensor the kernel's
    wrapper runs its plain version)."""
    if fft_impl == "xla":
        return "torch"
    if fft_impl == "pallas":
        sti_cuda.check_supported(nfft)
        return "cuda"
    if fft_impl != "auto":
        raise ValueError(f"unknown fft_impl {fft_impl!r}")
    if torch.device(device).type == "cuda" and sti_cuda.supported(nfft):
        return "cuda"
    return "torch"


def stream_impl(nfft: int, nint: int, hop: int, device) -> str:
    """'sti' | 'stream' | 'torch' — how a streaming push computes its
    columns (column t framed at t*hop of carry + block), one policy for
    models.streaming and the live engine's tail view:

    - hop == frame_len: 'sti', kernel B1, or B4 at nfft >= 65536, at the
      contiguous starts t*frame_len;
    - hop < frame_len and nfft <= 32768: 'stream', kernel B3;
    - hop < frame_len and nfft >= 65536: 'sti', kernel B4 at the starts
      t*hop (it takes any starts);
    - nfft below 256 or not a power of two, or a CPU device: 'torch',
      ops.plain.psd_torch — the JAX package's XLA route, which no TPU
      kernel covers either.

    There is no per-subchannel branch (sti_pallas.pallas_per_sub_profitable
    is a VMEM budget; the CUDA grid already has nsub as a dimension)."""
    if torch.device(device).type != "cuda" or not sti_cuda.supported(nfft):
        return "torch"
    if hop < nfft * nint and nfft <= stream_cuda.MAX_NFFT:
        return "stream"
    return "sti"


def check_knobs(*, nfft: int, mode: str, precision: str,
                fft_impl: str) -> None:
    """Raise on a mode, precision tier or ``fft_impl`` no STI function
    takes (an explicit fft_impl="pallas" outside the kernels' nfft range
    included)."""
    if mode not in ("parity", "welch"):
        raise ValueError(f"mode must be 'parity' or 'welch', got {mode!r}")
    if precision not in ("exact", "balanced", "display"):
        raise ValueError(f"unknown precision {precision!r}")
    pick_impl(nfft, "cpu", fft_impl)


def sti_psd(samples_pm: torch.Tensor, starts: torch.Tensor, *,
            fft_impl: str = "auto", **psd_kw) -> torch.Tensor:
    """Fftshifted linear power (ntime, nsub, nfft) of the frames at
    ``starts``, by :func:`pick_impl`: kernel B1 (B4 at nfft >= 65536) or
    ops.plain.psd_torch. ``psd_kw``: nfft, nint, mode, window, ref."""
    if pick_impl(psd_kw["nfft"], samples_pm.device, fft_impl) == "cuda":
        return sti_cuda.sti_psd_cuda(samples_pm, starts, **psd_kw)
    return psd_torch(samples_pm, starts, **psd_kw)


@functools.lru_cache(maxsize=64)
def hop_starts(k: int, hop: int, device: torch.device) -> torch.Tensor:
    """(k,) int32 starts t*hop on ``device``, built once per shape (the
    kernels only read them): a streaming push's columns, or a merged
    batch's side-by-side frames (hop = frame_len)."""
    return torch.arange(k, dtype=torch.int32, device=device) * hop


def stream_columns(buf_pm: torch.Tensor, k: int, *, nfft: int, nint: int,
                   hop: int, mode: str = "welch",
                   window: WindowSpec = ("kaiser", 1.7),
                   ref: float = 1.0) -> torch.Tensor:
    """The k columns of a plane-major push buffer (nsub*2, frame_len - hop
    + k*hop), column t framed at t*hop -> fftshifted linear power
    (k, nsub, nfft), by :func:`stream_impl`."""
    kw = dict(nfft=nfft, nint=nint, mode=mode, window=window, ref=ref)
    impl = stream_impl(nfft, nint, hop, buf_pm.device)
    if impl == "stream":
        return stream_cuda.stream_psd_cuda(buf_pm, hop=hop, **kw)
    starts = hop_starts(k, hop, buf_pm.device)
    if impl == "sti":
        return sti_cuda.sti_psd_cuda(buf_pm, starts, **kw)
    return psd_torch(buf_pm, starts, **kw)


@functools.lru_cache(maxsize=256)
def make_xla_psd(
    *,
    nfft: int,
    nint: int = 1,
    mode: str = "welch",
    window: WindowSpec = ("kaiser", 1.7),
    ref: float = 1.0,
):
    """The plain PSD step body, the JAX package's name for it: plane-major
    samples + frame starts -> fftshifted LINEAR power (ntime, nsub, nfft)
    by torch.fft (ops.plain.psd_torch with these knobs bound), kernel B1's
    plain version."""

    def xla_psd(samples_pm, starts):
        return psd_torch(samples_pm, starts, nfft=nfft, nint=nint,
                         mode=mode, window=window, ref=ref)

    return xla_psd


def make_sti_fn_pm(
    *,
    nfft: int,
    nint: int = 1,
    mode: str = "welch",
    window: WindowSpec = ("kaiser", 1.7),
    ref: float = 1.0,
    eps: float = 1e-15,
    fft_impl: str = "auto",
    return_linear: bool = False,
    return_minmax: bool = False,
    contiguous: bool = False,
    precision: str = "exact",
    tile=None,
):
    """Plane-major STI — the port of make_sti_fn_pm (ops/stft.py:410 of
    the JAX package), with the same output keys.

    Returns ``f(samples_pm, starts, qparams=None)``: samples_pm
    (nsub*2, nsamp) float32 or int16 (row 2s the real plane of subchannel
    s, row 2s+1 its imaginary plane; int16 widens on the device, the dBFS
    normalization rides the power scale), starts (ntime,) int32 on the
    same device. Outputs: ``sxx_med_dbfs`` (nsub, nfft), and either
    ``sxx_dbfs`` (ntime, nsub, nfft) or, with ``tile`` (a
    display.TileSpec), the uint8 ``tile`` (ntime, nsub, plot_n) whose
    colour range is the runtime operand ``qparams`` (TileSpec.qparams by
    default); plus ``sxx_min_dbfs``/``sxx_max_dbfs`` and the linear
    ``sxx``/``sxx_med`` on request.

    ``contiguous=True`` declares that column t starts at t*nfft*nint, as
    every block the pipeline assembles does; the buffer must then hold
    ntime such frames. ``precision`` is accepted for every tier: the
    float32 kernel meets all three (exact ~1e-5 dB, balanced ~7e-4 dB,
    display ~0.12 dB). ``fft_impl`` takes the JAX package's values, as
    :func:`pick_impl` reads them: "auto", "xla" (torch.fft) or "pallas"
    (the hand-written kernel, which raises outside its nfft range).
    """
    check_knobs(nfft=nfft, mode=mode, precision=precision, fft_impl=fft_impl)
    default_qp = None if tile is None else tile.qparams
    psd_kw = dict(nfft=nfft, nint=nint, mode=mode, window=window, ref=ref)

    def sti_fn(samples_pm: torch.Tensor, starts: torch.Tensor,
               qparams=None) -> dict:
        if contiguous and samples_pm.shape[1] < starts.shape[0] * nfft * nint:
            raise ValueError("buffer shorter than ntime contiguous frames")
        p = sti_psd(samples_pm, starts, fft_impl=fft_impl, **psd_kw)
        p_med = median_over_time(p)
        out = {"sxx_med_dbfs": to_dbfs(p_med, eps)}
        if tile is not None:
            # display mode: the float spectra stay on the device
            out["tile"] = display_tile.quantize_tile_linear(
                p, tile, eps, default_qp if qparams is None else qparams)
        else:
            out["sxx_dbfs"] = to_dbfs(p, eps)
        if return_minmax:
            out["sxx_min_dbfs"] = to_dbfs(p.amin(dim=0), eps)
            out["sxx_max_dbfs"] = to_dbfs(p.amax(dim=0), eps)
        if return_linear:
            out["sxx"] = p
            out["sxx_med"] = p_med
        return out

    return sti_fn


def to_reference_layout(sxx: np.ndarray) -> np.ndarray:
    """(ntime, nsub, nfft) device layout -> (nfft, ntime, nsub) reference
    layout (reference: drfProc.py:365)."""
    return np.moveaxis(np.asarray(sxx), -1, 0)


def shifted_freqs(nfft: int, sample_rate) -> np.ndarray:
    """fftshifted two-sided frequency axis in Hz, float64 on host
    (reference: drfProc.py:398, drfview.py:988)."""
    return np.fft.fftshift(np.fft.fftfreq(nfft, 1.0 / float(sample_rate)))
