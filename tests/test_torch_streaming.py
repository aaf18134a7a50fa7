"""The PyTorch port's StreamingSti and kernel B3's plain version (CPU)
against the JAX package's on the same numpy blocks.

Tolerances: linear power rtol 2e-4, atol 1e-6 (the JAX package's own
kernel-vs-XLA tolerance); dB 1e-4 dB on bins within 30 dB of the column's
peak (white noise: near a spectral null two float32 FFTs differ by up to
~2e-3 dB, which the linear check bounds). Views of the SAME linear ring —
the JAX state moved into the port's, as a checkpoint moves it — are held
tighter: uint8 tiles bit-equal to the JAX package's quantize_tile_linear
of the same rows, dB within 1e-4 dB on every bin.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pyspectrogram_tpu.display.tile import make_tile_spec
from pyspectrogram_tpu.display.tile import (
    quantize_tile_linear as jquantize_tile_linear,
)
from pyspectrogram_tpu.kernels.sti_pallas import make_pallas_stream_psd
from pyspectrogram_tpu.models.streaming import StreamingSti as JStreamingSti
from pyspectrogram_tpu_torch.kernels import stream_cuda
from pyspectrogram_tpu_torch.models.streaming import StreamingSti, StreamState
from pyspectrogram_tpu_torch.ops import stft

LIN = dict(rtol=2e-4, atol=1e-6)


def _assert_db_close(got, want, lin_want, floor_db=30.0, atol=1e-4):
    lin_want = np.asarray(lin_want)
    keep = lin_want >= lin_want.max(axis=-1, keepdims=True) * 10.0 ** (
        -floor_db / 10.0)
    np.testing.assert_allclose(np.asarray(got)[keep], np.asarray(want)[keep],
                               atol=atol, rtol=0)


def _blocks(n, nsub, block_len, dtype, seed):
    rng = np.random.default_rng(seed)
    if dtype == "int16":
        return [rng.integers(-2 ** 14, 2 ** 14, (2 * nsub, block_len))
                .astype(np.int16) for _ in range(n)]
    return [rng.standard_normal((2 * nsub, block_len)).astype(np.float32)
            for _ in range(n)]


def _pair(**kw):
    return StreamingSti(device="cpu", **kw), JStreamingSti(**kw)


def _transplant(jstate) -> StreamState:
    """The JAX state as the port's (the same linear ring)."""
    return StreamState(carry=torch.from_numpy(np.array(jstate.carry)),
                       ring=torch.from_numpy(np.array(jstate.ring)),
                       total_cols=int(jstate.total_cols))


def _spec(nfft):
    return make_tile_spec(stft.shifted_freqs(nfft, 1e6), (-300.0, 250.0),
                          (-40.0, 30.0))


def _tile_match(tile, jtile, lin, spec):
    """A tile of the linear rows ``lin`` is bit-equal to the JAX package's
    quantize_tile_linear of the same rows, and within one level of the
    JAX class's jitted view on <= 0.1% of pixels: XLA's fused CPU program
    rounds (db - cmin) * scale a hair differently from its own eager
    function at level boundaries."""
    want = np.asarray(jquantize_tile_linear(jnp.asarray(lin), spec, 1e-15,
                                            spec.qparams))
    np.testing.assert_array_equal(tile, want)
    d = np.abs(tile.astype(int) - np.asarray(jtile).astype(int))
    assert d.max() <= 1 and np.count_nonzero(d) <= 1e-3 * d.size


def _views_match(s, st, js, jst, n_disp, stride):
    """Every view of the same linear ring agrees with the JAX class's."""
    snap, n = s.snapshot(st)
    jsnap, jn = js.snapshot(jst)
    assert n == jn == s.valid_cols(st) == js.valid_cols(jst)
    np.testing.assert_allclose(snap, jsnap, atol=1e-4, rtol=0)
    spec = _spec(s.nfft)
    ring = st.ring.numpy()
    q, _ = s.snapshot_quantized(st, spec)
    jq, _ = js.snapshot_quantized(jst, spec)
    _tile_match(q, jq, np.roll(ring, -(st.total_cols % s.ring_len), axis=0),
                spec)
    for kw in ({}, {"n_cols": 40}, {"n_cols": 40, "span_ladder": False},
               {"n_cols": 3}):
        np.testing.assert_allclose(s.median_psd(st, **kw),
                                   js.median_psd(jst, **kw), atol=1e-4,
                                   rtol=0)
    cols = s.strided_cols(st, n_disp, stride)
    np.testing.assert_array_equal(cols, js.strided_cols(jst, n_disp, stride))
    rows = ring[np.mod(cols, s.ring_len)]
    for sp in (None, spec):
        got = s.snapshot_strided(st, n_disp, stride, spec=sp)
        want = js.snapshot_strided(jst, n_disp, stride, spec=sp)
        v, m = s.refresh_view(st, n_disp, stride, spec=sp, n_med=40)
        jv, jm = js.refresh_view(jst, n_disp, stride, spec=sp, n_med=40)
        np.testing.assert_allclose(m, jm, atol=1e-4, rtol=0)
        if sp is None:
            np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
            np.testing.assert_allclose(v, jv, atol=1e-4, rtol=0)
        else:
            _tile_match(got, want, rows, sp)
            _tile_match(v, jv, rows, sp)


# (hop, mode, nint) at nfft 1024: contiguous, the classic half overlap, a
# lane-aligned hop that divides nothing, and 300 (not lane-aligned: the
# TPU kernel's gate refuses it, the card's B3 takes it)
CASES = [(hop, mode, nint) for hop in (None, 512, 384, 300)
         for mode, nint in (("welch", 1), ("welch", 2), ("parity", 2))]


@pytest.mark.parametrize("case", range(len(CASES)))
def test_streaming_matches_jax(case):
    """Pushes, ring, carry, counter and every view against the JAX class.
    nsub, the ring's divisibility by k (slice vs scatter store), the block
    dtype and return_db vary across the cases and pushes."""
    hop, mode, nint = CASES[case]
    nfft = 1024
    nsub = 1 + case % 2
    k = 4
    block_len = k * (hop or nfft * nint)
    ring_len = 24 if case % 3 else 22          # 22 % 4 != 0: scatter store
    dtype = "int16" if case % 4 >= 2 else "float32"
    ref = 2.0 ** 15.5 if dtype == "int16" else 1.0
    s, js = _pair(nfft=nfft, nint=nint, nsub=nsub, block_len=block_len,
                  hop=hop, ring_len=ring_len, mode=mode, ref=ref)
    st, jst = s.init_state(), js.init_state()
    for i, b in enumerate(_blocks(8, nsub, block_len, dtype, seed=case)):
        return_db = i % 3 != 1
        st, cols = s.push(st, torch.from_numpy(b), return_db=return_db)
        jst, jcols = js.push(jst, jnp.asarray(b), return_db=return_db)
        if return_db:
            assert cols.shape == (k, nsub, nfft)
            _assert_db_close(cols.numpy(), np.asarray(jcols),
                             10.0 ** (np.asarray(jcols) / 10.0))
        else:
            assert cols is None and jcols is None
        assert st.total_cols == int(jst.total_cols) == (i + 1) * k
        np.testing.assert_array_equal(st.carry.numpy(), np.asarray(jst.carry))
    np.testing.assert_allclose(st.ring.numpy(), np.asarray(jst.ring), **LIN)
    _assert_db_close(s.snapshot(st)[0], js.snapshot(jst)[0],
                     np.asarray(js._ordered_ring(jst)))
    _views_match(s, _transplant(jst), js, jst, n_disp=7, stride=3)


def test_streaming_young_stream_views():
    """Before the ring fills: unfilled rows read the eps floor, the
    median spans the valid columns, strided rows with negative columns
    read unwritten slots — as the JAX class's."""
    kw = dict(nfft=256, nsub=2, block_len=256 * 2, ring_len=16,
              window="boxcar")
    s, js = _pair(**kw)
    b = _blocks(1, 2, 512, "float32", seed=5)[0]
    st, _ = s.push(s.init_state(), torch.from_numpy(b))
    jst, _ = js.push(js.init_state(), jnp.asarray(b))
    np.testing.assert_allclose(st.ring.numpy(), np.asarray(jst.ring), **LIN)
    st = _transplant(jst)
    snap, n = s.snapshot(st)
    assert n == 2
    np.testing.assert_allclose(snap[:14], 10 * np.log10(1e-15), rtol=1e-6)
    np.testing.assert_array_equal(s.strided_cols(st, 6, 2),
                                  [-9, -7, -5, -3, -1, 1])
    np.testing.assert_allclose(s.snapshot_strided(st, 6, 2),
                               js.snapshot_strided(jst, 6, 2), atol=1e-4)
    np.testing.assert_allclose(s.median_psd(st), js.median_psd(jst),
                               atol=1e-4)
    with pytest.raises(ValueError, match="alias"):
        s.snapshot_strided(st, 9, 2)
    with pytest.raises(ValueError, match="no columns"):
        s.median_psd(s.init_state())


def test_median_span_ladder():
    """The fill-span ladder decides which columns a windowed median spans:
    20 valid columns under a 32-column window take the newest 16
    (floor-pow2), exactly as the JAX class."""
    kw = dict(nfft=64, nsub=1, block_len=64 * 4, ring_len=64)
    s, js = _pair(**kw)
    st, jst = s.init_state(), js.init_state()
    for b in _blocks(5, 1, 256, "float32", seed=7):
        st, _ = s.push(st, torch.from_numpy(b), return_db=False)
        jst, _ = js.push(jst, jnp.asarray(b), return_db=False)
    st = _transplant(jst)
    assert s._span(20, 32, True) == js._span(20, 32, True) == 16
    med = s.median_psd(st, n_cols=32)
    np.testing.assert_array_equal(
        med, s.median_psd(st, n_cols=16, span_ladder=False))
    np.testing.assert_allclose(med, js.median_psd(jst, n_cols=32), atol=1e-4)
    # no window: exact over every valid column
    np.testing.assert_allclose(s.median_psd(st), js.median_psd(jst),
                               atol=1e-4)
    _, m = s.refresh_view(st, 4, 2, total_cols=20)
    np.testing.assert_array_equal(m, med)


def test_counter_fold_preserves_all_views():
    """With _FOLD_CAP shrunk on both classes the counter folds every few
    pushes; the folded counters agree, fold_total maps the true count onto
    them, and every view equals the JAX class's across the folds."""
    nfft, k, ring_len = 64, 4, 8

    class SmallFold(StreamingSti):
        _FOLD_CAP = 32

    class JSmallFold(JStreamingSti):
        _FOLD_CAP = 32

    kw = dict(nfft=nfft, nint=1, nsub=1, block_len=nfft * k,
              ring_len=ring_len, window="boxcar")
    s, js = SmallFold(device="cpu", **kw), JSmallFold(**kw)
    assert s._fold_at == js._fold_at == 32
    st, jst = s.init_state(), js.init_state()
    total = 0
    for b in _blocks(40, 1, nfft * k, "float32", seed=3):
        st, _ = s.push(st, torch.from_numpy(b), return_db=False)
        jst, _ = js.push(jst, jnp.asarray(b), return_db=False)
        total += k
        assert st.total_cols == int(jst.total_cols) == s.fold_total(total)
        assert s.fold_total(total) == js.fold_total(total)
    assert s.fold_total(total) != total          # the fold fired
    np.testing.assert_allclose(st.ring.numpy(), np.asarray(jst.ring), **LIN)
    _views_match(s, _transplant(jst), js, jst, n_disp=4, stride=2)
    np.testing.assert_array_equal(
        s.strided_cols(st, 4, 2, total_cols=total),
        js.strided_cols(jst, 4, 2, total_cols=total))


def test_push_consumes_state_in_place():
    """The ring updates in place (JAX donates it on a TPU): the returned
    state shares the input's ring tensor."""
    s = StreamingSti(nfft=64, nsub=1, block_len=128, ring_len=4,
                     device="cpu")
    st = s.init_state()
    ring = st.ring
    new, _ = s.push(st, torch.ones(2, 128))
    assert new.ring is ring and new.total_cols == 2
    assert bool((ring[:2] > 0).all()) and bool((ring[2:] == 0).all())


def test_validation_matches_jax():
    for kw in (dict(nfft=64, nsub=1, block_len=100),      # not k*hop
               dict(nfft=64, nsub=1, block_len=64 * 8, ring_len=2),
               dict(nfft=64, nsub=1, block_len=64, hop=65),
               dict(nfft=64, nsub=1, block_len=64, hop=0)):
        with pytest.raises(ValueError):
            JStreamingSti(**kw)
        with pytest.raises(ValueError):
            StreamingSti(device="cpu", **kw)
    with pytest.raises(TypeError):
        StreamingSti(nfft=64, nsub=1, block_len=64)         # device required
    s = StreamingSti(nfft=64, nsub=2, block_len=128, device="cpu")
    with pytest.raises(ValueError, match="block of shape"):
        s.push(s.init_state(), torch.zeros(2, 128))


def test_cuda_device_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StreamingSti(nfft=1024, block_len=1024, device="cuda")


@pytest.mark.parametrize("nfft,nint,hop,mode,k,precision", [
    (1024, 1, 512, "welch", 4, "exact"),
    (1024, 2, 1024, "welch", 4, "exact"),
    (1024, 1, 384, "welch", 4, "exact"),
    (2048, 2, 2048, "parity", 4, "exact"),
    (1024, 1, 512, "welch", 16, "exact"),
    (1024, 1, 512, "welch", 5, "exact"),
    (1024, 1, 512, "welch", 16, "display"),
    (1024, 1, 512, "welch", 32, "display"),
])
def test_stream_plain_matches_pallas_kernel(nfft, nint, hop, mode, k,
                                            precision):
    """Kernel B3's plain version against the Pallas stream kernel
    (interpret mode) at the JAX package's own test shapes
    (test_pallas_kernel.py:520-529)."""
    nsub = 2
    rng = np.random.default_rng(5)
    buf = rng.standard_normal(
        (nsub * 2, nfft * nint - hop + k * hop)).astype(np.float32)
    want = np.asarray(make_pallas_stream_psd(
        nfft=nfft, nint=nint, hop=hop, mode=mode, interpret=True,
        precision=precision)(jnp.asarray(buf)))
    before = stream_cuda.stream_psd_cuda.launches
    got = stream_cuda.stream_psd_cuda(torch.from_numpy(buf), nfft=nfft,
                                      nint=nint, hop=hop, mode=mode)
    assert stream_cuda.stream_psd_cuda.launches == before  # CPU: plain
    np.testing.assert_allclose(got.numpy(), want, **LIN)


@pytest.mark.parametrize("width,hop", [(1024 - 512 + 4 * 512 + 1, 512),
                                       (1024 - 512, 512), (2048, 1024)])
def test_stream_kernel_refuses_bad_buffers(width, hop):
    """A buffer that is not carry + k*hop wide, and hop == frame_len (the
    contiguous kernel's case), raise as make_pallas_stream_psd does."""
    with pytest.raises(ValueError):
        stream_cuda.stream_psd_cuda(torch.zeros(2, width), nfft=1024,
                                    hop=hop)


@pytest.mark.parametrize("nfft,nint,hop,device,want", [
    (4096, 1, 4096, "cuda", "sti"),       # contiguous: B1
    (4096, 1, 2048, "cuda", "stream"),    # overlap: B3
    (1024, 2, 300, "cuda", "stream"),     # overlap, not lane-aligned: B3
    (32768, 1, 16384, "cuda", "stream"),  # B3 through the four-step split
    (65536, 1, 65536, "cuda", "sti"),     # contiguous at 2^16: B4
    (1 << 20, 1, 1 << 19, "cuda", "sti"),  # overlap at 2^20: B4 at t*hop
    (128, 1, 64, "cuda", "torch"),        # below every kernel
    (1000, 1, 500, "cuda", "torch"),      # not a power of two
    (1 << 21, 1, 1 << 20, "cuda", "torch"),  # beyond NFFT_RANGE
    (4096, 1, 2048, "cpu", "torch"),
])
def test_stream_impl_table(nfft, nint, hop, device, want):
    assert stft.stream_impl(nfft, nint, hop, torch.device(device)) == want


@pytest.mark.parametrize("hop", [1024, 512, 300])
def test_stream_columns_equal_plain_at_hop_starts(hop):
    """The push's columns are the plain PSD at starts t*hop of the push
    buffer, whatever route stream_impl takes."""
    k = 5
    rng = np.random.default_rng(hop)
    buf = torch.from_numpy(rng.standard_normal(
        (4, 1024 - hop + k * hop)).astype(np.float32))
    got = stft.stream_columns(buf, k, nfft=1024, nint=1, hop=hop)
    want = stft.psd_torch(buf, torch.arange(k, dtype=torch.int32) * hop,
                          nfft=1024)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("dtype", ["complex64", "int16"])
def test_stream_blocks_match_jax_feeder(tmp_path, dtype):
    """io.ingest.stream_blocks yields the JAX feeder's plane-major blocks,
    bit for bit, in their storage dtype; they feed the port's ring like
    the JAX ring."""
    from pyspectrogram_tpu.clients.cli import SYNTH_DTYPES
    from pyspectrogram_tpu.io import RFDataset
    from pyspectrogram_tpu.io.ingest import stream_blocks as jstream_blocks
    from pyspectrogram_tpu.io.synthetic import write_capture
    from pyspectrogram_tpu_torch.io.ingest import stream_blocks

    write_capture(tmp_path, channel="c", kind="tone", n_samples=1 << 14,
                  num_subchannels=2, dtype=SYNTH_DTYPES[dtype])
    ds = RFDataset(tmp_path)
    lo, _ = ds.bnds["c"]
    got = list(stream_blocks(ds, "c", lo + 100, 1024, 6))
    with jstream_blocks(ds, "c", lo + 100, 1024, 6) as feeder:
        want = [np.asarray(b) for b in feeder]
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert isinstance(g, np.ndarray) and g.shape == (4, 1024)
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    s, js = _pair(nfft=256, nsub=2, block_len=1024, ring_len=32,
                  ref=ds.ref_dict["c"])
    state, jstate = s.init_state(), js.init_state()
    for g, w in zip(got, want):
        state, _ = s.push(state, torch.from_numpy(g), return_db=False)
        jstate, _ = js.push(jstate, jnp.asarray(w), return_db=False)
    got_med, want_med = s.median_psd(state), np.asarray(
        js.median_psd(jstate))
    keep = want_med >= want_med.max(axis=-1, keepdims=True) - 60.0
    np.testing.assert_allclose(got_med[keep], want_med[keep], atol=1e-4,
                               rtol=0)
