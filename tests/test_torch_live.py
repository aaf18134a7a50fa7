"""The PyTorch port's LiveStreamEngine and stream checkpoints (CPU) against
the JAX package's, on the same Digital RF captures.

Times, frame starts and masks must be exact. Spectra: dB within 1e-4 dB on
bins within 60 dB of the column's peak (tone captures; the rest is float32
FFT rounding of a floor far below the tone); uint8 tiles within one level
on <= 0.1% of pixels (two FFTs' linear power lands on either side of a
level boundary there). Checkpoints written by either package resume in
the other. Each package opens the captures with its own reader and gets its
own config (port_pairs).
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from port_pairs import jax_config, jax_dataset
from pyspectrogram_tpu.io.synthetic import tone_signal, write_capture
from pyspectrogram_tpu.io.writer import DigitalRFWriter
from pyspectrogram_tpu.runtime import checkpoint as jcheckpoint
from pyspectrogram_tpu.runtime.live import LiveStreamEngine as JEngine
from pyspectrogram_tpu_torch.io.memory import MemoryDataset
from pyspectrogram_tpu_torch.io.reader import RFDataset
from pyspectrogram_tpu_torch.kernels import _build
from pyspectrogram_tpu_torch.models.streaming import StreamingSti, StreamState
from pyspectrogram_tpu_torch.runtime import LiveStreamEngine, checkpoint
from pyspectrogram_tpu_torch.runtime.live import (
    _EagerRefresh,
    _EngineSlot,
    _GraphedRefresh,
)
from pyspectrogram_tpu_torch.utils import profiling
from pyspectrogram_tpu_torch.utils.config import SpectrogramConfig

SR = 100_000
START = 1_451_661_840 * SR
F0 = 12_500.0


def _growing_writer(path, n0):
    w = DigitalRFWriter(
        path, "live", np.complex64, start_global_index=START,
        sample_rate_numerator=SR, file_cadence_millisecs=100,
        subdir_cadence_secs=1,
    )
    w.rf_write(tone_signal(n0, SR, [F0]).astype(np.complex64))
    return w


def _append(w, ds_list, n_written, delta):
    w.rf_write(tone_signal(delta, SR, [F0], start_sample=n_written)
               .astype(np.complex64))
    for ds in ds_list:
        ds.bnds_update()
    return n_written + delta


def _count_reads(ds):
    spans = []
    orig = ds.reader.read_vector_raw

    def counting(start, n, chan, **kw):
        spans.append(int(n))
        return orig(start, n, chan, **kw)

    ds.reader.read_vector_raw = counting
    return spans


def _db_close(got, want, floor_db=60.0, atol=1e-4):
    keep = want >= want.max(axis=0, keepdims=True) - floor_db
    np.testing.assert_allclose(got[keep], want[keep], atol=atol, rtol=0)


def _same_result(got, want):
    """A port tick against a JAX tick."""
    assert (got is None) == (want is None)
    if got is None:
        return
    np.testing.assert_array_equal(got.times, want.times)
    np.testing.assert_array_equal(got.frame_starts, want.frame_starts)
    np.testing.assert_array_equal(got.mask, want.mask)
    np.testing.assert_array_equal(got.freqs, want.freqs)
    assert got.sample_rate == want.sample_rate
    assert got.sxx_med_dbfs.shape == want.sxx_med_dbfs.shape
    _db_close(got.sxx_med_dbfs, want.sxx_med_dbfs)
    if want.tile is not None:
        assert got.sxx_dbfs is None and got.tile.dtype == np.uint8
        np.testing.assert_array_equal(got.plot_freqs, want.plot_freqs)
        d = np.abs(got.tile.astype(int) - want.tile.astype(int))
        assert got.tile.shape == want.tile.shape
        assert d.max() <= 1 and np.count_nonzero(d) <= 1e-3 * d.size
    else:
        assert got.tile is None
        assert got.sxx_dbfs.shape == want.sxx_dbfs.shape
        _db_close(got.sxx_dbfs, want.sxx_dbfs)


def _engines(ds, cfg, **kw):
    """The port's engine on ``ds`` and the JAX engine on the same capture
    through its own reader (``jeng.ds``)."""
    return (LiveStreamEngine(ds, cfg, "cpu", **kw),
            JEngine(jax_dataset(ds), jax_config(cfg), **kw))


def _check_engines(a, b):
    """The engines' host bookkeeping agrees exactly (the port computes its
    tail view from the samples it staged, so it has no count of tail
    re-reads to compare)."""
    for f in ("window_cols", "cols_per_block", "block_len", "hop",
              "carry_len", "start_sample", "next_sample", "total_cols",
              "samples_read", "_tail_pending"):
        assert getattr(a, f) == getattr(b, f), f
    assert a.sti.ring_len == b.sti.ring_len
    np.testing.assert_array_equal(a.col_mask, b.col_mask)
    np.testing.assert_array_equal(a._carry_mask, b._carry_mask)


@pytest.mark.parametrize("cfg_kw", [
    dict(nfft=256, nint=2, ntime=64, stream_seconds=0.01),   # every column
    dict(nfft=64, ntime=10, stream_seconds=0.03),            # strided view
    dict(nfft=256, ntime=16, stream_seconds=0.01, display_tile=True,
         color_range_db=(-80.0, -10.0)),
    dict(nfft=128, nint=3, ntime=40, stream_seconds=0.02, mode="parity"),
])
def test_tick_matches_jax_on_tone_capture(tone_capture, cfg_kw):
    top, meta = tone_capture
    ds = RFDataset(top)
    cfg = SpectrogramConfig(streaming=True, **cfg_kw)
    eng, jeng = _engines(ds, cfg)
    for _ in range(2):                  # a cold tick, then an idle one
        _same_result(eng.tick(cfg), jeng.tick(jax_config(cfg)))
        _check_engines(eng, jeng)
    res = eng.tick(cfg)
    lo, hi = ds.bnds[meta["channel"]]
    assert res.frame_starts[-1] + cfg.nfft * cfg.nint == hi + 1
    med = res.sxx_med_dbfs
    for s, f in enumerate(meta["freqs_hz"]):
        assert abs(med[:, s].max()) < 0.1
        assert res.freqs[med[:, s].argmax()] == pytest.approx(
            f, abs=1e6 / cfg.nfft)


@pytest.mark.parametrize("nfft,nint,hop", [
    (256, 1, 128),   # half-frame overlap
    (256, 1, 64),    # 4x overlap
    (128, 2, 128),   # overlap across Welch segment boundaries
    (128, 2, 96),    # non-divisor hop, nint > 1
])
def test_overlap_hop_matches_jax(tone_capture, nfft, nint, hop):
    """Carry-seeded first column, ring columns and tail columns of an
    overlap-save stream against the JAX engine's."""
    top, _ = tone_capture
    ds = RFDataset(top)
    cfg = SpectrogramConfig(nfft=nfft, nint=nint, ntime=100,
                            stream_seconds=0.005, hop=hop, streaming=True)
    eng, jeng = _engines(ds, cfg)
    assert eng.hop == hop and eng.carry_len == nfft * nint - hop
    res = eng.tick(cfg)
    _same_result(res, jeng.tick(jax_config(cfg)))
    _check_engines(eng, jeng)
    assert np.all(np.diff(res.frame_starts) == hop)
    np.testing.assert_array_equal(eng.state.carry.numpy(),
                                  np.asarray(jeng.state.carry))


def test_tick_reads_are_o_delta_and_match_jax(tmp_path):
    n0 = 60_000
    w = _growing_writer(tmp_path, n0)
    ds = RFDataset(tmp_path)
    jds = jax_dataset(ds)
    cfg = SpectrogramConfig(nfft=64, ntime=16, stream_seconds=0.5,
                            streaming=True)
    eng = LiveStreamEngine(ds, cfg, "cpu", target_block_samples=4096)
    jeng = JEngine(jds, jax_config(cfg), target_block_samples=4096)
    spans = _count_reads(ds)
    window_samples = eng.window_cols * eng.hop
    assert window_samples == 50_048
    _same_result(eng.tick(cfg), jeng.tick(jax_config(cfg)))
    assert sum(spans) <= window_samples + eng.block_len
    for _ in range(3):
        n0 = _append(w, (ds, jds), n0, 7_000)
        before = sum(spans)
        _same_result(eng.tick(cfg), jeng.tick(jax_config(cfg)))
        read = sum(spans) - before
        assert read <= 7_000 + eng.block_len and read < window_samples / 4
        _check_engines(eng, jeng)


def test_backlog_skip_matches_jax(tmp_path):
    n0 = 30_000
    w = _growing_writer(tmp_path, n0)
    ds = RFDataset(tmp_path)
    cfg = SpectrogramConfig(nfft=64, ntime=8, stream_seconds=0.1,
                            streaming=True)
    eng, jeng = _engines(ds, cfg, target_block_samples=4096)
    _same_result(eng.tick(cfg), jeng.tick(jax_config(cfg)))
    spans = _count_reads(ds)
    _append(w, (ds, jeng.ds), n0, 5 * eng.window_cols * eng.hop)
    res = eng.tick(cfg)
    assert sum(spans) <= eng.window_cols * eng.hop + eng.block_len
    _same_result(res, jeng.tick(jax_config(cfg)))
    _check_engines(eng, jeng)
    lo, hi = ds.bnds["live"]
    assert hi + 1 - (res.frame_starts[-1] + 64) < eng.block_len


def test_gap_columns_flagged_as_jax(tmp_path):
    n0, gap, n1 = 20_000, 4_000, 16_000
    w = _growing_writer(tmp_path, n0)
    w.rf_write(tone_signal(n1, SR, [F0], start_sample=n0 + gap)
               .astype(np.complex64), global_index=START + n0 + gap)
    ds = RFDataset(tmp_path)
    cfg = SpectrogramConfig(nfft=64, ntime=1000, stream_seconds=0.4,
                            streaming=True)
    eng, jeng = _engines(ds, cfg, target_block_samples=4096)
    res = eng.tick(cfg)
    _same_result(res, jeng.tick(jax_config(cfg)))
    assert (~res.mask).any() and res.mask.any()
    hole_lo, hole_hi = START + n0, START + n0 + gap
    np.testing.assert_array_equal(
        ~res.mask, (res.frame_starts < hole_hi)
        & (res.frame_starts + 64 > hole_lo))


def test_overlap_gap_flags_touching_columns(tmp_path):
    write_capture(tmp_path, channel="g", kind="tone", n_samples=20_000,
                  sample_rate_numerator=SR, gap=(15_000, 300))
    ds = RFDataset(tmp_path)
    cfg = SpectrogramConfig(nfft=128, nint=1, ntime=200,
                            stream_seconds=0.1, hop=64, streaming=True)
    eng, jeng = _engines(ds, cfg)
    res = eng.tick(cfg)
    _same_result(res, jeng.tick(jax_config(cfg)))
    lo, _ = ds.bnds["g"]
    want_bad = ((res.frame_starts < lo + 15_300)
                & (res.frame_starts + 128 > lo + 15_000))
    assert want_bad.sum() > 300 // 64
    np.testing.assert_array_equal(~res.mask, want_bad)


def test_ring_wrap_long_run_matches_jax(tmp_path):
    n0 = 12_800
    w = _growing_writer(tmp_path, n0)
    ds = RFDataset(tmp_path)
    cfg = SpectrogramConfig(nfft=64, ntime=64, stream_seconds=0.04,
                            streaming=True)
    eng, jeng = _engines(ds, cfg, target_block_samples=2048)
    _same_result(eng.tick(cfg), jeng.tick(jax_config(cfg)))
    for _ in range(6):
        n0 = _append(w, (ds, jeng.ds), n0, 3_200)
        _same_result(eng.tick(cfg), jeng.tick(jax_config(cfg)))
    assert eng.total_cols > 4 * eng.sti.ring_len
    _check_engines(eng, jeng)


@pytest.mark.parametrize("display_tile", [False, True])
def test_tail_columns_match_jax(tmp_path, display_tile):
    """The tail view when the writer stops short of a block (cached on an
    idle tick), while blocks flow, and once its block completes."""
    n0 = 8_192
    w = _growing_writer(tmp_path, n0)
    ds = RFDataset(tmp_path)
    cfg = SpectrogramConfig(nfft=64, ntime=1000, stream_seconds=0.4,
                            streaming=True, display_tile=display_tile)
    eng, jeng = _engines(ds, cfg, target_block_samples=4096)
    assert eng.cols_per_block == 64
    _same_result(eng.tick(cfg), jeng.tick(jax_config(cfg)))
    n0 = _append(w, (ds, jeng.ds), n0, 37 * 64)    # < 1 block pending
    spans = _count_reads(ds)
    res1 = eng.tick(cfg)
    _same_result(res1, jeng.tick(jax_config(cfg)))
    assert eng._tail_pending == 37 and len(res1.frame_starts) == 128 + 37
    # the tail comes from the staged samples: only the appended ones read
    assert sum(spans) == 37 * 64
    res2 = eng.tick(cfg)                         # idle: cached tail
    _same_result(res2, jeng.tick(jax_config(cfg)))
    assert sum(spans) == 37 * 64
    # a block and a tail
    n0 = _append(w, (ds, jeng.ds), n0, (64 - 37 + 64 + 13) * 64)
    res3 = eng.tick(cfg)
    _same_result(res3, jeng.tick(jax_config(cfg)))
    assert eng._tail_pending == 13
    _check_engines(eng, jeng)
    lo, hi = ds.bnds["live"]
    assert res3.frame_starts[-1] + 64 == hi + 1
    assert np.all(np.diff(res3.frame_starts) == 64)


def test_overlap_hop_short_capture_still_displays(tmp_path):
    _growing_writer(tmp_path, 1_100)
    ds = RFDataset(tmp_path)
    cfg = SpectrogramConfig(nfft=64, nint=1, ntime=1000, hop=16,
                            stream_seconds=0.1, streaming=True)
    eng, jeng = _engines(ds, cfg, target_block_samples=4096)
    assert eng.carry_len + eng.cols_per_block * eng.hop <= 1_100
    res = eng.tick(cfg)
    assert res is not None
    _same_result(res, jeng.tick(jax_config(cfg)))
    assert np.all(np.diff(res.frame_starts) == 16)


def test_int16_capture_normalization(tmp_path):
    """int16 planes ride the push raw and widen there; the dBFS reference
    is the half-bit rule: a 2^14-amplitude tone reads -9.03 dBFS."""
    i16 = np.dtype([("r", np.int16), ("i", np.int16)])
    write_capture(tmp_path / "cap", channel="c", kind="tone",
                  n_samples=120_000, sample_rate_numerator=SR, dtype=i16)
    ds = RFDataset(tmp_path / "cap")
    for hop in (None, 128):
        cfg = SpectrogramConfig(nfft=256, ntime=8, stream_seconds=0.2,
                                hop=hop, streaming=True)
        eng, jeng = _engines(ds, cfg)
        res = eng.tick(cfg)
        _same_result(res, jeng.tick(jax_config(cfg)))
        np.testing.assert_allclose(float(res.sxx_med_dbfs.max()),
                                   20 * np.log10(2**14 / 2**15.5), atol=0.05)


def test_engine_slot_reinits_on_shape_change(tone_capture):
    ds = RFDataset(tone_capture[0])
    slot = _EngineSlot(ds, "cpu")
    cfg = SpectrogramConfig(nfft=128, ntime=8, stream_seconds=0.005,
                            streaming=True)
    r1 = slot.tick(cfg)
    e1 = slot.engine
    slot.tick(cfg.replace(color_range_db=(-90.0, -20.0), ntime=4))
    assert slot.engine is e1
    r2 = slot.tick(cfg.replace(nfft=256))
    assert slot.engine is not e1
    assert r1.freqs.shape == (128,) and r2.freqs.shape == (256,)
    e2 = slot.engine
    slot.tick(cfg.replace(nfft=256, eps=1e-9))
    assert slot.engine is not e2


@pytest.mark.parametrize("hop", [None, 32])
def test_checkpoints_cross_load(tmp_path, hop):
    """Port save -> JAX resume -> tick, and JAX save -> port resume ->
    tick: each equals the uninterrupted streams, and reads only the
    samples appended after the checkpoint."""
    n0 = 40_000
    cap = tmp_path / "cap"
    w = _growing_writer(cap, n0)
    cfg = SpectrogramConfig(nfft=64, ntime=16, stream_seconds=0.2, hop=hop,
                            streaming=True)
    ds = RFDataset(cap)
    eng, jeng = _engines(ds, cfg, target_block_samples=2048)
    _same_result(eng.tick(cfg), jeng.tick(jax_config(cfg)))
    ck = eng.save(tmp_path / "port.ckpt")
    jck = jeng.save(tmp_path / "jax.ckpt")
    assert ck.suffix == jck.suffix == ".npz"
    assert checkpoint.peek_stream_meta(jck) == jcheckpoint.peek_stream_meta(ck)

    _append(w, (ds, jeng.ds), n0, 9_000)
    from_port = JEngine.resume(jax_dataset(ds), jax_config(cfg), ck)
    ds_p = RFDataset(cap)
    from_jax = LiveStreamEngine.resume(ds_p, cfg, jck, "cpu")
    assert from_jax.total_cols == eng.total_cols
    assert from_jax.next_sample == from_port.next_sample == eng.next_sample
    spans = _count_reads(ds_p)
    want, jwant = eng.tick(cfg), jeng.tick(jax_config(cfg))
    got_j, got_p = from_port.tick(cfg), from_jax.tick(cfg)
    assert sum(spans) <= 9_000 + eng.block_len
    for got in (got_j, got_p):
        _same_result(got, want)
        _same_result(got, jwant)
    _check_engines(from_jax, from_port)


def test_port_resume_is_exact(tmp_path):
    """A port checkpoint resumed by the port continues bit for bit."""
    n0 = 60_000
    cap = tmp_path / "cap"
    w = _growing_writer(cap, n0)
    cfg = SpectrogramConfig(nfft=64, ntime=16, stream_seconds=0.5,
                            streaming=True)
    ds = RFDataset(cap)
    eng = LiveStreamEngine(ds, cfg, "cpu", target_block_samples=4096)
    eng.tick(cfg)
    ck = eng.save(tmp_path / "live.ckpt")
    _append(w, (ds,), n0, 9_000)
    eng_b = LiveStreamEngine.resume(RFDataset(cap), cfg, ck, "cpu")
    res_b, res_a = eng_b.tick(cfg), eng.tick(cfg)
    for f in ("sxx_dbfs", "sxx_med_dbfs", "frame_starts", "mask", "times"):
        np.testing.assert_array_equal(getattr(res_b, f), getattr(res_a, f))


def _saved(tmp_path, cfg=None):
    cap = tmp_path / "cap"
    _growing_writer(cap, 60_000)
    ds = RFDataset(cap)
    cfg = cfg or SpectrogramConfig(nfft=64, ntime=16, stream_seconds=0.5,
                                   streaming=True)
    eng = LiveStreamEngine(ds, cfg, "cpu", target_block_samples=4096)
    eng.tick(cfg)
    return ds, cfg, eng, eng.save(tmp_path / "live.ckpt")


def _rewrite(path, out, header_fn=None, **arrays):
    with np.load(path, allow_pickle=False) as z:
        a = {k: z[k] for k in z.files}
    if header_fn is not None:
        header = json.loads(bytes(a["header"].tobytes()).decode())
        header_fn(header)
        a["header"] = np.frombuffer(json.dumps(header).encode(), np.uint8)
    a.update(arrays)
    np.savez(out, **a)
    return out


def test_resume_refusals_match_jax(tmp_path):
    """Every refusal of the JAX engine's resume (live.py:242-280): a
    session file, other shape knobs, a torn state, another dataset's
    geometry — raised by both packages on the same files."""
    ds, cfg, eng, ck = _saved(tmp_path)
    sess = checkpoint.save_session(tmp_path / "sess.npz", tmp_path, cfg)
    torn = _rewrite(ck, tmp_path / "torn.npz", total_cols=np.asarray(
        eng.total_cols + eng.cols_per_block, np.int32))
    cap2 = tmp_path / "cap2"
    write_capture(cap2, channel="live", kind="tone", n_samples=60_000,
                  sample_rate_numerator=SR, num_subchannels=2)
    cases = [(ds, cfg.replace(nfft=128), ck, "shape knobs"),
             (ds, cfg, sess, ""),
             (ds, cfg, torn, "torn checkpoint"),
             (RFDataset(cap2), cfg, ck, "geometry mismatch")]
    for d, c, p, match in cases:
        with pytest.raises((KeyError, ValueError), match=match or None):
            LiveStreamEngine.resume(d, c, p, "cpu")
        with pytest.raises((KeyError, ValueError), match=match or None):
            JEngine.resume(jax_dataset(d), jax_config(c), p)


def test_resume_accepts_pre_hop_checkpoint(tmp_path):
    ds, cfg, eng, ck = _saved(tmp_path)

    def drop_hop(h):
        assert len(h["meta"]["signature"]) == 9
        h["meta"]["signature"] = h["meta"]["signature"][:8]

    old = _rewrite(ck, tmp_path / "old.npz", drop_hop)
    eng2 = LiveStreamEngine.resume(ds, cfg, old, "cpu")
    assert eng2.hop == 64 and eng2.carry_len == 0
    assert eng2.next_sample == eng.next_sample
    assert JEngine.resume(jax_dataset(ds), jax_config(cfg),
                          old).next_sample == eng.next_sample


def test_stream_state_format_refusals_match_jax(tmp_path):
    """v1 files (no ring_layout) load only when the rotation is the
    identity; canonical rings are re-rotated; unknown layouts and newer
    formats are refused — by both packages alike."""
    ring = np.arange(6 * 2 * 4, dtype=np.float32).reshape(6, 2, 4)
    st = StreamState(carry=torch.zeros(4, 3), ring=torch.from_numpy(ring),
                     total_cols=9)
    p = checkpoint.save_stream_state(tmp_path / "s.npz", st, {"k": 1})

    def v1(h):
        del h["ring_layout"]
        h["format_version"] = 1

    def layout(name):
        def f(h):
            h["ring_layout"] = name
        return f

    def newer(h):
        h["format_version"] = 3

    for fn, match in ((v1, "mid-wrap"), (layout("spiral"), "ring_layout"),
                      (newer, "newer format")):
        bad = _rewrite(p, tmp_path / "bad.npz", fn)
        with pytest.raises(ValueError, match=match):
            checkpoint.load_stream_state(bad, "cpu")
        with pytest.raises(ValueError, match=match):
            jcheckpoint.load_stream_state(bad)
    canon = _rewrite(p, tmp_path / "canon.npz", layout("canonical"))
    got, _ = checkpoint.load_stream_state(canon, "cpu")
    want, _ = jcheckpoint.load_stream_state(canon)
    np.testing.assert_array_equal(got.ring.numpy(), np.asarray(want.ring))
    np.testing.assert_array_equal(got.ring.numpy(), np.roll(ring, 3, axis=0))
    ident = _rewrite(p, tmp_path / "ident.npz", v1,
                     total_cols=np.asarray(12, np.int32))
    got, _ = checkpoint.load_stream_state(ident, "cpu")
    assert got.total_cols == 12
    np.testing.assert_array_equal(got.ring.numpy(), ring)
    with pytest.raises(ValueError, match="corrupt"):
        (tmp_path / "trunc.npz").write_bytes(p.read_bytes()[:100])
        checkpoint.load_stream_state(tmp_path / "trunc.npz", "cpu")


def test_stream_state_files_are_the_same_bytes(tmp_path):
    """The same state saved by each package: equal header, arrays and
    dtypes; each loads the other's."""
    rng = np.random.default_rng(1)
    carry = rng.standard_normal((4, 7)).astype(np.float32)
    ring = rng.exponential(size=(5, 2, 8)).astype(np.float32)
    meta = {"kind": "live_stream", "n": 3}
    extra = {"col_mask": np.array([True, False, True, True, True])}
    st = StreamState(carry=torch.from_numpy(carry),
                     ring=torch.from_numpy(ring), total_cols=13)
    jst, _ = jcheckpoint.load_stream_state(checkpoint.save_stream_state(
        tmp_path / "p.npz", st, meta, extra_arrays=extra))
    jcheckpoint.save_stream_state(tmp_path / "j.npz", jst, meta,
                                  extra_arrays=extra)
    with np.load(tmp_path / "p.npz") as a, np.load(tmp_path / "j.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            np.testing.assert_array_equal(a[k], b[k])
    back, m = checkpoint.load_stream_state(tmp_path / "j.npz", "cpu")
    assert back.total_cols == 13 and m["kind"] == "live_stream"
    np.testing.assert_array_equal(back.ring.numpy(), ring)
    np.testing.assert_array_equal(m["arrays"]["col_mask"], extra["col_mask"])


def test_session_files_cross_load(tmp_path):
    cfg = SpectrogramConfig(nfft=512, nint=2, window="hann",
                            time_span=(1.0, None), hop=128,
                            freq_window_khz=(-10.0, 10.0))
    jcfg = jax_config(cfg)
    for save, load, saved, loaded in (
            (checkpoint.save_session, jcheckpoint.load_session, cfg, jcfg),
            (jcheckpoint.save_session, checkpoint.load_session, jcfg, cfg)):
        p = save(tmp_path / "sess.ckpt", tmp_path, saved, (5, 99),
                 extra={"tab": 2})
        assert p.name == "sess.ckpt.npz"
        h = load(tmp_path / "sess.ckpt")
        assert h["config"] == loaded and h["sample_bounds"] == (5, 99)
        assert h["extra"] == {"tab": 2}


def test_memory_dataset_append_extends_bounds_and_reads():
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((1000, 2))
         + 1j * rng.standard_normal((1000, 2))).astype(np.complex64)
    ds = MemoryDataset(x[:300], 1000, start=50)
    assert ds.bnds["ch0"] == (50, 349)
    for lo, hi in ((300, 301), (301, 700), (700, 1000)):
        ds.append(x[lo:hi])
        assert ds.bnds["ch0"] == (50, 50 + lo - 1)   # until the refresh
        ds.bnds_update()
        assert ds.bnds["ch0"] == (50, 50 + hi - 1)
        assert ds.time_bnds[1] == (50 + hi - 1) / 1000
    raw, mask = ds.reader.read_vector_raw(40, 1020, "ch0", return_mask=True)
    np.testing.assert_array_equal(raw[10:1010], x)
    assert mask[10:1010].all() and not mask[:10].any() \
        and not mask[1010:].any()


def test_live_engine_on_growing_memory_dataset():
    """The in-memory capture grows like a written one: the engine reads
    exactly what was appended."""
    n = 30_000
    x = tone_signal(n + 3 * 5_000, SR, [F0]).astype(np.complex64)
    ds = MemoryDataset(x[:n], SR)
    cfg = SpectrogramConfig(nfft=64, ntime=1000, stream_seconds=0.2,
                            hop=32, streaming=True)
    eng = LiveStreamEngine(ds, cfg, "cpu", target_block_samples=2048)
    res = eng.tick(cfg)
    for i in range(3):
        before = eng.samples_read
        ds.append(x[n + 5_000 * i:n + 5_000 * (i + 1)])
        ds.bnds_update()
        res = eng.tick(cfg)
        assert eng.samples_read - before <= 5_000 + eng.block_len
    assert res.mask.all()
    assert 0 <= n + 15_000 - (res.frame_starts[-1] + 64) < 32
    assert np.all(np.diff(res.frame_starts) == 32)
    assert abs(res.sxx_med_dbfs.max()) < 0.1


# ---------------------------------------------------------------- the card
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the refresh is a CUDA graph only "
                    "on the card")


def _bit_equal(got, want):
    """Two engines' ticks of the same capture, field by field."""
    assert (got is None) == (want is None)
    if got is None:
        return
    for f in ("times", "frame_starts", "mask", "freqs", "sxx_med_dbfs",
              "sxx_dbfs", "tile", "plot_freqs"):
        a, b = getattr(got, f), getattr(want, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(a, b, err_msg=f)


def _counted(eng, cfg):
    """``eng.tick(cfg)`` and the graph counts of its ``live.refresh``."""
    profiling.reset()
    was = profiling.tracing(True)
    try:
        res = eng.tick(cfg)
    finally:
        profiling.tracing(was)
    got = [s.counts for s in profiling.spans() if s.name == "live.refresh"]
    profiling.reset()
    return res, {k: sum(c.get(k, 0) for c in got)
                 for k in ("graph", "graph_captures")}


def _live_capture(n):
    rng = np.random.default_rng(7)
    x = tone_signal(n, SR, [F0, -3 * F0]).reshape(-1, 1) * [1.0, 0.5]
    x = x + 1e-3 * (rng.standard_normal(x.shape)
                    + 1j * rng.standard_normal(x.shape))
    return x.astype(np.complex64)


def _eager(eng):
    """``eng`` with the eager refresh in place of its graph."""
    assert isinstance(eng._refresh, _GraphedRefresh)
    eng._refresh = _EagerRefresh(eng.sti)
    return eng


@pytest.mark.parametrize("display_tile", [False, True])
def test_graphed_tick_equals_an_eager_tick_on_the_card(monkeypatch,
                                                      display_tile):
    """On the card the refresh replays a CUDA graph; every tick equals the
    same capture's tick with the eager refresh (rows copied from the host)
    bit for bit, and counts the kernel launches it makes: the
    window filling (each tick eager), the ring wrapping and its counter
    folding, pending tails, a colour-range and an ntime change and a ring
    restart behind a backlog, each of the last three recaptured. B2 takes
    its radix design (938 columns)."""
    _card()
    monkeypatch.setattr(StreamingSti, "_FOLD_CAP", 64)
    x = _live_capture(400_000)
    n = 1_500
    ds = MemoryDataset(x[:n], SR)
    cfg = SpectrogramConfig(nfft=64, ntime=20, stream_seconds=0.3, hop=32,
                            streaming=True, display_tile=display_tile,
                            color_range_db=(-90.0, -10.0))
    g = LiveStreamEngine(ds, cfg, "cuda", target_block_samples=1024)
    e = _eager(LiveStreamEngine(ds, cfg, "cuda", target_block_samples=1024))
    assert g.window_cols == 938
    counts = {"graph": 0, "graph_captures": 0}
    tails = []

    def tick(c, grow=0):
        nonlocal n
        if grow:
            ds.append(x[n:n + grow])
            ds.bnds_update()
            n += grow
        filled = g.sti.filled_cols(g.total_cols)
        with _build.tally() as launched:
            got, k = _counted(g, c)
        with _build.tally() as want:
            _bit_equal(got, e.tick(c))
        assert launched == want
        if g.sti.filled_cols(g.total_cols) != filled:
            assert k == {"graph": 0, "graph_captures": 0}     # a new key
        for key in counts:
            counts[key] += k[key]
        tails.append(g._tail_pending)
        return k

    assert tick(cfg) == {"graph": 0, "graph_captures": 0}     # eager
    assert tick(cfg) == {"graph": 0, "graph_captures": 1}     # captured
    while g.total_cols < 3 * g.sti.ring_len:                  # fill, wrap
        tick(cfg, grow=1_000)
    assert g.sti.fold_total(g.total_cols) != g.total_cols     # folded
    assert any(tails) and counts["graph"] > 40
    for c in (dataclasses.replace(cfg, color_range_db=(-80.0, -30.0)),
              dataclasses.replace(cfg, ntime=50)):
        first = tick(c, grow=700)
        second = tick(c, grow=700)
        recaptured = display_tile or c.ntime != cfg.ntime
        assert first == ({"graph": 0, "graph_captures": 0} if recaptured
                         else {"graph": 1, "graph_captures": 0})
        assert second == ({"graph": 0, "graph_captures": 1} if recaptured
                          else {"graph": 1, "graph_captures": 0})
        cfg = c
    ring = g.state.ring
    assert tick(cfg, grow=2 * g.window_cols * g.hop) == {
        "graph": 0, "graph_captures": 0}                       # restart
    assert g.state.ring is not ring
    assert tick(cfg) == {"graph": 0, "graph_captures": 1}
    assert tick(cfg) == {"graph": 1, "graph_captures": 0}


def test_a_patched_refresh_local_is_what_the_graph_replays(monkeypatch):
    """The graph captures the engine's call of
    ``StreamingSti.refresh_local`` through the class attribute, so a patch
    that halves ``n_med`` (the benchmark's planted half-window fault)
    changes the replayed median exactly as it changes the eager one: once
    the window is full, and at every step of its fill, where the halved
    window's span leaves the ladder (469 columns) between two of its
    rungs."""
    _card()
    x = _live_capture(60_000)
    ds = MemoryDataset(x, SR)
    cfg = SpectrogramConfig(nfft=64, ntime=20, stream_seconds=0.3, hop=32,
                            streaming=True, display_tile=True)

    def engines(ds_):
        return (LiveStreamEngine(ds_, cfg, "cuda", target_block_samples=1024),
                _eager(LiveStreamEngine(ds_, cfg, "cuda",
                                        target_block_samples=1024)))

    g, e = engines(ds)
    want_whole = _eager(LiveStreamEngine(
        ds, cfg, "cuda", target_block_samples=1024)).tick(cfg)
    refresh = StreamingSti.refresh_local

    def half(self, *a, **kw):
        kw["n_med"] = max(1, int(kw["n_med"]) // 2)
        return refresh(self, *a, **kw)

    monkeypatch.setattr(StreamingSti, "refresh_local", half)
    replays = ({"graph": 0, "graph_captures": 0},
               {"graph": 0, "graph_captures": 1},
               {"graph": 1, "graph_captures": 0})
    for want in replays:
        got, k = _counted(g, cfg)
        assert k == want
    _bit_equal(got, e.tick(cfg))
    np.testing.assert_array_equal(got.tile, want_whole.tile)
    assert np.any(got.sxx_med_dbfs != want_whole.sxx_med_dbfs)

    n = 3_000
    filling = MemoryDataset(x[:n], SR)
    g, e = engines(filling)
    spans = set()
    while g.total_cols < g.sti.ring_len:
        for want in replays:
            got, k = _counted(g, cfg)
            assert k == want
            _bit_equal(got, e.tick(cfg))
        spans.add(g.sti._span(g.sti.filled_cols(g.total_cols),
                              g.window_cols // 2, True))
        filling.append(x[n:n + 1_024])                     # one block
        filling.bnds_update()
        n += 1_024
    assert {256, 469} <= spans
