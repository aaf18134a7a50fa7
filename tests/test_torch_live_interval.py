"""The live engine's ingest between ticks (LiveStreamEngine.ingest, which a
streaming processor calls through its pacing interval) against the serial
engine, on a capture that the port's writer grows.

Blocks land before the interval, between its probes and after its last
probe. At every tick the engine that ingested between ticks gives the
view, median, times, mask, cursors and ring of the serial engine (which
ingests only in its ticks, bounds from the full listing) bit for bit;
every sample is read once, the tail from the card's carry and what was
staged (a resumed engine reads nothing before its cursor), and on noise
the view is the JAX engine's, which reads it all from the files in its
ticks; a checkpoint saved between ticks is the serial engine's for the
same pushed blocks.
The processor keeps its pause, probes inside it and stops within a probe
slice of abort(); a capture in memory keeps the serial tick.
"""

import threading
import time

import numpy as np
import pytest
import torch

from port_pairs import jax_config, jax_dataset
from pyspectrogram_tpu.runtime.live import LiveStreamEngine as JEngine
from pyspectrogram_tpu_torch.io.edge import FollowedReader
from pyspectrogram_tpu_torch.io.memory import MemoryDataset
from pyspectrogram_tpu_torch.io.reader import DigitalRFReader, RFDataset
from pyspectrogram_tpu_torch.io.synthetic import tone_signal
from pyspectrogram_tpu_torch.io.writer import DigitalRFWriter
from pyspectrogram_tpu_torch.runtime import LiveStreamEngine, processor
from pyspectrogram_tpu_torch.runtime.live import _EngineSlot
from pyspectrogram_tpu_torch.runtime.signals import ProcessorCallbacks
from pyspectrogram_tpu_torch.utils.config import SpectrogramConfig
from pyspectrogram_tpu_torch.utils.errors import TerminateReason

SR = 100_000                      # 10,000 samples a file, 100,000 a subdir
START = 1_451_661_840 * SR
F0 = 12_500.0
#: complex int16 samples ("sc16"), which the push takes raw
SC16 = np.dtype([("r", np.int16), ("i", np.int16)])


class _Listing(DigitalRFReader):
    """The full listing every call: the serial engine's bounds."""


class _Capture:
    """A capture the port's writer grows by a seeded tone plus noise, in
    complex64 or in sc16 at 2^13 to full scale."""

    def __init__(self, top, n0, dtype=np.complex64):
        self.w = DigitalRFWriter(top, "live", dtype,
                                 start_global_index=START,
                                 sample_rate_numerator=SR,
                                 file_cadence_millisecs=100,
                                 subdir_cadence_secs=1, num_subchannels=2)
        self.n = 0
        self.append(n0)

    def append(self, n):
        x = tone_signal(n, SR, [F0], start_sample=self.n).reshape(-1)
        rng = np.random.default_rng(self.n)
        x = x[:, None] * [1.0, 0.5] + 1e-3 * rng.standard_normal((n, 2))
        if self.w.user_dtype == SC16:
            x, y = np.zeros(x.shape, SC16), np.round(x * 2 ** 13)
            x["r"], x["i"] = y.real, y.imag
        self.w.rf_write(x.astype(self.w.user_dtype))
        self.n += n


def _serial(top, cfg, **kw):
    ds = RFDataset(top)
    ds.reader.__class__ = _Listing
    eng = LiveStreamEngine(ds, cfg, "cpu", **kw)
    assert not eng.follows
    return ds, eng


def _followed(top, cfg, **kw):
    ds = RFDataset(top)
    eng = LiveStreamEngine(ds, cfg, "cpu", **kw)
    assert eng.follows and isinstance(ds.reader, FollowedReader)
    return ds, eng


def _tick(ds, eng, cfg):
    ds.bnds_update()
    return eng.tick(cfg)


def _bit_equal(a, b, ea, eb, counted=True):
    """Two ticks' results and their engines' state, bit for bit
    (``counted``: and the count of samples read)."""
    for f in ("times", "frame_starts", "mask", "sxx_dbfs", "sxx_med_dbfs",
              "tile", "freqs", "plot_freqs"):
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            np.testing.assert_array_equal(x, y, err_msg=f)
    for f in ("start_sample", "next_sample", "total_cols", "_tail_pending"):
        assert getattr(ea, f) == getattr(eb, f), f
    assert ea.samples_read == eb.samples_read or not counted
    np.testing.assert_array_equal(ea.col_mask, eb.col_mask)
    np.testing.assert_array_equal(ea._carry_mask, eb._carry_mask)
    assert ea.state.total_cols == eb.state.total_cols
    assert torch.equal(ea.state.ring, eb.state.ring)
    assert torch.equal(ea.state.carry, eb.state.carry)


#: (the view's knobs, the push block's target samples)
CFGS = [
    (dict(nfft=64, ntime=1000, stream_seconds=0.4), 2048),      # contiguous
    (dict(nfft=128, ntime=40, stream_seconds=0.3, hop=48,       # overlap,
          display_tile=True, color_range_db=(-80.0, 0.0)), 2048),  # tile
    (dict(nfft=64, nint=2, ntime=16, stream_seconds=0.2, hop=16), 64),
]                                                   # the carry over a block


def _reads(ds):
    """Every (start, n) the engine reads, in order."""
    spans = []
    orig = ds.reader.read_vector_raw

    def logged(start, n, chan, **kw):
        spans.append((int(start), int(n)))
        return orig(start, n, chan, **kw)

    ds.reader.read_vector_raw = logged
    return spans


@pytest.mark.parametrize("cfg_kw,target,dtype", [
    *[pytest.param(kw, t, np.complex64, id=f"cfg_kw{i}-{t}")
      for i, (kw, t) in enumerate(CFGS)],
    pytest.param(*CFGS[2], SC16, id="sc16-64")])      # int16 staged raw
def test_ingest_between_ticks_is_the_serial_tick(tmp_path, cfg_kw, target,
                                                 dtype):
    cfg = SpectrogramConfig(streaming=True, **cfg_kw)
    caps = [_Capture(tmp_path / "a", 30_000, dtype),
            _Capture(tmp_path / "b", 30_000, dtype)]
    sds, ser = _serial(tmp_path / "a", cfg, target_block_samples=target)
    fds, fol = _followed(tmp_path / "b", cfg, target_block_samples=target)
    if target == 64:
        assert fol.carry_len > fol.block_len
    reads = _reads(fds)
    _bit_equal(_tick(sds, ser, cfg), _tick(fds, fol, cfg), ser, fol)
    # (before the interval, between its probes, after its last probe),
    # each tick's growth within a window (a larger one restarts the ring)
    plan = [(700, [300], 0),            # short of a block: the tail
            (0, [2_048, 5_000], 1_000),  # blocks in the interval, then more
            (9_999, [], 0),             # a file rollover, all in the tick
            *[(5_000, [5_000], 5_000)] * 3,
            (0, [1], 9_000),            # a subdirectory rollover
            (0, [], 0),                 # nothing new: an idle tick
            (2_048 * 3, [333, 17], 4_100)]
    for before, during, after in plan:
        for cap in caps:
            cap.append(before) if before else None
        fol.ingest()
        for n in during:
            for cap in caps:
                cap.append(n)
            fol.ingest()
            fol.ingest()                # a probe that finds nothing
        for cap in caps:
            cap.append(after) if after else None
        # whatever landed after the last probe is the tick's: it consumes
        # every complete block appended before it began
        res_s, res_f = _tick(sds, ser, cfg), _tick(fds, fol, cfg)
        _bit_equal(res_s, res_f, ser, fol)
        hi = fds.bnds["live"][1]
        assert hi + 1 - fol.next_sample < fol.block_len
    # every sample read once, in order, from the first block on (the
    # carry seed came before); the tail came from the staging, never read
    # again
    assert [s for s, _ in reads[1:]] == [s + n for s, n in reads[:-1]]
    assert reads[0][0] == fol.start_sample + fol.carry_len
    assert reads[-1][0] + reads[-1][1] == fds.bnds["live"][1] + 1


@pytest.mark.parametrize("display_tile", [False, True])
def test_staged_pushes_and_tail_match_jax_on_noise(tmp_path, display_tile):
    """On white noise (every column differs), overlapping hops: the view
    built from blocks pushed between ticks and a tail from the staging is
    the JAX engine's, which reads both from the files in its ticks."""
    rng = np.random.default_rng(5)
    w = DigitalRFWriter(tmp_path, "live", np.complex64,
                        start_global_index=START, sample_rate_numerator=SR,
                        file_cadence_millisecs=100, subdir_cadence_secs=1,
                        num_subchannels=2)

    def append(n):
        w.rf_write((rng.standard_normal((n, 2))
                    + 1j * rng.standard_normal((n, 2))).astype(np.complex64))

    append(30_000)
    cfg = SpectrogramConfig(nfft=128, ntime=1000, stream_seconds=0.1, hop=48,
                            streaming=True, display_tile=display_tile,
                            color_range_db=(-40.0, 20.0))
    fds, fol = _followed(tmp_path, cfg, target_block_samples=2048)
    jeng = JEngine(jax_dataset(fds), jax_config(cfg),
                   target_block_samples=2048)
    for before, during in [(0, []), (700, [300]), (2_000, [5_000, 33]),
                           (0, [1_111]), (4_000, [])]:
        if before:
            append(before)
        fol.ingest()
        for n in during:
            append(n)
            fol.ingest()
        jeng.ds.bnds_update()
        got, want = _tick(fds, fol, cfg), jeng.tick(jax_config(cfg))
        assert fol._tail_pending == jeng._tail_pending > 0 or not during
        np.testing.assert_array_equal(got.frame_starts, want.frame_starts)
        np.testing.assert_array_equal(got.mask, want.mask)
        if display_tile:
            d = np.abs(got.tile.astype(int) - want.tile.astype(int))
            assert d.max() <= 1 and np.count_nonzero(d) <= 1e-3 * d.size
        else:
            np.testing.assert_allclose(got.sxx_dbfs, want.sxx_dbfs,
                                       atol=1e-3, rtol=0)
        np.testing.assert_allclose(got.sxx_med_dbfs, want.sxx_med_dbfs,
                                   atol=1e-3, rtol=0)


def test_a_block_after_the_last_probe_is_the_next_ticks(tmp_path):
    cfg = SpectrogramConfig(nfft=64, ntime=1000, stream_seconds=0.2,
                            streaming=True)
    cap = _Capture(tmp_path, 30_000)
    ds, eng = _followed(tmp_path, cfg, target_block_samples=4096)
    _tick(ds, eng, cfg)
    cursor = eng.next_sample
    assert eng.ingest() == 0                      # nothing landed
    cap.append(eng.block_len)
    res = _tick(ds, eng, cfg)                     # no probe since it landed
    assert eng.next_sample == cursor + eng.block_len
    assert 0 <= START + cap.n - (res.frame_starts[-1] + 64) < 64


def test_a_backlog_is_left_to_the_tick(tmp_path):
    """More than a window behind the last tick's cursor, though not behind
    what the interval pushed since: the interval ingests no further, and
    the tick restarts the ring as the serial engine does (having read the
    blocks the interval pushed before, which the restart drops)."""
    cfg = SpectrogramConfig(nfft=64, ntime=100, stream_seconds=0.1, hop=32,
                            streaming=True)
    caps = [_Capture(tmp_path / "a", 30_000), _Capture(tmp_path / "b", 30_000)]
    sds, ser = _serial(tmp_path / "a", cfg, target_block_samples=2048)
    fds, fol = _followed(tmp_path / "b", cfg, target_block_samples=2048)
    _bit_equal(_tick(sds, ser, cfg), _tick(fds, fol, cfg), ser, fol)
    window, block = fol.window_cols * fol.hop, fol.block_len
    staged = fds.bnds["live"][1] + 1 - fol.next_sample
    for cap in caps:
        cap.append(2 * block - staged)
    assert fol.ingest() == 2
    # the growth since the last tick: a window and two blocks, more than
    # the window and a block that restarts the ring
    for cap in caps:
        cap.append(window)
    assert fol.ingest() == 0
    _bit_equal(_tick(sds, ser, cfg), _tick(fds, fol, cfg), ser, fol,
               counted=False)
    assert fol.samples_read == ser.samples_read + 2 * block


def test_a_checkpoint_between_ticks_is_the_serial_engines(tmp_path):
    cfg = SpectrogramConfig(nfft=64, ntime=16, stream_seconds=0.2, hop=32,
                            streaming=True)
    caps = [_Capture(tmp_path / "a", 30_000), _Capture(tmp_path / "b", 30_000)]
    sds, ser = _serial(tmp_path / "a", cfg, target_block_samples=2048)
    fds, fol = _followed(tmp_path / "b", cfg, target_block_samples=2048)
    _tick(sds, ser, cfg)
    _tick(fds, fol, cfg)
    for cap in caps:
        cap.append(5_000)
    assert fol.ingest() >= 2                      # mid-interval
    ck_f = fol.save(tmp_path / "f.ckpt")
    _tick(sds, ser, cfg)                          # pushes the same blocks
    ck_s = ser.save(tmp_path / "s.ckpt")
    with np.load(ck_f) as a, np.load(ck_s) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for cap in caps:
        cap.append(3_000)
    rs = _tick(sds, LiveStreamEngine.resume(sds, cfg, ck_s, "cpu"), cfg)
    res = LiveStreamEngine.resume(fds, cfg, ck_f, "cpu")
    res.ingest()
    rf = _tick(fds, res, cfg)
    for f in ("times", "mask", "sxx_dbfs", "sxx_med_dbfs"):
        np.testing.assert_array_equal(getattr(rs, f), getattr(rf, f))


def test_a_resumed_engine_reads_nothing_before_its_cursor(tmp_path):
    """After a resume the restored carry on the device serves the tail:
    ingest() and a tick with a pending tail read only from the saved
    cursor on, and match the engine that never stopped bit for bit."""
    cfg = SpectrogramConfig(nfft=128, ntime=1000, stream_seconds=0.1, hop=48,
                            streaming=True)
    cap = _Capture(tmp_path, 30_000)
    ds, eng = _followed(tmp_path, cfg, target_block_samples=2048)
    _tick(ds, eng, cfg)
    ck = eng.save(tmp_path / "s.ckpt")
    rds = RFDataset(tmp_path)
    res = LiveStreamEngine.resume(rds, cfg, ck, "cpu")
    reads, cursor = _reads(rds), res.next_sample
    cap.append(7)                   # still short of a block: no push
    eng.ingest()
    res.ingest()
    _bit_equal(_tick(ds, eng, cfg), _tick(rds, res, cfg), eng, res)
    assert res.next_sample == cursor and res._tail_pending and res.carry_len
    assert reads[0][0] == cursor
    assert [s for s, _ in reads[1:]] == [s + n for s, n in reads[:-1]]


def _streaming(top, cfg, pause, **kw):
    events = []
    proc = processor.SpectrogramProcessor(
        "streaming", top, 0, cfg,
        callbacks=ProcessorCallbacks(
            on_iterated=lambda e: events.append(time.monotonic())),
        streaming_sleep=pause, device="cpu", **kw)
    return proc, events


def test_the_pause_is_kept_and_ingested_in(tmp_path):
    """A writer thread grows the capture while a threaded streaming tab
    runs: from each delivery to the next tick's bounds refresh is at least
    the pause, and blocks are read and pushed inside the pauses."""
    cap = _Capture(tmp_path, 30_000)
    # a 1 s window (push blocks of 65,536 samples) and a writer at ~1 MS/s:
    # a block lands every ~65 ms, and a slow tick stays far from a backlog
    cfg = SpectrogramConfig(nfft=64, ntime=100, stream_seconds=1.0)
    pause = 0.03
    proc, delivered = _streaming(tmp_path, cfg, pause, max_iterations=12)
    starts = []
    update = proc.ds.bnds_update

    def observed():
        starts.append(time.monotonic())
        return update()

    proc.ds.bnds_update = observed
    ingested = []
    real = LiveStreamEngine.ingest

    def counted(eng):
        ingested.append(real(eng))
        return ingested[-1]

    stop = threading.Event()

    def write():
        while not stop.wait(0.005):
            cap.append(5_000)

    writer = threading.Thread(target=write, daemon=True)
    LiveStreamEngine.ingest = counted
    try:
        writer.start()
        proc.start()
        proc.join(60)
    finally:
        LiveStreamEngine.ingest = real
        stop.set()
        writer.join(10)
    assert proc.reason == TerminateReason.OK and len(delivered) == 12
    gaps = [b - a for a, b in zip(delivered, starts[1:])]
    assert len(gaps) == 11 and min(gaps) >= pause
    # a probe at each interval's start (then every INGEST_PROBE_S), and
    # blocks pushed in the intervals
    assert len(ingested) >= 11 and sum(ingested) > 0


def test_abort_in_an_interval_stops_within_a_probe_slice(tmp_path):
    _Capture(tmp_path, 30_000)
    cfg = SpectrogramConfig(nfft=64, ntime=100, stream_seconds=0.2)
    proc, delivered = _streaming(tmp_path, cfg, 30.0)
    proc.start()
    t_end = time.monotonic() + 60
    while not delivered and time.monotonic() < t_end:
        time.sleep(0.005)
    assert delivered and proc._live.engine.follows
    time.sleep(0.05)                              # well into the interval
    t0 = time.monotonic()
    proc.abort()
    proc.join(10)
    took = time.monotonic() - t0
    assert not proc._thread.is_alive() and proc.reason == TerminateReason.OK
    assert took < processor.INGEST_PROBE_S + 0.1


def test_a_capture_in_memory_keeps_the_serial_tick(monkeypatch):
    x = tone_signal(40_000, SR, [F0]).astype(np.complex64)
    mem = MemoryDataset(x[:30_000], SR)
    cfg = SpectrogramConfig(nfft=64, ntime=100, stream_seconds=0.2)

    def never(eng):
        raise AssertionError("ingest() on a capture in memory")

    monkeypatch.setattr(LiveStreamEngine, "ingest", never)
    proc, delivered = _streaming(mem, cfg, 0.01, max_iterations=3)
    proc.run()
    assert proc.reason == TerminateReason.OK and len(delivered) == 3
    assert not proc._live.engine.follows
    slot = _EngineSlot(mem, "cpu")
    slot.tick(cfg.replace(streaming=True))
    assert not slot.engine.follows
