"""The PyTorch port's processor loop, signals and profiling (CPU) against
the JAX package's, on the same Digital RF captures.

Each case runs the port's SpectrogramProcessor and the JAX one over the
same capture and compares what their callbacks received: the Iterated
payloads (times, frame axes and masks exact; dB within 1e-4 dB on bins
within 60 dB of each column's peak; uint8 tiles within one level on <=
0.1% of pixels), the StatsUpdated echoes (equal) and the Terminated codes
(equal).
"""

import dataclasses
import json
import threading
import time

import numpy as np
import pytest
import torch

from pyspectrogram_tpu.io.reader import RFDataset
from pyspectrogram_tpu.io.synthetic import tone_signal
from pyspectrogram_tpu.io.writer import DigitalRFWriter
from pyspectrogram_tpu.runtime import processor as jprocessor
from pyspectrogram_tpu.runtime import signals as jsignals
from pyspectrogram_tpu.utils.config import SpectrogramConfig
from pyspectrogram_tpu.utils.errors import TerminateReason
from pyspectrogram_tpu_torch.io.memory import MemoryDataset
from pyspectrogram_tpu_torch.runtime import processor, signals
from pyspectrogram_tpu_torch.utils import profiling

SR = 100_000
START = 1_451_661_840 * SR
F0 = 12_500.0


def _collector(mod):
    events = {"iterated": [], "stats": [], "terminated": []}
    cb = mod.ProcessorCallbacks(
        on_iterated=events["iterated"].append,
        on_stats=events["stats"].append,
        on_terminated=events["terminated"].append,
    )
    return events, cb


def _pair(datasource, top, cfg, tab_id=3, jtop=None, **kw):
    """(port processor, its events, JAX processor, its events)."""
    ev, cb = _collector(signals)
    p = processor.SpectrogramProcessor(datasource, top, tab_id, cfg,
                                       callbacks=cb, device="cpu", **kw)
    jev, jcb = _collector(jsignals)
    jp = jprocessor.SpectrogramProcessor(datasource, top if jtop is None
                                         else jtop, tab_id, cfg,
                                         callbacks=jcb, **kw)
    return p, ev, jp, jev


def _db_close(got, want, floor_db=60.0, atol=1e-4):
    keep = want >= want.max(axis=0, keepdims=True) - floor_db
    np.testing.assert_allclose(got[keep], want[keep], atol=atol, rtol=0)


def assert_iterated_match(got, want):
    assert [e.i for e in got] == [e.i for e in want]
    for g, w in zip(got, want):
        assert g.tab_id == w.tab_id
        for f in ("times", "freqs", "mask", "plot_freqs"):
            np.testing.assert_array_equal(getattr(g, f), getattr(w, f))
        _db_close(g.sxx_med_dbfs, w.sxx_med_dbfs)
        if w.tile is None:
            assert g.tile is None
            _db_close(g.sxx_dbfs, w.sxx_dbfs)
        else:
            assert g.sxx_dbfs is None and w.sxx_dbfs is None
            d = np.abs(g.tile.astype(int) - w.tile.astype(int))
            assert g.tile.dtype == np.uint8 and d.max() <= 1
            assert np.count_nonzero(d) <= 1e-3 * d.size


@pytest.mark.parametrize("name", ["Iterated", "StatsUpdated", "Terminated",
                                  "ProcessorCallbacks"])
def test_signals_copy_matches_jax(name):
    """The port's payload classes carry the original's fields, in its
    order, with its defaults and frozenness."""
    a, b = getattr(signals, name), getattr(jsignals, name)
    fa = [(f.name, f.default, str(f.type)) for f in dataclasses.fields(a)]
    fb = [(f.name, f.default, str(f.type)) for f in dataclasses.fields(b)]
    assert fa == fb
    assert a.__dataclass_params__.frozen == b.__dataclass_params__.frozen


@pytest.mark.parametrize("tile", [False, True])
@pytest.mark.parametrize("ntime", [16, 40])
def test_written_loop_matches_jax(tone_capture, ntime, tile):
    """Three written iterations on a static capture: one compute, two
    delta skips; payloads and stats echoes equal to the JAX loop's."""
    top, _ = tone_capture
    cfg = SpectrogramConfig(nfft=256, ntime=ntime, display_tile=tile,
                            color_range_db=(-110.0, -40.0))
    p, ev, jp, jev = _pair("written", top, cfg, written_sleep=0.0,
                           max_iterations=3)
    assert p.chan_listing == jp.chan_listing
    assert p.sub_chan_list == jp.sub_chan_list
    p.run()
    jp.run()
    assert p.skipped_recomputes == jp.skipped_recomputes == 2
    assert_iterated_match(ev["iterated"], jev["iterated"])
    assert ev["stats"] == [signals.StatsUpdated(**dataclasses.asdict(s))
                           for s in jev["stats"]]
    assert [t.reason for t in ev["terminated"]] == [TerminateReason.OK]
    assert [t.reason for t in jev["terminated"]] == [TerminateReason.OK]
    stats = p.latency_stats()
    assert stats["n"] == 3 and set(stats) == set(jp.latency_stats())


def test_settings_update_and_channel_select_match_jax(tone_capture):
    """update_settings mid-run (from the consumer side) and a channel
    selection reach the next iteration, through the skip cache, in both
    packages alike."""
    top, meta = tone_capture
    cfg = SpectrogramConfig(nfft=256, ntime=8)
    p, ev, jp, jev = _pair("written", top, cfg, written_sleep=0.0,
                           max_iterations=4)
    for proc, events in ((p, ev), (jp, jev)):
        def flip(e, proc=proc, events=events):
            events["iterated"].append(e)
            if e.i == 1:
                proc.update_settings(nfft=512, ntime=5, bnd_end=None)
            if e.i == 2:
                proc.select_channel(f"{meta['channel']}:1")
        proc.callbacks.on_iterated = flip
        proc.run()
    assert [e.sxx_dbfs.shape for e in ev["iterated"]] == [
        (256, 8, 2), (256, 8, 2), (512, 5, 2), (512, 5, 1)]
    assert_iterated_match(ev["iterated"], jev["iterated"])
    assert [s.nfft for s in ev["stats"]] == [s.nfft for s in jev["stats"]]
    assert p.skipped_recomputes == jp.skipped_recomputes == 1


def test_terminate_missing_path():
    p, ev, jp, jev = _pair("written", "/nonexistent/drf",
                           SpectrogramConfig())
    for proc in (p, jp):
        assert not proc.is_running
        proc.run()                       # returns at once
        proc.update_settings(nfft=256)   # fails soft
    assert ev["terminated"] == [signals.Terminated(
        3, TerminateReason.MISSING_PATH)]
    assert jev["terminated"][0].reason == TerminateReason.MISSING_PATH
    assert p.latencies_s.maxlen == jp.latencies_s.maxlen


def test_terminate_init_failure(tmp_path):
    bad = tmp_path / "empty"
    bad.mkdir()
    p, ev, jp, jev = _pair("written", bad, SpectrogramConfig())
    (t,), (jt,) = ev["terminated"], jev["terminated"]
    assert t.reason == jt.reason == TerminateReason.LOOP_EXCEPTION
    assert t.detail == jt.detail
    assert "Failed to open the dataset" in t.detail


def test_terminate_loop_exception(tone_capture, capsys):
    top, _ = tone_capture
    p, ev, jp, jev = _pair("written", top, SpectrogramConfig(nfft=256),
                           written_sleep=0.0)
    for proc in (p, jp):
        proc.pipeline.compute = lambda *a, **k: (_ for _ in ()).throw(
            OSError("disk pulled"))
        proc.run()
    assert [t.reason for t in ev["terminated"]] == [
        t.reason for t in jev["terminated"]] == [
        TerminateReason.LOOP_EXCEPTION]
    assert "disk pulled" in capsys.readouterr().err


def test_terminate_raising_callback(tone_capture, capsys):
    """A raising on_iterated ends the loop with code 4, and a raising
    on_terminated does not swallow the root cause."""
    top, _ = tone_capture

    def boom(_payload):
        raise RuntimeError("widget torn down")

    codes = []
    for mod, make in ((signals, processor.SpectrogramProcessor),
                      (jsignals, jprocessor.SpectrogramProcessor)):
        kw = {"device": "cpu"} if mod is signals else {}
        proc = make("written", top, 0, SpectrogramConfig(nfft=256),
                    callbacks=mod.ProcessorCallbacks(on_iterated=boom,
                                                     on_terminated=boom),
                    written_sleep=0.0, max_iterations=3, **kw)
        proc.run()                       # must not raise
        codes.append(proc.reason)
    assert codes == [TerminateReason.LOOP_EXCEPTION] * 2
    assert "widget torn down" in capsys.readouterr().err


def test_stop_mid_compute_drops_only_later_frames(tone_capture):
    """Stop inside the first compute still delivers that frame; stop
    inside the second drops the stale one (JAX's rule)."""
    top, _ = tone_capture
    cfg = SpectrogramConfig(nfft=256, ntime=8)
    delivered = []
    for abort_at in (1, 2):
        ev, cb = _collector(signals)
        proc = processor.SpectrogramProcessor("written", top, 0, cfg,
                                              callbacks=cb, device="cpu")
        orig, calls = proc.pipeline.compute, []
        proc.pipeline.request_key = lambda c: len(calls)

        def compute(c, **kw):
            res = orig(c, **kw)
            calls.append(1)
            if len(calls) == abort_at:
                proc.abort()
            return res

        proc.pipeline.compute = compute
        proc.run()
        delivered.append(len(ev["iterated"]))
    assert delivered == [1, 1]


def test_thread_start_abort_join(tone_capture):
    top, _ = tone_capture
    ev, cb = _collector(signals)
    proc = processor.SpectrogramProcessor(
        "written", top, 4, SpectrogramConfig(nfft=256, ntime=8),
        callbacks=cb, written_sleep=0.01, device="cpu").start()
    deadline = time.time() + 20
    while not ev["iterated"] and time.time() < deadline:
        time.sleep(0.01)
    proc.abort()
    proc.join(10)
    assert not proc._thread.is_alive()
    assert ev["iterated"] and ev["terminated"][-1].reason == TerminateReason.OK


def _writer(path):
    w = DigitalRFWriter(path, "live", np.complex64, start_global_index=START,
                        sample_rate_numerator=SR, file_cadence_millisecs=100,
                        subdir_cadence_secs=1)
    w.rf_write(tone_signal(20_000, SR, [F0]).astype(np.complex64))
    return w


def test_streaming_chases_growing_capture(tmp_path):
    """Two copies of one capture, each grown by the same block after every
    iteration: the port's streaming loop and JAX's deliver the same
    frames, each chasing the new tail."""
    tops = [tmp_path / "a", tmp_path / "b"]
    writers = [_writer(t) for t in tops]
    cfg = SpectrogramConfig(nfft=256, ntime=16, stream_seconds=0.05,
                            display_tile=True, color_range_db=(-80.0, 0.0))
    p, ev, jp, jev = _pair("streaming", tops[0], cfg, jtop=tops[1],
                           streaming_sleep=0.0, max_iterations=4)
    for proc, events, w in ((p, ev, writers[0]), (jp, jev, writers[1])):
        grown = [20_000]

        def grow(e, events=events, w=w, grown=grown):
            events["iterated"].append(e)
            w.rf_write(tone_signal(3_000, SR, [F0], start_sample=grown[0])
                       .astype(np.complex64))
            grown[0] += 3_000

        proc.callbacks.on_iterated = grow
        proc.run()
    assert len(ev["iterated"]) == 4
    assert_iterated_match(ev["iterated"], jev["iterated"])
    ends = [e.times[-1] for e in ev["iterated"]]
    assert all(b > a for a, b in zip(ends, ends[1:]))
    assert p.has_live_state and p._live.engine.samples_read == \
        jp._live.engine.samples_read


def test_live_state_crosses_packages(tone_capture, tmp_path):
    """save_live_state of either package seeds the other's streaming
    processor (preload_live_state): the resumed loop continues the saved
    stream and delivers what the saving loop delivered."""
    top, _ = tone_capture
    cfg = SpectrogramConfig(nfft=256, ntime=8, stream_seconds=0.01)
    p, ev, jp, jev = _pair("streaming", top, cfg, streaming_sleep=0.0,
                           max_iterations=1)
    p.run()
    jp.run()
    ck = p.save_live_state(tmp_path / "port.npz")
    jck = jp.save_live_state(tmp_path / "jax.npz")
    q, qev, jq, jqev = _pair("streaming", top, cfg, streaming_sleep=0.0,
                             max_iterations=1)
    q.preload_live_state(jck)
    jq.preload_live_state(ck)
    q.run()
    jq.run()
    assert q._live.engine.samples_read == p._live.engine.samples_read
    assert_iterated_match(qev["iterated"], jev["iterated"])
    assert_iterated_match(ev["iterated"], jqev["iterated"])


def test_live_state_guards(tone_capture, tmp_path):
    top, _ = tone_capture
    cfg = SpectrogramConfig(nfft=256, ntime=8)
    bad = processor.SpectrogramProcessor("streaming", "/nonexistent-dir", 0,
                                         cfg, device="cpu")
    assert not bad.has_live_state
    with pytest.raises(ValueError, match="no live engine"):
        bad.save_live_state(tmp_path / "x.npz")
    with pytest.raises(ValueError, match="streaming mode"):
        bad.preload_live_state(tmp_path / "x.npz")
    written = processor.SpectrogramProcessor("written", top, 0, cfg,
                                             device="cpu")
    with pytest.raises(ValueError, match="no live engine"):
        written.save_live_state(tmp_path / "x.npz")


def test_opened_dataset_and_device(tone_capture):
    """drfdir may be an opened RFDataset (the in-memory capture); a CUDA
    device on a machine without one raises instead of terminating."""
    ds = RFDataset(tone_capture[0])
    chan = ds.channels[0]
    lo, hi = ds.bnds[chan]
    mem = MemoryDataset(ds.reader.read_vector_raw(lo, hi - lo + 1, chan),
                        ds.sr_dict[chan], channel=chan, start=lo)
    cfg = SpectrogramConfig(nfft=256, ntime=8)
    aev, acb = _collector(signals)
    a = processor.SpectrogramProcessor("written", mem, 0, cfg, callbacks=acb,
                                       device="cpu", max_iterations=1)
    bev, bcb = _collector(signals)
    b = processor.SpectrogramProcessor("written", tone_capture[0], 0, cfg,
                                       callbacks=bcb, device="cpu",
                                       max_iterations=1)
    assert a.ds is mem
    a.run()
    b.run()
    ga, gb = aev["iterated"][0], bev["iterated"][0]
    for f in ("times", "sxx_dbfs", "sxx_med_dbfs", "mask"):
        np.testing.assert_array_equal(getattr(ga, f), getattr(gb, f))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            processor.SpectrogramProcessor("written", mem, 0, cfg,
                                           device="cuda")


def test_capture_grown_by_a_thread_while_a_processor_reads(tmp_path):
    """A writer thread appends to an in-memory capture while a threaded
    streaming processor ticks over it: every tick delivers a full,
    gap-free view of the tone at its frequency."""
    n0, blk = 40_000, 1_000
    x = tone_signal(n0 + 400 * blk, SR, [F0]).astype(np.complex64)
    mem = MemoryDataset(x[:n0], SR)
    stop = threading.Event()

    def write():
        pos = n0
        while not stop.is_set() and pos + blk <= len(x):
            mem.append(x[pos:pos + blk])
            pos += blk
            time.sleep(0.0005)

    events = []
    cfg = SpectrogramConfig(nfft=256, ntime=16, stream_seconds=0.1)
    proc = processor.SpectrogramProcessor(
        "streaming", mem, 0, cfg,
        callbacks=signals.ProcessorCallbacks(on_iterated=events.append),
        streaming_sleep=0.001, max_iterations=30, device="cpu")
    writer = threading.Thread(target=write, daemon=True)
    writer.start()
    proc.start()
    proc.join(60)
    stop.set()
    writer.join(10)
    assert not proc._thread.is_alive() and not writer.is_alive()
    assert proc.reason == TerminateReason.OK and len(events) == 30
    for e in events:
        med = e.sxx_med_dbfs[:, 0]
        assert e.mask.all() and abs(e.freqs[med.argmax()] - F0) <= SR / 256
    assert events[-1].times[-1] > events[0].times[-1]


def test_stage_timer_stats():
    t = profiling.StageTimer()
    for _ in range(3):
        with t.stage("read"):
            time.sleep(0.001)
    t.record("copy", 0.5)
    s = t.stats()
    assert s["read"]["n"] == 3 and s["read"]["p50_s"] >= 0.001
    assert t.stats("copy") == {"n": 1, "p50_s": 0.5, "p99_s": 0.5,
                               "mean_s": 0.5, "total_s": 0.5}
    assert t.stats("none") == {"n": 0}
    t.reset()
    assert t.stats() == {}


def test_global_timer_is_one_process_wide_timer():
    """utils.profiling.GLOBAL_TIMER: one StageTimer per process, as in the
    JAX module, that callers record their own stages into."""
    from pyspectrogram_tpu.utils import profiling as jprofiling
    from pyspectrogram_tpu_torch.utils.profiling import GLOBAL_TIMER

    assert GLOBAL_TIMER is profiling.GLOBAL_TIMER
    assert isinstance(GLOBAL_TIMER, profiling.StageTimer)
    assert GLOBAL_TIMER is not jprofiling.GLOBAL_TIMER
    jax_before = jprofiling.GLOBAL_TIMER.stats()
    GLOBAL_TIMER.reset()
    try:
        with GLOBAL_TIMER.stage("io"):
            pass
        GLOBAL_TIMER.record("io", 0.25)
        assert GLOBAL_TIMER.stats("io")["n"] == 2
        assert jprofiling.GLOBAL_TIMER.stats() == jax_before
    finally:
        GLOBAL_TIMER.reset()
    assert GLOBAL_TIMER.stats() == {}


def test_device_trace_writes_a_chrome_trace(tmp_path):
    """device_trace records the stages on the CPU too; the busy share of
    a span with no device activity is 0."""
    t = profiling.StageTimer()
    with profiling.device_trace(tmp_path / "prof") as prof:
        with t.stage("cycle"):
            torch.fft.fft(torch.ones(1024, dtype=torch.complex64)).abs().sum()
    assert prof.trace_path.is_file()
    names = {e.get("name") for e in
             json.loads(prof.trace_path.read_text())["traceEvents"]}
    assert "cycle" in names
    share = profiling.device_busy_share(prof.trace_path, "cycle")
    assert share["device_events"] == 0 and share["busy_share"] == 0.0
    with pytest.raises(ValueError, match="no 'nope' range"):
        profiling.device_busy_share(prof.trace_path, "nope")


def test_device_busy_share_unions_overlaps(tmp_path):
    """Overlapping and clipped device events count once, inside the span
    only."""
    ev = [{"cat": "user_annotation", "name": "cycle", "ts": 100, "dur": 100},
          {"cat": "kernel", "name": "k", "ts": 90, "dur": 20},     # 100-110
          {"cat": "kernel", "name": "k", "ts": 105, "dur": 10},    # in 100-115
          {"cat": "gpu_memcpy", "name": "c", "ts": 150, "dur": 10},
          {"cat": "gpu_memset", "name": "s", "ts": 195, "dur": 30},  # 195-200
          {"cat": "cpu_op", "name": "x", "ts": 120, "dur": 50}]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    share = profiling.device_busy_share(path, "cycle")
    assert share["device_events"] == 4
    assert share["device_busy_ms"] == pytest.approx((15 + 10 + 5) / 1e3)
    assert share["busy_share"] == pytest.approx(0.30)


def test_launch_counter_is_thread_safe():
    """Processors on several threads count launches of the same kernel:
    no update is lost (16 threads, a switch interval of 1 us)."""
    import sys

    from pyspectrogram_tpu_torch.kernels import _build

    def fn():
        pass

    fn.launches = 0
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [_build.count(fn) for _ in range(2000)])
            for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert fn.launches == 16 * 2000
