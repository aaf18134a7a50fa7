"""The PyTorch port's shared refresh scheduler (CPU) against the JAX
package's: the cases of tests/test_scheduler.py but the meshed one, each
run through both schedulers over the same tab set. Counters must be equal;
payloads as in tests/test_torch_runtime.py (times exact, dB within 1e-4 dB
on bins within 60 dB of each column's peak, tiles within one level on <=
0.1% of pixels). Each side's processors get that package's own config
(port_pairs) and open the captures with its own reader."""

import time

import numpy as np
import pytest

from port_pairs import jax_config
from pyspectrogram_tpu.io.synthetic import tone_signal
from pyspectrogram_tpu.io.writer import DigitalRFWriter
from pyspectrogram_tpu.models import batch as jbatch
from pyspectrogram_tpu.runtime import processor as jprocessor
from pyspectrogram_tpu.runtime import scheduler as jscheduler
from pyspectrogram_tpu.runtime import signals as jsignals
from pyspectrogram_tpu_torch.models import batch, sti
from pyspectrogram_tpu_torch.runtime import processor, scheduler, signals
from pyspectrogram_tpu_torch.utils.config import SpectrogramConfig
from pyspectrogram_tpu_torch.utils.errors import TerminateReason
from test_torch_runtime import assert_iterated_match

CFG = SpectrogramConfig(nfft=256, nint=1, ntime=16)

#: (processor, scheduler, signals, device kwargs, the side's config from
#: a port config)
PORT = (processor.SpectrogramProcessor, scheduler.SharedRefreshScheduler,
        signals, {"device": "cpu"}, lambda cfg: cfg)
JAX = (jprocessor.SpectrogramProcessor, jscheduler.SharedRefreshScheduler,
       jsignals, {}, jax_config)


def _tabs(side, top, cfgs, sched=None, callbacks=None, **kw):
    """Processors registered with one scheduler (no per-tab threads);
    returns (scheduler, [(processor, events)])."""
    make, make_sched, sig, dev, side_cfg = side
    sched = sched or make_sched(autostart=False)
    tabs = []
    for i, cfg in enumerate(cfgs):
        seen = {"iterated": [], "stats": [], "terminated": []}
        cbs = (callbacks(sig, i) if callbacks else None) or \
            sig.ProcessorCallbacks(on_iterated=seen["iterated"].append,
                                   on_stats=seen["stats"].append,
                                   on_terminated=seen["terminated"].append)
        p = make("written", top, i, side_cfg(cfg), callbacks=cbs,
                 scheduler=sched, **kw, **dev)
        assert p.is_running
        p.start()
        assert p._thread is None
        tabs.append((p, seen))
    return sched, tabs


def _counters(s):
    return (s.ticks, s.merged_launches, s.merged_requests, s.solo_launches)


def _both(top, cfgs, ticks=1, between=None, **kw):
    """Run the same tabs through both schedulers; returns (port, jax) as
    (scheduler, tabs) after ``ticks`` cycles (``between(side, tabs, k)``
    after cycle k)."""
    out = []
    for side in (PORT, JAX):
        sched, tabs = _tabs(side, top, cfgs, **kw)
        for k in range(ticks):
            sched.tick_once()
            if between:
                between(side, tabs, k)
        out.append((sched, tabs))
    (s, tabs), (js, jtabs) = out
    assert _counters(s) == _counters(js)
    for (p, seen), (jp, jseen) in zip(tabs, jtabs):
        assert_iterated_match(seen["iterated"], jseen["iterated"])
        assert len(seen["stats"]) == len(jseen["stats"])
        assert [t.reason for t in seen["terminated"]] == [
            t.reason for t in jseen["terminated"]]
        assert p.skipped_recomputes == jp.skipped_recomputes
    return out


def _abort(*runs):
    for _, tabs in runs:
        for p, _ in tabs:
            if p.is_running:
                p.abort()


def test_merged_launch_and_delta_skip(tone_capture):
    """Three same-shape tabs: ONE merged launch; a second cycle on a
    static capture re-emits and launches nothing."""
    top, _ = tone_capture
    port, jax_ = _both(top, [CFG] * 3, ticks=2)
    s, tabs = port
    assert _counters(s) == (2, 1, 3, 0)
    for p, seen in tabs:
        assert p.skipped_recomputes == 1
        assert [e.i for e in seen["iterated"]] == [0, 1]
    # the merged payload equals a standalone pipeline's
    want = sti.StiPipeline(tabs[0][0].ds, CFG, device="cpu").compute()
    got = tabs[0][1]["iterated"][0]
    np.testing.assert_array_equal(got.times, want.times)
    np.testing.assert_allclose(got.sxx_dbfs, want.sxx_dbfs, atol=1e-4)
    _abort(port, jax_)


@pytest.mark.parametrize("ntime", [16, 40])
def test_tile_mode_merges_colour_ranges(tone_capture, ntime):
    """Display-tile tabs with different colour ranges merge into one
    launch; each tile equals its tab's solo request."""
    top, _ = tone_capture
    base = CFG.replace(display_tile=True, ntime=ntime)
    cfgs = [base.replace(color_range_db=(-110.0 - i, -40.0))
            for i in range(3)]
    port, jax_ = _both(top, cfgs)
    s, tabs = port
    assert _counters(s) == (1, 1, 3, 0)
    for (p, seen), cfg in zip(tabs, cfgs):
        want = sti.StiPipeline(p.ds, cfg, device="cpu").compute()
        np.testing.assert_array_equal(seen["iterated"][0].tile, want.tile)
        np.testing.assert_array_equal(seen["iterated"][0].sxx_med_dbfs,
                                      want.sxx_med_dbfs)
    _abort(port, jax_)


def test_shape_mismatch_falls_back_to_solo(tone_capture):
    top, _ = tone_capture
    port, jax_ = _both(top, [CFG, CFG, CFG.replace(nfft=512)])
    assert _counters(port[0]) == (1, 1, 2, 1)
    assert port[1][2][1]["iterated"][0].freqs.shape == (512,)
    _abort(port, jax_)


def test_subchannel_entries_merge(tone_capture):
    top, meta = tone_capture
    chan = meta["channel"]
    port, jax_ = _both(top, [CFG.replace(channel=f"{chan}:{i}")
                             for i in (0, 1)])
    assert _counters(port[0]) == (1, 1, 2, 0)
    for _, seen in port[1]:
        assert seen["iterated"][0].sxx_dbfs.shape[-1] == 1
    _abort(port, jax_)


def test_settings_change_recomputes_and_regroups(tone_capture):
    top, _ = tone_capture

    def flip(side, tabs, k):
        if k == 0:
            tabs[0][0].update_settings(nfft=512)

    port, jax_ = _both(top, [CFG, CFG], ticks=2, between=flip)
    assert _counters(port[0]) == (2, 1, 2, 1)
    assert port[1][1][0].skipped_recomputes == 1
    assert port[1][0][1]["iterated"][-1].freqs.shape == (512,)
    _abort(port, jax_)


def test_abort_unregisters_and_stops_emission(tone_capture):
    top, _ = tone_capture

    def stop(side, tabs, k):
        tabs[k][0].abort()

    port, jax_ = _both(top, [CFG, CFG], ticks=2, between=stop)
    s, tabs = port
    assert [len(seen["iterated"]) for _, seen in tabs] == [1, 2]
    assert [t.reason for t in tabs[0][1]["terminated"]] == [
        TerminateReason.OK]
    s.tick_once()
    with s._lock:
        assert s._procs == []


def test_max_iterations_terminates(tone_capture):
    top, _ = tone_capture
    port, jax_ = _both(top, [CFG], ticks=3, max_iterations=2)
    p, seen = port[1][0]
    assert not p.is_running and p.reason == TerminateReason.OK
    assert len(seen["iterated"]) == 2 and len(seen["terminated"]) == 1


def test_growing_capture_recomputes(tmp_path):
    """Bounds growth changes the resolved span: the cycle recomputes
    instead of skipping, in both schedulers."""
    sr, block = 100_000, 1 << 14
    runs = []
    for side, sub in ((PORT, "a"), (JAX, "b")):
        w = DigitalRFWriter(tmp_path / sub, "g0", np.complex64,
                            start_global_index=1_451_661_840 * sr,
                            sample_rate_numerator=sr,
                            file_cadence_millisecs=100, subdir_cadence_secs=1)
        w.rf_write(tone_signal(block, sr, [12_500.0]).astype(np.complex64))
        sched, tabs = _tabs(side, tmp_path / sub,
                            [SpectrogramConfig(nfft=128, nint=1, ntime=8)])
        sched.tick_once()
        w.rf_write(tone_signal(block, sr, [12_500.0], start_sample=block)
                   .astype(np.complex64))
        sched.tick_once()
        runs.append((sched, tabs))
    (s, tabs), (js, jtabs) = runs
    assert _counters(s) == _counters(js) == (2, 0, 0, 2)
    assert tabs[0][0].skipped_recomputes == 0
    ev = tabs[0][1]["iterated"]
    assert ev[1].times[-1] > ev[0].times[-1]
    assert_iterated_match(ev, jtabs[0][1]["iterated"])
    _abort(*runs)


def test_merged_failure_falls_back_to_solo(tone_capture, monkeypatch):
    top, _ = tone_capture

    class Boom(batch.BatchedStiPipeline):
        def compute(self, *args, **kw):
            raise RuntimeError("merged boom")

    class JBoom(jbatch.BatchedStiPipeline):
        def compute(self, *args, **kw):
            raise RuntimeError("merged boom")

    monkeypatch.setattr(batch, "BatchedStiPipeline", Boom)
    monkeypatch.setattr(jbatch, "BatchedStiPipeline", JBoom)
    port, jax_ = _both(top, [CFG, CFG])
    assert _counters(port[0]) == (1, 0, 0, 2)
    for p, seen in port[1]:
        assert p.is_running and seen["iterated"][0].sxx_dbfs is not None
    _abort(port, jax_)


def test_one_broken_member_terminates_only_its_tab(tone_capture,
                                                   monkeypatch):
    top, _ = tone_capture
    runs = []
    for side in (PORT, JAX):
        sched, tabs = _tabs(side, top, [CFG, CFG])

        def boom(*args, **kw):
            raise OSError("disk pulled")

        monkeypatch.setattr(tabs[1][0].ds.reader, "read_vector_raw", boom)
        sched.tick_once()
        sched.tick_once()
        runs.append((sched, tabs))
    (s, tabs), (js, jtabs) = runs
    assert _counters(s) == _counters(js)
    (a, aseen), (b, bseen) = tabs
    assert a.is_running and len(aseen["iterated"]) == 2
    assert b.reason == jtabs[1][0].reason == TerminateReason.LOOP_EXCEPTION
    assert len(bseen["terminated"]) == 1
    _abort(*runs)


def test_double_raising_callbacks_cost_only_their_tab(tone_capture):
    top, _ = tone_capture

    def boom(_payload):
        raise RuntimeError("widget torn down")

    def callbacks(sig, i):
        if i == 0:
            return sig.ProcessorCallbacks(on_iterated=boom,
                                          on_terminated=boom)
        return None

    port, jax_ = _both(top, [CFG, CFG], ticks=2, callbacks=callbacks)
    s, tabs = port
    broken, (healthy, seen) = tabs[0][0], tabs[1]
    assert broken.reason == TerminateReason.LOOP_EXCEPTION
    assert broken not in s._procs
    assert len(seen["iterated"]) == 2 and len(seen["stats"]) == 2
    _abort(port, jax_)


def test_autostart_thread_delivers_and_drains(tone_capture):
    top, _ = tone_capture
    sched = scheduler.SharedRefreshScheduler(refresh_s=0.02)
    _, [(p, seen)] = _tabs(PORT, top, [CFG], sched=sched)
    t0 = time.time()
    while time.time() - t0 < 30 and len(seen["iterated"]) < 2:
        time.sleep(0.02)
    assert len(seen["iterated"]) >= 2 and p.skipped_recomputes >= 1
    p.abort()
    p.join(5)
    sched.stop()
    assert not sched._thread.is_alive()


def test_group_key_separates_devices(tone_capture):
    """Tabs on different devices never share a launch (the key's mesh
    branch has no counterpart in the port; the device takes its place)."""
    top, _ = tone_capture
    _, [(p, _)] = _tabs(PORT, top, [CFG])
    key = scheduler.SharedRefreshScheduler._group_key(p, p.config)
    assert p.pipeline.device in key
    p.pipeline.device = "meta"
    assert scheduler.SharedRefreshScheduler._group_key(p, p.config) != key
    p.abort()
