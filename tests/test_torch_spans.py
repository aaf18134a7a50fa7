"""The port's span recorder (utils.profiling) and the spans of a live tab's
loop, on the CPU.

Recording is off unless ``tracing(True)`` was called or a torch.profiler
profile is active; off, a span site allocates nothing and opens no
``record_function``. On, spans nest through a per-thread stack (parent,
inherited unit), counts land on the innermost open span, and finished
spans go into a bounded ring. A streaming SpectrogramProcessor gives each
tick ``processor.tick`` holding ``io.bounds``, ``live.push`` (with its
``live.read``), ``live.refresh`` and ``live.readback``, then
``processor.wait``; on the card its ``live.refresh`` counts the replays
and captures of the refresh's CUDA graph.
"""

import itertools
import sys
import threading
import time
import tracemalloc

import numpy as np
import pytest
import torch

from pyspectrogram_tpu_torch.io.reader import RFDataset
from pyspectrogram_tpu_torch.io.synthetic import tone_signal
from pyspectrogram_tpu_torch.io.writer import DigitalRFWriter
from pyspectrogram_tpu_torch.runtime import processor, signals
from pyspectrogram_tpu_torch.utils import profiling
from pyspectrogram_tpu_torch.utils.config import SpectrogramConfig
from pyspectrogram_tpu_torch.utils.errors import TerminateReason

SR = 100_000
START = 1_451_661_840 * SR
F0 = 12_500.0


@pytest.fixture
def recorder():
    """A clean process-wide recorder, with recording off afterwards."""
    profiling.reset()
    was = profiling.tracing(False)
    yield profiling
    profiling.tracing(was)
    profiling.reset()


def _by(spans, name):
    return [s for s in spans if s.name == name]


@profiling.spanned("site.decorated")
def _decorated():
    pass


def _span_sites(n):
    for _ in itertools.repeat(None, n):
        with profiling.span("site.block"):
            profiling.count("k", 1)
            profiling.current()
            _decorated()


def test_off_records_nothing_allocates_nothing_and_opens_no_range(
        recorder, monkeypatch):
    def no_range(name):
        raise AssertionError(f"record_function({name!r}) opened while off")

    monkeypatch.setattr(profiling, "record_function", no_range)
    # one shared no-op context, whatever the name
    assert profiling.span("a") is profiling.span("b", (1, 2))
    assert profiling.current() is None
    _span_sites(10)
    tracemalloc.start()
    try:
        before = tracemalloc.get_traced_memory()[0]
        _span_sites(2000)
        off = tracemalloc.get_traced_memory()[0] - before
        monkeypatch.undo()
        profiling.tracing(True)
        before = tracemalloc.get_traced_memory()[0]
        _span_sites(2000)
        on = tracemalloc.get_traced_memory()[0] - before
    finally:
        tracemalloc.stop()
    assert off == 0
    assert on > 0           # the measurement sees what recording allocates
    assert len(_by(profiling.spans(), "site.block")) == 2000


def test_a_profile_entered_later_records_a_running_thread(recorder):
    """torch.profiler entered on the main thread after a worker thread has
    started (the benchmark's traced run): the worker's spans are recorded
    while the profile is active, and none that opened after it."""
    stop = threading.Event()
    ticks = []

    def work():
        i = 0
        while not stop.is_set():
            with profiling.span("worker.tick", (7, i)):
                with profiling.span("worker.part"):
                    time.sleep(0.001)
            ticks.append(i)
            i += 1

    t = threading.Thread(target=work, daemon=True)
    t.start()
    try:
        deadline = time.monotonic() + 20
        while len(ticks) < 3 and time.monotonic() < deadline:
            time.sleep(0.001)
        assert profiling.spans() == []          # off before the profile
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU]):
            assert profiling.span("a") is not profiling.span("b")
            seen = len(ticks)
            while len(ticks) < seen + 5 and time.monotonic() < deadline:
                time.sleep(0.001)
        ended = time.monotonic_ns()
        assert profiling.span("a") is profiling.span("b")
    finally:
        stop.set()
        t.join(10)
    assert not t.is_alive()
    mine = [s for s in profiling.spans() if s.thread == t.ident]
    assert len(_by(mine, "worker.tick")) >= 3
    assert all(s.t0_ns < ended for s in mine)
    for part in _by(mine, "worker.part"):
        if part.parent is not None:
            parent = next(s for s in mine if s.id == part.parent)
            assert parent.name == "worker.tick" and part.unit == parent.unit


def test_spans_nest_with_parents_units_and_self_times(recorder):
    profiling.tracing(True)
    with profiling.span("a", (3, 9)):
        time.sleep(0.002)
        with profiling.span("b"):
            time.sleep(0.002)
            with profiling.span("c", (4, 0)):
                time.sleep(0.001)
        with profiling.span("b"):
            time.sleep(0.001)
    with profiling.span("d"):
        pass
    spans = {s.id: s for s in profiling.spans()}
    a, = _by(spans.values(), "a")
    b1, b2 = _by(spans.values(), "b")
    c, = _by(spans.values(), "c")
    d, = _by(spans.values(), "d")
    assert (a.parent, b1.parent, b2.parent, c.parent, d.parent) == (
        None, a.id, a.id, b1.id, None)
    # a child takes its parent's unit unless it names its own
    assert (a.unit, b1.unit, b2.unit, c.unit, d.unit) == (
        (3, 9), (3, 9), (3, 9), (4, 0), None)
    # the children lie inside their parents; self time = span less them
    for s in spans.values():
        if s.parent is not None:
            p = spans[s.parent]
            assert p.t0_ns <= s.t0_ns <= s.t1_ns <= p.t1_ns
    dur = {i: s.t1_ns - s.t0_ns for i, s in spans.items()}
    own = {i: dur[i] - sum(dur[k] for k, s in spans.items()
                           if s.parent == i) for i in spans}
    assert own[a.id] == dur[a.id] - dur[b1.id] - dur[b2.id]
    assert own[b1.id] == dur[b1.id] - dur[c.id] and own[c.id] == dur[c.id]
    assert own[a.id] >= 2e6 and own[b1.id] >= 2e6       # the sleeps
    assert all(v >= 0 for v in own.values())


def test_ring_is_bounded_and_keeps_the_stats_api():
    timer = profiling.StageTimer(capacity=4)
    for k in range(10):
        timer.record(f"s{k}", 0.25)
    assert [s.name for s in timer.spans()] == ["s6", "s7", "s8", "s9"]
    assert timer.stats("s9") == {"n": 1, "p50_s": 0.25, "p99_s": 0.25,
                                 "mean_s": 0.25, "total_s": 0.25}
    assert timer.stats("s0") == {"n": 0}
    assert profiling.GLOBAL_TIMER._ring.maxlen == profiling.RING_CAPACITY


def test_count_lands_on_the_innermost_span(recorder):
    profiling.count("lost")                 # no span open: nothing, no error
    profiling.tracing(True)
    profiling.count("lost")
    with profiling.span("outer"):
        profiling.count("n")
        outer = profiling.current()
        with profiling.span("inner"):
            profiling.count("n", 3)
            done = threading.Thread(
                target=profiling.count, args=("w", 5), kwargs={"into": outer})
            done.start()
            done.join(10)
        profiling.count("n")
    (o,), (i,) = (_by(profiling.spans(), n) for n in ("outer", "inner"))
    assert o is outer
    assert o.counts == {"n": 2, "w": 5} and i.counts == {"n": 3}


def test_counts_from_many_threads_into_one_span_are_not_lost(recorder):
    """Pool workers count into the span of the thread that handed them the
    work (io.fastread's reads): 16 threads, a switch interval of 1 us."""
    profiling.tracing(True)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profiling.span("read") as sp:
            def add():
                for _ in range(2000):
                    profiling.count("syscalls", into=sp)

            threads = [threading.Thread(target=add) for _ in range(16)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(60)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert sp.counts == {"syscalls": 16 * 2000}


def _capture(top):
    w = DigitalRFWriter(top, "live", np.complex64, start_global_index=START,
                        sample_rate_numerator=SR, file_cadence_millisecs=100,
                        subdir_cadence_secs=1)
    w.rf_write(tone_signal(20_000, SR, [F0]).astype(np.complex64))
    return w


def test_streaming_processor_spans_each_tick(recorder, tmp_path):
    """A streaming tab on a capture grown by more than a push block at
    every delivery: each tick is processor.tick holding io.bounds,
    live.push (the cold start's reads inside), live.refresh and
    live.readback in that order, then processor.wait, whose ingest reads
    and pushes the growth (a live.push with its live.read inside), with
    samples, files and system calls counted."""
    top = tmp_path / "cap"
    w = _capture(top)
    grown = [20_000]

    def grow(_):
        w.rf_write(tone_signal(6_000, SR, [F0], start_sample=grown[0])
                   .astype(np.complex64))
        grown[0] += 6_000

    n = 5
    cfg = SpectrogramConfig(nfft=256, ntime=16, stream_seconds=0.05,
                            hop=128, display_tile=True)
    proc = processor.SpectrogramProcessor(
        "streaming", RFDataset(top), 3, cfg,
        callbacks=signals.ProcessorCallbacks(on_iterated=grow),
        streaming_sleep=0.001, max_iterations=n, device="cpu")
    profiling.tracing(True)
    proc.run()
    profiling.tracing(False)
    assert proc.reason == TerminateReason.OK
    spans = profiling.spans()
    ticks = _by(spans, "processor.tick")
    assert [t.unit for t in ticks] == [(3, i) for i in range(n)]
    waits = _by(spans, "processor.wait")
    # the last iteration terminates instead of pacing
    assert [s.unit for s in waits] == [(3, i) for i in range(n - 1)]
    by_id = {s.id: s for s in spans}
    pushed_reads = 0
    for tick in ticks:
        kids = sorted((s for s in spans if s.parent == tick.id),
                      key=lambda s: s.t0_ns)
        # the engine's first tick builds it, and its carry seed reads
        seeds = [s for s in kids if s.name == "live.read"]
        assert len(seeds) == (tick.unit[1] == 0)
        kids = [s for s in kids if s.name != "live.read"]
        names = [s.name for s in kids]
        assert names == ["io.bounds", "live.push", "live.refresh",
                         "live.readback"], names
        assert all(s.unit == tick.unit for s in kids)
        bounds = kids[names.index("io.bounds")]
        # the first refresh lists the capture; the engine it builds then
        # follows the edge, whose probe is stat calls
        assert bounds.counts["syscalls"] > 0
        assert bounds.counts.get("files", 0) > 0 or tick.unit[1] > 0
        for s in spans:
            if s.name == "live.read" and by_id[s.parent].parent == tick.id:
                assert by_id[s.parent].name == "live.push"
                assert s.unit == tick.unit
                assert s.counts["syscalls"] > 0 and s.counts["samples"] > 0
                assert tick.unit[1] == 0
                pushed_reads += 1
    assert pushed_reads >= 1
    # each delivery's growth lands before the interval's first probe, so
    # the interval reads all of it and pushes its block, and the next tick
    # reads nothing
    for wait in waits:
        pushes = [s for s in spans
                  if s.parent == wait.id and s.name == "live.push"]
        reads = [s for s in spans if s.name == "live.read"
                 and s.parent in {p.id for p in pushes}]
        assert pushes and all(s.unit == wait.unit for s in pushes + reads)
        assert sum(s.counts["samples"] for s in reads) == 6_000
        assert all(s.counts["syscalls"] > 0 for s in reads)
    for wait in waits:
        tick = ticks[wait.unit[1]]
        assert wait.parent is None and wait.t0_ns >= tick.t1_ns


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_graph_counts_land_on_live_refresh(recorder, tmp_path, device):
    """On the card each ``live.refresh`` of a streaming tab counts
    ``graph``, 0 on the eager tick of a new key and on the tick that
    captures (it returns the warm-up's outputs), 1 on each replay, and
    ``graph_captures`` on the tick that captures; no other span counts
    either, and on the CPU nothing counts them."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the refresh is a CUDA graph only "
                    "on the card")
    top = tmp_path / "cap"
    _capture(top)
    n = 5
    cfg = SpectrogramConfig(nfft=256, ntime=16, stream_seconds=0.05,
                            hop=128, display_tile=True)
    proc = processor.SpectrogramProcessor(
        "streaming", RFDataset(top), 3, cfg, streaming_sleep=0.001,
        max_iterations=n, device=device)
    profiling.tracing(True)
    proc.run()
    profiling.tracing(False)
    assert proc.reason == TerminateReason.OK
    spans = profiling.spans()
    counted = {s.name for s in spans
               if {"graph", "graph_captures"} & s.counts.keys()}
    if device == "cpu":
        assert not counted
        return
    assert counted == {"live.refresh"}
    got = [(s.counts["graph"], s.counts.get("graph_captures", 0))
           for s in _by(spans, "live.refresh")]
    assert got == [(0, 0), (0, 1)] + [(1, 0)] * (n - 2)
