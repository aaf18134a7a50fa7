"""The readers of the program's own spans (``drfbench/spans.py`` and the
``metrics/*.tick.py`` that use it) on a hand-made trace and hand-made
spans, and on the card a short traced run of ``live.tick30s``.

The hand-made timeline (host seconds; the window is [10.000, 10.100)):

    tick C  9.995-10.005   starts before the window: not a window tick
    tick A 10.010-10.030   bounds 3 ms (60 files); push 7 ms holding reads
                           of 3 and 1 ms (7 and 3 calls); refresh 6 ms
                           holding a 1 ms read (4 calls); readback 3 ms
    wait A 10.030-10.040
    tick D 10.040-10.050   bounds 2 ms (80 files), push 3 ms, refresh 2 ms,
                           readback 1 ms
    wait D 10.050-10.200   past the window's end
    tick E 10.100-10.110   starts at the window's end: not a window tick

and on the device: a kernel at 10.021-10.024 (in A's refresh), a DtoH
copy at 10.027-10.028 (A's readback), kernels at 10.035-10.036 (wait A)
and 10.095-10.097 (wait D). The benchmark's read marks hold A's three
reads 3 us outside each, and one read before the profile began.
"""

import json
import sys
import types

import pytest

from drfbench import spans as program
from drfbench import spec
from drfbench.rundata import RunData, idle_pct
from drfbench.trace import WINDOW, Trace, union_us

#: the window's start on the trace's clock (us) and on the host's (s)
T0_US, T0_S = 1_000_000.0, 10.0
NEW = ("bounds_ms.tick", "bounds_files.tick", "read_ms.tick",
       "read_syscalls.tick", "push_ms.tick", "refresh_ms.tick",
       "readback_ms.tick", "device_idle_wait_pct.tick",
       "device_idle_tick_pct.tick")


def _ns(ms_after_10s: float) -> int:
    return 10_000_000_000 + round(ms_after_10s * 1e6)


class _Spans:
    def __init__(self):
        self.out = []

    def add(self, name, a_ms, b_ms, parent=None, unit=None, **counts):
        s = types.SimpleNamespace(
            id=len(self.out) + 1, name=name, unit=unit,
            parent=parent.id if parent is not None else None, thread=1,
            t0_ns=_ns(a_ms), t1_ns=_ns(b_ms), counts=counts)
        self.out.append(s)
        return s


def _timeline() -> list:
    sp = _Spans()
    c = sp.add("processor.tick", -5, 5, unit=(0, 4))
    sp.add("io.bounds", -5, -1, c, files=500)
    a = sp.add("processor.tick", 10, 30, unit=(0, 5))
    sp.add("io.bounds", 10, 13, a, files=60, syscalls=40)
    push = sp.add("live.push", 13, 20, a)
    sp.add("live.read", 14, 17, push, syscalls=7)
    sp.add("live.read", 18, 19, push, syscalls=3)
    ref = sp.add("live.refresh", 20, 26, a)
    sp.add("live.read", 22, 23, ref, syscalls=4)
    sp.add("live.readback", 26, 29, a)
    sp.add("processor.wait", 30, 40, unit=(0, 5))
    d = sp.add("processor.tick", 40, 50, unit=(0, 6))
    sp.add("io.bounds", 40, 42, d, files=80)
    sp.add("live.push", 42, 45, d)
    sp.add("live.refresh", 45, 47, d)
    sp.add("live.readback", 47, 48, d)
    sp.add("processor.wait", 50, 200, unit=(0, 6))
    e = sp.add("processor.tick", 100, 110, unit=(0, 7))
    sp.add("io.bounds", 100, 109, e, files=900)
    return sp.out


def _trace() -> Trace:
    def dev(cat, name, a_ms, b_ms):
        return {"cat": cat, "name": name, "ts": T0_US + a_ms * 1e3,
                "dur": (b_ms - a_ms) * 1e3}

    events = [{"cat": "user_annotation", "name": WINDOW, "ts": T0_US,
               "dur": 100e3},
              dev("kernel", "radix_hist", 21, 24),
              dev("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 27, 28),
              dev("kernel", "reg_psd", 35, 36),
              dev("kernel", "reg_psd", 95, 97),
              {"cat": "cpu_op", "name": "aten::copy_", "ts": T0_US,
               "dur": 5e3}]
    host = {WINDOW: [(T0_S, T0_S + 0.1)],
            "bench.tick": [(T0_S + 0.010, T0_S + 0.030)],
            "bench.live_read": [(9.5, 9.501)] + [
                (T0_S + a / 1e3 - 3e-6, T0_S + b / 1e3 + 3e-6)
                for a, b in ((14, 17), (18, 19), (22, 23))]}
    return Trace(events, host)


@pytest.fixture
def run(monkeypatch):
    from pyspectrogram_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "spans", _timeline)
    r = RunData(setup_s=1.0, latencies={"tick": [0.02, 0.01]},
                window_s=0.1)
    r.trace = _trace()
    return r


def _read(name, run):
    return spec.metric_reader(name)(run)


@pytest.mark.parametrize("name, want", [
    ("bounds_ms.tick", (3 + 2) / 2),
    ("bounds_files.tick", (60 + 80) / 2),
    ("read_ms.tick", (3 + 1 + 1 + 0) / 2),
    ("read_syscalls.tick", (7 + 3 + 4 + 0) / 2),
    ("push_ms.tick", ((7 - 3 - 1) + 3) / 2),
    ("refresh_ms.tick", ((6 - 1) + 2) / 2),
    ("readback_ms.tick", (3 + 1) / 2),
    # waits in the window: 10 + 50 ms, less 1 + 2 ms of kernels
    ("device_idle_wait_pct.tick", 100 * (60 - 3) / 100),
    # ticks in the window: C's last 5 ms, A's 20 less 3 + 1, D's 10
    ("device_idle_tick_pct.tick", 100 * (5 + 20 - 4 + 10) / 100),
])
def test_reader_arithmetic(run, name, want):
    assert _read(name, run) == pytest.approx(want, abs=1e-6)


def test_window_membership_and_the_idle_split(run):
    ts = program.ticks(run)
    # C starts before the window, E at its end: neither is a window tick
    assert [round(t.start - T0_US) for t in ts] == [10_000, 40_000]
    # the waits, the ticks and the one 5 ms gap between C and A make up
    # the window's idle time
    split = (_read("device_idle_wait_pct.tick", run)
             + _read("device_idle_tick_pct.tick", run))
    assert idle_pct(run) == pytest.approx(split + 5.0)


def test_no_spans_no_reading(run, monkeypatch):
    from pyspectrogram_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "spans", list)
    assert all(_read(n, run) is None for n in NEW)
    # a program without the recorder's accessor (the parent of the spans)
    monkeypatch.delattr(profiling, "spans")
    assert all(_read(n, run) is None for n in NEW)
    monkeypatch.setattr(profiling, "spans", _timeline, raising=False)
    # a run without a trace
    run.trace = None
    assert all(_read(n, run) is None for n in NEW)


def test_the_offset_is_recovered_from_the_read_marks():
    """The trace keeps no offset from the host's clock to its own: the
    marks around the reads give it back, to within the mark's own few
    microseconds around its span, among marks that hold no recorded span
    (reads before the profile began) and spans that no mark holds
    (another run's)."""
    import numpy as np

    rng = np.random.default_rng(7)
    starts = np.cumsum(rng.uniform(0.5e-3, 90e-3, 300)) + 9.0
    lens = rng.uniform(0.2e-3, 5e-3, 300)
    sp, marks = _Spans(), []
    for k, (a, n) in enumerate(zip(starts, lens)):
        if k % 15 != 3:
            sp.add("live.read", (a - T0_S) * 1e3, (a + n - T0_S) * 1e3)
        if k % 15 != 7:
            marks.append((a - rng.uniform(2e-6, 4e-6),
                          a + n + rng.uniform(2e-6, 4e-6)))
    host = {WINDOW: [(T0_S, T0_S + 0.1)], "bench.live_read": marks}
    trace = Trace([{"cat": "user_annotation", "name": WINDOW, "ts": T0_US,
                    "dur": 100e3}], host)
    assert program.offset_us(trace, sp.out) == pytest.approx(
        T0_US - T0_S * 1e6, abs=1.0)
    assert program.offset_us(trace, _timeline()[:2]) is None
    del host["bench.live_read"]
    trace = Trace([{"cat": "user_annotation", "name": WINDOW, "ts": T0_US,
                    "dur": 100e3}], host)
    assert program.offset_us(trace, sp.out) is None


def test_the_new_metrics_are_entries_of_the_live_cell():
    cell = spec.cell(spec.load_benchmark(), "live.tick30s")
    names = [m["name"] for m in cell["per_layer"]]
    assert names[:4] == ["tick_ms.tick", "tick_read_ms.tick",
                         "device_roofline_pct.tick", "device_idle_pct.tick"]
    assert names[4:] == list(NEW)
    for m in cell["per_layer"][4:]:
        assert m["moves"] == "refresh_hz" and m["workloads"] == [
            "live.tick30s"]
        assert m["source"] == ("device_trace" if "idle" in m["name"]
                               else "host_clock")


def _traced_live(monkeypatch, seconds: float, seed: int):
    """One traced run of live.tick30s: its result, the window's trace and
    events, the program's spans and their offset to the trace's clock."""
    import os
    import tempfile
    from pathlib import Path

    import run as bench
    from pyspectrogram_tpu_torch.utils import profiling

    bench.cache_dirs(spec.ROOT)
    kept = {}

    def keep(cls, prof, host):
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            kept["events"] = json.loads(Path(path).read_text())["traceEvents"]
        finally:
            os.unlink(path)
        kept["trace"] = cls(kept["events"], host)
        return kept["trace"]

    monkeypatch.setattr(Trace, "from_profiler", classmethod(keep))
    profiling.reset()
    cell = spec.cell(spec.load_benchmark(), "live.tick30s")
    out = bench.run_cell(cell, seed, seconds, True, "cuda",
                         bench.boot_clock())
    assert out["correct"] is True, out["checks"]
    spans = profiling.spans()
    trace = kept["trace"]
    off = program.offset_us(trace, spans)
    assert off is not None
    return out, trace, kept["events"], spans, off


def _copies_in_readback(trace, events, spans, off):
    """(the window's DtoH copies, those inside a mapped live.readback
    within 50 us, those whose cudaMemcpyAsync call is inside one)."""
    backs = sorted((s.t0_ns / 1e3 + off - 50, s.t1_ns / 1e3 + off + 50)
                   for s in spans if s.name == "live.readback")
    copies = [e for e in events if e.get("cat") == "gpu_memcpy"
              and "DtoH" in e.get("name", "")
              and trace.t0 <= float(e["ts"]) < trace.t1]
    calls = {e["args"]["correlation"]: e for e in events
             if e.get("cat") == "cuda_runtime"
             and "correlation" in e.get("args", {})}

    def inside(e):
        a = float(e["ts"])
        b = a + float(e.get("dur", 0))
        return any(s <= a and b <= t for s, t in backs)

    on_device = sum(inside(e) for e in copies)
    launched = [calls.get(e.get("args", {}).get("correlation")) for e in copies]
    on_host = sum(inside(c) for c in launched if c is not None)
    print(f"DtoH copies in the window: {len(copies)}, inside a mapped "
          f"live.readback: {on_device}; their runtime calls inside: "
          f"{on_host}", file=sys.stderr)
    return len(copies), on_device, on_host


@pytest.mark.card
def test_spans_share_the_traces_clock_on_the_card(monkeypatch):
    """A short traced run of live.tick30s: every new metric is in the
    result; at least 99% of the window's device-to-host copies, and of the
    cudaMemcpyAsync calls that launched them, lie inside a live.readback
    span (within 50 us); the children of a tick cover at least 90% of it
    (median); the idle time inside the waits and the ticks makes up the
    device's idle time from the first recorded span on within 1 point."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import statistics

    out, trace, events, spans, off = _traced_live(
        monkeypatch, 8.0, (1 << 31) + 23)
    missing = [n for n in NEW if n not in out["metrics"]]
    assert not missing, (missing, json.dumps(out["metrics"]))
    n, on_device, on_host = _copies_in_readback(trace, events, spans, off)
    assert n and on_device >= 0.99 * n
    assert on_host >= 0.99 * n
    # spans open when the profile began were not recorded, so the waits and
    # ticks make up the device's idle time from the first recorded one on
    m = {k: v["value"] for k, v in out["metrics"].items()}
    split = m["device_idle_wait_pct.tick"] + m["device_idle_tick_pct.tick"]
    seen = max(trace.t0, min(
        s.t0_ns / 1e3 + off for s in spans
        if s.name in ("processor.tick", "processor.wait")
        and s.t1_ns / 1e3 + off > trace.t0))
    idle_seen = 100.0 * ((trace.t1 - seen) - union_us(
        [(a, b) for _, _, a, b in trace.device], seen, trace.t1)) / (
        trace.t1 - trace.t0)
    assert abs(split - idle_seen) <= 1.0, (split, idle_seen, m)
    kids = ("io.bounds", "live.push", "live.refresh", "live.readback")
    cover = []
    for tick in spans:
        if tick.name == "processor.tick" and (
                trace.t0 <= tick.t0_ns / 1e3 + off < trace.t1):
            covered = sum(s.t1_ns - s.t0_ns for s in spans
                          if s.parent == tick.id and s.name in kids)
            cover.append(covered / (tick.t1_ns - tick.t0_ns))
    assert cover and statistics.median(cover) >= 0.9, cover


@pytest.mark.card
def test_copies_are_launched_inside_readback_over_a_whole_window(monkeypatch):
    """A traced run of live.tick30s as long as the benchmark's: at least
    99% of the window's device-to-host copies were launched (their
    cudaMemcpyAsync call, on the trace's CPU clock) inside a mapped
    live.readback span, within 50 us. The copies' device timestamps are
    printed, not held to it: late in such a window the trace's device
    clock steps up to a few hundred microseconds against its CPU clock."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    seconds = float(spec.load_benchmark()["run_seconds"])
    _, trace, events, spans, off = _traced_live(
        monkeypatch, seconds, (1 << 32) + 51)
    n, _, on_host = _copies_in_readback(trace, events, spans, off)
    assert n and on_host >= 0.99 * n
