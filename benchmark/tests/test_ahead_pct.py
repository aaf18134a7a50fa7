"""The reader of ``ahead_pct.tick`` on hand-made spans and trace: the share
of the window's samples read in the pacing intervals, and nothing to read
where the program counts no samples on its reads.

The hand-made timeline (host seconds; the window is [10.000, 10.100)):

    tick C  9.995-10.005   starts before the window: its read (100,000
                           samples) is not counted
    tick A 10.010-10.030   a push reading 1,000 samples
    wait A 10.030-10.040   an ingest (push) reading 9,000 samples
    tick D 10.040-10.050   a push reading 500 samples
    wait D 10.050-10.200   a push reading 4,000 samples at 10.060
    wait E 10.100-10.110   starts at the window's end: its read (7,777
                           samples) is not counted

The benchmark's read marks hold each read 3 us outside it.
"""

import types

import pytest

from drfbench import spec
from drfbench.rundata import RunData
from drfbench.trace import WINDOW, Trace

T0_US, T0_S = 1_000_000.0, 10.0
#: (outer span, its start and end in ms after 10 s, its read's start and
#: end, the samples read)
TIMELINE = [("processor.tick", -5, 5, -4, -3, 100_000),
            ("processor.tick", 10, 30, 14, 17, 1_000),
            ("processor.wait", 30, 40, 32, 34, 9_000),
            ("processor.tick", 40, 50, 43, 44, 500),
            ("processor.wait", 50, 200, 60, 61, 4_000),
            ("processor.wait", 100, 110, 101, 102, 7_777)]


def _ns(ms_after_10s: float) -> int:
    return 10_000_000_000 + round(ms_after_10s * 1e6)


def _spans(counted: bool = True) -> list:
    out = []

    def add(name, a_ms, b_ms, parent=None, **counts):
        s = types.SimpleNamespace(
            id=len(out) + 1, name=name, unit=None,
            parent=parent.id if parent is not None else None, thread=1,
            t0_ns=_ns(a_ms), t1_ns=_ns(b_ms), counts=counts)
        out.append(s)
        return s

    for outer, a, b, ra, rb, n in TIMELINE:
        top = add(outer, a, b)
        push = add("live.push", ra - 0.5, rb + 0.5, top)
        add("live.read", ra, rb, push, syscalls=3,
            **({"samples": n} if counted else {}))
    return out


def _run(monkeypatch, spans) -> RunData:
    from pyspectrogram_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "spans", lambda: spans)
    events = [{"cat": "user_annotation", "name": WINDOW, "ts": T0_US,
               "dur": 100e3},
              {"cat": "kernel", "name": "reg_psd", "ts": T0_US + 33e3,
               "dur": 1e3}]
    host = {WINDOW: [(T0_S, T0_S + 0.1)],
            "bench.live_read": [(T0_S + ra / 1e3 - 3e-6, T0_S + rb / 1e3 + 3e-6)
                                for _, _, _, ra, rb, _ in TIMELINE]}
    run = RunData(setup_s=1.0, latencies={"tick": [0.02, 0.01]},
                  window_s=0.1)
    run.trace = Trace(events, host)
    return run


def test_the_share_of_samples_read_in_the_waits(monkeypatch):
    run = _run(monkeypatch, _spans())
    got = spec.metric_reader("ahead_pct.tick")(run)
    assert got == pytest.approx(100 * (9_000 + 4_000) / (9_000 + 4_000
                                                         + 1_000 + 500))


def test_nothing_to_read_without_the_count(monkeypatch):
    """The parent program counts no samples on its reads: null, as where
    there are no spans or no trace."""
    reader = spec.metric_reader("ahead_pct.tick")
    assert reader(_run(monkeypatch, _spans(counted=False))) is None
    assert reader(_run(monkeypatch, [])) is None
    run = _run(monkeypatch, _spans())
    run.trace = None
    assert reader(run) is None


def test_an_entry_of_the_live_cell():
    cell = spec.cell(spec.load_benchmark(), "live.tick30s")
    m = {x["name"]: x for x in cell["per_layer"]}["ahead_pct.tick"]
    assert (m["unit"], m["better"], m["source"], m["layer"], m["moves"],
            m["workloads"]) == ("%", "higher", "program_counter",
                                "live ingest", "refresh_hz", ["live.tick30s"])
