"""The reader of ``graph_hit_pct.tick`` on hand-made spans and trace: the
share of the window's ticks whose ``live.refresh`` replayed the graph, and
nothing to read where no refresh counts ``graph``.

The hand-made timeline (ms after 10 s; the window is [0, 100)):

    tick   -5-5    starts before the window: not counted
    ticks  10-20, 30-40, 50-60, 70-80, 90-110   in the window

Each tick holds a ``live.push`` with one ``live.read`` (the benchmark's
read marks hold each read 3 us outside it, which places the spans) and a
``live.refresh`` with the counts the case gives.
"""

import types

import pytest

from drfbench import spec
from drfbench.rundata import RunData
from drfbench.trace import WINDOW, Trace

T0_US, T0_S = 1_000_000.0, 10.0
#: tick start and end, ms after 10 s
TICKS = [(-5, 5), (10, 20), (30, 40), (50, 60), (70, 80), (90, 110)]


def _ns(ms_after_10s: float) -> int:
    return 10_000_000_000 + round(ms_after_10s * 1e6)


def _spans(counts: list) -> list:
    """The timeline's spans, ``counts[i]`` on tick i's refresh."""
    out = []

    def add(name, a_ms, b_ms, parent=None, **kw):
        s = types.SimpleNamespace(
            id=len(out) + 1, name=name, unit=None,
            parent=parent.id if parent is not None else None, thread=1,
            t0_ns=_ns(a_ms), t1_ns=_ns(b_ms), counts=kw)
        out.append(s)
        return s

    for (a, b), c in zip(TICKS, counts):
        top = add("processor.tick", a, b)
        push = add("live.push", a + 1, a + 4, top)
        add("live.read", a + 2, a + 3, push, samples=10)
        add("live.refresh", a + 5, a + 6, top, **c)
        add("live.readback", a + 6, a + 8, top)
    return out


def _run(monkeypatch, spans) -> RunData:
    from pyspectrogram_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "spans", lambda: spans)
    events = [{"cat": "user_annotation", "name": WINDOW, "ts": T0_US,
               "dur": 100e3},
              {"cat": "kernel", "name": "radix_hist_kernel",
               "ts": T0_US + 16e3, "dur": 1e3}]
    host = {WINDOW: [(T0_S, T0_S + 0.1)],
            "bench.live_read": [(T0_S + (a + 2) / 1e3 - 3e-6,
                                 T0_S + (a + 3) / 1e3 + 3e-6)
                                for a, _ in TICKS]}
    run = RunData(setup_s=1.0, latencies={"tick": [0.01] * 5},
                  window_s=0.1)
    run.trace = Trace(events, host)
    return run


REPLAY, EAGER = {"graph": 1}, {"graph": 0}
CAPTURE = {"graph": 0, "graph_captures": 1}     # the tick runs eagerly


@pytest.mark.parametrize("counts,want", [
    # the tick before the window is eager and not counted
    ([EAGER, REPLAY, REPLAY, EAGER, CAPTURE, REPLAY], 60.0),
    ([REPLAY, EAGER, CAPTURE, REPLAY, REPLAY, REPLAY], 60.0),
    ([EAGER, REPLAY, REPLAY, REPLAY, REPLAY, EAGER], 80.0),
    ([REPLAY, EAGER, EAGER, EAGER, EAGER, EAGER], 0.0),
    ([EAGER] + [REPLAY] * 5, 100.0),
])
def test_the_share_of_ticks_that_replayed(monkeypatch, counts, want):
    run = _run(monkeypatch, _spans(counts))
    assert spec.metric_reader("graph_hit_pct.tick")(run) == pytest.approx(
        want)


def test_nothing_to_read_without_the_count(monkeypatch):
    """The parent program, and a CPU engine, count no ``graph``: null, as
    where there are no spans or no trace. A count before the window does
    not make one."""
    reader = spec.metric_reader("graph_hit_pct.tick")
    assert reader(_run(monkeypatch, _spans([{}] * 6))) is None
    assert reader(_run(monkeypatch, _spans([REPLAY] + [{}] * 5))) is None
    assert reader(_run(monkeypatch, [])) is None
    run = _run(monkeypatch, _spans([REPLAY] * 6))
    run.trace = None
    assert reader(run) is None


def test_an_entry_of_the_live_cell():
    cell = spec.cell(spec.load_benchmark(), "live.tick30s")
    m = {x["name"]: x for x in cell["per_layer"]}["graph_hit_pct.tick"]
    assert (m["unit"], m["better"], m["source"], m["layer"], m["moves"],
            m["workloads"]) == ("%", "higher", "program_counter",
                                "live refresh", "refresh_hz",
                                ["live.tick30s"])
