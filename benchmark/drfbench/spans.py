"""The program's own spans in a traced run, as the per-layer metrics read
them.

The port's recorder (``pyspectrogram_tpu_torch.utils.profiling``) records
spans while a torch.profiler profile is active, so a traced run's window
holds the spans of every tab's thread: ``processor.tick`` (one iteration
of a tab's loop, its unit ``(tab_id, i)``) with ``io.bounds``,
``live.push`` (and its ``live.read`` children), ``live.refresh`` and
``live.readback`` inside, then ``processor.wait`` (the pacing). Each
span's start and end are ``time.monotonic_ns``, the clock of the
benchmark's own marks (``trace.Marks``). The trace places those marks by
an offset it does not keep, so :func:`offset_us` recovers it from the
marks around the live engine's reads (``bench.live_read``), each of which
holds one of the program's ``live.read`` spans a few microseconds inside
it. A tick belongs to the window when its ``processor.tick`` starts in
it. A program without the recorder, or a run without a trace or read
marks, gives nothing to read: every function here then returns None.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Callable, List, Optional

import numpy as np

from drfbench.trace import union_us

#: the span of one iteration of a tab's loop
TICK = "processor.tick"
#: the benchmark's mark around each call of the live engine's read, and
#: the program's span inside the call
READ_MARK, READ_SPAN = "bench.live_read", "live.read"
#: how far (us) a read's mark and its span may differ in length, or their
#: midpoints from the offset
SLACK_US = 50.0
#: reads whose candidate offsets are tallied (the rest are then matched)
ANCHORS = 64


def program_spans() -> Optional[list]:
    """The spans the program recorded, or None where it records none."""
    try:
        from pyspectrogram_tpu_torch.utils import profiling
    except ImportError:
        return None
    get = getattr(profiling, "spans", None)
    return get() if callable(get) else None


def offset_us(trace, spans: list) -> Optional[float]:
    """The offset (us) from ``time.monotonic`` to the trace's clock, by
    which the trace placed the benchmark's marks, or None where no read
    mark holds a read span. Each ``bench.live_read`` mark and the
    ``live.read`` span inside it differ in their midpoints by the offset
    (the few microseconds of the mark's own work before and after the
    span fall on both sides); the offset most anchor reads agree on, to
    ``SLACK_US``, is refined to the median over every read that matches
    it."""
    marks = sorted(getattr(trace, "marks", {}).get(READ_MARK, ()))
    reads = [((s.t0_ns + s.t1_ns) / 2e3, (s.t1_ns - s.t0_ns) / 1e3)
             for s in spans if s.name == READ_SPAN and s.t1_ns is not None]
    if not marks or not reads:
        return None
    mid = np.array([(a + b) / 2 for a, b in marks])
    dur = np.array([b - a for a, b in marks])
    cand = np.concatenate([
        mid[np.abs(dur - d) <= SLACK_US] - m
        for m, d in reads[::max(1, len(reads) // ANCHORS)]])
    if len(cand) == 0:
        return None
    cand.sort()
    agree = np.searchsorted(cand, cand + SLACK_US, side="right")
    best = int(np.argmax(agree - np.arange(len(cand))))
    guess = float(np.median(cand[best:agree[best]]))
    starts = [a for a, _ in marks]
    diffs = []
    for m, d in reads:
        j = bisect.bisect_right(starts, m + guess) - 1
        if j >= 0 and abs(dur[j] - d) <= SLACK_US and (
                abs(mid[j] - m - guess) <= SLACK_US):
            diffs.append(mid[j] - m)
    return float(np.median(diffs)) if diffs else None


class Tick:
    """One ``processor.tick`` span and the spans under it, in the
    trace's microseconds."""

    def __init__(self, tick, below: list, off: float):
        self.start = tick.t0_ns / 1e3 + off
        self.end = tick.t1_ns / 1e3 + off
        self.below = below
        ids = {s.id for s in below}
        self._child_us = defaultdict(float)
        for s in below:
            if s.parent in ids:
                self._child_us[s.parent] += (s.t1_ns - s.t0_ns) / 1e3

    def total_us(self, name: str) -> float:
        """Summed duration of the spans named ``name`` in this tick."""
        return sum((s.t1_ns - s.t0_ns) / 1e3 for s in self.below
                   if s.name == name)

    def self_us(self, name: str) -> float:
        """Summed self time of the spans named ``name``: each span's
        duration less its children's."""
        return sum((s.t1_ns - s.t0_ns) / 1e3 - self._child_us[s.id]
                   for s in self.below if s.name == name)

    def counted(self, name: str, key: str) -> int:
        """Summed count ``key`` of the spans named ``name``."""
        return sum(int(s.counts.get(key, 0)) for s in self.below
                   if s.name == name)


def _placed(run):
    """(the program's spans, their offset to the trace's clock), or None
    where either is missing."""
    trace = getattr(run, "trace", None)
    spans = program_spans() if trace is not None else None
    off = offset_us(trace, spans) if spans else None
    return None if off is None else (spans, off)


def ticks(run) -> Optional[List[Tick]]:
    """The window's ticks (every tab's), or None where there are none to
    read."""
    placed = _placed(run)
    if placed is None:
        return None
    spans, off = placed
    t0, t1 = run.trace.t0, run.trace.t1
    kids = defaultdict(list)
    for s in spans:
        if s.parent is not None and s.t1_ns is not None:
            kids[s.parent].append(s)
    out = []
    for s in spans:
        if s.name != TICK or s.t1_ns is None:
            continue
        if not t0 <= s.t0_ns / 1e3 + off < t1:
            continue
        below, todo = [], [s.id]
        while todo:
            for k in kids.get(todo.pop(), ()):
                below.append(k)
                todo.append(k.id)
        out.append(Tick(s, below, off))
    return out or None


def median_per_tick(run, value: Callable[[Tick], float]) -> Optional[float]:
    """Median over the window's ticks of ``value(tick)``."""
    ts = ticks(run)
    if ts is None:
        return None
    return float(np.median([value(t) for t in ts]))


def idle_pct_inside(run, name: str) -> Optional[float]:
    """The device's idle time (the window less the union of its events,
    as ``trace.union_us``) inside the program's spans named ``name``,
    over the window, %: the union of the spans and the device's events
    less the union of the events."""
    placed = _placed(run)
    if placed is None:
        return None
    spans, off = placed
    trace = run.trace
    t0, t1 = trace.t0, trace.t1
    inside = [(s.t0_ns / 1e3 + off, s.t1_ns / 1e3 + off)
              for s in spans if s.name == name and s.t1_ns is not None]
    if union_us(inside, t0, t1) <= 0:
        return None
    busy = [(a, b) for _, _, a, b in trace.device]
    idle = union_us(inside + busy, t0, t1) - union_us(busy, t0, t1)
    return 100.0 * idle / (t1 - t0)
