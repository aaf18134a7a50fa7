"""The port's span recorder, on ``time.monotonic_ns`` and torch.profiler.

A span is one stretch of work on one thread: its name, the unit of work it
belongs to (``unit``, e.g. ``(tab_id, iteration)`` for a live tick), the
span it ran inside (``parent``), its thread, its start and end on
``time.monotonic_ns()`` and a small dict of counts. Spans nest through a
per-thread stack; a child takes its parent's unit. Finished spans go into
a bounded ring (:class:`StageTimer`), oldest dropped first.

The program's own span sites (``span``, ``spanned``, ``count``) record
into :data:`GLOBAL_TIMER` only while recording is on: after
``tracing(True)``, or while a ``torch.profiler`` profile is active
anywhere in the process (torch's process-wide flag, so a profile entered
on one thread records the spans of threads started before it). Off, a
span site reads the two flags and returns a shared no-op context: no
allocation, no ``record_function``. On, a span also opens a
``record_function`` range on a thread the active profiler records (the
thread that entered it), so its trace carries the span's name; other
threads' ranges the profiler would drop, and they open none. An operator
reads what was recorded with :func:`spans` and :func:`stats`.

:class:`StageTimer` instances that callers make themselves record always.
:func:`device_trace` records CPU and CUDA activity into a Chrome trace,
and :func:`device_busy_share` reads from one how much of a marked range
the device was busy.

The spans of a live tab's loop (runtime.processor, runtime.live, io):
``processor.tick`` (one iteration, unit ``(tab_id, i)``) holding
``io.bounds`` (count ``files``), ``live.push`` with its ``live.read``
children (counts ``samples`` and ``syscalls``), ``live.refresh`` (the
view, the median and the tail, which reads nothing) and ``live.readback``;
then ``processor.wait``, the pacing, holding the ``live.push`` of each
ingest between ticks.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import json
import threading
import time
from collections import defaultdict, deque
from pathlib import Path
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch
import torch.autograd.profiler as _autograd_profiler
from torch.autograd import _profiler_enabled as _profiled_here
from torch.profiler import ProfilerActivity, profile, record_function

#: Chrome-trace categories of work on the device
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
#: finished spans a timer keeps by default
RING_CAPACITY = 1 << 16

_on = False
_stack = threading.local()
_ids = itertools.count(1)
_count_lock = threading.Lock()


class Span:
    """One finished (or open) span. ``t1_ns`` is None while it is open.
    ``counts`` holds what its own thread counted, and once it has ended
    what other threads counted into it while it was open."""

    __slots__ = ("id", "name", "unit", "parent", "thread", "t0_ns", "t1_ns",
                 "counts", "_shared")

    def __init__(self, name: str, unit=None, t0_ns: int = 0,
                 t1_ns: Optional[int] = None):
        self.id = next(_ids)
        self.name = name
        self.unit = unit
        self.parent: Optional[int] = None
        self.thread = threading.get_ident()
        self.t0_ns = t0_ns
        self.t1_ns = t1_ns
        self.counts: Dict[str, int] = {}
        self._shared: Optional[Dict[str, int]] = None


def _open_stack() -> list:
    try:
        return _stack.spans
    except AttributeError:
        _stack.spans = []
        return _stack.spans


class _Stage:
    """The context of one recorded span: pushes it on this thread's stack,
    opens a ``record_function`` range where the active profiler records
    this thread, and at the end pops it and puts it in the timer's ring."""

    __slots__ = ("timer", "span", "rf")

    def __init__(self, timer: "StageTimer", name: str, unit):
        self.timer = timer
        self.span = Span(name, unit)
        self.rf = None

    def __enter__(self) -> Span:
        stack = _open_stack()
        sp = self.span
        if stack:
            top = stack[-1]
            sp.parent = top.id
            if sp.unit is None:
                sp.unit = top.unit
        stack.append(sp)
        if _autograd_profiler._is_profiler_enabled and _profiled_here():
            self.rf = record_function(sp.name)
            self.rf.__enter__()
        sp.t0_ns = time.monotonic_ns()
        return sp

    def __exit__(self, *exc) -> bool:
        sp = self.span
        sp.t1_ns = time.monotonic_ns()
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
        stack = _open_stack()
        if stack and stack[-1] is sp:
            stack.pop()
        if sp._shared is not None:
            with _count_lock:
                for key, n in sp._shared.items():
                    sp.counts[key] = sp.counts.get(key, 0) + n
                sp._shared = None
        self.timer._add(sp)
        return False


class _Null:
    """The shared context a span site gets while recording is off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc) -> bool:
        return False


_NULL = _Null()


class StageTimer:
    """A thread-safe, bounded ring of finished spans (the last
    ``capacity``), with per-name wall-clock statistics. Stages nest via
    the context manager, which records always; on a thread a torch.profiler
    records, each stage is also a ``record_function`` range."""

    def __init__(self, capacity: int = RING_CAPACITY):
        # appends, copies and clears of a deque are each one atomic step
        # under the interpreter lock, so the ring needs no lock of its own
        self._ring: deque = deque(maxlen=int(capacity))

    def stage(self, name: str, unit=None) -> _Stage:
        """A span named ``name`` around the block; ``unit`` defaults to
        the enclosing span's."""
        return _Stage(self, name, unit)

    def record(self, name: str, seconds: float) -> None:
        """A span of ``seconds`` ending now, timed by the caller."""
        t1 = time.monotonic_ns()
        self._add(Span(name, t0_ns=t1 - round(seconds * 1e9), t1_ns=t1))

    def _add(self, sp: Span) -> None:
        self._ring.append(sp)

    def spans(self) -> List[Span]:
        """The finished spans kept, oldest first."""
        return list(self._ring)

    def stats(self, name: Optional[str] = None) -> dict:
        """p50/p99/mean/total seconds and the count, by span name (of the
        spans the ring still holds)."""
        by_name: Dict[str, list] = defaultdict(list)
        for sp in self.spans():
            if name is None or sp.name == name:
                by_name[sp.name].append(sp.t1_ns - sp.t0_ns)
        out = {}
        for n in [name] if name else list(by_name):
            a = np.asarray(by_name.get(n, []), np.float64) / 1e9
            if len(a) == 0:
                out[n] = {"n": 0}
                continue
            out[n] = {
                "n": int(len(a)),
                "p50_s": float(np.percentile(a, 50)),
                "p99_s": float(np.percentile(a, 99)),
                "mean_s": float(a.mean()),
                "total_s": float(a.sum()),
            }
        return out[name] if name else out

    def reset(self) -> None:
        self._ring.clear()


#: the process-wide recorder: the program's span sites record into it
#: while recording is on (:func:`tracing`, or a torch.profiler profile);
#: callers may also time their own stages into it
GLOBAL_TIMER = StageTimer()


def tracing(on: bool = True) -> bool:
    """Turn the program's span recording on or off (it is also on while
    a torch.profiler profile is active); returns the previous setting."""
    global _on
    was, _on = _on, bool(on)
    return was


def span(name: str, unit=None):
    """A span named ``name`` around the block, recorded into
    :data:`GLOBAL_TIMER` while recording is on; a shared no-op context
    otherwise. ``unit`` defaults to the enclosing span's."""
    if not (_on or _autograd_profiler._is_profiler_enabled):
        return _NULL
    return _Stage(GLOBAL_TIMER, name, unit)


def spanned(name: str):
    """Decorator: each call of the function is a span named ``name``."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not (_on or _autograd_profiler._is_profiler_enabled):
                return fn(*args, **kwargs)
            with _Stage(GLOBAL_TIMER, name, None):
                return fn(*args, **kwargs)
        return wrapper
    return deco


def current() -> Optional[Span]:
    """The innermost open span of this thread, or None (always None while
    recording is off). Work handed to other threads counts into it with
    ``count(..., into=)``."""
    if not (_on or _autograd_profiler._is_profiler_enabled):
        return None
    stack = _open_stack()
    return stack[-1] if stack else None


def count(key: str, n: int = 1, into: Optional[Span] = None) -> None:
    """Add ``n`` to count ``key`` of the innermost open span of this
    thread, or of ``into``: a span another thread opened, which takes the
    count when it ends (so hand a span's work to other threads only while
    it waits for them, as io.fastread's pool does). Nothing while
    recording is off or no span is open."""
    if not (_on or _autograd_profiler._is_profiler_enabled):
        return
    if into is None:
        stack = _open_stack()
        if not stack:
            return
        into = stack[-1]
    elif into.thread != threading.get_ident():
        with _count_lock:
            if into._shared is None:
                into._shared = {}
            into._shared[key] = into._shared.get(key, 0) + n
        return
    into.counts[key] = into.counts.get(key, 0) + n


def spans() -> List[Span]:
    """:data:`GLOBAL_TIMER`'s finished spans, oldest first."""
    return GLOBAL_TIMER.spans()


def stats(name: Optional[str] = None) -> dict:
    """:data:`GLOBAL_TIMER`'s per-name statistics."""
    return GLOBAL_TIMER.stats(name)


def reset() -> None:
    """Drop :data:`GLOBAL_TIMER`'s spans."""
    GLOBAL_TIMER.reset()


@contextlib.contextmanager
def device_trace(log_dir) -> Iterator[profile]:
    """Profile the block over CPU and (when present) CUDA activity and
    write a Chrome trace to ``log_dir/trace.json``; yields the profiler
    (``key_averages()`` after the block). The trace's path is set on the
    profiler as ``trace_path`` when the block ends."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    path = Path(log_dir) / "trace.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(path))
    prof.trace_path = path


def device_busy_share(trace_path, span: str) -> dict:
    """Busy share of the device over the last ``span`` range (a
    StageTimer stage or record_function name) of a Chrome trace: the
    union of device events (kernels, copies, memsets) inside it over its
    length."""
    events = json.loads(Path(trace_path).read_text())["traceEvents"]
    marks = [e for e in events if e.get("cat") == "user_annotation"
             and e.get("name") == span]
    if not marks:
        raise ValueError(f"no {span!r} range in {trace_path}")
    t0 = float(marks[-1]["ts"])
    t1 = t0 + float(marks[-1]["dur"])
    ivs = sorted((max(float(e["ts"]), t0),
                  min(float(e["ts"]) + float(e.get("dur", 0)), t1))
                 for e in events if e.get("cat") in DEVICE_CATEGORIES)
    busy, end, n = 0.0, t0, 0
    for a, b in ivs:
        if b <= a:
            continue
        n += 1
        if b > end:
            busy += b - max(a, end)
            end = b
    return {"span_ms": (t1 - t0) / 1e3, "device_busy_ms": busy / 1e3,
            "busy_share": busy / (t1 - t0) if t1 > t0 else 0.0,
            "device_events": n}
