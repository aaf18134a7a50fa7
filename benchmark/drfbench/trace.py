"""The traced run: a torch.profiler trace of the measured window, and what
the per-layer metrics read from it.

The busy arithmetic is that of the port's ``utils.profiling.
device_busy_share`` (the union of device events, kernels, copies and
memsets, inside a marked range), kept here so that no change to the
program can move it. Ranges are the benchmark's own marks (``bench.*``),
placed on the trace's clock by their host times (see :class:`Marks`).
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import threading
import time
from collections import defaultdict
from pathlib import Path

from torch.profiler import ProfilerActivity, profile, record_function

#: Chrome-trace categories of work on the device
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
#: the mark around the measured window
WINDOW = "bench.window"


class Marks:
    """Opens and closes ``bench.*`` ranges when tracing, and nothing
    otherwise. A range may open in one call and close in another on the
    same thread (a live tick opens at its bounds refresh and closes at
    its delivery). Each range's host times are kept (``host``): the
    profiler records ``record_function`` ranges only on the threads it
    profiles, and a live tab's thread starts before the window, so the
    trace places every range by its host times, on the clock of the
    window's range."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.host = defaultdict(list)
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def range(self, name: str):
        h = self.open(name)
        try:
            yield
        finally:
            self.close(h)

    def open(self, name: str):
        if not self.enabled:
            return None
        rf = record_function(name)
        rf.__enter__()
        return name, time.monotonic(), rf

    def close(self, h) -> None:
        if h is None:
            return
        name, t0, rf = h
        t1 = time.monotonic()
        rf.__exit__(None, None, None)
        with self._lock:
            self.host[name].append((t0, t1))


def profiler(device_type: str):
    acts = [ProfilerActivity.CPU]
    if device_type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def union_us(ivs, t0: float, t1: float) -> float:
    """Length of the union of intervals ``ivs`` clipped to [t0, t1]."""
    busy, end = 0.0, t0
    for a, b in sorted((max(a, t0), min(b, t1)) for a, b in ivs):
        if b <= a:
            continue
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


class Trace:
    """The window's device events and the ``bench.*`` ranges."""

    def __init__(self, events: list, host: dict):
        """``events``: the Chrome trace's; ``host``: Marks.host, the
        ranges' host times (time.monotonic seconds)."""
        self.device = [(e["name"], e["cat"], float(e["ts"]),
                        float(e["ts"]) + float(e.get("dur", 0)))
                       for e in events if e.get("cat") in DEVICE_CATEGORIES]
        win = [e for e in events if e.get("cat") == "user_annotation"
               and e.get("name") == WINDOW]
        if not win or not host.get(WINDOW):
            raise ValueError(f"the trace holds no {WINDOW!r} range")
        self.t0 = float(win[-1]["ts"])
        self.t1 = self.t0 + float(win[-1].get("dur", 0))
        # the host clock in the trace's microseconds, by the window's start
        off = self.t0 - host[WINDOW][-1][0] * 1e6
        self.marks = {name: [(a * 1e6 + off, b * 1e6 + off) for a, b in ivs]
                      for name, ivs in host.items()}

    @classmethod
    def from_profiler(cls, prof, host: dict) -> "Trace":
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            events = json.loads(Path(path).read_text())["traceEvents"]
        finally:
            os.unlink(path)
        return cls(events, host)

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    def busy_s(self) -> float:
        return union_us([(a, b) for _, _, a, b in self.device],
                        self.t0, self.t1) / 1e6

    def kernel_s_within(self, mark: str) -> float:
        """Seconds of kernels (not copies or memsets) that start inside a
        ``mark`` range that itself starts inside the window."""
        spans = sorted((a, b) for a, b in self.marks.get(mark, [])
                       if self.t0 <= a < self.t1)
        total = 0.0
        for _, cat, a, b in self.device:
            if cat != "kernel":
                continue
            if any(s <= a < e for s, e in spans):
                total += b - a
        return total / 1e6

    def breakdown(self, n: int = 10) -> dict:
        """The device operations that took most time in the window, and
        the longest idle gaps, each named by the innermost ``bench.*``
        range the host was in at the gap's middle."""
        by_name = defaultdict(float)
        ivs = []
        for name, _, a, b in self.device:
            a, b = max(a, self.t0), min(b, self.t1)
            if b > a:
                by_name[name] += (b - a) / 1e6
                ivs.append((a, b))
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
        gaps, end = [], self.t0
        for a, b in sorted(ivs):
            if a > end:
                gaps.append((end, a))
            end = max(end, b)
        if self.t1 > end:
            gaps.append((end, self.t1))
        gaps.sort(key=lambda g: g[0] - g[1])
        named = []
        for a, b in gaps[:n]:
            named.append([self._host_at((a + b) / 2), (b - a) / 1e6])
        return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": named}

    def _host_at(self, t: float) -> str:
        best, width = "outside bench ranges", float("inf")
        for name, spans in self.marks.items():
            if name == WINDOW:
                continue
            for a, b in spans:
                if a <= t < b and b - a < width:
                    best, width = name, b - a
        return best
