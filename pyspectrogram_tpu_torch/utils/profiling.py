"""Tracing and latency instrumentation — the port of
pyspectrogram_tpu/utils/profiling.py on torch.profiler.

:class:`StageTimer` keeps a per-stage wall-clock histogram and marks each
stage in traces: a ``torch.profiler.record_function`` range, plus an NVTX
range when CUDA is present. :func:`device_trace` records CPU and CUDA
activity into a Chrome trace, and :func:`device_busy_share` reads from one
how much of a marked span the device was busy.
"""

from __future__ import annotations

import contextlib
import json
import threading
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict, Iterator, Optional

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

#: Chrome-trace categories of work on the device
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


class StageTimer:
    """Thread-safe per-stage wall-clock histogram; stages nest via the
    context manager and carry their names into torch.profiler traces (and
    NVTX, when CUDA is present)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._samples: Dict[str, list] = defaultdict(list)

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        nvtx = torch.cuda.is_available()
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        t0 = time.perf_counter()
        try:
            with record_function(name):
                yield
        finally:
            dt = time.perf_counter() - t0
            if nvtx:
                torch.cuda.nvtx.range_pop()
            with self._lock:
                self._samples[name].append(dt)

    def record(self, name: str, seconds: float) -> None:
        with self._lock:
            self._samples[name].append(seconds)

    def stats(self, name: Optional[str] = None) -> dict:
        with self._lock:
            names = [name] if name else list(self._samples)
            out = {}
            for n in names:
                a = np.asarray(self._samples.get(n, []))
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
        with self._lock:
            self._samples.clear()


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
