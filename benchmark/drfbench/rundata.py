"""What one run measured, as the metric readers (``benchmark/metrics``)
see it."""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class RunData:
    #: seconds from the process's start to the window's start
    setup_s: float
    #: host-clock seconds of each unit of work in the window that
    #: succeeded, by kind ("request", "tick")
    latencies: Dict[str, List[float]]
    #: host-clock seconds of the benchmark's spans around calls into a
    #: layer, summed per unit: spans[name][unit] (traced runs)
    spans: Dict[str, Dict[int, float]] = dataclasses.field(
        default_factory=lambda: defaultdict(lambda: defaultdict(float)))
    #: the least seconds of each unit's device work (roofline.bound_s),
    #: by kind
    bound_s: Dict[str, List[float]] = dataclasses.field(
        default_factory=lambda: defaultdict(list))
    #: the window's profiler trace (traced runs), a drfbench.trace.Trace
    trace: Optional[object] = None
    #: the measured window's seconds
    window_s: float = 0.0


def percentile_ms(values, q: float) -> Optional[float]:
    """The q-th percentile (numpy's linear rule) of seconds, in ms."""
    if not values:
        return None
    return float(np.percentile(np.asarray(values, np.float64), q) * 1e3)


def median_span_ms(run: RunData, name: str) -> Optional[float]:
    """Median over units of a span's per-unit seconds, in ms."""
    per_unit = run.spans.get(name)
    if not per_unit:
        return None
    return float(np.median(list(per_unit.values())) * 1e3)


def roofline_pct(run: RunData, kind: str, mark: str) -> Optional[float]:
    """The least time of the units' device work over the time of the
    kernels that started inside ``mark`` ranges, in %."""
    if run.trace is None or not run.bound_s.get(kind):
        return None
    kernel_s = run.trace.kernel_s_within(mark)
    if kernel_s <= 0:
        return None
    return 100.0 * sum(run.bound_s[kind]) / kernel_s


def idle_pct(run: RunData) -> Optional[float]:
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)
