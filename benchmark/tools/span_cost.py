"""What the program's span sites cost on this host, in microseconds.

    python3 benchmark/tools/span_cost.py [--n 20000]

times ``with profiling.span(...)`` holding one ``profiling.count(...)``,
and ``profiling.count`` alone, in four states: recording off; on by
``profiling.tracing(True)``; on under an active torch.profiler profile
(CPU and, with a card, CUDA activities) on the profiling thread, where a
span also opens a ``record_function`` range; and the same on a thread
started before the profile (a live tab's thread in a traced benchmark
run, whose ranges the profiler drops). Prints one JSON line of
microseconds per call (the median of 5 rounds) and the card.
"""

from __future__ import annotations

import argparse
import itertools
import json
import statistics
import sys
import threading
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def _per_call_us(fn, n: int) -> float:
    rounds = []
    for _ in range(5):
        t = time.perf_counter_ns()
        fn(n)
        rounds.append((time.perf_counter_ns() - t) / n / 1e3)
    return statistics.median(rounds)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=20000)
    args = ap.parse_args(argv)
    import torch
    from torch.profiler import ProfilerActivity, profile

    from pyspectrogram_tpu_torch.utils import profiling

    def spans(n):
        for _ in itertools.repeat(None, n):
            with profiling.span("cost.span"):
                profiling.count("k")

    def counts(n):
        with profiling.span("cost.counts"):
            for _ in itertools.repeat(None, n):
                profiling.count("k")

    def both(n):
        return {"span_us": _per_call_us(spans, n),
                "count_us": _per_call_us(counts, n)}

    out = {"n": args.n}
    profiling.tracing(False)
    out["off"] = both(args.n)
    profiling.tracing(True)
    out["tracing"] = both(args.n)
    profiling.tracing(False)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts):
        out["profiler"] = both(args.n)
    # a thread started before the profile, as a live tab's
    go, done, res = threading.Event(), threading.Event(), {}

    def tab():
        go.wait(60)
        res.update(both(args.n))
        done.set()

    t = threading.Thread(target=tab, daemon=True)
    t.start()
    with profile(activities=acts):
        go.set()
        done.wait(600)
    t.join(60)
    out["profiler_other_thread"] = res
    profiling.reset()
    out["card"] = (torch.cuda.get_device_name(0)
                   if torch.cuda.is_available() else "none")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
