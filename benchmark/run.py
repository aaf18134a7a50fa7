"""The benchmark of pyspectrogram_tpu_torch on Digital RF captures on disk.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

runs one cell of BENCHMARK.json on this machine's CUDA card: set-up
(the capture written from the seed, the program's first use, the cell's
shapes warmed), a measured window of ``--seconds``, then the check of
what the window produced against the plain reference
(``benchmark/reference``). The last line of standard output is one JSON
object: correct, attempted, failed, metrics (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer metrics), device, with
``--trace 1`` a breakdown, and last the numbers compared with their
limits, which also close standard error. Without a card, or in a
checkout without the program, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE.parent), str(HERE)]


def boot_clock() -> float:
    return time.clock_gettime(time.CLOCK_BOOTTIME)


def process_start() -> float:
    """This process's start on the boot clock (/proc/self/stat), or now
    where that cannot be read."""
    try:
        stat = Path("/proc/self/stat").read_text()
        ticks = int(stat.rsplit(")", 1)[1].split()[19])
        return ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return boot_clock()


T_START = process_start()


def cache_dirs(root: Path) -> None:
    """Every build and kernel cache in fixed directories of the checkout,
    so that only a checkout's first run builds."""
    build = root / "build"
    os.environ["PSTORCH_BUILD_DIR"] = str(build / "kernels")
    os.environ["PSTORCH_NATIVE_DIR"] = str(build / "native")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")
    os.environ["USE_FLAX"] = "0"


def run_cell(cell: dict, seed: int, seconds: float, trace: bool,
             device: str, t_start: float, control: bool = False) -> dict:
    """One run of ``cell`` on ``device``; the result's fields, with
    ``checks`` (and ``control``: the reference in bfloat16 put in the
    program's place, its numbers and ``correct`` judged as the
    program's, for setting limits)."""
    import torch

    from drfbench import guard, spec
    from drfbench.rundata import RunData
    from drfbench.trace import WINDOW, Marks, Trace, profiler

    Driver = spec.traffic_driver(cell["traffic"]["kind"])
    marks = Marks(trace)
    tmp = Path(tempfile.mkdtemp(prefix="drfbench-"))
    drv = Driver(cell, seed, device, tmp / "capture", marks)
    cuda = device.startswith("cuda")
    run = RunData(setup_s=0.0, latencies={}, window_s=float(seconds))
    try:
        drv.setup(max_seconds=seconds + 300)
        guard.check("after set-up")
        if trace:
            drv.install_spans(run)
        if cuda:
            torch.cuda.synchronize()
        prof = profiler(device) if trace else contextlib.nullcontext()
        run.setup_s = boot_clock() - t_start
        with prof:
            with marks.range(WINDOW):
                drv.window(seconds, run)
            drv.close_window(run)
            if cuda:
                torch.cuda.synchronize()
        if trace:
            drv.remove_spans()
            run.trace = Trace.from_profiler(prof, marks.host)
        run.latencies = {drv.kind: drv.latencies}
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        drv.release()
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        numbers = drv.compare(device) if drv.latencies else {}
        control_numbers = (drv.compare(device, control=True)
                           if control and drv.latencies else None)
    finally:
        drv.kill()
        shutil.rmtree(tmp, ignore_errors=True)
    guard.check("at the end")

    metrics = {}
    for m in cell["per_layer" if trace else "end_to_end"]:
        value = spec.metric_reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    limits = cell["traffic"]["limits"]
    checks, correct = judge(numbers, limits)
    dev = {"platform": "gpu" if cuda else device,
           "kind": torch.cuda.get_device_name(0) if cuda else device,
           "count": int(cell["workload"]["chips"]),
           "memory_peak_bytes": int(peak)}
    out = {"correct": correct, "attempted": drv.attempted,
           "failed": drv.failed, "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = run.trace.busy_s()
        dev["window_s"] = run.trace.window_s
        out["breakdown"] = run.trace.breakdown()
    out["notes"] = {"window_units": len(drv.latencies), "kind": drv.kind,
                    "set-up": drv.parts, **drv.notes()}
    if control_numbers is not None:
        c_checks, c_correct = judge(control_numbers, limits)
        out["control"] = {"correct": c_correct, "checks": c_checks}
    out["checks"] = checks
    return out


def judge(numbers: dict, limits: dict):
    """The numbers compared, each beside its limit, and whether the run
    is correct: every limit has its number and none is over it. The
    program's numbers and the control's go through this alike."""
    checks = {k: {"value": numbers[k], "limit": limits[k]}
              for k in limits if k in numbers}
    correct = (bool(checks) and set(checks) == set(limits)
               and all(c["value"] <= c["limit"] for c in checks.values()))
    return checks, correct


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    from drfbench import spec

    cell = spec.cell(spec.load_benchmark(waiting=True), args.workload)
    cache_dirs(spec.ROOT)
    import torch

    chips = int(cell["workload"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"this cell needs {chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    out = run_cell(cell, args.seed % (1 << 64), args.seconds,
                   bool(args.trace), "cuda", T_START)
    notes = out.pop("notes")
    print(f"card: {power_limit()}", file=sys.stderr)
    units, kind = notes.pop("window_units"), notes.pop("kind")
    for k, v in notes.items():
        print(f"{k}: {json.dumps(v)}", file=sys.stderr)
    print(f"window: {units} {kind}s, {out['failed']} failed",
          file=sys.stderr)
    for k, c in out["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(result_line(out), flush=True)
    return 0


def result_line(out: dict) -> str:
    """The result as one JSON line: the contract's keys, and last the
    numbers compared with their limits."""
    keys = ("correct", "attempted", "failed", "metrics", "device",
            "breakdown", "checks")
    return json.dumps({k: out[k] for k in keys if k in out})


if __name__ == "__main__":
    sys.exit(main())
