"""Readings that the limits of a cell's check are set from, on the card:
runs of the cell at its own size, one per seed, in one process, each
printing the numbers its check compares (one JSON line a seed); with
``--control`` also the numbers of the reference in bfloat16 put in the
program's place, over the same requests or ticks; with ``--fault`` a
fault of ``drfbench.faults`` planted under the timed path.

    python3 benchmark/tools/readings.py --workload browse.headline \
        --seeds 101-112 --seconds 6 --control
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[0:1] = [str(HERE.parents[1]), str(HERE.parent)]

import run as bench  # noqa: E402
from drfbench import faults, spec  # noqa: E402


def seeds_of(text: str) -> list:
    out = []
    for part in text.split(","):
        a, _, b = part.partition("-")
        out += list(range(int(a), int(b or a) + 1))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", choices=faults.NAMES)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cell = spec.cell(spec.load_benchmark(waiting=True), args.workload)
    bench.cache_dirs(spec.ROOT)
    kind = cell["traffic"]["kind"]
    for seed in seeds_of(args.seeds):
        plant = (faults.plant(kind, args.fault) if args.fault
                 else contextlib.nullcontext())
        with plant:
            out = bench.run_cell(cell, seed, args.seconds, False, args.device,
                                 bench.boot_clock(), control=args.control)
        print(json.dumps({
            "workload": args.workload, "seed": seed, "fault": args.fault,
            "correct": out["correct"], "attempted": out["attempted"],
            "failed": out["failed"],
            "program": {k: v["value"] for k, v in out["checks"].items()},
            "control": out.get("control"), "metrics": out["metrics"],
            "notes": out["notes"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
