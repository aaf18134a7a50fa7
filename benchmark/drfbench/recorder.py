"""A Digital RF recorder in a process of its own: appends one block of the
seeded samples every period through the port's writer, until its
standard input closes or ``--max-blocks`` are written, then prints its
log as one JSON line. It starts (imports, its first block) while the
capture is still being written, says "ready", and begins to append at
the line "go" on its standard input.

    python3 benchmark/drfbench/recorder.py --config '<json>' --dir D \
        --seed N --first-block B --max-blocks M
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
# the checkout and the benchmark's folder, in place of this script's own
# folder (whose module names are the harness's, not top-level ones)
sys.path[0:1] = [str(HERE.parents[1]), str(HERE.parent)]

from drfbench.capture import block_rows, signal_of, writer  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--dir", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--first-block", type=int, required=True)
    ap.add_argument("--max-blocks", type=int, required=True)
    args = ap.parse_args(argv)
    config = json.loads(args.config)
    period = float(config["recorder"]["period_s"])
    rows = block_rows(config)
    sig = signal_of(config, args.seed)
    go, stop = threading.Event(), threading.Event()

    def watch_stdin():
        for line in sys.stdin:
            if line.strip() == "go":
                go.set()
        stop.set()
        go.set()

    threading.Thread(target=watch_stdin, daemon=True).start()
    blk = sig.block(args.first_block)
    print("ready", flush=True)
    go.wait()
    if stop.is_set():
        return 0
    w = writer(config, Path(args.dir), args.first_block * rows)
    due, began, done = [], [], []
    t0 = time.monotonic()
    for k in range(args.max_blocks):
        t_due = t0 + k * period
        if stop.wait(max(0.0, t_due - time.monotonic())):
            break
        due.append(t_due)
        began.append(time.monotonic())
        w.rf_write(blk)
        done.append(time.monotonic())
        blk = sig.block(args.first_block + k + 1)
    print(json.dumps({"first_block": args.first_block, "rows": rows,
                      "blocks": len(done), "due": due, "began": began,
                      "done": done}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
