"""The capture on disk: written in set-up by the port's Digital RF writer,
and, for a capture being recorded, grown by a recorder in a process of
its own (``recorder.py``), as Digital RF recorders run.
"""

from __future__ import annotations

import json
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np

from drfbench.samples import Signal
from drfbench.spec import BENCH_DIR, ROOT


def signal_of(config: dict, seed: int) -> Signal:
    """The configuration's samples from ``seed``, in blocks of the
    recorder's append (or 0.1 s)."""
    return Signal(seed, config["sample_rate"], config["num_subchannels"],
                  config["signal"], block_rows(config))


def block_rows(config: dict) -> int:
    rec = config.get("recorder")
    return int(rec["block_rows"]) if rec else config["sample_rate"] // 10


def start_index(config: dict) -> int:
    return int(config["start_time_s"]) * int(config["sample_rate"])


def writer(config: dict, top: Path, first_row: int):
    from pyspectrogram_tpu_torch.io import DigitalRFWriter

    return DigitalRFWriter(
        top, config["channel"], np.dtype(config["dtype"]),
        start_global_index=start_index(config) + first_row,
        sample_rate_numerator=config["sample_rate"],
        subdir_cadence_secs=config["subdir_cadence_s"],
        file_cadence_millisecs=config["file_cadence_ms"],
        num_subchannels=config["num_subchannels"])


def write_capture(config: dict, top: Path, x: np.ndarray) -> None:
    writer(config, top, 0).rf_write(x.astype(np.dtype(config["dtype"]),
                                             copy=False))


class Recorder:
    """The recorder process: appends block after block on a fixed cadence
    from ``first_block`` on, until stopped; its log says when each block
    was due and when its append ended (``time.monotonic``, a clock both
    processes share)."""

    def __init__(self, config: dict, top: Path, seed: int,
                 first_block: int, max_blocks: int):
        cmd = [sys.executable, str(BENCH_DIR / "drfbench" / "recorder.py"),
               "--config", json.dumps(config), "--dir", str(top),
               "--seed", str(int(seed)), "--first-block", str(first_block),
               "--max-blocks", str(max_blocks)]
        self.proc = subprocess.Popen(
            cmd, cwd=str(ROOT), stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            text=True)
        self._lines = []
        self._reader = threading.Thread(target=self._read, daemon=True)
        self._reader.start()
        self.log = None

    def _read(self) -> None:
        for line in self.proc.stdout:
            self._lines.append(line)

    def wait_ready(self, timeout: float = 120.0) -> None:
        t_end = time.monotonic() + timeout
        while not any(s.startswith("ready") for s in self._lines):
            if self.proc.poll() is not None:
                raise RuntimeError(f"the recorder exited with "
                                   f"{self.proc.returncode} before it began")
            if time.monotonic() > t_end:
                raise RuntimeError("the recorder did not begin in time")
            time.sleep(0.01)

    def go(self) -> None:
        """Begin appending (the capture's set-up is on disk)."""
        self.proc.stdin.write("go\n")
        self.proc.stdin.flush()

    def stop(self, timeout: float = 60.0) -> dict:
        """Close its input (its cue to stop), wait for it, and return its
        log."""
        if self.log is not None:
            return self.log
        try:
            self.proc.stdin.close()
        except OSError:
            pass
        try:
            self.proc.wait(timeout)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()
            raise RuntimeError("the recorder did not stop in time")
        self._reader.join(timeout)
        logs = [s for s in self._lines if s.startswith("{")]
        if self.proc.returncode != 0 or not logs:
            raise RuntimeError(f"the recorder failed (exit "
                               f"{self.proc.returncode})")
        self.log = json.loads(logs[-1])
        return self.log

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


def recorded_rows(log: dict, t: float, rows: int) -> int:
    """Rows the recorder had appended by monotonic time ``t``."""
    done = np.asarray(log["done"])
    return int((done <= t).sum()) * rows
