"""Traffic of kind ``live``: live tabs on a capture that a recorder in
another process grows, each tab a ``SpectrogramProcessor("streaming",
RFDataset(dir), ...)`` on its own thread at the program's own pacing, as
the viewer runs a live tab.

A tick runs from its iteration's bounds refresh (the tab's
``RFDataset.bnds_update``, which the benchmark observes) to its result in
the tab's callback. The traffic file gives the view's knobs (``view``),
the number of tabs (``tabs``), the seconds of ticks before the window
(``warmup_s``), how many ticks per tab the check compares
(``check_ticks``) and the limits.
"""

from __future__ import annotations

import math
import threading
import time
from fractions import Fraction

import numpy as np
import torch

from drfbench import capture, roofline
from drfbench.browse import _gap, _level_gap, _view
from reference import sti as ref

#: a block the recorder ended this long before a tick's bounds refresh
#: is visible to that refresh
VISIBLE_AFTER_S = 0.05


class _Tab:
    def __init__(self, index: int):
        self.index = index
        self.proc = None
        self.pending = None          # (start, mark) of the tick in flight
        self.ticks = []              # delivered: dict per tick
        self.in_window = 0           # ticks delivered that began in it
        self.last = None             # the newest tick's payload
        self.missed = []             # starts of ticks never delivered
        self.terminated = None
        self.reads = 0.0


class Live:
    kind = "tick"
    #: the faults of ``drfbench.faults`` a live tab can have
    FAULTS = ("stale", "half_batch", "altered")

    def __init__(self, cell: dict, seed: int, device: str, top, marks):
        self.config = cell["config"]
        self.traffic = cell["traffic"]
        self.seed = int(seed)
        self.device = device
        self.top = top
        self.marks = marks
        self.sr = int(self.config["sample_rate"])
        self.lo = capture.start_index(self.config)
        self.n0 = int(self.config["seconds"]) * self.sr
        self.tabs = []
        self.recorder = None
        self.window_t = (math.inf, math.inf)
        self.keep = set()
        self.stopping = False
        self.attempted = self.failed = 0
        self.latencies = []
        self.parts = {}             # seconds of each step of set-up

    # ------------------------------------------------------------- set-up
    def setup(self, max_seconds: float) -> None:
        from pyspectrogram_tpu_torch import SpectrogramConfig
        from pyspectrogram_tpu_torch.io import RFDataset
        from pyspectrogram_tpu_torch.runtime import SpectrogramProcessor
        from pyspectrogram_tpu_torch.runtime.signals import ProcessorCallbacks

        self.sig = capture.signal_of(self.config, self.seed)
        rows = self.sig.block_rows
        self.first_block = self.n0 // rows
        period = float(self.config["recorder"]["period_s"])
        # the recorder starts while the capture is made and written
        self.recorder = capture.Recorder(
            self.config, self.top, self.seed, self.first_block,
            max_blocks=int(max_seconds / period) + 1)
        t = time.monotonic()
        self.x0 = self.sig.blocks(0, self.first_block)
        self.parts["samples_s"] = time.monotonic() - t
        t = time.monotonic()
        capture.write_capture(self.config, self.top, self.x0)
        self.parts["write_s"] = time.monotonic() - t
        self.cfg = SpectrogramConfig(**_view(self.traffic["view"]))
        t = time.monotonic()
        self.recorder.wait_ready()
        self.recorder.go()
        self.parts["recorder_wait_s"] = time.monotonic() - t
        for k in range(int(self.traffic["tabs"])):
            tab = _Tab(k)
            ds = RFDataset(self.top)
            ds.bnds_update = self._observed(tab, ds.bnds_update)
            cb = ProcessorCallbacks(
                on_iterated=lambda p, tab=tab: self._delivered(tab, p),
                on_terminated=lambda t, tab=tab: self._terminated(tab, t))
            tab.proc = SpectrogramProcessor("streaming", ds, k, self.cfg,
                                            callbacks=cb, device=self.device)
            if tab.proc.reason is not None:
                raise RuntimeError(f"live tab {k} did not start: "
                                   f"{tab.proc.reason}")
            self.tabs.append(tab)
        t = time.monotonic()
        for tab in self.tabs:
            tab.proc.start()
        # each tab's cold start (its first tick reads the whole window),
        # then warmup_s of ticks: pushes of one and of several blocks
        for tab in self.tabs:
            self._wait(lambda tab=tab: tab.ticks or tab.terminated, 300)
            if not tab.ticks:
                raise RuntimeError(f"live tab {tab.index} delivered nothing "
                                   f"({tab.terminated})")
        self.parts["cold_start_s"] = time.monotonic() - t
        time.sleep(float(self.traffic["warmup_s"]))
        ends = [t["end"] for t in self.tabs[0].ticks[1:]]
        self.tick_period_s = (float(np.median(np.diff(ends)))
                              if len(ends) > 2 else 0.1)

    def _wait(self, pred, timeout: float) -> bool:
        t_end = time.monotonic() + timeout
        while not pred():
            if time.monotonic() > t_end:
                return False
            time.sleep(0.005)
        return True

    # ------------------------------------------------ what the tabs report
    def _observed(self, tab: _Tab, bnds_update):
        def inner():
            now = time.monotonic()
            if tab.pending is not None:
                # the last iteration delivered nothing
                self.marks.close(tab.pending[1])
                tab.missed.append(tab.pending[0])
            tab.pending = (now, self.marks.open("bench.tick"))
            tab.reads = 0.0
            return bnds_update()
        return inner

    def _delivered(self, tab: _Tab, payload) -> None:
        now = time.monotonic()
        if tab.pending is None:
            return
        start, mark = tab.pending
        self.marks.close(mark)
        tab.pending = None
        eng = tab.proc._live.engine
        tick = {"start": start, "end": now, "cursor": int(eng.next_sample),
                "pushed": int(eng.total_cols), "read_s": tab.reads,
                "payload": None}
        w0, w1 = self.window_t
        if w0 <= start < w1:
            # only the payloads the check compares are held, so that the
            # window's memory stays flat
            if tab.in_window in self.keep:
                tick["payload"] = payload
            tab.in_window += 1
            tab.last = (len(tab.ticks), payload)
        tab.ticks.append(tick)

    def _terminated(self, tab: _Tab, t) -> None:
        tab.terminated = t
        if tab.pending is not None and not self.stopping:
            self.marks.close(tab.pending[1])
            tab.missed.append(tab.pending[0])
            tab.pending = None

    def install_spans(self, run) -> None:
        """Host-clock spans around the live engine's reads (traced runs),
        summed per tick of the tab whose thread reads."""
        from pyspectrogram_tpu_torch.runtime.live import LiveStreamEngine

        by_thread = {}
        drv = self
        read = LiveStreamEngine._read

        def timed_read(eng, *a, **kw):
            tab = by_thread.get(threading.get_ident())
            if tab is None:
                for t in drv.tabs:
                    if t.proc._thread is threading.current_thread():
                        by_thread[threading.get_ident()] = tab = t
            t0 = time.perf_counter()
            with drv.marks.range("bench.live_read"):
                try:
                    return read(eng, *a, **kw)
                finally:
                    if tab is not None:
                        tab.reads += time.perf_counter() - t0

        self._saved_read = read
        LiveStreamEngine._read = timed_read

    def remove_spans(self) -> None:
        from pyspectrogram_tpu_torch.runtime.live import LiveStreamEngine

        if getattr(self, "_saved_read", None):
            LiveStreamEngine._read = self._saved_read
            self._saved_read = None

    # ---------------------------------------------------------- the window
    def _keep(self, seconds: float) -> set:
        """Per tab, the indices (among the window's ticks) of the ticks
        the check compares, drawn from the seed before the window out of
        the ticks it is expected to hold; the last tick is held too."""
        expect = max(2, int(seconds / max(self.tick_period_s, 1e-3)))
        rng = np.random.default_rng([self.seed, 0xC4EC])
        k = max(0, int(self.traffic["check_ticks"]) - 1)
        return set(rng.choice(expect, min(k, expect), replace=False).tolist())

    def window(self, seconds: float, run) -> None:
        self.keep = self._keep(seconds)
        w0 = time.monotonic()
        self.window_t = (w0, w0 + seconds)
        time.sleep(max(0.0, self.window_t[1] - time.monotonic()))

    def close_window(self, run) -> None:
        """Wait for the ticks in flight at the window's end, stop the
        tabs and the recorder, and count what the window held."""
        w0, w1 = self.window_t
        for tab in self.tabs:
            self._wait(lambda tab=tab: tab.pending is None
                       or tab.pending[0] >= w1 or tab.terminated, 60)
        self.stopping = True
        for tab in self.tabs:
            tab.proc.abort()
        for tab in self.tabs:
            tab.proc.join(60)
            if tab.proc._thread is not None and tab.proc._thread.is_alive():
                raise RuntimeError(f"live tab {tab.index} did not stop")
        self.log = self.recorder.stop()
        c = self.cfg
        for tab in self.tabs:
            prev = None
            for t in tab.ticks:
                if w0 <= t["start"] < w1:
                    self.attempted += 1
                    self.latencies.append(t["end"] - t["start"])
                    run.spans["tick_read"][len(self.latencies)] = t["read_s"]
                    new = t["cursor"] - prev if prev is not None else 0
                    run.bound_s[self.kind].append(roofline.bound_s(
                        *roofline.tick_work(
                            nfft=c.nfft, hop=self.hop, nsub=self.nsub,
                            new_samples=new, window_cols=self.window_cols,
                            view_rows=self.view_rows,
                            tile_bins=self.tile_bins,
                            sample_bytes=np.dtype(
                                self.config["dtype"]).itemsize)))
                prev = t["cursor"]
            lost = [s for s in tab.missed if w0 <= s < w1]
            if tab.pending is not None and w0 <= tab.pending[0] < w1:
                lost.append(tab.pending[0])
            self.attempted += len(lost)
            self.failed += len(lost)

    @property
    def nsub(self) -> int:
        return int(self.config["num_subchannels"])

    @property
    def hop(self) -> int:
        return int(self.cfg.hop or self.cfg.nfft * self.cfg.nint)

    @property
    def window_cols(self) -> int:
        """Columns of the trailing window: ceil(stream_seconds * sr /
        hop) (the viewer's live window in hop-spaced columns)."""
        return math.ceil(Fraction(self.cfg.stream_seconds) * self.sr
                         / self.hop)

    @property
    def view_rows(self) -> int:
        """Rows of a full window's view (the ring's stride grid)."""
        W = self.window_cols
        stride = -(-W // max(1, min(self.cfg.ntime, W)))
        return -(-W // stride)

    @property
    def tile_bins(self) -> int:
        if not self.cfg.display_tile:
            return 0
        return len(ref.tile_bins(ref.shifted_freqs(self.cfg.nfft, self.sr),
                                 self.cfg.freq_window_khz))

    def release(self) -> None:
        for tab in self.tabs:
            tab.proc = None

    def notes(self) -> dict:
        """How late the recorder ran."""
        log = getattr(self, "log", None)
        if not log:
            return {}
        late = np.asarray(log["began"]) - np.asarray(log["due"])
        took = np.asarray(log["done"]) - np.asarray(log["began"])
        ms = (lambda f, v: float(f(v) * 1e3) if len(v) else None)
        return {"recorder": {"blocks": log["blocks"],
                             "late_ms_p50": ms(np.median, late),
                             "late_ms_max": ms(np.max, late),
                             "append_ms_p50": ms(np.median, took)}}

    @staticmethod
    def fault(name: str):
        from drfbench import faults

        return faults.live(name)

    def kill(self) -> None:
        """Stop whatever still runs (after a failure)."""
        for tab in self.tabs:
            if tab.proc is not None:
                tab.proc.abort()
                tab.proc.join(30)
        if self.recorder is not None:
            self.recorder.kill()

    def lag_samples(self) -> int:
        """Largest distance, over the window's ticks, from the end of what
        the recorder had appended a moment before a tick's bounds refresh
        to the end of the samples that tick had consumed."""
        w0, w1 = self.window_t
        rows = self.sig.block_rows
        worst = -(1 << 62)
        for tab in self.tabs:
            for t in tab.ticks:
                if w0 <= t["start"] < w1:
                    end = self.lo + self.n0 + capture.recorded_rows(
                        self.log, t["start"] - VISIBLE_AFTER_S, rows)
                    worst = max(worst, end - t["cursor"])
        return int(worst)

    # ----------------------------------------------------------- the check
    def sample(self) -> list:
        """(tab, tick) pairs the check compares: per tab, the window's
        ticks held (:meth:`_keep`) and its last one."""
        out = []
        for tab in self.tabs:
            if tab.last is None:
                continue
            tab.ticks[tab.last[0]]["payload"] = tab.last[1]
            out += [(tab, t) for t in tab.ticks if t["payload"] is not None]
        return out

    def samples(self) -> np.ndarray:
        """Every sample the capture held at the end: set-up's and the
        recorder's blocks, made again from the seed."""
        extra = self.sig.blocks(self.first_block, int(self.log["blocks"]))
        return np.concatenate([self.x0, extra])

    def compare(self, device: str, control: bool = False) -> dict:
        """The numbers the check compares over the sampled ticks: the
        program's view and median against the reference's (or, with
        ``control``, the reference in bfloat16 put in the program's
        place). Every column the sampled ticks need is computed once."""
        c = self.cfg
        beta, eps = float(c.window[1]), float(c.eps)
        frame_len = c.nfft * c.nint
        hop, W = self.hop, self.window_cols
        n_target = max(1, min(c.ntime, W))
        stride = -(-W // n_target)
        n_disp = -(-W // stride)
        carry = frame_len - hop
        bins = ref.tile_bins(ref.shifted_freqs(c.nfft, self.sr),
                             c.freq_window_khz)
        x = self.samples()
        end = self.lo + len(x)
        plans = []
        for _, t in self.sample():
            p = t["payload"]
            # where the engine's ring stands: its read cursor and the
            # columns pushed since it began (or restarted behind a
            # backlog); column j of the ring starts at first + j * hop
            cur, pushed = t["cursor"], t["pushed"]
            first = cur - carry - pushed * hop
            newest = cur - frame_len
            ring = newest - stride * hop * np.arange(n_disp - 1, -1, -1)
            ring = ring[ring >= first]
            # complete columns past the cursor (the tail view) continue
            # the grid
            tail = cur - carry + hop * (stride - 1 + stride * np.arange(
                len(p.times)))
            tail = tail[tail + frame_len <= end][:max(0, len(p.times)
                                                      - len(ring))]
            # while the window fills, the median spans the newest
            # power-of-two columns (the engine's documented ladder)
            n_med = W if pushed >= W else 1 << (pushed.bit_length() - 1)
            plans.append((p, np.concatenate([ring, tail]).astype(np.int64),
                          newest - hop * np.arange(n_med - 1, -1, -1)))
        cols = np.unique(np.concatenate([np.concatenate(pl[1:])
                                         for pl in plans]))
        kw = dict(nfft=c.nfft, nint=c.nint, beta=beta, device=device)
        want = ref.psd_columns(x, cols - self.lo, **kw)
        alt = (ref.psd_columns(x, cols - self.lo, precision="bf16", **kw)
               if control else None)
        out = {"frame_start_errors": 0, "tick_lag_samples": self.lag_samples(),
               "median_db_gap": 0.0}
        out["tile_level_gap" if c.display_tile else "spectra_db_gap"] = 0
        for p, starts, med_starts in plans:
            iv = torch.as_tensor(np.searchsorted(cols, starts), device=want.device)
            im = torch.as_tensor(np.searchsorted(cols, med_starts),
                                 device=want.device)
            want_db = ref.dbfs(want[iv], eps)
            want_med = ref.dbfs(ref.median_time_chunked(want[im]), eps)
            want_times = ref.start_times_us(starts, self.sr)
            if control:
                got_db = ref.dbfs(alt[iv], eps)
                got_med = ref.dbfs(ref.median_time_chunked(alt[im]), eps)
                got_tile = (ref.tile_levels(got_db, bins, c.color_range_db)
                            if c.display_tile else None)
                got_times, got_mask = want_times, np.ones(len(starts), bool)
            else:
                got_med = np.moveaxis(p.sxx_med_dbfs, 0, -1)
                got_tile = p.tile
                got_db = (None if p.sxx_dbfs is None
                          else np.moveaxis(p.sxx_dbfs, 0, -1))
                got_times = np.asarray(p.times).astype(
                    "datetime64[us]").astype(np.int64)
                got_mask = np.asarray(p.mask, bool)
            if len(got_times) != len(starts):
                out["frame_start_errors"] += max(len(got_times), len(starts))
            else:
                out["frame_start_errors"] += int(
                    ((got_times != want_times) | ~got_mask).sum())
            out["median_db_gap"] = max(out["median_db_gap"],
                                       _gap(got_med, want_med))
            if c.display_tile:
                want_tile = ref.tile_levels(want_db, bins, c.color_range_db)
                out["tile_level_gap"] = max(out["tile_level_gap"],
                                            _level_gap(got_tile, want_tile))
            else:
                out["spectra_db_gap"] = max(out["spectra_db_gap"],
                                            _gap(got_db, want_db))
        return out


Driver = Live
