"""Traffic of kind ``browse``: one closed-loop user viewing a recorded
capture, request after request through
``StiPipeline(RFDataset(dir), cfg, device).compute()``.

The traffic file gives the view's knobs (``view``, a SpectrogramConfig's
fields), the spans requested (``spans``: seconds, or null for the whole
capture; each round of len(spans) requests takes every span once, in an
order drawn from the seed, at a start drawn uniformly), how many
requests the check compares (``check_requests``) and the limits. Only
the results the check compares are held, so that the window's memory
stays flat.
"""

from __future__ import annotations

import threading
import time
import traceback
from fractions import Fraction

import numpy as np
import torch

from drfbench import capture, roofline
from reference import sti as ref


class Browse:
    kind = "request"
    #: the faults of ``drfbench.faults`` a view can have; a request holds
    #: no state, so none is left unchanged ("stale" returns an earlier
    #: answer, which is the right one where the same view is asked again)
    FAULTS = ("half_batch", "altered")

    def __init__(self, cell: dict, seed: int, device: str, top, marks):
        self.config = cell["config"]
        self.traffic = cell["traffic"]
        self.seed = int(seed)
        self.device = device
        self.top = top
        self.marks = marks
        self.sr = int(self.config["sample_rate"])
        self.lo = capture.start_index(self.config)
        self.n = int(self.config["seconds"]) * self.sr
        self.results = {}
        self.latencies = []
        self.attempted = self.failed = 0
        self.unit = -1
        self.parts = {}             # seconds of each step of set-up

    # ------------------------------------------------------------- set-up
    def setup(self, max_seconds: float = 0.0) -> None:
        from pyspectrogram_tpu_torch import SpectrogramConfig
        from pyspectrogram_tpu_torch.io import RFDataset
        from pyspectrogram_tpu_torch.models import sti

        t = time.monotonic()
        self.sig = capture.signal_of(self.config, self.seed)
        nblocks = self.n // self.sig.block_rows
        self.x = self.sig.blocks(0, nblocks)
        self.parts["samples_s"] = time.monotonic() - t
        t = time.monotonic()
        capture.write_capture(self.config, self.top, self.x)
        self.parts["write_s"] = time.monotonic() - t
        self.cfg = SpectrogramConfig(**_view(self.traffic["view"]))
        t = time.monotonic()
        self.ds = RFDataset(self.top)
        self.pipe = sti.StiPipeline(self.ds, self.cfg, device=self.device)
        # every span once, before the window: its shapes and read paths
        warm = []
        for i, span in enumerate(self.traffic["spans"]):
            t0 = time.perf_counter()
            self.pipe.compute(self.cfg.replace(
                time_span=self._span(span, np.random.default_rng(
                    [self.seed, 0xA11, i]))))
            warm.append(time.perf_counter() - t0)
        self._sync()
        self.warm_mean_s = float(np.mean(warm))
        self.parts["warm_s"] = time.monotonic() - t

    def _span(self, seconds, rng):
        """A request's time_span: None for the whole capture, else
        ``seconds`` at a uniform start."""
        if seconds is None:
            return None
        m = int(round(float(seconds) * self.sr))
        s = self.lo + int(rng.integers(0, self.n - m + 1))
        return (float(Fraction(s, self.sr)), float(Fraction(s + m, self.sr)))

    def schedule(self):
        """Request i's time span: rounds of every span once, in a seeded
        order."""
        rng = np.random.default_rng([self.seed, 0x5CED])
        spans = self.traffic["spans"]
        while True:
            for j in rng.permutation(len(spans)):
                yield spans[j], self._span(spans[j], rng)

    def _sync(self) -> None:
        if self.device.startswith("cuda"):
            torch.cuda.synchronize()

    # ---------------------------------------------------------- the spans
    def install_spans(self, run) -> None:
        """Host-clock spans around the host read and assembly and the
        device half of each request (traced runs)."""
        from pyspectrogram_tpu_torch.models import sti

        lock = threading.Lock()
        drv = self

        def wrap(fn, name, mark):
            def inner(*a, **kw):
                unit = drv.unit
                t0 = time.perf_counter()
                with drv.marks.range(mark):
                    try:
                        return fn(*a, **kw)
                    finally:
                        with lock:
                            run.spans[name][unit] += time.perf_counter() - t0
            return inner

        self._saved = (sti.assemble_device_block,
                       sti.assemble_device_block_prefetch,
                       sti.StiPipeline.compute_block)
        # the prefetched assembly calls the plain one per chunk on a worker
        # thread: "assemble" is the outer call of each request
        sti.assemble_device_block_prefetch = wrap(
            sti.assemble_device_block_prefetch, "assemble",
            "bench.assemble")
        plain = sti.assemble_device_block
        timed = wrap(plain, "assemble", "bench.assemble")

        def plain_outer(*a, **kw):
            if threading.current_thread() is threading.main_thread():
                return timed(*a, **kw)
            return plain(*a, **kw)

        sti.assemble_device_block = plain_outer
        sti.StiPipeline.compute_block = wrap(
            sti.StiPipeline.compute_block, "compute_block",
            "bench.compute_block")

    def remove_spans(self) -> None:
        from pyspectrogram_tpu_torch.models import sti

        if getattr(self, "_saved", None):
            (sti.assemble_device_block, sti.assemble_device_block_prefetch,
             sti.StiPipeline.compute_block) = self._saved
            self._saved = None

    # ---------------------------------------------------------- the window
    def _keep(self, seconds: float) -> set:
        """Indices of the requests whose results the check compares,
        drawn before the window so that only those are held: the first
        round (every span, the whole capture among them) and a seeded
        sample of the requests the window is expected to hold."""
        first = len(self.traffic["spans"])
        expect = max(first + 1, int(seconds / max(self.warm_mean_s, 1e-3)))
        k = max(0, int(self.traffic["check_requests"]) - first)
        rng = np.random.default_rng([self.seed, 0xC4EC])
        pool = np.arange(first, expect)
        pick = rng.choice(pool, min(k, len(pool)), replace=False)
        return set(range(first)) | set(pick.tolist())

    def window(self, seconds: float, run) -> None:
        keep = self._keep(seconds)
        t_end = time.perf_counter() + seconds
        sched = self.schedule()
        work = roofline.bound_s(*self._work())
        i = 0
        while time.perf_counter() < t_end:
            kind, span = next(sched)
            self.unit = i
            self.attempted += 1
            t0 = time.perf_counter()
            try:
                with self.marks.range("bench.request"):
                    res = self.pipe.compute(self.cfg.replace(time_span=span))
            except Exception:
                traceback.print_exc()
                self.failed += 1
            else:
                self.latencies.append(time.perf_counter() - t0)
                if i in keep:
                    self.results[i] = (kind, span, res)
                run.bound_s[self.kind].append(work)
            i += 1

    def _work(self):
        c = self.cfg
        tile = 0
        if c.display_tile:
            tile = len(ref.tile_bins(ref.shifted_freqs(c.nfft, self.sr),
                                     c.freq_window_khz))
        return roofline.request_work(
            nfft=c.nfft, nint=c.nint, ntime=c.ntime,
            nsub=self.config["num_subchannels"],
            sample_bytes=np.dtype(self.config["dtype"]).itemsize,
            tile_bins=tile)

    def close_window(self, run) -> None:
        """Nothing is in flight once the closed loop ends."""

    def release(self) -> None:
        """Free the program's state (after the peak has been read)."""
        self.pipe = self.ds = None

    def kill(self) -> None:
        """Nothing runs beside this process."""

    def notes(self) -> dict:
        return {}

    @staticmethod
    def fault(name: str):
        from drfbench import faults

        return faults.browse(name)

    # ----------------------------------------------------------- the check
    def compare(self, device: str, control: bool = False) -> dict:
        """The numbers the check compares, over the requests held
        (:meth:`_keep`): the program's outputs against the reference's (or, with ``control``,
        the reference in bfloat16 put in the program's place)."""
        c = self.cfg
        beta = float(c.window[1])
        eps = float(c.eps)
        freqs = ref.shifted_freqs(c.nfft, self.sr)
        bins = ref.tile_bins(freqs, c.freq_window_khz)
        hi = self.lo + self.n - 1
        out = {"frame_start_errors": 0, "spectra_db_gap": 0.0,
               "median_db_gap": 0.0}
        if c.display_tile:
            out["tile_level_gap"] = 0
        wanted = {}                 # the reference's answer, once a span
        for i in sorted(self.results):
            _, span, res = self.results[i]
            t0, t1 = ((float(Fraction(self.lo, self.sr)),
                       float(Fraction(hi, self.sr))) if span is None
                      else span)
            st, en = ref.time_to_sample(t0, self.sr), ref.time_to_sample(
                t1, self.sr)
            starts = ref.frame_starts(st, en, c.nfft, c.nint, c.ntime)
            if (st, en) not in wanted:
                p = ref.psd_columns(self.x, starts - self.lo, nfft=c.nfft,
                                    nint=c.nint, beta=beta, device=device)
                wanted[(st, en)] = (p, ref.dbfs(p, eps),
                                    ref.dbfs(ref.median_time(p), eps))
            p, want_db, want_med = wanted[(st, en)]
            if control:
                q = ref.psd_columns(self.x, starts - self.lo, nfft=c.nfft,
                                    nint=c.nint, beta=beta, device=device,
                                    precision="bf16")
                got = {"starts": starts, "times": ref.start_times_us(
                    starts, self.sr), "mask": np.ones(len(starts), bool),
                    "db": ref.dbfs(q, eps), "med": ref.dbfs(
                        ref.median_time(q), eps)}
                if c.display_tile:
                    got["tile"] = ref.tile_levels(got["db"], bins,
                                                  c.color_range_db)
            else:
                got = {"starts": np.asarray(res.frame_starts),
                       "times": np.asarray(res.times).astype(
                           "datetime64[us]").astype(np.int64),
                       "mask": np.asarray(res.mask, bool),
                       "med": torch.as_tensor(np.moveaxis(
                           res.sxx_med_dbfs, 0, -1), device=device)}
                if res.sxx_dbfs is not None:
                    got["db"] = torch.as_tensor(
                        np.moveaxis(res.sxx_dbfs, 0, -1), device=device)
                if c.display_tile:
                    got["tile"] = torch.as_tensor(res.tile, device=device)
            out["frame_start_errors"] += _start_errors(
                got, starts, ref.start_times_us(starts, self.sr))
            if "db" in got and got["db"] is not None:
                out["spectra_db_gap"] = max(out["spectra_db_gap"], _gap(
                    got["db"], want_db))
            out["median_db_gap"] = max(out["median_db_gap"], _gap(
                got["med"], want_med))
            if c.display_tile:
                want_tile = ref.tile_levels(want_db, bins, c.color_range_db)
                out["tile_level_gap"] = max(out["tile_level_gap"], _level_gap(
                    got["tile"], want_tile))
        if c.display_tile:
            del out["spectra_db_gap"]
        return out


Driver = Browse


def _view(view: dict) -> dict:
    kw = dict(view)
    for k in ("window", "color_range_db", "freq_window_khz"):
        if k in kw:
            kw[k] = tuple(kw[k])
    return kw


def _start_errors(got: dict, starts, times_us) -> int:
    """Columns whose start, time or validity differ (every column, when
    the counts differ)."""
    g = np.asarray(got["starts"], np.int64)
    if g.shape != starts.shape:
        return max(len(g), len(starts))
    bad = ((g != starts) | (np.asarray(got["times"]) != times_us)
           | ~np.asarray(got["mask"], bool))
    return int(bad.sum())


def _gap(got, want) -> float:
    """Largest |got - want| (dB), float64; inf where the shapes differ."""
    got = torch.as_tensor(got).to(want.device, torch.float64)
    if got.shape != want.shape:
        return float("inf")
    return float((got - want).abs().max())


def _level_gap(got, want) -> int:
    got = torch.as_tensor(got).to(want.device)
    if got.shape != want.shape:
        return 256
    return int((got.to(torch.int32) - want.to(torch.int32)).abs().max())
