"""Shared refresh scheduler: merge same-shape tabs into one device launch —
the port of pyspectrogram_tpu/runtime/scheduler.py.

ONE refresh thread serves every registered written-mode processor, and
each cycle it

1. refreshes bounds and re-emits effective stats per processor (loop
   parity with runtime.processor.run);
2. delta-checks each processor's effective request (StiPipeline
   .request_key) and re-emits the cached result for unchanged ones — no
   read, no copy, no device work;
3. groups the CHANGED requests by batch shape — nfft/nint/ntime/mode/
   window/precision/eps/subchannel count and device, plus the display crop
   plan in tile mode — and runs each group of >= 2 as ONE
   models.batch.BatchedStiPipeline launch; singletons run their own
   pipeline, as a standalone processor would, and so does every member of
   a group whose merged launch raised, and every meshed tab (it keeps
   its own sharded dispatch).

Processors opt in via ``SpectrogramProcessor(..., scheduler=...)``:
``start()`` then registers with the scheduler instead of spawning a
per-tab thread (streaming tabs keep their own thread). One slow launch
holds up every tab of the cycle (head-of-line blocking), as in the JAX
package.
"""

from __future__ import annotations

import threading
import time
import traceback
from typing import List, Optional

from pyspectrogram_tpu_torch.models import batch
from pyspectrogram_tpu_torch.utils.errors import TerminateReason
from pyspectrogram_tpu_torch.utils.log import get_logger, log_event

logger = get_logger("pstpu.scheduler")


class SharedRefreshScheduler:
    """One refresh loop for N written-mode processors.

    ``autostart=False`` skips the background thread so callers (tests,
    batch drivers) run deterministic cycles via :meth:`tick_once`.
    """

    def __init__(self, refresh_s: float = 0.1, autostart: bool = True):
        self.refresh_s = refresh_s
        self.autostart = autostart
        self._procs: List = []
        self._lock = threading.Lock()
        self._stop_evt = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # drain support: tab ids being served by the current cycle
        self._cv = threading.Condition()
        self._active: set = set()
        # observability
        self.ticks = 0
        self.merged_launches = 0   # batched launches (>= 2 requests)
        self.merged_requests = 0   # requests served by merged launches
        self.solo_launches = 0     # single-request launches

    # ------------------------------------------------------------ registry
    def register(self, proc) -> None:
        with self._lock:
            if proc not in self._procs:
                self._procs.append(proc)
            if self.autostart and (self._thread is None
                                   or not self._thread.is_alive()):
                self._stop_evt.clear()
                self._thread = threading.Thread(target=self._run,
                                                daemon=True)
                self._thread.start()

    def unregister(self, proc) -> None:
        with self._lock:
            if proc in self._procs:
                self._procs.remove(proc)

    def stop(self, wait: bool = True) -> None:
        """Stop the refresh thread; registered processors are left as
        they are. ``wait=False`` only signals (the thread is a daemon)."""
        self._stop_evt.set()
        t = self._thread
        if wait and t is not None and t is not threading.current_thread():
            t.join()

    def drain(self, proc, timeout: Optional[float] = None) -> None:
        """Block until the current cycle (if any) is no longer serving
        ``proc`` — the scheduler-mode counterpart of joining a processor
        thread."""
        with self._cv:
            self._cv.wait_for(lambda: id(proc) not in self._active, timeout)

    # ---------------------------------------------------------------- loop
    def _run(self) -> None:
        while not self._stop_evt.is_set():
            try:
                self.tick_once()
            except Exception:
                # a cycle-level bug must not stop every tab's refreshes
                # (per-tab failures terminate just that tab via _fail)
                logger.exception("refresh cycle failed; continuing")
            self._stop_evt.wait(self.refresh_s)

    def tick_once(self) -> None:
        """One refresh cycle over all registered processors."""
        with self._lock:
            procs = list(self._procs)
        with self._cv:
            self._active = {id(p) for p in procs}
        try:
            self._tick(procs)
        finally:
            with self._cv:
                self._active = set()
                self._cv.notify_all()

    def _tick(self, procs) -> None:
        self.ticks += 1
        work = []  # (proc, cfg, key) whose effective request changed
        for p in procs:
            if not p.is_running or p._stop.is_set():
                self.unregister(p)
                continue
            try:
                cfg = p.config
                p.ds.bnds_update()
                p._emit_stats(cfg)
                key = p.pipeline.request_key(cfg)
            except Exception:
                self._fail(p)
                continue
            if p._unchanged(key):
                # unchanged request: re-emit the cached result
                p.skipped_recomputes += 1
                self._deliver(p, p._last_result)
            else:
                work.append((p, cfg, key))
        groups: dict = {}
        for item in work:
            groups.setdefault(self._group_key(item[0], item[1]),
                              []).append(item)
        for gk, members in groups.items():
            if gk is None or len(members) == 1:
                for p, cfg, key in members:
                    self._solo(p, cfg, key)
            else:
                self._merged(members)

    # ------------------------------------------------------------ grouping
    @staticmethod
    def _group_key(p, cfg):
        """Hashable batch-compatibility key; None = never batch (a meshed
        pipeline keeps its own sharded dispatch, as in the JAX package).
        Equal keys fold into one BatchedStiPipeline launch: equal shape
        knobs, subchannel counts and device, plus — in tile mode — an
        equal crop plan (sample rate + frequency window)."""
        if p.pipeline.mesh is not None:
            return None
        try:
            chan, isub = p.pipeline.channel_of(cfg)
            nsub = 1 if isub is not None else len(p.ds.chan_2sub[chan])
            sr = p.ds.sr_dict[chan]
        except Exception:
            return None
        return (cfg.nfft, cfg.nint, cfg.ntime, cfg.mode, cfg.window,
                cfg.precision, cfg.eps, nsub, p.pipeline.device,
                cfg.display_tile,
                (cfg.freq_window_khz, sr) if cfg.display_tile else None)

    # ------------------------------------------------------------- compute
    def _solo(self, p, cfg, key) -> None:
        t0 = time.perf_counter()
        try:
            result = p.pipeline.compute(cfg, refresh_bounds=False)
        except Exception:
            self._fail(p)
            return
        p.latencies_s.append(time.perf_counter() - t0)
        p._last_key, p._last_result = key, result
        self.solo_launches += 1
        self._deliver(p, result)

    def _merged(self, members) -> None:
        base = members[0][1]  # shape knobs equal across the group
        t0 = time.perf_counter()
        try:
            bp = batch.BatchedStiPipeline(
                [(p.ds, c.channel or None) for p, c, _ in members], base,
                device=members[0][0].pipeline.device)
            results = bp.compute(
                # a member's None span stays ITS full capture: (None,
                # None) resolves to that dataset's own bounds
                time_spans=[c.time_span if c.time_span is not None
                            else (None, None) for _, c, _ in members],
                color_ranges=[c.color_range_db for _, c, _ in members],
                refresh_bounds=False)
        except Exception:
            logger.exception("merged launch failed; falling back to solo "
                             "launches (%d requests)", len(members))
            for p, cfg, key in members:
                self._solo(p, cfg, key)
            return
        dt = time.perf_counter() - t0
        self.merged_launches += 1
        self.merged_requests += len(members)
        log_event(logger, "merged launch", requests=len(members),
                  seconds=dt)
        for (p, cfg, key), result in zip(members, results):
            p.latencies_s.append(dt)
            p._last_key, p._last_result = key, result
            self._deliver(p, result)

    # ------------------------------------------------------------ delivery
    def _deliver(self, p, result) -> None:
        if p._stop.is_set() and p._sched_delivered:
            # stop landed while this cycle was in flight and the consumer
            # already holds delivered state (processor.run's rule)
            return
        p._sched_i += 1
        try:
            p._emit_iterated(p._sched_i, result)
        except Exception:
            # a raising client callback terminates ITS tab, never the loop
            self._fail(p)
            return
        p._sched_delivered = True
        if (p.max_iterations is not None
                and p._sched_i + 1 >= p.max_iterations):
            self._terminate(p, TerminateReason.OK)

    def _fail(self, p) -> None:
        # report the original error first: the on_terminated callback may
        # itself raise
        traceback.print_exc()
        p.is_running = False
        self._terminate(p, TerminateReason.LOOP_EXCEPTION)

    def _terminate(self, p, reason) -> None:
        """Terminate ONE tab without letting its on_terminated callback
        take the rest of the cycle down."""
        try:
            p._terminate(reason)  # unregisters via processor
        except Exception:
            logger.exception("terminate callback raised (tab %s)",
                             getattr(p, "tab_id", "?"))
            self.unregister(p)
