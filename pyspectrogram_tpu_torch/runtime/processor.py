"""Worker-loop processor — the port of pyspectrogram_tpu/runtime/
processor.py, on one torch device or, with ``mesh``, over the ranks of a
parallel.make_mesh mesh (SPMD: every rank runs the same processor on its
own thread and gets the whole result).

Behaviour parity with the JAX processor (and through it with the
reference's ``DrfProcessor`` worker, drfProc.py:209-361):

* "written" mode re-reads the user-selected bounds every iteration and,
  when the effective request is unchanged, re-emits the cached result
  (the delta-aware loop); "streaming" mode ticks a runtime.live
  LiveStreamEngine, which reads only the samples written since its last
  tick;
* bounds are refreshed and the effective settings echoed each iteration;
* pacing sleeps between iterations (0.08 s streaming / 0.1 s written);
* terminate reason codes: 0 user stop, 1 missing path, 4 loop exception
  (an init failure on an existing directory is 4 with the error as
  detail);
* settings updates swap an immutable ``SpectrogramConfig`` snapshot under
  a lock;
* with a shared ``scheduler`` (runtime.scheduler), written-mode tabs
  register with its refresh loop instead of running their own thread.

The device work of an iteration is launched on the calling thread's
current CUDA stream: tabs on several threads serialize on the card, as
they do on one TPU. On a mesh each rank's loop makes the same collectives
in the same order, so whether an iteration recomputes or re-emits its
cached result is decided by every rank together (:meth:`_unchanged`).
"""

from __future__ import annotations

import pathlib
import threading
import time
import traceback
from collections import deque
from typing import Optional, Union

import numpy as np
import torch

from pyspectrogram_tpu_torch.io.reader import RFDataset
from pyspectrogram_tpu_torch.models.sti import StiPipeline, check_device
from pyspectrogram_tpu_torch.parallel import mesh as pmesh
from pyspectrogram_tpu_torch.runtime.live import LiveStreamEngine, _EngineSlot
from pyspectrogram_tpu_torch.runtime.signals import (
    Iterated,
    ProcessorCallbacks,
    StatsUpdated,
    Terminated,
)
from pyspectrogram_tpu_torch.utils.config import (
    SpectrogramConfig,
    resolve_time_span,
)
from pyspectrogram_tpu_torch.utils.errors import TerminateReason
from pyspectrogram_tpu_torch.utils.log import get_logger, log_event

logger = get_logger("pstpu.processor")


class SpectrogramProcessor:
    """One dataset's processing loop, running on a host thread, with its
    device work on ``device``."""

    def __init__(
        self,
        datasource: str,
        drfdir,
        tab_id: int,
        config: SpectrogramConfig,
        callbacks: Optional[ProcessorCallbacks] = None,
        written_sleep: float = 0.1,
        streaming_sleep: float = 0.08,
        max_iterations: Optional[int] = None,
        scheduler=None,
        *,
        device: Union[str, torch.device],
        mesh=None,
    ):
        """``drfdir`` is a Digital RF directory, as in the JAX package.
        It may also be an already opened RFDataset (such as
        io.memory.MemoryDataset, which serves a capture from memory); the
        missing-path check then does not apply.

        ``device`` ("cuda", "cpu", ...) is required, as for StiPipeline;
        a CUDA device on a machine without one raises here.

        ``mesh`` (parallel.make_mesh; ``device`` then this rank's
        mesh_device) runs every iteration over the mesh's ranks: written
        mode through StiPipeline(mesh=), streaming mode on a chan-sharded
        live ring (LiveStreamEngine(mesh=)).

        ``scheduler`` (a runtime.scheduler.SharedRefreshScheduler) makes
        written-mode ``start()`` register with the shared refresh loop
        instead of spawning a per-tab thread, so same-shape tabs merge
        into one batched launch per cycle; streaming mode ignores it (the
        live engine's ring is stateful per tick)."""
        self.device = check_device(device)
        self.tab_id = tab_id
        self.callbacks = callbacks or ProcessorCallbacks()
        self.written_sleep = written_sleep
        self.streaming_sleep = streaming_sleep
        self.max_iterations = max_iterations
        self.reason: Optional[TerminateReason] = None
        self.is_running = False
        self._lock = threading.Lock()
        self._ready = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # bounded: the percentile stats cover the most recent iterations
        self.latencies_s = deque(maxlen=1 << 16)
        # delta-aware written loop: the last computed (request key,
        # result); ticks whose effective request is unchanged re-emit the
        # cached result instead of re-reading and recomputing (run())
        self._last_key = None
        self._last_result = None
        self.skipped_recomputes = 0
        # shared-scheduler mode (runtime.scheduler): per-processor
        # iteration counter + delivered flag the scheduler maintains
        self._scheduler = scheduler
        self._sched_i = -1
        self._sched_delivered = False

        streaming = str(datasource).lower() == "streaming"
        self._config = config.replace(streaming=streaming)

        opened = isinstance(drfdir, RFDataset)
        if not opened and not pathlib.Path(drfdir).expanduser().exists():
            # reference: terminate(1) from __init__ (drfProc.py:245-246)
            self._terminate(TerminateReason.MISSING_PATH)
            return
        try:
            self.ds = drfdir if opened else RFDataset(drfdir)
            self.pipeline = StiPipeline(self.ds, self._config, self.device,
                                        mesh=mesh)
        except Exception as e:
            # the dir exists but opening it failed: report the real error,
            # not the blanket missing-path code
            logger.exception("processor init failed (tab %d)", tab_id)
            self._terminate(TerminateReason.LOOP_EXCEPTION,
                            detail=f"Failed to open the dataset: {e}")
            return
        # live mode is incremental: a ring + carry persist across ticks
        self._live = (_EngineSlot(self.ds, self.device, mesh=mesh)
                      if streaming else None)
        self.chan_listing = list(self.ds.chan_2sub)
        self.sub_chan_list = list(self.ds.chan_entries)
        self.is_running = True
        self._ready.set()
        log_event(logger, "processor ready", tab_id=tab_id,
                  channels=self.chan_listing, streaming=streaming)

    # ------------------------------------------------------------- control
    @property
    def config(self) -> SpectrogramConfig:
        with self._lock:
            return self._config

    def start(self) -> "SpectrogramProcessor":
        """Spawn the worker thread — or, with a shared ``scheduler`` in
        written mode, register with its refresh loop."""
        if (self._scheduler is not None and self.is_running
                and getattr(self, "_live", None) is None):
            self._scheduler.register(self)
            return self
        self._thread = threading.Thread(target=self.run, daemon=True)
        self._thread.start()
        return self

    def run(self) -> None:
        """The loop body; callable directly (synchronously) or via
        start()."""
        # init is synchronous, so _ready is set by now — by a successful
        # __init__ or by its _terminate
        self._ready.wait()
        if self.reason is not None:
            return
        i = -1
        delivered = False
        try:
            while self.is_running and not self._stop.is_set():
                i += 1
                cfg = self.config
                self.ds.bnds_update()
                self._emit_stats(cfg)
                t0 = time.perf_counter()
                if self._live is not None:
                    result = self._live.tick(cfg)
                else:
                    # delta-aware written mode: an unchanged EFFECTIVE
                    # request (config snapshot + resolved channel/sample
                    # span) re-emits the last result instead of re-reading
                    # and recomputing it; the compute skips its own bounds
                    # refresh (this loop just refreshed)
                    key = self.pipeline.request_key(cfg)
                    if self._unchanged(key):
                        result = self._last_result
                        self.skipped_recomputes += 1
                    else:
                        result = self.pipeline.compute(
                            cfg, refresh_bounds=False)
                        self._last_key, self._last_result = key, result
                self.latencies_s.append(time.perf_counter() - t0)
                if self._stop.is_set() and delivered:
                    # stop arrived while this iteration was in flight and
                    # Terminated is out: a stale Iterated would overwrite
                    # what the consumer captured at stop time. When
                    # nothing was delivered yet, emit the run's only
                    # result instead.
                    return
                if result is None:
                    # capture still shorter than one STI column — keep
                    # chasing bounds until data appears
                    if (self.max_iterations is not None
                            and i + 1 >= self.max_iterations):
                        self._terminate(TerminateReason.OK)
                        return
                    self._stop.wait(self.streaming_sleep)
                    continue
                self._emit_iterated(i, result)
                delivered = True
                if self._stop.is_set():
                    return
                if (self.max_iterations is not None
                        and i + 1 >= self.max_iterations):
                    self._terminate(TerminateReason.OK)
                    return
                self._stop.wait(
                    self.streaming_sleep if cfg.streaming else self.written_sleep
                )
        except Exception:
            # report the loop error BEFORE the terminate emit: a raising
            # on_terminated callback would otherwise swallow the cause
            traceback.print_exc()
            self.is_running = False
            try:
                self._terminate(TerminateReason.LOOP_EXCEPTION)
            except Exception:
                traceback.print_exc()

    def update_settings(
        self,
        nfft: Optional[int] = None,
        nint: Optional[int] = None,
        ntime: Optional[int] = None,
        bnd_beg: Optional[float] = None,
        bnd_end: Optional[float] = None,
        **extra,
    ) -> None:
        """Settings slot (reference: drfProc.py:329-345): swap an immutable
        config snapshot and echo the effective stats."""
        if getattr(self, "ds", None) is None:
            # __init__ terminated before the dataset opened: fail soft
            return
        with self._lock:
            kw = dict(extra)
            if nfft is not None:
                kw["nfft"] = int(nfft)
            if nint is not None:
                kw["nint"] = int(nint)
            if ntime is not None:
                kw["ntime"] = int(ntime)
            if bnd_beg is not None or bnd_end is not None:
                cur = resolve_time_span(self._config.time_span,
                                        self.ds.time_bnds)
                kw["time_span"] = (
                    cur[0] if bnd_beg is None else float(bnd_beg),
                    cur[1] if bnd_end is None else float(bnd_end),
                )
            self._config = self._config.replace(**kw)
            cfg = self._config
        self._emit_stats(cfg)

    def select_channel(self, chan_entry: str) -> None:
        with self._lock:
            self._config = self._config.replace(channel=chan_entry)

    def abort(self) -> None:
        """User stop (reference: drfProc.py:347-352)."""
        self._terminate(TerminateReason.OK)

    # --------------------------------------------------- live checkpointing
    @property
    def has_live_state(self) -> bool:
        """True when a streaming run has a ring to checkpoint."""
        return (getattr(self, "_live", None) is not None
                and self._live.engine is not None)

    def save_live_state(self, path):
        """Persist streaming mode's mid-stream state (ring + carry + read
        cursor) in the JAX package's stream-state format, so a later run
        of either package resumes it. Call after the loop has stopped
        (join() first when threaded)."""
        if not self.has_live_state:
            raise ValueError(
                "no live engine to checkpoint (requires streaming mode "
                "and at least one completed iteration)")
        return self._live.engine.save(path)

    def preload_live_state(self, path) -> None:
        """Seed streaming mode from a save_live_state checkpoint (of
        either package) BEFORE run(): the first tick continues the saved
        stream instead of re-reading a cold trailing window."""
        if getattr(self, "_live", None) is None:
            raise ValueError("preload_live_state requires streaming mode")
        self._live.engine = LiveStreamEngine.resume(
            self.ds, self.config, path, self.device,
            mesh=self.pipeline.mesh)

    def join(self, timeout: Optional[float] = None) -> None:
        if self._thread is not None:
            self._thread.join(timeout)
        elif self._scheduler is not None:
            # scheduler mode has no per-tab thread: wait out the refresh
            # cycle currently serving this processor (if any)
            self._scheduler.drain(self, timeout)

    # ------------------------------------------------------------ internal
    def _unchanged(self, key) -> bool:
        """Whether the written request ``key`` (StiPipeline.request_key)
        is the last computed one, so its cached result is re-emitted; on
        a mesh only when it is so on every rank, so the ranks skip or
        recompute together."""
        same = key == self._last_key and self._last_result is not None
        if self.pipeline.mesh is None:
            return same
        return pmesh.every_rank(self.pipeline.mesh, same)

    def _emit_iterated(self, i: int, result) -> None:
        """One Iterated payload from an StiResult (shared by run() and the
        scheduler's delivery)."""
        self.callbacks.emit_iterated(Iterated(
            i=i,
            tab_id=self.tab_id,
            times=result.times,
            freqs=result.freqs,
            sxx_dbfs=result.sxx_dbfs,
            sxx_med_dbfs=result.sxx_med_dbfs,
            tile=result.tile,
            plot_freqs=result.plot_freqs,
            mask=result.mask,
        ))

    def _emit_stats(self, cfg: SpectrogramConfig) -> None:
        chan, _ = self.pipeline.channel_of(cfg)
        self.callbacks.emit_stats(StatsUpdated(
            tab_id=self.tab_id,
            sample_rate=self.ds.sr_dict[chan],
            nfft=cfg.nfft,
            nint=cfg.nint,
            ntime=cfg.ntime,
            time_bounds=resolve_time_span(cfg.time_span, self.ds.time_bnds),
        ))

    def _terminate(self, reason: TerminateReason,
                   detail: Optional[str] = None) -> None:
        self.reason = reason
        self.is_running = False
        self._stop.set()
        if self._scheduler is not None:
            self._scheduler.unregister(self)
        # wake any run() blocked in _ready.wait()
        self._ready.set()
        log_event(logger, "processor terminated", tab_id=self.tab_id,
                  reason=int(reason), detail=detail or reason.describe(),
                  latency=self.latency_stats())
        self.callbacks.emit_terminated(
            Terminated(self.tab_id, reason, detail))

    # --------------------------------------------------------- observability
    def latency_stats(self) -> dict:
        """p50/p99 iteration latency over the bounded recent window."""
        if not self.latencies_s:
            return {"n": 0}
        a = np.asarray(self.latencies_s)
        return {
            "n": len(a),
            "p50_s": float(np.percentile(a, 50)),
            "p99_s": float(np.percentile(a, 99)),
            "mean_s": float(a.mean()),
        }
