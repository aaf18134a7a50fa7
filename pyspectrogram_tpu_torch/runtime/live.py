"""Incremental live-streaming engine: O(delta) work per refresh — the port
of pyspectrogram_tpu/runtime/live.py, on one torch device or, with
``mesh``, chan-sharded over the ranks of a parallel.make_mesh mesh.

The engine keeps a :class:`~pyspectrogram_tpu_torch.models.streaming.
StreamingSti` ring + carry across ticks and, per tick, reads ONLY the
samples written since the last read, pushes each complete block (host ->
device from pinned memory, non-blocking), and serves the display from the
ring:

* every new sample is read exactly once, into one host buffer of the
  block being filled, from which the block is pushed; the carry stays on
  the device, and the tail view (complete columns short of a block) is
  computed there from the carry and the staged block (``samples_read``
  counts the pushed samples and the carry seeds);
* the refresh view is a stride-decimated trailing-window gather that
  leaves the device as a uint8 tile or float dB rows (<= ntime rows);
* the median PSD is computed on the device over the window's columns
  (kernel B2 above 32 columns);
* on one CUDA device the refresh's device chain (the view's gather and
  tile, the median's gather, B2, dB) is one CUDA graph that each tick
  replays, its rows built on the card from the newest column's row
  (:class:`_GraphedRefresh`); the readback copies into kept pinned
  buffers. On a CPU device or a mesh the chain runs eagerly
  (:class:`_EagerRefresh`).

On one device over a Digital RF directory the engine follows the capture's
edge (io.edge.FollowedReader, which it gives its dataset), so bounds cost a
few ``stat`` calls, and :meth:`LiveStreamEngine.ingest` reads and pushes
what the capture gained between ticks: a streaming processor calls it
through its pacing interval (runtime.processor), and the tick itself only
catches up with what landed after the interval's last probe. Either way
the ring, masks and cursors after a tick are those of ingesting every
block inside the tick.

The engine is rebuilt only when a SHAPE knob changes (:func:`_signature`);
color-range and freq-window changes are display-edge knobs.

On a mesh every rank runs the same engine over its own reader (SPMD) and
holds its subchannels' ring and carry (models.streaming). Where the JAX
controller reads a growing capture's bounds once per tick, the ranks read
them at different moments, so every decision that gates a collective (the
blocks to push, a backlog restart, the tail's length) is taken on the
bounds all ranks agree on (parallel.mesh.agree_bounds). A push copies
only the rank's rows; a tick gathers the view (ring rows and tail rows
together) and the median over ``chan``; a save gathers the ring and carry
to global rank 0 alone (parallel.mesh.gather_to_root), which writes the
one-device file.

While span recording is on (utils.profiling), a tick is ``live.push``
with a ``live.read`` per read (count ``samples``, and the system calls
and files the io layer counts into it), ``live.refresh`` (the view, the
median and the tail) and ``live.readback`` (the host waiting for the view
and the median). On an engine that graphs its refresh, ``live.refresh``
counts ``graph`` (1 when it replays the graph, 0 when it runs eagerly)
and ``graph_captures`` when it captures one (that tick runs eagerly). An
:meth:`LiveStreamEngine.ingest` that finds new samples is a ``live.push``
of its own, inside whatever span its caller holds.
"""

from __future__ import annotations

import dataclasses
import json
import threading
from fractions import Fraction
from typing import Optional, Union

import numpy as np
import torch

from pyspectrogram_tpu_torch.display.tile import (
    make_tile_spec,
    quantize_tile_linear,
    tile_freqs,
)
from pyspectrogram_tpu_torch.io.edge import FollowedReader
from pyspectrogram_tpu_torch.io.reader import DigitalRFReader, RFDataset
from pyspectrogram_tpu_torch.io.time_util import samples_to_datetime64
from pyspectrogram_tpu_torch.kernels import _build
from pyspectrogram_tpu_torch.models.sti import (
    StiResult,
    _assemblable,
    to_device,
)
from pyspectrogram_tpu_torch.models.streaming import StreamingSti
from pyspectrogram_tpu_torch.native import ingest as native_ingest
from pyspectrogram_tpu_torch.ops import stft
from pyspectrogram_tpu_torch.ops.plain import to_dbfs
from pyspectrogram_tpu_torch.parallel import mesh as pmesh
from pyspectrogram_tpu_torch.runtime import checkpoint
from pyspectrogram_tpu_torch.utils import profiling
from pyspectrogram_tpu_torch.utils.config import SpectrogramConfig
from pyspectrogram_tpu_torch.utils.errors import FormatError

#: per-push block target (samples): big enough to amortize the launches,
#: small enough that new data surfaces within a refresh tick (~0.07 s of
#: samples at 1 MS/s) — the JAX engine's value
TARGET_BLOCK_SAMPLES = 1 << 16
#: device-memory cap for the column ring (float32 power columns)
RING_BYTE_BUDGET = 512 << 20


def _signature(cfg: SpectrogramConfig):
    """The knobs whose change forces a ring rebuild (shapes and numerics
    of the push; eps is in every dB/tile value, so it counts). Color
    range, freq window, ntime and display_tile are display-edge knobs. The
    hop entry is canonicalized to its effective value (None means
    contiguous = nfft*nint). Equal to the JAX engine's signature, which
    checkpoints of either package record."""
    return (cfg.nfft, cfg.nint, cfg.mode, cfg.window, cfg.precision,
            cfg.channel, float(cfg.stream_seconds), float(cfg.eps),
            int(cfg.hop or cfg.nfft * cfg.nint))


def _plane_major(raw: np.ndarray, isub: Optional[int], n: int) -> np.ndarray:
    """A dense (n, nsub) storage-dtype read -> plane-major (nsub*2, n)
    float32 or int16 (the native assembly of one contiguous frame)."""
    if isub is not None:
        raw = raw[:, isub : isub + 1]
    return native_ingest.assemble_plane_major(
        _assemblable(raw), np.asarray([0], np.int64), n)


class _Upload:
    """Host arrays to one device. To a CUDA device through one pinned
    buffer kept for the engine's life, which each copy reuses once the
    last copy from it has left: a fresh pinned buffer (models.sti.
    to_device) costs milliseconds of host time once the host allocator
    has sat idle for a pacing interval (4-5 ms against 0.25 ms back to
    back, for a 1 MiB push block on an H100's host), where a reused one
    costs a copy."""

    def __init__(self, device: torch.device):
        self.device = device
        self._buf: Optional[torch.Tensor] = None
        self._done = None

    def __call__(self, a: np.ndarray) -> torch.Tensor:
        if self.device.type != "cuda":
            return to_device(a, self.device)
        if self._buf is None or self._buf.numel() < a.nbytes:
            self._buf = torch.empty(a.nbytes, dtype=torch.uint8,
                                    pin_memory=True)
        elif self._done is not None:
            self._done.synchronize()
        host = self._buf[:a.nbytes].view(
            torch.from_numpy(a[:0]).dtype).view(a.shape)
        host.numpy()[...] = a
        out = host.to(self.device, non_blocking=True)
        self._done = torch.cuda.Event()
        self._done.record()
        return out


class _EagerRefresh:
    """A live engine's refresh on a CPU device or over a mesh: the
    engine's ``StreamingSti.refresh_local`` call as it stands, its rows
    from a cursor copied from the state; the readback gathers each output
    over the mesh's ranks and copies it to the host."""

    def __init__(self, sti: StreamingSti):
        self.sti = sti

    def refresh(self, eng: "LiveStreamEngine", n_disp: int, stride: int,
                spec, crop_qp, total: int):
        """(view, median) device tensors of ``eng``'s refresh."""
        return self.sti.refresh_local(eng.state, n_disp, stride, spec=spec,
                                      n_med=eng.window_cols,
                                      total_cols=total)

    def readback(self, view: torch.Tensor, med: torch.Tensor,
                 tail: Optional[torch.Tensor]):
        """Host arrays of the view, the median and the tail rows (None
        without a tail), each of every rank's subchannels."""
        sti = self.sti
        return (sti.gather_view(view).cpu().numpy(),
                sti.gather_median(med).cpu().numpy(),
                None if tail is None else sti.gather_view(tail).cpu().numpy())


#: one refresh graph captured at a time in the process (each tab's engine
#: captures on its own thread)
_CAPTURE_LOCK = threading.Lock()


class _GraphedRefresh:
    """A live engine's refresh on one CUDA device, as one CUDA graph.

    The engine's ``StreamingSti.refresh_local`` call (through the class
    attribute, so whatever is patched there is what runs) takes its rows
    from ``cursor_rows`` of a (1,) int64 device cursor, which the call
    first copies from a kept pinned host word: the chain launches without
    a pageable copy or a wait. A key holds every other input of the call:
    the view's shape, the ring's filled columns (all the call takes of the
    column count, so a key covers whatever median span the call picks),
    crop, colour range and the ring's storage. A key runs eagerly on the
    tick it first appears (each tick while the window fills), is captured
    on the next tick that repeats it, after a warm-up on a side stream
    whose outputs that tick returns, and is replayed after that; the host
    then writes the cursor and replays. Any other key drops the graph and
    its pool. The kernel launches the warm-up counted are counted again at
    each replay. The readback copies the outputs and the tail rows into
    kept pinned buffers and waits on one event."""

    def __init__(self, device: torch.device):
        self.device = device
        self._cursor_host = torch.zeros(1, dtype=torch.int64,
                                        pin_memory=True)
        self._cursor_word = self._cursor_host.numpy()
        self._cursor = torch.zeros(1, dtype=torch.int64, device=device)
        self._side = torch.cuda.Stream(device)
        self._seen = None       # the key of the last eager refresh
        self._key = None        # the key of the captured graph
        self._graph = None
        self._out = None        # the graph's static (view, median)
        self._launches = {}     # the launches a replay makes, by counter
        self._pinned = {}       # readback buffers by slot
        self._copied = torch.cuda.Event()

    def refresh(self, eng: "LiveStreamEngine", n_disp: int, stride: int,
                spec, crop_qp, total: int):
        """(view, median) device tensors of ``eng``'s refresh."""
        sti, state = eng.sti, eng.state
        key = (n_disp, stride, sti.filled_cols(total), crop_qp,
               state.ring.data_ptr(), tuple(state.ring.shape))
        # the last tick's readback waited for its copy of the word
        self._cursor_word[0] = sti.newest_row(total)

        def run():
            self._cursor.copy_(self._cursor_host, non_blocking=True)
            return sti.refresh_local(state, n_disp, stride, spec=spec,
                                     n_med=eng.window_cols,
                                     total_cols=total, cursor=self._cursor)

        if key != self._key:
            self._graph = self._out = self._key = None
            if key != self._seen:
                profiling.count("graph", 0)
                out = run()
                self._seen = key
                return out
            # warm-up and capture on a side stream of this engine's own,
            # in this thread's mode: other tabs' threads keep launching,
            # and no two captures share a stream
            current = torch.cuda.current_stream(self.device)
            self._side.wait_stream(current)
            graph = torch.cuda.CUDAGraph()
            with _CAPTURE_LOCK, torch.cuda.stream(self._side):
                with _build.tally() as launches:
                    out = run()
                graph.capture_begin(capture_error_mode="thread_local")
                try:
                    self._out = run()
                finally:
                    graph.capture_end()
            current.wait_stream(self._side)
            self._graph, self._key, self._launches = graph, key, launches
            profiling.count("graph", 0)
            profiling.count("graph_captures")
            return out                  # the warm-up's
        self._graph.replay()
        for (fn, attr), n in self._launches.items():
            _build.count(fn, attr, n)
        profiling.count("graph")
        return self._out

    def _into(self, slot: str, t: torch.Tensor) -> np.ndarray:
        """Start ``t``'s copy into the kept pinned buffer ``slot`` (grown,
        never shrunk: the tail's rows vary by the tick); its host array,
        valid once the readback's event has passed."""
        nbytes = t.numel() * t.element_size()
        buf = self._pinned.get(slot)
        if buf is None or buf.numel() < nbytes:
            buf = self._pinned[slot] = torch.empty(
                nbytes, dtype=torch.uint8, pin_memory=True)
        host = buf[:nbytes].view(t.dtype).view(t.shape)
        host.copy_(t, non_blocking=True)
        return host.numpy()

    def readback(self, view: torch.Tensor, med: torch.Tensor,
                 tail: Optional[torch.Tensor]):
        """Host arrays of the view, the median and the tail rows (None
        without a tail), in the kept buffers: valid until the next
        readback."""
        host = [None if t is None else self._into(slot, t)
                for slot, t in (("view", view), ("median", med),
                                ("tail", tail))]
        self._copied.record()
        self._copied.synchronize()
        return host


class LiveStreamEngine:
    """One channel's incremental trailing-window stream over a (possibly
    growing) dataset, on one torch device or chan-sharded over ``mesh``
    (every rank then passes its mesh_device and gets the whole result).

    >>> eng = LiveStreamEngine(ds, cfg, device="cuda")
    >>> res = eng.tick(cfg)    # push new samples, return an StiResult
    """

    def __init__(self, ds: RFDataset, cfg: SpectrogramConfig,
                 device: Union[str, torch.device], mesh=None,
                 target_block_samples: int = TARGET_BLOCK_SAMPLES,
                 cols_per_block: Optional[int] = None,
                 init_device_state: bool = True):
        """``cols_per_block`` pins the push-block geometry explicitly
        (resume() passes the checkpointed value so the rebuilt ring has
        the same shape); by default it is derived from
        ``target_block_samples`` and the data available right now.
        ``init_device_state=False`` skips allocating the zeroed ring
        (resume() installs a restored one instead — avoids holding two
        full rings on the device during a large-window resume)."""
        if mesh is None and type(ds.reader) is DigitalRFReader:
            # one device over a directory: follow its edge, so bounds cost
            # a few stat calls (the mesh agrees its ranks' full listings)
            ds.reader = FollowedReader.following(ds.reader)
        self.ds = ds
        #: whether :meth:`ingest` may run between ticks: on one device, over
        #: a reader that follows the capture's edge (so a probe is cheap)
        self.follows = mesh is None and isinstance(ds.reader, FollowedReader)
        self.device = torch.device(device)
        self.mesh = mesh
        self._probed: Optional[tuple] = None    # ingest()'s bounds
        self.sig = _signature(cfg)
        chan, isub = ds._split_entry(cfg.channel or ds.channels[0])
        self.chan, self.isub = chan, isub
        self.sr: Fraction = ds.sr_dict[chan]
        self.ref = ds.ref_dict[chan]
        self.nsub = 1 if isub is not None else len(ds.chan_2sub[chan])
        frame_len = cfg.nfft * cfg.nint
        # column spacing: contiguous by default; cfg.hop < frame_len
        # overlaps columns (overlap-save: the carry holds the trailing
        # frame_len - hop samples between pushes)
        self.hop = int(cfg.hop or frame_len)
        self.carry_len = frame_len - self.hop
        self._iteration = -1
        self.samples_read = 0                   # O(delta) observability

        # trailing-window geometry: how many hop-spaced columns cover
        # stream_seconds (reference streamtime, drfProc.py:241)
        w = int(-(-(cfg.stream_seconds * self.sr) // self.hop))  # ceil
        cap = max(1, RING_BYTE_BUDGET // (self.nsub * cfg.nfft * 4))
        self.window_cols = max(1, min(w, cap))

        # block size: ~target_block_samples, whole columns, and no larger
        # than the initially-available data (frame-aware: a block of k
        # columns needs carry_len + k*hop samples) so short/young
        # captures still surface columns block by block
        lo, hi = self._bounds()
        if cols_per_block is not None:
            k = int(cols_per_block)
        else:
            avail_cols = max(1, (hi - lo + 1 - self.carry_len) // self.hop)
            k = max(1, min(target_block_samples // self.hop,
                           avail_cols, self.window_cols))
        self.cols_per_block = k
        self.block_len = k * self.hop
        # round the ring up to whole blocks: stores stay wrap-free
        ring_len = -(-self.window_cols // k) * k

        # tail view: complete columns that do not yet fill a whole push
        # block still surface in the display (see _tail_view)
        self._tail_pending = 0
        self._tail_cache_key = None
        self._tail_cache = None
        self._cfg = cfg                         # numerics knobs for the tail
        self._last_view = None      # the last tick's (spec, stride, crop_qp)
        self._display_key = None
        self._display = None        # (freqs, spec, crop_qp, plot_freqs)
        # host staging of the block being filled: the samples read past
        # the push cursor, plane-major in the assembly's dtype (allocated
        # at the first read), their mask and their count. The carry's
        # samples are on the device alone (state.carry).
        self._stage: Optional[np.ndarray] = None
        self._stage_mask = np.empty(self.block_len, bool)
        self._staged = 0

        # a pushed block and a tail's samples each go to the device
        # through a pinned buffer of their own
        self._upload_block = _Upload(self.device)
        self._upload_tail = _Upload(self.device)
        self.sti = StreamingSti(
            nfft=cfg.nfft, nint=cfg.nint, nsub=self.nsub,
            block_len=self.block_len, hop=self.hop, ring_len=ring_len,
            mode=cfg.mode, window=cfg.window, ref=self.ref, eps=cfg.eps,
            precision=cfg.precision, device=self.device, mesh=mesh,
        )
        self.state = self.sti.init_state() if init_device_state else None
        self._refresh = (_GraphedRefresh(self.device) if mesh is None
                         and self.device.type == "cuda"
                         else _EagerRefresh(self.sti))
        # the unfolded count of pushed columns (the state's counter folds)
        self.total_cols = 0
        # per-column validity, same rotating storage as the ring: a column
        # computed over zero-filled gap samples is flagged, like the batch
        # path's mask
        self.col_mask = np.ones(ring_len, bool)
        # gap shadow of the carry: with overlapping hops a column's
        # validity spans carry + block
        self._carry_mask = np.ones(self.carry_len, bool)
        # anchor at the current trailing window (cold start reads at most
        # one window). Column j's frame covers [start_sample + j*hop,
        # + frame_len): the window's last frame ends at the data tail when
        # the anchor backs off by the extra carry_len.
        self.start_sample = max(
            lo, hi + 1 - (self.window_cols * self.hop + self.carry_len))
        self.next_sample = self.start_sample + self.carry_len
        if init_device_state and self.carry_len:
            self._seed_carry()
        # the cursor at the end of the last tick: a tick's backlog restart
        # is decided from it, whatever ingest() pushed since
        self._tick_cursor = self.next_sample

    def _bounds(self):
        """The channel's (first, last) sample: the probe's while
        :meth:`ingest` pushes up to it, else the dataset's (which a tick's
        bounds refresh reads), agreed over the mesh."""
        if self._probed is not None:
            return self._probed
        lo, hi = self.ds.bnds[self.chan]
        if self.mesh is None:
            return lo, hi
        return pmesh.agree_bounds(self.mesh, int(lo), int(hi))

    def _read(self, start: int, n: int):
        """(plane-major block, sample mask) of ``n`` samples at ``start``."""
        with profiling.span("live.read"):
            profiling.count("samples", n)
            raw, mask = self.ds.reader.read_vector_raw(start, n, self.chan,
                                                       return_mask=True)
            return _plane_major(raw, self.isub, n), np.asarray(mask, bool)

    def _seed_carry(self) -> None:
        """Overlapping hops only: pre-fill the carry with the frame_len -
        hop samples before the first block, so column 0 covers
        [start_sample, start_sample + frame_len) with real data (reads
        before the capture start zero-fill and flag the gap mask)."""
        pm, mask = self._read(self.start_sample, self.carry_len)
        self.state.carry = to_device(
            self.sti.local_block(pm).astype(np.float32), self.device)
        self._carry_mask = mask
        self.samples_read += self.carry_len

    def _col_valid(self, m: np.ndarray, n: int) -> np.ndarray:
        """Validity of ``n`` hop-spaced columns whose frames slide over
        the sample mask ``m``: column t is valid iff m[t*hop : t*hop +
        frame_len] has no gap (a gap-count prefix sum)."""
        frame_len = self.hop + self.carry_len
        bad = np.concatenate([[0], np.cumsum(~np.asarray(m, bool))])
        t = np.arange(n) * self.hop
        return bad[t + frame_len] - bad[t] == 0

    # ----------------------------------------------------------- checkpoint
    def save(self, path):
        """Checkpoint the live session between ticks: the ring + carry plus
        the host read cursor, so :meth:`resume` continues at the exact
        next sample with no recompute. The file is the JAX engine's
        format; either package resumes it, on one device or a mesh.

        On a mesh every rank calls this: the ring and carry are gathered
        over ``chan`` to global rank 0's host alone, rank 0 writes the
        file the one-device engine writes, and the ranks meet at a barrier
        before returning its path."""
        state = self.sti.global_state(self.state)
        meta = {
            "kind": "live_stream",
            # json round-trip now so resume() compares like with like
            "signature": json.loads(json.dumps(self.sig)),
            "next_sample": int(self.next_sample),
            "start_sample": int(self.start_sample),
            "total_cols": int(self.total_cols),
            "samples_read": int(self.samples_read),
            "cols_per_block": int(self.cols_per_block),
        }
        extra = {"col_mask": self.col_mask, "carry_mask": self._carry_mask}
        if self.mesh is None:
            return checkpoint.save_stream_state(path, state, meta, extra)
        if state is not None:
            path = checkpoint.save_stream_state(path, state, meta, extra)
        else:
            path = checkpoint._npz_path(path)
        pmesh.barrier(self.mesh)
        return path

    @classmethod
    def resume(cls, ds: RFDataset, cfg: SpectrogramConfig, path,
               device: Union[str, torch.device],
               mesh=None) -> "LiveStreamEngine":
        """Rebuild an engine from a :meth:`save` checkpoint (of either
        package, one-device or meshed) on ``device`` and continue the
        stream: the next tick reads from the saved cursor. With ``mesh``
        every rank loads the file and keeps its chan slice of the ring and
        carry, so the session resumes sharded."""
        # the whole state on the host first: the refusals see its global
        # shapes, then only this rank's slice is copied to the device
        state, meta = checkpoint.load_stream_state(path, "cpu")
        if meta.get("kind") != "live_stream":
            raise ValueError(
                f"{path} is not a live-stream checkpoint "
                f"(kind={meta.get('kind')!r})")
        eng = cls(ds, cfg, device, mesh=mesh,
                  cols_per_block=int(meta["cols_per_block"]),
                  init_device_state=False)
        saved_sig = meta["signature"]
        if len(saved_sig) == len(eng.sig) - 1:
            # pre-hop checkpoints were always contiguous: their effective
            # hop is nfft*nint, so normalize instead of refusing them
            saved_sig = list(saved_sig) + [
                int(saved_sig[0]) * int(saved_sig[1])]
        if json.loads(json.dumps(eng.sig)) != saved_sig:
            raise ValueError(
                f"checkpoint was written with different shape knobs "
                f"({meta['signature']} vs {list(eng.sig)}); pass the "
                f"config the stream was started with")
        # the signature can't see dataset-derived geometry (nsub)
        want_ring = (eng.sti.ring_len, eng.nsub, cfg.nfft)
        want_carry = (eng.nsub * 2, eng.sti.frame_len - eng.sti.hop)
        if (tuple(state.ring.shape) != want_ring
                or tuple(state.carry.shape) != want_carry):
            raise ValueError(
                f"stream-state geometry mismatch: checkpoint ring/carry "
                f"{tuple(state.ring.shape)}/{tuple(state.carry.shape)} vs "
                f"this dataset's {want_ring}/{want_carry}")
        # the counter folds (fold_total), so an unbounded host cursor
        # compares through the fold
        if state.total_cols != eng.sti.fold_total(int(meta["total_cols"])):
            raise ValueError(
                "torn checkpoint: device column count "
                f"({state.total_cols}) disagrees with "
                f"the host cursor ({meta['total_cols']}) — the state was "
                "saved mid-tick; re-save from a quiesced session")
        eng.state = eng.sti.place_state(state)
        eng.total_cols = int(meta["total_cols"])
        eng.start_sample = int(meta["start_sample"])
        eng.next_sample = eng._tick_cursor = int(meta["next_sample"])
        eng.samples_read = int(meta["samples_read"])
        arrays = meta.get("arrays", {})
        if "col_mask" in arrays:
            eng.col_mask = np.asarray(arrays["col_mask"]).astype(bool)
        cmask = arrays.get("carry_mask")
        if cmask is not None and len(cmask) == eng.carry_len:
            eng._carry_mask = np.asarray(cmask).astype(bool)
        return eng

    # ---------------------------------------------------------------- ingest
    @profiling.spanned("live.push")
    def _push_new(self) -> int:
        """Read + push every complete new block up to :meth:`_bounds`;
        returns blocks pushed. On a mesh the bounds are the agreed ones,
        so every rank pushes the same blocks."""
        lo, hi = self._bounds()
        if self._outran(hi):
            # restart the ring at the new trailing window instead of
            # reading samples the ring would evict unseen (reads stay
            # O(window))
            self.state = self.sti.init_state()
            self.total_cols = 0
            self.col_mask[:] = True
            self.start_sample = (hi + 1 - self.window_cols * self.hop
                                 - self.carry_len)
            self.next_sample = self.start_sample + self.carry_len
            self._staged = 0
            if self.carry_len:
                self._seed_carry()          # and the carry's mask
        n_blocks = self._ingest(hi)
        # complete columns beyond the cursor that do not yet fill a whole
        # block (0..cols_per_block-1); the tail view surfaces them. The
        # next unpushed column starts carry_len before the cursor.
        avail = hi + 1 - (self.next_sample - self.carry_len)
        frame_len = self.hop + self.carry_len
        self._tail_pending = int(
            max(0, (avail - frame_len) // self.hop + 1)
            if avail >= frame_len else 0)
        return n_blocks

    def _outran(self, hi: int) -> bool:
        """Whether the capture's last sample ``hi`` outran the last tick's
        cursor by more than a whole window plus a block: the tick restarts
        the ring then, and :meth:`ingest` leaves the backlog to it."""
        return (hi + 1 - self._tick_cursor
                > self.window_cols * self.hop + self.block_len)

    def ingest(self) -> int:
        """Between ticks: read what the capture gained since the last read,
        push each block it completes and compute the tail view the next
        tick will show (as the last tick's view); returns blocks pushed.
        Costs a bounds probe when nothing landed (cheap where the engine
        ``follows`` the edge). A backlog the next tick will restart the
        ring for is left to that tick, so a tick's result stays that of
        ingesting every block inside it."""
        try:
            lo, hi = self.ds.reader.get_bounds(self.chan)
        except (OSError, KeyError, FormatError):
            return 0        # a file mid-creation: the next probe sees it
        if self._outran(hi) or hi < self.next_sample + self._staged:
            return 0
        self._probed = (lo, hi)
        try:
            n_blocks = self._push_new()
        finally:
            self._probed = None
        if self._tail_pending and self._last_view is not None:
            # the next tick's tail view, from what was just staged: its
            # cache serves that tick unless its catch-up or view differs
            self._tail_view(*self._last_view)
        return n_blocks

    def _ingest(self, hi: int) -> int:
        """Read the samples past the staging up to ``hi`` once, into the
        staging buffer in pieces that end at block boundaries, pushing each
        block as it completes; returns blocks pushed."""
        n_blocks = 0
        while True:
            at = self._staged
            n = min(hi + 1 - (self.next_sample + at), self.block_len - at)
            if n <= 0:
                return n_blocks
            pm, mask = self._read(self.next_sample + at, n)
            if self._stage is None or self._stage.dtype != pm.dtype:
                # the first read, or an integer channel whose dtype
                # io.reader settled at its first readable file: what was
                # staged before is cast as a concatenation would cast it
                stage = np.empty((pm.shape[0], self.block_len), pm.dtype)
                if at:
                    stage[:, :at] = self._stage[:, :at]
                self._stage = stage
            self._stage[:, at:at + n] = pm
            self._stage_mask[at:at + n] = mask
            self._staged += n
            if self._staged == self.block_len:
                self._push_staged()
                n_blocks += 1

    def _push_staged(self) -> None:
        """Push the staged block and move the carry's mask, the column
        validity and the cursors past it."""
        rows = (self.total_cols
                + np.arange(self.cols_per_block)) % self.sti.ring_len
        m = np.concatenate([self._carry_mask, self._stage_mask])
        self.col_mask[rows] = self._col_valid(m, self.cols_per_block)
        self._carry_mask = m[len(m) - self.carry_len:]
        self.samples_read += self.block_len
        # on a mesh the push copies only this rank's rows to its device;
        # either way the block leaves the staging before the next read
        block = (self._stage if self.mesh is not None
                 else self._upload_block(self._stage))
        self.state, _ = self.sti.push(self.state, block, return_db=False)
        self.total_cols += self.cols_per_block
        self.next_sample += self.block_len
        self._staged = 0

    # ------------------------------------------------------------- tail view
    def _tail_view(self, spec, stride: int, crop_qp):
        """Display rows for the pending tail: complete columns past the
        push cursor that do not yet fill a whole push block, computed from
        the card's carry and the staged block as a side view by the push's
        own policy (ops.stft.stream_columns) — the cursor does NOT advance,
        so ring pushes stay block-aligned and checkpoints exact. Cached on
        (cursor, pending, crop, colour range): a stopped writer's tail is
        computed once.

        ``crop_qp`` is the display's (crop, colour range) key, None
        without a tile. Returns (rows, cols, mask) continuing tick()'s
        stride grid
        (absolute column j displayed iff (j - total + 1) % stride == 0),
        or (None, None, None) when nothing lands on the grid; ``rows`` is
        a device tensor of this rank's subchannels (tick() reads it back
        after the ring's view). The median stays ring-only."""
        pending = self._tail_pending
        grid = np.arange(stride - 1, pending, stride, dtype=np.int64)
        if len(grid) == 0:
            return None, None, None
        key = (self.next_sample, pending, crop_qp)
        if key == self._tail_cache_key:
            rows, colmask = self._tail_cache
        else:
            # the next unpushed column starts carry_len before the push
            # cursor, so the pending columns' frames cover the carry and
            # the first pending*hop staged samples; zero-padded to a pow2
            # column count as the JAX engine's tail does
            k = pending * self.hop
            n = 1 << (pending - 1).bit_length()
            carry = self.state.carry
            staged = self._upload_tail(
                self.sti.local_block(self._stage[:, :k]))
            buf = torch.cat([carry, staged.to(torch.float32), carry.new_zeros(
                (carry.shape[0], (n - pending) * self.hop))], dim=1)
            mask = np.concatenate([self._carry_mask, self._stage_mask[:k]])
            cfg = self._cfg
            p = stft.stream_columns(
                buf, n, nfft=cfg.nfft, nint=cfg.nint,
                hop=self.hop, mode=cfg.mode, window=cfg.window, ref=self.ref)
            view = (to_dbfs(p, cfg.eps) if spec is None
                    else quantize_tile_linear(p, spec, cfg.eps, spec.qparams))
            rows = view[:pending]
            colmask = self._col_valid(mask, pending)
            self._tail_cache_key = key
            self._tail_cache = (rows, colmask)
        cols = self.total_cols + grid
        # the grid is a strided slice of the rows: no index tensor to copy
        # to the device, so the host does not wait here for the device
        return rows[stride - 1::stride], cols, colmask[grid]

    # --------------------------------------------------------------- display
    def _display_for(self, cfg: SpectrogramConfig):
        """(freqs, spec, crop_qp, plot_freqs) of ``cfg``'s display knobs,
        made once per (nfft, tile, freq window, colour range): ``spec`` is
        the TileSpec (None without a tile), ``crop_qp`` its (crop, float32
        colour range) key for the tail and graph caches."""
        key = (cfg.nfft, cfg.display_tile, tuple(cfg.freq_window_khz),
               tuple(cfg.color_range_db))
        if key != self._display_key:
            freqs = stft.shifted_freqs(cfg.nfft, self.sr)
            spec = crop_qp = plot_freqs = None
            if cfg.display_tile:
                spec = make_tile_spec(freqs, cfg.freq_window_khz,
                                      cfg.color_range_db)
            if spec is not None:
                crop_qp = (spec.crop_key(), tuple(
                    np.asarray(spec.qparams, np.float32).tolist()))
                plot_freqs = tile_freqs(spec, freqs)
            self._display_key = key
            self._display = (freqs, spec, crop_qp, plot_freqs)
        return self._display

    def tick(self, cfg: SpectrogramConfig) -> Optional[StiResult]:
        """One refresh: ingest the delta, then build the display payload
        from the ring (no recompute of already-pushed columns). Returns
        None while the capture is still shorter than one column."""
        self._push_new()
        self._tick_cursor = self.next_sample
        total = self.total_cols
        if total == 0:
            return None
        self._iteration += 1

        W = self.window_cols
        n_target = max(1, min(cfg.ntime, W))
        stride = -(-W // n_target)                       # ceil
        n_disp = -(-W // stride)
        with profiling.span("live.refresh"):
            freqs, spec, crop_qp, plot_freqs = self._display_for(cfg)
            # launched first, so the host work below overlaps the device's
            view, med = self._refresh.refresh(self, n_disp, stride, spec,
                                              crop_qp, total)
            cols = self.sti.strided_cols(self.state, n_disp, stride,
                                         total_cols=total)
            # the unfilled rows (negative columns) lead, so the kept rows
            # are a slice: no mask to copy and no count to read back, and
            # the host waits for the device only in the readback
            first = int(np.count_nonzero(cols < 0))
            kept_cols = cols[first:]
            mask = self.col_mask[kept_cols % self.sti.ring_len]
            self._last_view = (spec, stride, crop_qp)
            t_rows = None
            if self._tail_pending:
                # complete columns past the push cursor that do not yet
                # fill a push block surface every tick, so the newest
                # complete column appears in the tick it completes
                t_rows, t_cols, t_mask = self._tail_view(spec, stride,
                                                         crop_qp)
                if t_rows is not None:
                    kept_cols = np.concatenate([kept_cols, t_cols])
                    mask = np.concatenate([mask, t_mask])
        with profiling.span("live.readback"):
            view, med, tail = self._refresh.readback(view, med, t_rows)
        # the kept rows, then the tail's, copied out of the readback's
        # buffers
        view = np.concatenate([view[first:]] + ([] if tail is None
                                                else [tail]))
        med = med.copy()
        tile = sxx_dbfs = None
        if spec is not None:
            tile = view
        else:
            sxx_dbfs = stft.to_reference_layout(view)
        starts = self.start_sample + kept_cols * self.hop
        return StiResult(
            iteration=self._iteration,
            times=samples_to_datetime64(starts, self.sr),
            freqs=freqs,
            sxx_dbfs=sxx_dbfs,
            sxx_med_dbfs=np.moveaxis(med, -1, 0),
            sample_rate=self.sr,
            frame_starts=np.asarray(starts),
            mask=mask,
            tile=tile,
            plot_freqs=plot_freqs,
        )


@dataclasses.dataclass
class _EngineSlot:
    """Processor-side holder: rebuilds the engine when the config's shape
    signature changes (a new ring is the correct semantics for a shape
    change); ``mesh`` chan-shards the engine's ring."""

    ds: RFDataset
    device: Union[str, torch.device]
    mesh: object = None
    engine: Optional[LiveStreamEngine] = None

    def tick(self, cfg: SpectrogramConfig) -> Optional[StiResult]:
        sig = _signature(cfg)
        if self.engine is None or self.engine.sig != sig:
            self.engine = LiveStreamEngine(self.ds, cfg, self.device,
                                           mesh=self.mesh)
        return self.engine.tick(cfg)
