"""Streaming STI: blockwise overlap-save STFT + rolling ring — the port of
pyspectrogram_tpu/models/streaming.py, on one torch device or, with
``mesh``, sharded over the ``chan`` axis of a parallel.make_mesh mesh.

Fixed-size plane-major sample blocks are pushed; each push computes only
the new STI columns (a (frame_len - hop)-sample carry rides between
blocks) and stores them in a rotating on-device ring of LINEAR power
columns. Column c lives at ring row c % ring_len, so a push writes only
its k new rows and every read path gathers or de-rotates on demand.

The push columns follow ops.stft.stream_impl: kernel B1 (B4 at nfft >=
65536) for contiguous hops, kernel B3 for overlapping hops (B4 at the
starts t*hop above 32768), ops.plain.psd_torch on the CPU or outside the
kernels' range. Medians over more than 32 columns run kernel B2.

On a mesh (SPMD: every rank makes the same calls) each rank holds its
subchannels' carry and ring, nsub // chan of them, on its own device; the
stream is replicated over ``time``. A push copies only the rank's rows of
the block and makes no collective; every read path computes on the local
ring (the median with B2 per rank) and gathers only its result over
``chan``, so each rank returns the global host array the JAX caller gets.

PyTorch runs eagerly, so the JAX class's jit caches are gone; the
floor-pow2 median span ladder stays, because it decides which columns a
median spans while the window fills.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import numpy as np
import torch

from pyspectrogram_tpu_torch.display.tile import quantize_tile_linear
from pyspectrogram_tpu_torch.models.sti import check_device, to_device
from pyspectrogram_tpu_torch.ops import stft
from pyspectrogram_tpu_torch.ops.plain import to_dbfs
from pyspectrogram_tpu_torch.ops.windows import WindowSpec, get_window
from pyspectrogram_tpu_torch.parallel import mesh as pmesh
from pyspectrogram_tpu_torch.parallel.mesh import CHAN_AXIS

#: sharding specs of the chan-sharded stream (the JAX class's
#: _shardings): plane-major blocks and the carry shard their rows, the
#: ring and a view their subchannel dim, a median its leading dim
BLOCK_SPEC = (CHAN_AXIS, None)
RING_SPEC = (None, CHAN_AXIS, None)
MEDIAN_SPEC = (CHAN_AXIS, None)


@dataclasses.dataclass
class StreamState:
    """Streaming state: the carry and ring on the device, the column
    counter on the host. On a mesh each rank holds its own chan slice of
    the carry and ring (nsub_l = nsub // chan subchannels, rows 2s and
    2s+1 of the carry for each) and the same counter."""

    carry: torch.Tensor     # (nsub_l*2, frame_len - hop) float32 trailing
                            # samples, plane-major like every sample buffer
    ring: torch.Tensor      # (ring_len, nsub_l, nfft) LINEAR power columns,
                            # column c at row c % ring_len (dB happens at
                            # the display edge so medians stay exact)
    total_cols: int         # columns produced since start, folded back by
                            # a ring_len multiple exactly like the JAX
                            # int32 counter (StreamingSti.fold_total), so
                            # checkpoints cross-load; host-side, so no push
                            # reads a scalar back


class StreamingSti:
    """Incremental STI over an unbounded sample stream.

    >>> s = StreamingSti(nfft=1024, nint=2, nsub=1, block_len=8192,
    ...                  device="cuda")
    >>> state = s.init_state()
    >>> state, cols_db = s.push(state, pm_block)
    >>> sti_db, n_valid = s.snapshot(state)            # host view of ring

    Blocks are plane-major (nsub*2, block_len) float32 or int16 (row 2s =
    subchannel s real plane, row 2s+1 imag).

    With ``mesh`` every rank constructs the stream with its own
    ``device=mesh_device(mesh)`` and pushes the same global blocks; the
    read paths return the global arrays on every rank.
    """

    #: column-counter fold threshold (the JAX class's, models/streaming.py
    #: :76): the counter folds back by a ring_len multiple once it crosses
    #: this, preserving every mod-ring_len row and min(total, ring_len).
    #: Tests shrink it to exercise the fold in a few pushes.
    _FOLD_CAP = 1 << 30

    def __init__(
        self,
        *,
        nfft: int,
        nint: int = 1,
        nsub: int = 1,
        block_len: int,
        hop: Optional[int] = None,
        ring_len: int = 1024,
        mode: str = "welch",
        window: WindowSpec = ("kaiser", 1.7),
        ref: float = 1.0,
        eps: float = 1e-15,
        precision: str = "exact",
        device: Union[str, torch.device],
        mesh=None,
    ):
        """``precision`` is accepted for every tier: the float32 kernels
        meet all three. ``device`` is required ("cuda", "cpu", ...).

        ``mesh`` (parallel.make_mesh) shards the stream over its ``chan``
        axis: ``device`` must be this rank's mesh_device, and nsub must
        divide by the chan axis size."""
        self.device = check_device(device)
        self.nfft, self.nint, self.nsub = nfft, nint, nsub
        self.precision = precision
        self.mesh = mesh
        if mesh is not None:
            pmesh.check_mesh_device(mesh, self.device)
            ndev_c = pmesh.axis_size(mesh, CHAN_AXIS)
            if nsub % ndev_c:
                raise ValueError(
                    f"nsub {nsub} must divide by the chan axis ({ndev_c})")
            self._nsub_local = nsub // ndev_c
            # this rank's block rows (local_shard over chan), found once:
            # the push is host-bound, and the mesh lookups cost per call
            c = pmesh.axis_index(mesh, CHAN_AXIS)
            self._local_rows = slice(2 * self._nsub_local * c,
                                     2 * self._nsub_local * (c + 1))
        else:
            self._nsub_local = nsub
        self.frame_len = nfft * nint
        self.hop = self.frame_len if hop is None else hop
        if self.hop <= 0 or self.hop > self.frame_len:
            raise ValueError("hop must be in (0, nfft*nint]")
        if block_len % self.hop != 0:
            raise ValueError("block_len must be a multiple of hop")
        self.block_len = block_len
        self.cols_per_block = block_len // self.hop
        if self.cols_per_block > ring_len:
            raise ValueError("ring_len must hold at least one block of columns")
        self.ring_len = ring_len
        self.mode = mode
        self.eps = eps
        self._fold_at = ring_len * max(2, self._FOLD_CAP // ring_len)

        get_window(window, nfft)  # validate the window spec eagerly
        self._window = window
        self._ref = float(ref)

    def init_state(self) -> StreamState:
        """A zeroed state: this rank's slice on a mesh."""
        return StreamState(
            carry=torch.zeros((self._nsub_local * 2,
                               self.frame_len - self.hop),
                              dtype=torch.float32, device=self.device),
            ring=torch.zeros((self.ring_len, self._nsub_local, self.nfft),
                             dtype=torch.float32, device=self.device),
            total_cols=0,
        )

    def block_sharding(self):
        """The sharding spec of a pushed block on the mesh (None without
        one): its rows shard over ``chan``. A push takes the global block
        and copies only this rank's rows (local_block)."""
        return None if self.mesh is None else BLOCK_SPEC

    def local_block(self, block):
        """This rank's rows of a global plane-major block, host or device
        (the block itself without a mesh); no copy, no communication."""
        if self.mesh is None:
            return block
        return block[self._local_rows]

    def _gather(self, local: torch.Tensor, spec) -> torch.Tensor:
        """The global tensor of a per-rank result (itself without a
        mesh): a gather over ``chan``."""
        if self.mesh is None:
            return local
        return pmesh.assemble(local, self.mesh, spec)

    def global_state(self, state: StreamState) -> Optional[StreamState]:
        """The whole stream's state as a checkpoint stores it: ``state``
        itself without a mesh; on a mesh the carry and ring gathered over
        ``chan`` to the host of global rank 0, and None on every other
        rank (every rank calls this)."""
        if self.mesh is None:
            return state
        carry = pmesh.gather_to_root(state.carry, self.mesh, CHAN_AXIS,
                                     dim=BLOCK_SPEC.index(CHAN_AXIS))
        ring = pmesh.gather_to_root(state.ring, self.mesh, CHAN_AXIS,
                                    dim=RING_SPEC.index(CHAN_AXIS))
        if carry is None:
            return None
        return StreamState(carry=carry, ring=ring,
                           total_cols=state.total_cols)

    def place_state(self, state: StreamState) -> StreamState:
        """A global state (any device, a restored checkpoint's) as this
        stream's state: this rank's chan slice of the carry and ring,
        copied to the stream's device."""
        carry, ring = state.carry, state.ring
        if self.mesh is not None:
            carry = pmesh.local_shard(carry, self.mesh, BLOCK_SPEC)
            ring = pmesh.local_shard(ring, self.mesh, RING_SPEC)
        return StreamState(carry=carry.contiguous().to(self.device),
                           ring=ring.contiguous().to(self.device),
                           total_cols=state.total_cols)

    def push(self, state: StreamState, block, return_db: bool = True
             ) -> Tuple[StreamState, Optional[torch.Tensor]]:
        """Consume one plane-major (nsub*2, block_len) block (host array or
        tensor); returns (new_state, new dB columns (cols_per_block, nsub,
        nfft)), or (new_state, None) with ``return_db=False`` (the hot
        ingest path, which skips the dB pass).

        On a mesh the block is the global one, as the JAX push takes it:
        only this rank's rows are copied to its device, the columns are
        computed on them with no collective, and the dB columns (with
        ``return_db``) are gathered over ``chan``.

        Move semantics, as JAX's donated push on a TPU: the new columns
        are written into ``state.ring`` in place and the returned state
        shares that tensor, so the input state is consumed — snapshot or
        save a state BEFORE pushing from it if its old contents matter."""
        k, ring_len = self.cols_per_block, self.ring_len
        if tuple(block.shape) != (self.nsub * 2, self.block_len):
            raise ValueError(f"block of shape {tuple(block.shape)}, expected "
                             f"{(self.nsub * 2, self.block_len)}")
        block = self.local_block(block)
        if isinstance(block, torch.Tensor):
            block = block.to(self.device)
        else:
            block = to_device(np.asarray(block), self.device)
        buf = torch.cat([state.carry, block.to(torch.float32)], dim=1)
        cols = stft.stream_columns(
            buf, k, nfft=self.nfft, nint=self.nint, hop=self.hop,
            mode=self.mode, window=self._window, ref=self._ref)
        carry = buf[:, buf.shape[1] - (self.frame_len - self.hop):].clone()
        ring = state.ring
        pos = state.total_cols % ring_len
        if ring_len % k == 0:
            # a write never wraps: one slice assignment
            ring[pos:pos + k] = cols
        else:
            rows = (pos + torch.arange(k, device=self.device)) % ring_len
            ring.index_copy_(0, rows, cols)
        total = state.total_cols + k
        if total >= self._fold_at:
            # fold as the JAX counter does before int32 could wrap:
            # subtracting a ring_len multiple keeps every row (mod
            # ring_len) and min(total, ring_len)
            total -= self._fold_at - ring_len
        new = StreamState(carry=carry, ring=ring, total_cols=total)
        if not return_db:
            return new, None
        return new, self._gather(to_dbfs(cols, self.eps), RING_SPEC)

    def fold_total(self, total: int) -> int:
        """Counter value after ``total`` true columns: equal below the fold
        threshold, then offset into the fold orbit [ring_len, fold_at).
        Host bookkeeping that compares an unbounded true count against
        the state's counter (the checkpoint torn-state check) compares
        through this."""
        if total < self._fold_at:
            return int(total)
        period = self._fold_at - self.ring_len
        return int(self.ring_len + (total - self.ring_len) % period)

    # ------------------------------------------------------------- queries
    def valid_cols(self, state: StreamState) -> int:
        return self.filled_cols(state.total_cols)

    def filled_cols(self, total_cols: int) -> int:
        """The ring's filled columns once ``total_cols`` are pushed: all
        that a refresh (:meth:`refresh_local`) takes of its column count,
        the rows aside."""
        return min(int(total_cols), self.ring_len)

    def _ordered_ring(self, state: StreamState) -> torch.Tensor:
        """Ring in canonical layout: oldest first in the LAST n slots,
        unfilled slots first (storage row of the next write == oldest)."""
        return torch.roll(state.ring, -(state.total_cols % self.ring_len),
                          dims=0)

    def newest_row(self, total_cols: int) -> int:
        """Storage row of the newest of ``total_cols`` columns (folded or
        not: the fold keeps every row)."""
        return (int(total_cols) - 1) % self.ring_len

    def _cursor(self, state: StreamState) -> torch.Tensor:
        """The state's :meth:`newest_row` as a (1,) int64 tensor on the
        stream's device."""
        return torch.tensor([self.newest_row(state.total_cols)],
                            device=self.device)

    def cursor_rows(self, cursor: torch.Tensor, n: int,
                    step: int = 1) -> torch.Tensor:
        """Storage rows of the ``n`` columns ``step`` apart that end at the
        newest one, oldest first, built on ``cursor``'s device from
        ``cursor``, a (1,) int64 tensor holding :meth:`newest_row`: column
        c is at row c mod ring_len, and negative (unfilled) columns wrap
        onto rows that are provably unwritten while the span < ring_len.
        No host array is copied to the device."""
        back = torch.arange((1 - n) * step, 1, step, device=cursor.device)
        return torch.remainder(cursor + back, self.ring_len)

    def snapshot(self, state: StreamState) -> Tuple[np.ndarray, int]:
        """Host copy of the ring in dBFS (oldest column first; unfilled
        slots read as the eps floor) + valid count."""
        db = to_dbfs(self._ordered_ring(state), self.eps)
        return self._gather(db, RING_SPEC).cpu().numpy(), \
            self.valid_cols(state)

    def snapshot_quantized(self, state: StreamState, spec
                           ) -> Tuple[np.ndarray, int]:
        """Host copy of the ring as a uint8 display tile (``spec`` a
        display.TileSpec) + valid count; rows oldest-first like
        snapshot(), unfilled slots quantize the eps floor."""
        q = quantize_tile_linear(self._ordered_ring(state), spec, self.eps,
                                 spec.qparams)
        return self._gather(q, RING_SPEC).cpu().numpy(), \
            self.valid_cols(state)

    def _span(self, n_valid: int, window: int, ladder: bool) -> int:
        """Median span while the window is still FILLING: the newest
        floor-pow2 columns until the window fills, then exactly
        ``window`` — the JAX class's ladder (there it bounds the compiled
        programs; here it keeps the port's medians over the same
        columns)."""
        if n_valid >= window:
            return window
        return (1 << (n_valid.bit_length() - 1)) if ladder else n_valid

    def _median_db(self, state: StreamState, n: int,
                   cursor: torch.Tensor) -> torch.Tensor:
        """dBFS median (nsub_l, nfft) of this rank's subchannels over the
        newest ``n`` columns, taken straight from rotated storage (the
        rows :meth:`cursor_rows` builds from ``cursor``)."""
        sel = state.ring.index_select(0, self.cursor_rows(cursor, n))
        return to_dbfs(stft.median_over_time(sel), self.eps)

    def median_psd(self, state: StreamState, n_cols: Optional[int] = None,
                   total_cols: Optional[int] = None,
                   span_ladder: bool = True) -> np.ndarray:
        """Median dBFS PSD over the valid ring columns (median taken in
        linear power, like the batch path; reference: drfProc.py:401).

        ``n_cols`` restricts it to the NEWEST n_cols columns (the live
        trailing window); while that window is still filling the span
        rides the floor-pow2 ladder (:meth:`_span`), and
        ``span_ladder=False`` forces the exact fill count. Without
        ``n_cols`` the median is exact over every valid column.
        ``total_cols`` is the caller's unfolded count, as in the JAX
        class."""
        n_valid = self.filled_cols(total_cols if total_cols is not None
                                   else state.total_cols)
        if n_valid == 0:
            raise ValueError("no columns pushed yet")
        if n_cols is None:
            n = n_valid
        else:
            n = self._span(n_valid, min(self.ring_len, int(n_cols)),
                           span_ladder)
        med = self._median_db(state, n, self._cursor(state))
        return self._gather(med, MEDIAN_SPEC).cpu().numpy()

    # ------------------------------------------------- trailing-window view
    def strided_cols(self, state: StreamState, n_disp: int,
                     stride: int, total_cols=None) -> np.ndarray:
        """(n_disp,) absolute column indices snapshot_strided selects,
        oldest first; entries < 0 are unfilled rows (they read as the eps
        floor) — trim them on the host. Pass the unfolded ``total_cols``
        on streams beyond ~2^30 columns (the state's counter folds)."""
        newest = (int(total_cols) if total_cols is not None
                  else state.total_cols) - 1
        return newest - stride * np.arange(n_disp - 1, -1, -1,
                                           dtype=np.int64)

    def _check_span(self, n_disp: int, stride: int) -> None:
        if stride < 1 or n_disp < 1:
            raise ValueError("n_disp and stride must be >= 1")
        if stride * (n_disp - 1) >= self.ring_len:
            raise ValueError(
                f"window span {stride * (n_disp - 1) + 1} cols exceeds the "
                f"ring ({self.ring_len}) — selected rows would alias")

    def _trailing_view(self, state: StreamState, n_disp: int, stride: int,
                       spec, cursor: torch.Tensor) -> torch.Tensor:
        """The stride-decimated trailing window gathered out of rotated
        storage (the rows :meth:`cursor_rows` builds from ``cursor``):
        dBFS floats, or a uint8 tile with ``spec``."""
        sel = state.ring.index_select(
            0, self.cursor_rows(cursor, n_disp, stride))
        if spec is None:
            return to_dbfs(sel, self.eps)
        return quantize_tile_linear(sel, spec, self.eps, spec.qparams)

    def snapshot_strided(self, state: StreamState, n_disp: int, stride: int,
                         spec=None) -> np.ndarray:
        """Trailing-window view, time-decimated on the device before the
        readback: every ``stride``-th column ending at the newest one,
        n_disp rows, as (n_disp, nsub, nfft) float dBFS or, with ``spec``
        (a display.TileSpec), a (n_disp, nsub, plot_n) uint8 tile. Rows
        whose column index is negative (see strided_cols) read unwritten
        slots."""
        self._check_span(n_disp, stride)
        view = self._trailing_view(state, n_disp, stride, spec,
                                   self._cursor(state))
        return self._gather(view, RING_SPEC).cpu().numpy()

    def refresh_view(self, state: StreamState, n_disp: int, stride: int,
                     spec=None, n_med: Optional[int] = None,
                     total_cols: Optional[int] = None,
                     span_ladder: bool = True):
        """The live refresh: the stride-decimated trailing-window view and
        the median PSD over the newest ``n_med`` valid columns (riding the
        fill ladder, :meth:`_span`; ``span_ladder=False`` forces the exact
        count). Returns (view, med_db) as host arrays: ``view`` as in
        :meth:`snapshot_strided`, ``med_db`` (nsub, nfft). On a mesh each
        rank computes both on its own subchannels (B2 on its local
        window) and only they are gathered, never the ring."""
        view, med = self.refresh_local(state, n_disp, stride, spec, n_med,
                                       total_cols, span_ladder)
        return (self._gather(view, RING_SPEC).cpu().numpy(),
                self._gather(med, MEDIAN_SPEC).cpu().numpy())

    def refresh_local(self, state: StreamState, n_disp: int, stride: int,
                      spec=None, n_med: Optional[int] = None,
                      total_cols: Optional[int] = None,
                      span_ladder: bool = True,
                      cursor: Optional[torch.Tensor] = None):
        """:meth:`refresh_view`'s (view, med_db) as this rank's device
        tensors, (n_disp, nsub_l, ...) and (nsub_l, nfft), before the
        gather. Of ``total_cols`` it takes only :meth:`filled_cols`.

        The rows are built on the device from ``cursor``
        (:meth:`cursor_rows`), by default one copied from the state's
        counter. A cursor the caller keeps on the device lets the call
        launch without waiting on a copy, and be captured in a CUDA graph
        that replays with the cursor's new value."""
        self._check_span(n_disp, stride)
        n_valid = self.filled_cols(total_cols if total_cols is not None
                                   else state.total_cols)
        if n_valid == 0:
            raise ValueError("no columns pushed yet")
        window = (min(self.ring_len, int(n_med)) if n_med is not None
                  else self.ring_len)
        n = self._span(n_valid, window, span_ladder)
        if cursor is None:
            cursor = self._cursor(state)
        return (self._trailing_view(state, n_disp, stride, spec, cursor),
                self._median_db(state, n, cursor))

    def gather_view(self, view: torch.Tensor) -> torch.Tensor:
        """The global (rows, nsub, ...) view of this rank's (rows, nsub_l,
        ...) rows (itself without a mesh)."""
        return self._gather(view, RING_SPEC)

    def gather_median(self, med: torch.Tensor) -> torch.Tensor:
        """The global (nsub, nfft) median of this rank's (nsub_l, nfft)."""
        return self._gather(med, MEDIAN_SPEC)
