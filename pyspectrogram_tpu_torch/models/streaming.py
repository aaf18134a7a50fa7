"""Streaming STI on one torch device: blockwise overlap-save STFT + rolling
ring — the port of pyspectrogram_tpu/models/streaming.py without the
``mesh`` argument (chan sharding waits for torch.distributed).

Fixed-size plane-major sample blocks are pushed; each push computes only
the new STI columns (a (frame_len - hop)-sample carry rides between
blocks) and stores them in a rotating on-device ring of LINEAR power
columns. Column c lives at ring row c % ring_len, so a push writes only
its k new rows and every read path gathers or de-rotates on demand.

The push columns follow ops.stft.stream_impl: kernel B1 (B4 at nfft >=
65536) for contiguous hops, kernel B3 for overlapping hops (B4 at the
starts t*hop above 32768), ops.plain.psd_torch on the CPU or outside the
kernels' range. Medians over more than 32 columns run kernel B2.

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
from pyspectrogram_tpu_torch.ops import stft
from pyspectrogram_tpu_torch.ops.plain import to_dbfs
from pyspectrogram_tpu_torch.ops.windows import WindowSpec, get_window


@dataclasses.dataclass
class StreamState:
    """Streaming state: the carry and ring on the device, the column
    counter on the host."""

    carry: torch.Tensor     # (nsub*2, frame_len - hop) float32 trailing
                            # samples, plane-major like every sample buffer
    ring: torch.Tensor      # (ring_len, nsub, nfft) LINEAR power columns,
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
    ):
        """``precision`` is accepted for every tier: the float32 kernels
        meet all three. ``device`` is required ("cuda", "cpu", ...)."""
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {self.device} requested but torch "
                               "sees no CUDA device")
        self.nfft, self.nint, self.nsub = nfft, nint, nsub
        self.precision = precision
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
        return StreamState(
            carry=torch.zeros((self.nsub * 2, self.frame_len - self.hop),
                              dtype=torch.float32, device=self.device),
            ring=torch.zeros((self.ring_len, self.nsub, self.nfft),
                             dtype=torch.float32, device=self.device),
            total_cols=0,
        )

    def push(self, state: StreamState, block, return_db: bool = True
             ) -> Tuple[StreamState, Optional[torch.Tensor]]:
        """Consume one plane-major (nsub*2, block_len) block; returns
        (new_state, new dB columns (cols_per_block, nsub, nfft)), or
        (new_state, None) with ``return_db=False`` (the hot ingest path,
        which skips the dB pass).

        Move semantics, as JAX's donated push on a TPU: the new columns
        are written into ``state.ring`` in place and the returned state
        shares that tensor, so the input state is consumed — snapshot or
        save a state BEFORE pushing from it if its old contents matter."""
        k, ring_len = self.cols_per_block, self.ring_len
        block = torch.as_tensor(block, device=self.device)
        if tuple(block.shape) != (self.nsub * 2, self.block_len):
            raise ValueError(f"block of shape {tuple(block.shape)}, expected "
                             f"{(self.nsub * 2, self.block_len)}")
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
        return new, (to_dbfs(cols, self.eps) if return_db else None)

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
        return int(min(state.total_cols, self.ring_len))

    def _ordered_ring(self, state: StreamState) -> torch.Tensor:
        """Ring in canonical layout: oldest first in the LAST n slots,
        unfilled slots first (storage row of the next write == oldest)."""
        return torch.roll(state.ring, -(state.total_cols % self.ring_len),
                          dims=0)

    def _rows(self, cols: np.ndarray) -> torch.Tensor:
        """Storage rows of absolute columns (negative columns wrap onto
        rows that are provably unwritten while the span < ring_len)."""
        return torch.from_numpy(np.mod(cols, self.ring_len)).to(self.device)

    def snapshot(self, state: StreamState) -> Tuple[np.ndarray, int]:
        """Host copy of the ring in dBFS (oldest column first; unfilled
        slots read as the eps floor) + valid count."""
        db = to_dbfs(self._ordered_ring(state), self.eps)
        return db.cpu().numpy(), self.valid_cols(state)

    def snapshot_quantized(self, state: StreamState, spec
                           ) -> Tuple[np.ndarray, int]:
        """Host copy of the ring as a uint8 display tile (``spec`` a
        display.TileSpec) + valid count; rows oldest-first like
        snapshot(), unfilled slots quantize the eps floor."""
        q = quantize_tile_linear(self._ordered_ring(state), spec, self.eps,
                                 spec.qparams)
        return q.cpu().numpy(), self.valid_cols(state)

    def _span(self, n_valid: int, window: int, ladder: bool) -> int:
        """Median span while the window is still FILLING: the newest
        floor-pow2 columns until the window fills, then exactly
        ``window`` — the JAX class's ladder (there it bounds the compiled
        programs; here it keeps the port's medians over the same
        columns)."""
        if n_valid >= window:
            return window
        return (1 << (n_valid.bit_length() - 1)) if ladder else n_valid

    def _median_db(self, state: StreamState, n: int) -> torch.Tensor:
        """dBFS median (nsub, nfft) over the newest ``n`` columns, gathered
        straight from rotated storage (row of column c is c % ring_len)."""
        rows = self._rows(state.total_cols - n + np.arange(n))
        sel = state.ring.index_select(0, rows)
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
        n_valid = (min(int(total_cols), self.ring_len)
                   if total_cols is not None else self.valid_cols(state))
        if n_valid == 0:
            raise ValueError("no columns pushed yet")
        if n_cols is None:
            n = n_valid
        else:
            n = self._span(n_valid, min(self.ring_len, int(n_cols)),
                           span_ladder)
        return self._median_db(state, n).cpu().numpy()

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
                       spec) -> torch.Tensor:
        """The stride-decimated trailing window gathered out of rotated
        storage: dBFS floats, or a uint8 tile with ``spec``."""
        sel = state.ring.index_select(
            0, self._rows(self.strided_cols(state, n_disp, stride)))
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
        return self._trailing_view(state, n_disp, stride, spec).cpu().numpy()

    def refresh_view(self, state: StreamState, n_disp: int, stride: int,
                     spec=None, n_med: Optional[int] = None,
                     total_cols: Optional[int] = None,
                     span_ladder: bool = True):
        """The live refresh: the stride-decimated trailing-window view and
        the median PSD over the newest ``n_med`` valid columns (riding the
        fill ladder, :meth:`_span`; ``span_ladder=False`` forces the exact
        count). Returns (view, med_db) as host arrays: ``view`` as in
        :meth:`snapshot_strided`, ``med_db`` (nsub, nfft)."""
        self._check_span(n_disp, stride)
        total = (int(total_cols) if total_cols is not None
                 else state.total_cols)
        n_valid = min(total, self.ring_len)
        if n_valid == 0:
            raise ValueError("no columns pushed yet")
        window = (min(self.ring_len, int(n_med)) if n_med is not None
                  else self.ring_len)
        n = self._span(n_valid, window, span_ladder)
        view = self._trailing_view(state, n_disp, stride, spec)
        med = self._median_db(state, n)
        return view.cpu().numpy(), med.cpu().numpy()
