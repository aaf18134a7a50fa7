"""Digital RF reader: channel discovery, bounds, gap-aware sample reads.

From-scratch replacement for the external ``digital_rf.DigitalRFReader``
C/HDF5 library the reference sits on (reference: drfProc.py:52, 63-92).
Two layers:

* :class:`DigitalRFReader` — format-level API (``get_channels`` /
  ``get_properties`` / ``get_bounds`` / ``read_vector`` / ``read``),
  mirroring the upstream surface the reference consumes.
* :class:`RFDataset` — the ingest object the processing layer uses, the
  equivalent of the reference's ``DrfInput`` (reference: drfProc.py:59-179):
  channel/subchannel entry map, exact Fraction sample rates, dBFS
  normalization, strided STI block gathers, growing-bounds refresh.

Unlike the reference (whose ``read_vector`` raises on missing data), reads
here zero-fill gaps and can return a validity mask, so growing or gappy
captures degrade gracefully (SURVEY.md section 5, failure handling).

Copy of pyspectrogram_tpu/io/reader.py: the port imports nothing of that
package.
"""

from __future__ import annotations

from collections import OrderedDict
from fractions import Fraction
from pathlib import Path
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

from pyspectrogram_tpu_torch.io import drf_format as fmt
from pyspectrogram_tpu_torch.utils.errors import (
    ChannelNotFoundError,
    FormatError,
)


class DigitalRFReader:
    """Format-level reader over a Digital RF top-level directory.

    ``io_workers`` sizes the pooled GIL-free bulk-read path
    (io.fastread); 0 disables it and every read goes through h5py.
    """

    def __init__(self, top_dir: Union[str, Path],
                 io_workers: Optional[int] = None):
        self.top_dir = Path(top_dir).expanduser()
        if not self.top_dir.is_dir():
            raise FormatError(f"not a directory: {self.top_dir}")
        self._props: Dict[str, fmt.ChannelProperties] = {}
        for chan_dir in sorted(self.top_dir.iterdir()):
            pfile = chan_dir / fmt.PROPERTIES_FILENAME
            if chan_dir.is_dir() and pfile.exists():
                self._props[chan_dir.name] = fmt.read_properties(pfile)
        if not self._props:
            raise FormatError(f"no Digital RF channels under {self.top_dir}")
        if io_workers == 0:
            self._fast = None
        else:
            from pyspectrogram_tpu_torch.io.fastread import FastSpanReader

            self._fast = FastSpanReader(workers=io_workers)
        self._mem_dtype: Dict[str, np.dtype] = {}

    # ---- discovery -----------------------------------------------------
    def get_channels(self) -> List[str]:
        return sorted(self._props)

    def get_properties(self, channel: str) -> dict:
        return self._channel_props(channel).as_dict()

    def _channel_props(self, channel: str) -> fmt.ChannelProperties:
        try:
            return self._props[channel]
        except KeyError:
            raise ChannelNotFoundError(channel) from None

    def get_bounds(self, channel: str) -> Tuple[int, int]:
        """(first_sample, last_sample) absolute indices, both inclusive —
        matching the upstream convention the reference relies on
        (reference: drfProc.py:80-87).

        Edge-only scan: bounds live in the chronologically first/last
        cadence subdirectories, so this walks O(#subdirs) plus the files
        of the two edge subdirs — NOT every file of the capture. The
        live path calls this every refresh tick (bnds_update, reference:
        drfProc.py:169-179); a full listing would make each tick
        O(capture length) for multi-hour captures."""
        from pyspectrogram_tpu_torch.io import hdf5 as h5py

        self._channel_props(channel)  # ChannelNotFoundError on unknowns
        subs = fmt.list_subdirs(self.top_dir / channel)
        # A live writer creates a file before its first index row lands
        # (reference scenario: readers chase a growing capture,
        # drfProc.py:169-179) — skip not-yet-populated files/subdirs at
        # either end.
        first = last = None
        for sub in subs:
            for _, path in fmt.subdir_data_files(sub):
                with h5py.File(path, "r") as f:
                    idx = f["rf_data_index"]
                    if idx.shape[0]:
                        first = int(idx[0, 0])
                        break
            if first is not None:
                break
        for sub in reversed(subs):
            for _, path in reversed(fmt.subdir_data_files(sub)):
                with h5py.File(path, "r") as f:
                    idx = f["rf_data_index"][...]
                    nrows = f["rf_data"].shape[0]
                    if len(idx):
                        last = int(idx[-1, 0]) + (nrows - int(idx[-1, 1])) - 1
                        break
            if last is not None:
                break
        if first is None or last is None:
            # covers both no-files-at-all and files-without-index-rows:
            # the edge loops above already visited every candidate, so a
            # separate any() pre-scan would only re-list the same edge
            # subdirs a second time on the per-tick live path
            raise FormatError(f"channel {channel} has no written samples yet")
        return first, last

    def data_version(self, channel: str) -> Tuple[int, int]:
        """Cheap content fingerprint of a channel's INTERIOR: (number of
        cadence subdirectories, newest interior-subdir mtime). Bounds
        alone cannot see a backfill — an out-of-order writer filling a
        gap between unchanged (first, last) samples — but such writes
        land as new HDF5 files, which bump their cadence directory's
        mtime (or create a new directory). The FINAL subdirectory is
        deliberately excluded from the mtime max: a steady appender
        touches it every block, and appends already move the bounds the
        delta-aware loop (models.sti.request_key) keys on. Same
        O(#subdirs) cost class as :meth:`get_bounds`. Known blind spots
        (accepted, documented): in-place row appends to an interior
        file, and backfills confined to the final subdirectory — both
        touch no interior directory."""
        self._channel_props(channel)  # ChannelNotFoundError on unknowns
        subs = fmt.list_subdirs(self.top_dir / channel)
        interior_ns = 0
        for sub in subs[:-1]:
            m = sub.stat().st_mtime_ns
            if m > interior_ns:
                interior_ns = m
        return len(subs), interior_ns

    # ---- reads ---------------------------------------------------------
    def read(self, start_sample: int, n_samples: int, channel: str
             ) -> "OrderedDict[int, np.ndarray]":
        """Contiguous runs intersecting [start, start+n) as
        {global_start_index: (n, nsub) array} in native memory dtype."""
        from pyspectrogram_tpu_torch.io import hdf5 as h5py

        props = self._channel_props(channel)
        start = int(start_sample)
        end = start + int(n_samples)
        runs: "OrderedDict[int, np.ndarray]" = OrderedDict()
        pieces: List[Tuple[int, np.ndarray]] = []
        for _, path in fmt.files_overlapping(
            props, self.top_dir / channel, start, end
        ):
            with h5py.File(path, "r") as f:
                ds = f["rf_data"]
                idx = f["rf_data_index"][...].astype(np.int64)
                nrows = ds.shape[0]
                for k in range(len(idx)):
                    g0, r0 = int(idx[k, 0]), int(idx[k, 1])
                    r1 = int(idx[k + 1, 1]) if k + 1 < len(idx) else nrows
                    g1 = g0 + (r1 - r0)
                    lo, hi = max(start, g0), min(end, g1)
                    if lo < hi:
                        rows = ds[r0 + (lo - g0) : r0 + (hi - g0)]
                        pieces.append((lo, rows))
        # merge adjacent pieces (across file boundaries) into runs —
        # grouped first, one concatenate per run: pairwise concatenation
        # would copy O(total^2) bytes on spans with many pieces (small
        # file cadence and/or many gaps)
        run_start, run_parts, run_len = None, [], 0
        def flush():
            runs[run_start] = (
                run_parts[0] if len(run_parts) == 1
                else np.concatenate(run_parts, axis=0))
        for g, arr in pieces:  # pieces arrive in ascending sample order
            if run_start is not None and run_start + run_len == g:
                run_parts.append(arr)
                run_len += len(arr)
                continue
            if run_start is not None:
                flush()
            run_start, run_parts, run_len = g, [arr], len(arr)
        if run_start is not None:
            flush()
        return runs

    def _memory_dtype(self, channel: str) -> np.dtype:
        """In-memory dtype for this channel's reads. drf_properties
        records class/size/precision but NOT signedness (upstream
        parity: digital_rf readers take the dtype from ``rf_data``
        itself), so an INTEGER channel reconstructed from props alone
        would always come back signed — an unsigned capture would wrap
        negative above half scale. Probe one data file's true dtype,
        cached per channel; fall back to the props reconstruction until
        the channel has a readable file."""
        dt = self._mem_dtype.get(channel)
        if dt is not None:
            return dt
        props = self._channel_props(channel)
        dt = fmt.memory_dtype_of(props)
        if props.h5_class != fmt.H5T_INTEGER:
            # float channels are unambiguous from props (and the complex
            # compound -> native-complex mapping is theirs alone)
            self._mem_dtype[channel] = dt
            return dt
        from pyspectrogram_tpu_torch.io import hdf5 as h5py

        for sub in fmt.list_subdirs(self.top_dir / channel):
            for _, path in fmt.subdir_data_files(sub):
                try:
                    with h5py.File(path, "r") as f:
                        dt = f["rf_data"].dtype
                except OSError:
                    continue  # mid-write file: keep probing
                self._mem_dtype[channel] = dt
                return dt
        return dt  # no file yet: props fallback, re-probe next read

    def read_vector_raw(
        self, start_sample: int, n_samples: int, channel: str,
        return_mask: bool = False,
    ):
        """Dense (n, nsub) read in native memory dtype; gaps zero-filled.

        With ``return_mask`` also returns a bool (n,) validity mask.
        Large spans over unchunked files go through the pooled GIL-free
        byte-range path (io.fastread); anything else through h5py —
        results are identical.
        """
        props = self._channel_props(channel)
        n = int(n_samples)
        # uninitialized on purpose: the fast path writes data rows via
        # preadv and zeroes only the gap rows itself
        out = np.empty((n, props.num_subchannels),
                       dtype=self._memory_dtype(channel))
        mask = np.zeros(n, dtype=bool)
        if self._fast is not None and self._fast.read_into(
            props, self.top_dir / channel, int(start_sample), n, out, mask
        ):
            return (out, mask) if return_mask else out
        out[:] = 0
        mask[:] = False
        for g, arr in self.read(start_sample, n, channel).items():
            o = g - int(start_sample)
            out[o : o + len(arr)] = arr
            mask[o : o + len(arr)] = True
        return (out, mask) if return_mask else out

    def read_vector(
        self, start_sample: int, n_samples: int, channel: str,
        sub_channel: Optional[int] = None,
    ) -> np.ndarray:
        """Dense read converted to float64/complex128.

        Matches the reference's use of the upstream ``read_vector``: 2-D
        (n, nsub) when no subchannel is given, 1-D otherwise
        (reference: drfProc.py:124-126 and drfProc.py:162-164 where the 2-D
        result is stacked into STI blocks).
        """
        raw = self.read_vector_raw(start_sample, n_samples, channel)
        out = to_complex(raw)
        if sub_channel is not None:
            out = out[:, int(sub_channel)]
        return out


def to_complex(raw: np.ndarray) -> np.ndarray:
    """Storage-dtype array -> float64/complex128 numpy array."""
    if raw.dtype.names is not None:
        return raw["r"].astype(np.float64) + 1j * raw["i"].astype(np.float64)
    if raw.dtype.kind == "c":
        return raw.astype(np.complex128)
    return raw.astype(np.float64)


class RFDataset:
    """High-level ingest: the reference's ``DrfInput`` equivalent
    (reference: drfProc.py:59-179) with identical public state:
    ``chan_2sub``, ``chan_entries``, ``sr_dict``, ``ref_dict``, ``bnds``,
    ``time_bnds`` — plus ``data_version`` (per-channel interior content
    fingerprint, refreshed by ``bnds_update``; the delta-aware written
    loop keys on it, models.sti.request_key)."""

    def __init__(self, top_dir: Union[str, Path],
                 io_workers: Optional[int] = None):
        self.reader = DigitalRFReader(top_dir, io_workers=io_workers)
        self.chan_2sub: Dict[str, np.ndarray] = {}
        self.chan_entries: Dict[str, Tuple[str, int]] = {}
        self.sr_dict: Dict[str, Fraction] = {}
        self.ref_dict: Dict[str, float] = {}
        self.bnds: Dict[str, Tuple[int, int]] = {}
        self.data_version: Dict[str, Tuple[int, int]] = {}
        self.time_bnds: Tuple[float, float] = (np.inf, -np.inf)
        for chan in self.reader.get_channels():
            props = self.reader.get_properties(chan)
            sr = Fraction(
                props["sample_rate_numerator"], props["sample_rate_denominator"]
            )
            bnds = self.reader.get_bounds(chan)
            nsub = props["num_subchannels"]
            self.chan_2sub[chan] = np.arange(nsub)
            self.sr_dict[chan] = sr
            self.ref_dict[chan] = fmt.get_ref(props)
            self.bnds[chan] = bnds
            self.data_version[chan] = self.reader.data_version(chan)
            self.time_bnds = (
                min(self.time_bnds[0], float(bnds[0] / sr)),
                max(self.time_bnds[1], float(bnds[1] / sr)),
            )
            for isub in range(nsub):
                self.chan_entries[f"{chan}:{isub}"] = (chan, isub)

    @property
    def channels(self) -> List[str]:
        return list(self.chan_2sub)

    def _split_entry(self, chan_entry: str) -> Tuple[str, Optional[int]]:
        if ":" in chan_entry:
            if chan_entry not in self.chan_entries:
                raise ChannelNotFoundError(chan_entry)
            return self.chan_entries[chan_entry]
        if chan_entry not in self.chan_2sub:
            raise ChannelNotFoundError(chan_entry)
        return chan_entry, None

    def read(self, st_sample: int, n_sample: int, chan_entry: str,
             adj_bnds: bool = False) -> np.ndarray:
        """dBFS-normalized dense read (x / full_scale_ref,
        reference: drfProc.py:94-130). (n, nsub) without a subchannel,
        (n,) with one. ``adj_bnds`` clamps the request into current bounds
        (reference: drfProc.py:120-122)."""
        chan, isub = self._split_entry(chan_entry)
        bnds = self.reader.get_bounds(chan)
        self.bnds[chan] = bnds
        if adj_bnds:
            st_sample = max(int(st_sample), bnds[0])
            n_sample = min(bnds[1], n_sample + st_sample) - st_sample
        x = self.reader.read_vector(int(st_sample), int(n_sample), chan, isub)
        return x / self.ref_dict[chan]

    def sti_frame_starts(self, st_sample: int, en_sample: int, nfft: int,
                         nint: int, ntime: int) -> np.ndarray:
        """Frame-start indices for an STI: ntime points spread evenly over
        [st, en - nint*nfft] (reference: drfProc.py:159 — np.linspace with
        dtype=int, i.e. truncation, reproduced exactly).

        A window shorter than one frame clamps the upper endpoint to st
        (all frames start at st; reads past the window zero-fill) — the
        reference's DECREASING linspace there produces negative-offset
        slices and crashes its read loop."""
        n_sample = int(nint) * int(nfft)
        en_top = max(int(st_sample), int(en_sample) - n_sample)
        return np.linspace(int(st_sample), en_top, int(ntime), dtype=int)

    def read_sti(self, st_sample: int, chan_entry: str, en_sample: int,
                 nfft: int, nint: int, ntime: int
                 ) -> Tuple[np.ndarray, np.ndarray]:
        """Gather the (nfft*nint, ntime, nsub) STI input block
        (reference: drfProc.py:132-167).

        Reference semantics but not the reference's per-column read loop:
        frame reads are coalesced — one (or few) bulk HDF5 reads cover all
        frames, then frames are sliced out in memory. Returns
        (frame_start_indices, block).
        """
        chan, isub = self._split_entry(chan_entry)
        n_sample = int(nint) * int(nfft)
        n_st = self.sti_frame_starts(st_sample, en_sample, nfft, nint, ntime)

        lo = int(n_st[0])
        hi = int(n_st[-1]) + n_sample
        total = hi - lo
        # Coalesce when the whole span is at most 2x the sum of frame reads;
        # otherwise frames are sparse and per-frame reads win.
        if total <= 2 * n_sample * len(n_st):
            span = self.reader.read_vector(lo, total, chan, isub)
            cols = [span[s - lo : s - lo + n_sample] for s in n_st]
        else:
            cols = [
                self.reader.read_vector(int(s), n_sample, chan, isub)
                for s in n_st
            ]
        dout = np.stack(cols, axis=1) / self.ref_dict[chan]
        return n_st, dout

    def bnds_update(self) -> None:
        """Refresh bounds so reads chase a growing dataset
        (reference: drfProc.py:169-179).

        A concurrent writer can leave a file transiently unreadable
        (created but unpopulated, or mid-append); such a refresh keeps the
        previous bounds instead of failing the processing loop.
        """
        for chan in self.chan_2sub:
            try:
                bnds = self.reader.get_bounds(chan)
                # refresh the interior fingerprint alongside the bounds
                # so the delta-aware loop's request_key sees backfilled
                # gap writes that leave (first, last) unchanged
                self.data_version[chan] = self.reader.data_version(chan)
            except (OSError, KeyError, FormatError):
                continue
            sr = self.sr_dict[chan]
            self.bnds[chan] = bnds
            self.time_bnds = (
                min(self.time_bnds[0], float(bnds[0] / sr)),
                max(self.time_bnds[1], float(bnds[1] / sr)),
            )
