"""Parallel, GIL-free bulk sample reads from Digital RF captures.

The reference's IO hot path is ntime sequential ``read_vector`` calls per
STI refresh through libdigital_rf (reference: drfProc.py:161-166) — and
even this package's coalesced h5py path serializes every byte through
h5py's global API lock, so reader threads cannot scale it.

This module sidesteps the lock for the bulk data: h5py is only needed
ONCE per file to probe metadata — the ``rf_data`` extent map (one byte
offset for a contiguous dataset; the per-chunk byte offsets for an
uncompressed full-row-width chunked dataset, which is what this package's
writer produces), the row count/dtype, and the ``rf_data_index`` block
table (a few KB). After that, sample rows are plain byte ranges, read
directly into the destination buffer with ``os.preadv`` from a thread
pool: no HDF5 library in the loop, no GIL, no intermediate copies. Files
the probe cannot map (compressed/filtered, subchannel-split chunks,
non-native byte order) fail it and the caller falls back to the h5py
path, so results are always identical.

Storage dtypes and memory dtypes are byte-identical here (complex64 IS
the {r: f4, i: f4} compound; int16 compounds stay structured), so reading
raw bytes into the memory-dtype array is exact.

Copy of pyspectrogram_tpu/io/fastread.py: the port imports nothing of that
package.
"""

from __future__ import annotations

import dataclasses
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from pyspectrogram_tpu_torch.io import drf_format as fmt

#: below this many bytes a parallel read is pure overhead
MIN_PARALLEL_BYTES = 2 * 1024 * 1024

#: split large per-file segments into jobs of this size so a few big files
#: still spread across the pool
JOB_BYTES = 8 * 1024 * 1024

#: probed-file cache cap: a multi-day live session at 1 s file cadence
#: otherwise accumulates one _FileMap (index + chunk offsets) per file
#: forever; eviction is FIFO (oldest files first — exactly the ones a
#: trailing-window reader stops touching) and only costs a re-probe
MAPS_CAP = 8192


@dataclasses.dataclass(frozen=True)
class _FileMap:
    """Everything needed to read a data file without h5py.

    The extent map is (chunk_rows, chunk_offsets): a contiguous dataset is
    one implicit chunk of all rows; a full-row-width uncompressed chunked
    dataset has chunk k covering rows [k*chunk_rows, (k+1)*chunk_rows) at
    byte offset chunk_offsets[k] (HDF5 allocates chunks full-size, so the
    mapping holds for the final partial chunk too).
    """

    nrows: int
    row_bytes: int
    chunk_rows: int
    chunk_offsets: np.ndarray   # (nchunks,) int64 byte offsets, -1 = hole
    index: np.ndarray           # (nblocks, 2) int64 (global_sample, row)
    mtime_ns: int


class FastSpanReader:
    """Reads dense sample spans with pooled preadv; h5py only for probing.

    One instance per reader object; thread-safe. ``read_into`` returns
    False (without touching ``out``) when any overlapping file cannot be
    mapped, so callers can fall back to the h5py path.
    """

    def __init__(self, workers: Optional[int] = None):
        self.workers = workers or min(16, (os.cpu_count() or 4))
        self._maps: Dict[Path, _FileMap] = {}
        self._lock = threading.Lock()
        self._pool: Optional[ThreadPoolExecutor] = None

    # ------------------------------------------------------------ probing
    def _probe(self, path: Path) -> Optional[_FileMap]:
        try:
            st = path.stat()
        except OSError:
            return None
        with self._lock:
            fm = self._maps.get(path)
            if fm is not None and fm.mtime_ns == st.st_mtime_ns:
                return fm
        from pyspectrogram_tpu_torch.io import hdf5 as h5py

        try:
            with h5py.File(path, "r") as f:
                ds = f["rf_data"]
                if ds.compression is not None or ds.compression_opts:
                    return None
                if ds.shuffle or ds.scaleoffset is not None or ds.fletcher32:
                    # size-preserving filters (shuffle especially) pass the
                    # chunk-size check below but permute the raw bytes —
                    # a preadv read would return garbage marked valid
                    return None
                if ds.dtype.byteorder not in ("<", "=", "|"):
                    return None  # raw-byte reads assume native LE
                if ds.dtype.names is not None and any(
                    f[0].byteorder not in ("<", "=", "|")
                    for f in ds.dtype.fields.values()
                ):
                    # compound dtypes report '|' at the top level even when
                    # their fields are big-endian; a raw read would return
                    # byte-swapped samples silently
                    return None
                nrows = int(ds.shape[0])
                row_bytes = int(ds.dtype.itemsize) * int(ds.shape[1])
                if ds.chunks is None:
                    offset = ds.id.get_offset()
                    if offset is None:
                        return None
                    chunk_rows = max(nrows, 1)
                    chunk_offsets = np.asarray([offset], np.int64)
                else:
                    # only full-row-width chunks map to row-contiguous
                    # byte ranges (this package's writer guarantees that;
                    # (N, 1) subchannel-split chunks do not)
                    if ds.chunks[1] != ds.shape[1]:
                        return None
                    chunk_rows = int(ds.chunks[0])
                    nchunks = -(-nrows // chunk_rows) if nrows else 0
                    chunk_offsets = np.full(nchunks, -1, np.int64)
                    for k in range(ds.id.get_num_chunks()):
                        info = ds.id.get_chunk_info(k)
                        if info.filter_mask:
                            return None
                        ci = info.chunk_offset[0] // chunk_rows
                        # unfiltered chunks are allocated raw full-size
                        if info.size != chunk_rows * row_bytes:
                            return None
                        chunk_offsets[ci] = info.byte_offset
                index = f["rf_data_index"][...].astype(np.int64)
                fm = _FileMap(
                    nrows=nrows,
                    row_bytes=row_bytes,
                    chunk_rows=chunk_rows,
                    chunk_offsets=chunk_offsets,
                    index=index,
                    mtime_ns=st.st_mtime_ns,
                )
        except Exception:
            return None
        with self._lock:
            while len(self._maps) >= MAPS_CAP:
                self._maps.pop(next(iter(self._maps)))  # FIFO eviction
            self._maps[path] = fm
        return fm

    # ------------------------------------------------------------- reads
    def read_into(
        self,
        props: fmt.ChannelProperties,
        channel_dir: Path,
        start: int,
        n: int,
        out: np.ndarray,
        mask: Optional[np.ndarray] = None,
    ) -> bool:
        """Fill ``out`` (n, nsub) from [start, start+n), zeroing gap rows.

        ``out`` may be uninitialized (np.empty): data rows are written by
        preadv and only the gap complement is zeroed — for a gapless
        multi-GB read that skips a full page-faulting memset. Returns
        False if any overlapping file cannot be fast-mapped; the caller
        must then use the h5py path. ``mask`` (n,) bool is set True where
        data exists.

        On a False return ``out``/``mask`` may have been PARTIALLY
        written (rows read or zeroed before the failing file was probed)
        — callers must treat their contents as undefined and fully
        rebuild via the fallback path, as read_vector_raw does.
        """
        if not hasattr(os, "preadv"):  # not on Windows/older macOS
            return False
        end = start + n
        covered = mask if mask is not None else np.zeros(n, bool)
        # the gap-zeroing below trusts False entries only: a caller-reused
        # mask with stale True rows would leave np.empty garbage marked
        # valid, so establish the all-False precondition here
        covered[:] = False
        row_bytes = out.dtype.itemsize * (out.shape[1] if out.ndim > 1 else 1)
        jobs: List[Tuple[Path, int, int, int]] = []  # path, byte_off, dest_row, nrows
        for _, path in fmt.files_overlapping(props, channel_dir, start, end):
            fm = self._probe(path)
            if fm is None:
                return False
            if fm.row_bytes != row_bytes:
                return False
            idx = fm.index
            for k in range(len(idx)):
                g0, r0 = int(idx[k, 0]), int(idx[k, 1])
                r1 = int(idx[k + 1, 1]) if k + 1 < len(idx) else fm.nrows
                g1 = g0 + (r1 - r0)
                lo, hi = max(start, g0), min(end, g1)
                if lo >= hi:
                    continue
                # split the row range at chunk-extent boundaries
                row = r0 + (lo - g0)
                dest = lo - start
                left = hi - lo
                while left > 0:
                    ci = row // fm.chunk_rows
                    in_chunk = row - ci * fm.chunk_rows
                    take = min(left, fm.chunk_rows - in_chunk)
                    base = int(fm.chunk_offsets[ci])
                    if base < 0:
                        return False  # indexed rows in an unallocated chunk
                    off = base + in_chunk * row_bytes
                    # HDF5 usually allocates consecutive chunks back to
                    # back; merging byte-adjacent pieces keeps one preadv
                    # per contiguous extent instead of one per chunk
                    if jobs and jobs[-1][0] == path and (
                        jobs[-1][1] + jobs[-1][3] * row_bytes == off
                        and jobs[-1][2] + jobs[-1][3] == dest
                    ):
                        p_, o_, d_, n_ = jobs[-1]
                        jobs[-1] = (p_, o_, d_, n_ + take)
                    else:
                        jobs.append((path, off, dest, take))
                    row += take
                    dest += take
                    left -= take
                covered[lo - start : hi - start] = True

        out_b = out.view(np.uint8).reshape(n, row_bytes)
        if not covered.all():  # zero only the gaps, by contiguous run
            holes = np.flatnonzero(~covered)
            if holes.size:
                breaks = np.flatnonzero(np.diff(holes) > 1)
                starts_h = np.concatenate([[0], breaks + 1])
                ends_h = np.concatenate([breaks, [holes.size - 1]])
                for a, b in zip(holes[starts_h], holes[ends_h]):
                    out_b[a : b + 1] = 0

        def run(job):
            path, byte_off, dest_row, nrows = job
            fd = os.open(path, os.O_RDONLY)
            try:
                view = memoryview(out_b[dest_row : dest_row + nrows]).cast("B")
                done = 0
                want = nrows * row_bytes
                while done < want:
                    got = os.preadv(fd, [view[done:]], byte_off + done)
                    if got <= 0:
                        raise IOError(f"short read from {path}")
                    done += got
            finally:
                os.close(fd)

        total = sum(j[3] for j in jobs) * row_bytes
        try:
            if len(jobs) <= 1 or total < MIN_PARALLEL_BYTES:
                for j in jobs:
                    run(j)
                return True
            # split very large segments so they spread over the pool
            split: List[Tuple[Path, int, int, int]] = []
            rows_per_job = max(JOB_BYTES // row_bytes, 1)
            for path, off, dest, nrows in jobs:
                while nrows > 0:
                    take = min(nrows, rows_per_job)
                    split.append((path, off, dest, take))
                    off += take * row_bytes
                    dest += take
                    nrows -= take
            pool = self._get_pool()
            # submit + drain EVERY future before returning: Executor.map's
            # exception cleanup cancels only not-yet-started jobs, and an
            # in-flight straggler writing into `out` after a False return
            # would race the caller's h5py fallback refilling the same
            # buffer — silent corruption marked valid by the rebuilt mask
            futs = [pool.submit(run, j) for j in split]
            err: Optional[BaseException] = None
            for f in futs:
                try:
                    f.result()
                except Exception as e:
                    err = e
            if err is not None:
                raise err
            return True
        except Exception:
            # runtime read failure (file truncated/rewritten by a live
            # writer between probe and read): drop the stale maps and let
            # the caller take the h5py path, which re-reads fresh state.
            # Deliberately broad — the fast path is opportunistic and the
            # h5py fallback is the ground truth for ANY failure mode here
            with self._lock:
                self._maps.clear()
            return False

    def _get_pool(self) -> ThreadPoolExecutor:
        with self._lock:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(
                    max_workers=self.workers,
                    thread_name_prefix="pstpu-io",
                )
            return self._pool

    def close(self):
        with self._lock:
            if self._pool is not None:
                self._pool.shutdown(wait=False)
                self._pool = None
