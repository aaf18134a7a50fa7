"""Digital RF channel writer.

The reference has no writer (it only views data produced by external
recorders); a writer is required here both to generate synthetic test
fixtures (SURVEY.md section 4.3) and to make the framework a complete,
standalone Digital RF toolchain. Output is format-compatible with the
upstream ``digital_rf`` library and with this package's reader.

Copy of pyspectrogram_tpu/io/writer.py: the port imports nothing of that
package.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Union

import numpy as np

from pyspectrogram_tpu_torch.io import drf_format as fmt
from pyspectrogram_tpu_torch.utils.errors import FormatError


class DigitalRFWriter:
    """Append-only writer for one channel.

    Samples are addressed by absolute index since the epoch at the channel's
    rational rate. ``rf_write`` appends contiguous data; ``skip`` advances
    the write head, producing a gap (recorded via ``rf_data_index``).
    """

    def __init__(
        self,
        top_dir: Union[str, Path],
        channel: str,
        dtype,
        start_global_index: int,
        sample_rate_numerator: int,
        sample_rate_denominator: int = 1,
        subdir_cadence_secs: int = 3600,
        file_cadence_millisecs: int = 1000,
        num_subchannels: int = 1,
        compression_level: int = 0,
    ):
        self.top_dir = Path(top_dir)
        self.channel = channel
        self.user_dtype = np.dtype(dtype)
        self.disk_dtype = fmt.storage_dtype(self.user_dtype)
        klass, size, prec, is_complex = fmt.base_dtype_properties(self.user_dtype)
        self.props = fmt.ChannelProperties(
            sample_rate_numerator=sample_rate_numerator,
            sample_rate_denominator=sample_rate_denominator,
            subdir_cadence_secs=subdir_cadence_secs,
            file_cadence_millisecs=file_cadence_millisecs,
            num_subchannels=num_subchannels,
            is_complex=is_complex,
            is_continuous=True,
            h5_class=klass,
            h5_size=size,
            h5_precision=prec,
        )
        self.next_index = int(start_global_index)
        self._gap_pending = False
        self.compression_level = compression_level
        chan_dir = self.top_dir / channel
        chan_dir.mkdir(parents=True, exist_ok=True)
        fmt.write_properties(chan_dir / fmt.PROPERTIES_FILENAME, self.props)

    # ------------------------------------------------------------------
    def rf_write(self, arr: np.ndarray, global_index: Optional[int] = None) -> int:
        """Append a contiguous block; returns the next write index.

        ``arr`` is (n,) or (n, num_subchannels); ``global_index`` (if given)
        must be >= the current head and creates a gap when greater.
        """
        arr = np.asarray(arr)
        if arr.ndim == 1:
            arr = arr[:, None]
        if arr.ndim != 2 or arr.shape[1] != self.props.num_subchannels:
            raise FormatError(
                f"expected (n, {self.props.num_subchannels}) data, got {arr.shape}"
            )
        if global_index is not None:
            gi = int(global_index)
            if gi < self.next_index:
                raise FormatError("rf_write indices must be monotonically increasing")
            if gi > self.next_index:
                self._gap_pending = True
            self.next_index = gi
        if arr.dtype != self.user_dtype:
            arr = arr.astype(self.user_dtype)
        disk = fmt.packed_view(arr)

        start = self.next_index
        end = start + len(arr)
        s = start
        ms = self.props.file_start_ms(s)
        while s < end:
            _, span_end = self.props.file_sample_span(ms)
            chunk_end = min(end, span_end)
            if chunk_end > s:
                self._append_to_file(ms, s, disk[s - start : chunk_end - start])
                s = chunk_end
            # a cadence window holding zero samples (rate below
            # 1000/file_cadence_millisecs) writes no file at all —
            # appending here would litter empty .h5 files with bogus
            # zero-row index entries
            ms += self.props.file_cadence_millisecs
        self.next_index = end
        self._gap_pending = False
        return self.next_index

    def skip(self, n_samples: int) -> None:
        """Advance the write head without writing (creates a data gap)."""
        if n_samples < 0:
            raise FormatError("cannot skip backwards")
        self.next_index += int(n_samples)
        self._gap_pending = True

    # ------------------------------------------------------------------
    def _append_to_file(self, file_ms: int, global_start: int, disk_rows) -> None:
        import time

        import h5py

        path = self.props.file_path(self.top_dir, self.channel, file_ms)
        path.parent.mkdir(parents=True, exist_ok=True)
        kw = {}
        if self.compression_level:
            kw = dict(compression="gzip", compression_opts=self.compression_level)
        # a live reader in the same process may hold this file open
        # read-only for a moment (HDF5 refuses RDWR then) — retry briefly
        # instead of dropping the block
        for attempt in range(200):
            try:
                f = h5py.File(path, "a")
                break
            except OSError:
                if attempt == 199:
                    raise
                time.sleep(0.002)
        with f:
            if "rf_data" not in f:
                # full-row-width chunks: each chunk is then a contiguous
                # byte range of whole sample rows, which the pooled
                # GIL-free read path (io.fastread) maps directly; h5py's
                # auto-chunking would split the subchannel axis instead
                # chunk row count is bounded (NOT the whole file span):
                # HDF5 allocates uncompressed chunks full-size, so a file
                # holding a few rows of a sparse capture would otherwise
                # occupy chunk_rows*row_bytes on disk regardless of data
                # written. 8192 rows bounds that overallocation while the
                # fastread extent map merges byte-adjacent chunks back
                # into single preadv extents.
                span = self.props.file_sample_span(file_ms)
                chunk_rows = max(1, min(int(span[1] - span[0]), 8192))
                f.create_dataset(
                    "rf_data",
                    shape=(0, self.props.num_subchannels),
                    maxshape=(None, self.props.num_subchannels),
                    dtype=self.disk_dtype,
                    chunks=(chunk_rows, self.props.num_subchannels),
                    **kw,
                )
                f.create_dataset(
                    "rf_data_index",
                    shape=(0, 2),
                    maxshape=(None, 2),
                    dtype=np.uint64,
                )
            ds = f["rf_data"]
            idx = f["rf_data_index"]
            row = ds.shape[0]
            # New index entry at file start or after a gap; otherwise the
            # block continues the previous contiguous run.
            need_entry = True
            if idx.shape[0] and not self._gap_pending:
                last_g, last_r = (int(v) for v in idx[-1])
                if last_g + (row - last_r) == global_start:
                    need_entry = False
            ds.resize(row + len(disk_rows), axis=0)
            ds[row:] = disk_rows
            if need_entry:
                idx.resize(idx.shape[0] + 1, axis=0)
                idx[-1] = (global_start, row)

    def close(self) -> None:  # API symmetry; files are closed per-append
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
