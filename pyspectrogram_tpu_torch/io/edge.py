"""Bounds of a growing Digital RF capture from its followed edge.

:class:`DigitalRFReader` finds a channel's bounds by listing its cadence
subdirectories and the files of the two edge subdirectories and by parsing
the edge files' ``rf_data_index`` — every call. A live tab asks for them
every tick, and its engine asks between ticks as often as every few
milliseconds (runtime.live), so :class:`FollowedReader` answers the same
question from what it saw last time: it runs the same walk, but reuses a
directory listing while the directory's ``stat`` is unchanged, and an edge
file's parsed index while the file's ``stat`` is unchanged. On a capture
that only grows, a call is then a handful of ``stat`` calls: the channel
directory, the first and the last subdirectory, the first populated file
and the newest file. A file that gains rows, a new file (a rollover or a
gap) and a new subdirectory change one of those, and only that one is
read again. While span recording is on, each ``stat`` counts as one of
the ``syscalls`` of the open span, and a listing's entries and an opened
file as its ``files``, as the full listing counts them.

The answers are the full listing's at the moment of the call: the walk is
the same, and what it reuses is reread whenever it could have changed.
A ``stat`` shows a change by its inode, size, mtime or ctime. A second
write that lands within the file system's timestamp granule of the write
that set those could leave all four as they were, so a read is reused only
once it began at least :data:`RACY_NS` after this reader first saw that
stat (git's rule for racily clean index entries, timed on this host's
monotonic clock alone, so a file server's clock may run apart): any later
write then lies in a later granule and changes the stat. Until then each
call reads again. A file system whose timestamps are coarser than
:data:`RACY_NS` can hide such a second write until the next one.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Optional, Tuple

from pyspectrogram_tpu_torch.io import drf_format as fmt
from pyspectrogram_tpu_torch.io.reader import DigitalRFReader
from pyspectrogram_tpu_torch.utils import profiling
from pyspectrogram_tpu_torch.utils.errors import FormatError

#: a listing or an index read less than this long after this reader first
#: saw the directory's or file's stat is read again at the next call: a
#: local file system's timestamp granule, one kernel tick, is 1-10 ms
RACY_NS = 10_000_000
#: listings and indexes kept; the oldest go first, and a dropped one costs
#: only a reread
CACHE_CAP = 1024


def _stamp(path) -> Tuple[int, int, int, int]:
    """What a change to ``path`` changes: inode, size, mtime and ctime."""
    profiling.count("syscalls")
    st = os.stat(path)
    return st.st_ino, st.st_size, st.st_mtime_ns, st.st_ctime_ns


class FollowedReader(DigitalRFReader):
    """A :class:`DigitalRFReader` whose :meth:`get_bounds` and
    :meth:`data_version` follow the capture's edge (module docstring);
    everything else is the reader it was made from, whose state (the
    channels, the pooled fast read path) it shares.

    >>> ds.reader = FollowedReader.following(ds.reader)
    """

    @classmethod
    def following(cls, reader: DigitalRFReader) -> "FollowedReader":
        """A followed reader over ``reader``'s directory and state."""
        new = cls.__new__(cls)
        new.__dict__.update(reader.__dict__)
        new._seen = {}       # key -> (stamp, first seen, trusted, call, value)
        new._call = 0                   # calls of get_bounds / data_version
        new._edge_lock = threading.Lock()
        return new

    # ---------------------------------------------------------- the cache
    def _reuse(self, key, path, read):
        """``read(path)``, or what it returned before while ``path``'s
        stamp is unchanged and that read was not racy. A path the walk
        visits twice in one call (the one subdirectory that is both first
        and last) is stat'ed and read once."""
        seen = self._seen.get(key)
        if seen is not None and seen[3] == self._call:
            return seen[4]
        stamp = _stamp(path)
        now = time.monotonic_ns()
        if seen is not None and seen[0] == stamp:
            if seen[2]:
                self._seen[key] = seen[:3] + (self._call, seen[4])
                return seen[4]
            first = seen[1]
        else:
            first = now              # the write behind ``stamp`` came before
        value = read(path)
        self._seen.pop(key, None)
        while len(self._seen) >= CACHE_CAP:
            self._seen.pop(next(iter(self._seen)))
        self._seen[key] = (stamp, first, now - first >= RACY_NS, self._call,
                           value)
        return value

    def _subdirs(self, channel: str):
        def listing(chan_dir):
            subs = fmt.list_subdirs(chan_dir)
            profiling.count("files", len(subs))
            return subs
        chan_dir = self.top_dir / channel
        return self._reuse(("subs", chan_dir), chan_dir, listing)

    def _files(self, sub):
        return self._reuse(("files", sub), sub, fmt.subdir_data_files)

    def _edges(self, path) -> Tuple[Optional[int], Optional[int]]:
        """(first sample, last sample) of one data file, (None, None)
        while it has no index rows."""
        def parse(p):
            from pyspectrogram_tpu_torch.io import hdf5 as h5py

            with h5py.File(p, "r") as f:
                idx = f["rf_data_index"][...]
                nrows = f["rf_data"].shape[0]
            if not len(idx):
                return None, None
            return (int(idx[0, 0]),
                    int(idx[-1, 0]) + (nrows - int(idx[-1, 1])) - 1)
        return self._reuse(("edges", path), path, parse)

    # ------------------------------------------------------- the answers
    def get_bounds(self, channel: str) -> Tuple[int, int]:
        """(first_sample, last_sample), both inclusive: the full
        listing's walk (DigitalRFReader.get_bounds) over reused listings
        and indexes."""
        self._channel_props(channel)  # ChannelNotFoundError on unknowns
        with self._edge_lock:
            self._call += 1
            subs = self._subdirs(channel)
            first = last = None
            for sub in subs:
                for _, path in self._files(sub):
                    first = self._edges(path)[0]
                    if first is not None:
                        break
                if first is not None:
                    break
            for sub in reversed(subs):
                for _, path in reversed(self._files(sub)):
                    last = self._edges(path)[1]
                    if last is not None:
                        break
                if last is not None:
                    break
        if first is None or last is None:
            raise FormatError(f"channel {channel} has no written samples yet")
        return first, last

    def data_version(self, channel: str) -> Tuple[int, int]:
        """(number of cadence subdirectories, newest interior-subdir
        mtime), as DigitalRFReader.data_version, over the reused listing:
        each interior subdirectory is still stat'ed every call."""
        self._channel_props(channel)  # ChannelNotFoundError on unknowns
        with self._edge_lock:
            self._call += 1
            subs = self._subdirs(channel)
        interior_ns = 0
        for sub in subs[:-1]:
            interior_ns = max(interior_ns, _stamp(sub)[2])
        return len(subs), interior_ns
