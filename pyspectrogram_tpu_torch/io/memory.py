"""A capture held in memory, with the RFDataset interface StiPipeline reads.

:class:`MemoryDataset` serves one channel of samples from a numpy array:
its bounds, rate, full-scale reference and channel maps, and
``reader.read_vector_raw`` with the Digital RF reader's semantics (storage
dtype, zero fill and a False mask outside the written span). A request then
runs end to end, host assembly and prefetch branch included, without
Digital RF files or h5py; ``append`` grows the capture for the live
engine, from a writer thread while processors read it from theirs.
"""

from __future__ import annotations

import threading
from fractions import Fraction

import numpy as np

from pyspectrogram_tpu_torch.io.reader import RFDataset


class MemoryReader:
    """The part of io.reader.DigitalRFReader that StiPipeline and the live
    engine call, over one (n, nsub) array whose first row is absolute
    sample ``start``. :meth:`append` grows it, as a writer grows a
    capture; a lock makes an append and the reads of other threads see
    the store whole."""

    def __init__(self, channel: str, samples: np.ndarray, start: int):
        self.channel = channel
        self._lock = threading.Lock()
        self._buf = samples
        self._n = len(samples)
        self.start = int(start)

    @property
    def samples(self) -> np.ndarray:
        """The held samples, (n, nsub)."""
        with self._lock:
            return self._buf[:self._n]

    def append(self, samples: np.ndarray) -> None:
        """Extend the capture by ``samples`` ((m, nsub), or (m,) for one
        subchannel, in the held dtype). The store grows geometrically, so
        an append copies O(m) samples amortized."""
        with self._lock:
            samples = np.asarray(samples, self._buf.dtype).reshape(
                -1, self._buf.shape[1])
            n = self._n + len(samples)
            if n > len(self._buf):
                buf = np.empty((max(n, 2 * len(self._buf)),
                                self._buf.shape[1]), self._buf.dtype)
                buf[:self._n] = self._buf[:self._n]
                self._buf = buf
            self._buf[self._n:n] = samples
            self._n = n

    def get_bounds(self, channel: str):
        """(first, last) absolute sample, both inclusive."""
        with self._lock:
            return self.start, self.start + self._n - 1

    def data_version(self, channel: str):
        return 1, 0  # held samples never change; appends move the bounds

    def read_vector_raw(self, start_sample: int, n_samples: int,
                        channel: str, return_mask: bool = False):
        """Dense (n, nsub) read in the storage dtype; samples outside the
        held span are zero and masked False."""
        held = self.samples   # appends never change the rows of this view
        st, n = int(start_sample), int(n_samples)
        out = np.zeros((n, held.shape[1]), held.dtype)
        mask = np.zeros(n, bool)
        lo = max(st, self.start)
        hi = min(st + n, self.start + len(held))
        if lo < hi:
            out[lo - st:hi - st] = held[lo - self.start:hi - self.start]
            mask[lo - st:hi - st] = True
        return (out, mask) if return_mask else out


class MemoryDataset(RFDataset):
    """One channel of ``samples`` ((n, nsub) or (n,), complex64 or the
    int16 ('r', 'i') compound) at ``sample_rate`` Hz, first sample at
    absolute index ``start``, dBFS reference ``ref``. Holds the same public
    state as RFDataset and inherits its channel parsing, frame-start
    spreading and bounds refresh."""

    def __init__(self, samples: np.ndarray, sample_rate, channel: str = "ch0",
                 start: int = 0, ref: float = 1.0):
        # RFDataset.__init__ opens a directory; set its state directly
        samples = np.asarray(samples)
        if samples.ndim == 1:
            samples = samples[:, None]
        self.reader = MemoryReader(channel, samples, start)
        sr = Fraction(sample_rate)
        bnds = self.reader.get_bounds(channel)
        nsub = samples.shape[1]
        self.chan_2sub = {channel: np.arange(nsub)}
        self.chan_entries = {f"{channel}:{i}": (channel, i)
                             for i in range(nsub)}
        self.sr_dict = {channel: sr}
        self.ref_dict = {channel: float(ref)}
        self.bnds = {channel: bnds}
        self.data_version = {channel: self.reader.data_version(channel)}
        self.time_bnds = (float(bnds[0] / sr), float(bnds[1] / sr))

    def append(self, samples: np.ndarray) -> None:
        """Grow the capture (MemoryReader.append); :meth:`bnds_update`
        then sees the new bounds, as it sees a writer's."""
        self.reader.append(samples)
