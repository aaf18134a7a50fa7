"""io.edge.FollowedReader against the full listing (io.reader.
DigitalRFReader) on a capture that the port's writer grows: at every step
the followed ``get_bounds`` and ``data_version`` equal a fresh reader's,
across file and subdirectory rollover, a gap, a data file that exists
before its first index row, a backfill into an interior subdirectory and
a recorder that stops; a probe of an unchanged capture lists and opens
nothing, and a read made within a timestamp granule of a change is made
again."""

import time

import numpy as np
import pytest

from pyspectrogram_tpu_torch.io import edge
from pyspectrogram_tpu_torch.io import hdf5 as h5py
from pyspectrogram_tpu_torch.io.reader import DigitalRFReader, RFDataset
from pyspectrogram_tpu_torch.io.writer import DigitalRFWriter
from pyspectrogram_tpu_torch.utils import profiling
from pyspectrogram_tpu_torch.utils.errors import FormatError

SR = 100_000                      # 10,000 samples a file, 100,000 a subdir
START = 1_451_661_840 * SR
CHAN = "live"


def _writer(top, start=START):
    return DigitalRFWriter(top, CHAN, np.complex64, start_global_index=start,
                           sample_rate_numerator=SR,
                           file_cadence_millisecs=100, subdir_cadence_secs=1)


def _samples(n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, 1))
            + 1j * rng.standard_normal((n, 1))).astype(np.complex64)


def _same(followed, top):
    """The followed reader answers as a fresh full listing does."""
    full = DigitalRFReader(top)
    assert followed.get_bounds(CHAN) == full.get_bounds(CHAN)
    assert followed.data_version(CHAN) == full.data_version(CHAN)
    return full.get_bounds(CHAN)


def _empty_file(top, sample):
    """The data file holding ``sample``, created as a writer creates it,
    before its first index row lands."""
    props = DigitalRFReader(top)._channel_props(CHAN)
    path = props.file_path(top, CHAN, props.file_start_ms(sample))
    path.parent.mkdir(parents=True, exist_ok=True)
    with h5py.File(path, "a") as f:
        f.create_dataset("rf_data", shape=(0, 1), maxshape=(None, 1),
                         dtype=np.dtype([("r", "<f4"), ("i", "<f4")]),
                         chunks=(8192, 1))
        f.create_dataset("rf_data_index", shape=(0, 2), maxshape=(None, 2),
                         dtype=np.uint64)
    return path


def test_followed_bounds_equal_the_full_listing_as_a_capture_grows(tmp_path):
    w = _writer(tmp_path)
    w.rf_write(_samples(4_000))
    followed = edge.FollowedReader.following(DigitalRFReader(tmp_path))
    n = 4_000
    steps = [3_000,            # inside the first file
             3_000,            # to the file's end exactly
             1,                # a new file of one sample
             25_000,           # across two file rollovers
             65_000,           # into the next subdirectory
             10_000, 7]
    for k, step in enumerate(steps):
        w.rf_write(_samples(step, k + 1))
        n += step
        assert _same(followed, tmp_path) == (START, START + n - 1)
        # asked again at once (a racy read), then once it is trusted
        assert _same(followed, tmp_path) == (START, START + n - 1)
    time.sleep(edge.RACY_NS / 1e9)
    assert _same(followed, tmp_path) == (START, START + n - 1)

    # a file that exists before its first index row: the bounds stay those
    # of the last populated file, then move once its first rows land
    w.rf_write(_samples(-n % 10_000, 8))
    n += -n % 10_000
    _empty_file(tmp_path, START + n)
    assert _same(followed, tmp_path) == (START, START + n - 1)
    w.rf_write(_samples(500, 9))
    n += 500
    assert _same(followed, tmp_path) == (START, START + n - 1)

    # a gap that skips files and a subdirectory
    w.rf_write(_samples(2_000, 10), global_index=START + n + 150_000)
    n += 152_000
    assert _same(followed, tmp_path) == (START, START + n - 1)

    # the recorder stops: every later probe answers the same
    for _ in range(3):
        assert _same(followed, tmp_path) == (START, START + n - 1)
        time.sleep(edge.RACY_NS / 2e9)


def test_backfill_into_an_interior_subdirectory(tmp_path):
    w = _writer(tmp_path)
    w.rf_write(_samples(30_000))
    w.rf_write(_samples(30_000, 1), global_index=START + 250_000)
    followed = edge.FollowedReader.following(DigitalRFReader(tmp_path))
    _same(followed, tmp_path)
    time.sleep(edge.RACY_NS / 1e9)
    before = followed.data_version(CHAN)
    # an out-of-order writer fills part of the gap, in the middle
    # subdirectory: the bounds stay, the interior fingerprint moves
    _writer(tmp_path, START + 150_000).rf_write(_samples(1_000, 2))
    assert _same(followed, tmp_path) == (START, START + 279_999)
    assert followed.data_version(CHAN) != before


def test_a_channel_without_samples_raises_as_the_full_listing(tmp_path):
    _writer(tmp_path)
    _empty_file(tmp_path, START)
    followed = edge.FollowedReader.following(DigitalRFReader(tmp_path))
    for reader in (followed, DigitalRFReader(tmp_path)):
        with pytest.raises(FormatError, match="no written samples"):
            reader.get_bounds(CHAN)
    _writer(tmp_path).rf_write(_samples(10))
    assert _same(followed, tmp_path) == (START, START + 9)


def test_an_unchanged_capture_costs_stat_calls_alone(tmp_path):
    """Once what it read is older than a timestamp granule, a probe of a
    capture that did not change lists no directory and opens no file;
    after an append it opens the newest file alone."""
    w = _writer(tmp_path)
    w.rf_write(_samples(150_050))          # two subdirectories, 16 files
    ds = RFDataset(tmp_path)
    ds.reader = edge.FollowedReader.following(ds.reader)
    ds.bnds_update()
    time.sleep(edge.RACY_NS / 1e9)
    ds.bnds_update()
    profiling.reset()
    was = profiling.tracing(True)
    try:
        ds.bnds_update()
        w.rf_write(_samples(100, 1))
        ds.bnds_update()
    finally:
        profiling.tracing(was)
    idle, grown = [s for s in profiling.spans() if s.name == "io.bounds"]
    profiling.reset()
    assert "files" not in idle.counts and 0 < idle.counts["syscalls"] <= 8
    assert grown.counts["files"] == 1
    assert ds.bnds[CHAN] == (START, START + 150_149)


def test_a_read_within_a_granule_is_made_again(tmp_path, monkeypatch):
    """Where the file system's timestamps are coarse, a write just after a
    read can leave the file's stat as it was: a read made within RACY_NS
    of first seeing that stat is not reused."""
    w = _writer(tmp_path)
    w.rf_write(_samples(1_000))
    real = edge._stamp
    frozen = {}

    def coarse(path):
        # the stat of the first call, forever
        return frozen.setdefault(path, real(path))

    monkeypatch.setattr(edge, "_stamp", coarse)
    followed = edge.FollowedReader.following(DigitalRFReader(tmp_path))
    assert followed.get_bounds(CHAN) == (START, START + 999)
    w.rf_write(_samples(500, 1))           # same file, same (frozen) stat
    assert followed.get_bounds(CHAN) == (START, START + 1_499)
