"""Digital RF captures in every HDF5 format h5py writes, read through the
port (pyspectrogram_tpu_torch) against the JAX package's reader, on the
CPU.

(e) captures the JAX writer wrote, every file (drf_properties.h5 with its
    15 attributes: dense storage from v108 on) rewritten by h5py in each
    libver, with fletcher32, shuffle + gzip, big-endian samples and
    fixed-shape rf_data; and the upstream-shaped golden captures
    (tests/upstream_capture.py: its long double rate) rewritten with
    libver="latest": the port's RFDataset, pooled and io_workers=0,
    returns what the JAX reader returns, bit for bit, and a request
    through StiPipeline(device="cpu") agrees with the JAX package's within
    1e-4 dB on every bin within 60 dB of its column's peak (the tolerance
    of tests/test_torch_hdf5.py's request test);
(f) an h5py writer in another process appends to a capture with
    libver="latest" while the port's streaming processor chases it;
and chip_smoke's GUI phase opens its directory tabs on the CPU.

The port's side of every case runs with h5py blocked in sys.modules.
"""

import json
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import h5py
import numpy as np
import pytest

from pyspectrogram_tpu.io import reader as jreader
from pyspectrogram_tpu.io import synthetic as jsynthetic
from pyspectrogram_tpu.models import sti as jsti
from pyspectrogram_tpu_torch.io import hdf5, reader
from pyspectrogram_tpu_torch.models import sti
from pyspectrogram_tpu_torch.runtime import processor, signals
from pyspectrogram_tpu_torch.utils.config import SpectrogramConfig
from pyspectrogram_tpu_torch.utils.errors import TerminateReason

from port_pairs import jax_config
from test_torch_hdf5 import UPSTREAM, _port_reads, _reads, _same, no_h5py

REPO = Path(__file__).resolve().parents[1]

#: name -> (libver, rf_data filters, rf_data dtype or None, growable)
FORMATS = {
    **{lv: (lv, {}, None, True)
       for lv in ("earliest", "v108", "v110", "v112", "v114", "latest")},
    "latest_shuffle_gzip_fletcher32": (
        "latest", dict(shuffle=True, compression="gzip", fletcher32=True),
        None, True),
    "v110_fletcher32_big_endian": ("v110", dict(fletcher32=True),
                                   np.dtype(">c8"), True),
    "v108_fixed_big_endian": ("v108", {}, np.dtype(">c8"), False),
    "earliest_fletcher32": ("earliest", dict(fletcher32=True), None, True),
}
#: the cases that also run a request against the JAX package's
REQUESTS = ("latest_shuffle_gzip_fletcher32", "v110_fletcher32_big_endian")
REQUEST = SpectrogramConfig(nfft=1024, nint=2, ntime=40)


def rewrite_file(path, libver, data_kw=None, dtype=None, growable=True):
    """Rewrite one HDF5 file of a capture through h5py in ``libver``:
    every attribute of the root, and every dataset (rf_data with
    ``data_kw`` and ``dtype``, growable or of fixed shape; a contiguous
    dataset stays contiguous)."""
    with h5py.File(path, "r") as f:
        attrs = {k: f.attrs[k] for k in f.attrs}
        sets = {k: (d[...], d.chunks) for k, d in f.items()}
    with h5py.File(path, "w", libver=libver) as f:
        for k, v in attrs.items():
            f.attrs[k] = v
        for k, (data, chunks) in sets.items():
            kw = {}
            if k == "rf_data":
                if dtype is not None:
                    data = data.astype(dtype)
                kw = dict(data_kw or {})
            if chunks is not None or kw:
                rows = min(4096, max(len(data), 1))
                kw["chunks"] = (rows,) + data.shape[1:]
                if growable or k != "rf_data":
                    kw["maxshape"] = (None,) + data.shape[1:]
            f.create_dataset(k, data=data, **kw)


def rewrite_capture(top, libver, data_kw=None, dtype=None, growable=True):
    for path in sorted(Path(top).rglob("*.h5")):
        rewrite_file(path, libver, data_kw, dtype, growable)


def _request_matches_jax(top) -> None:
    want = jsti.StiPipeline(jreader.RFDataset(top),
                            jax_config(REQUEST)).compute()
    with no_h5py():
        got = sti.StiPipeline(reader.RFDataset(top), REQUEST,
                              device="cpu").compute()
    np.testing.assert_array_equal(got.frame_starts, want.frame_starts)
    np.testing.assert_array_equal(got.mask, want.mask)
    for g, w in ((got.sxx_med_dbfs, want.sxx_med_dbfs),
                 (got.sxx_dbfs, want.sxx_dbfs)):
        assert g.shape == w.shape
        keep = w >= w.max(axis=0, keepdims=True) - 60.0
        np.testing.assert_allclose(g[keep], w[keep], atol=1e-4, rtol=0)


@pytest.mark.parametrize("case", list(FORMATS))
def test_captures_in_every_format_read_as_the_jax_reader(tmp_path, case):
    """(e) A two-file, two-subchannel capture rewritten in one format:
    the port's reads equal the JAX reader's on both read paths."""
    libver, data_kw, dtype, growable = FORMATS[case]
    jsynthetic.write_capture(tmp_path, n_samples=40_000, num_subchannels=2,
                             sample_rate_numerator=20_000, noise_rms=1e-3)
    rewrite_capture(tmp_path, libver, data_kw, dtype, growable)
    props = next(tmp_path.glob("*/drf_properties.h5")).read_bytes()
    assert props[8] == (0 if libver == "earliest" else
                        2 if libver == "v108" else 3)
    assert (b"FRHP" in props) == (libver != "earliest")
    want = _reads(jreader.RFDataset(tmp_path))
    _same(_port_reads(tmp_path), want)
    _same(_port_reads(tmp_path, io_workers=0), want)
    if case in REQUESTS:
        _request_matches_jax(tmp_path)


@pytest.mark.parametrize("case", list(UPSTREAM))
def test_upstream_captures_in_the_latest_format(tmp_path, case):
    """(e) The upstream-shaped golden captures rewritten with
    libver="latest" (contiguous rf_data stays contiguous): the port's
    reads and every property attribute, the long double rate included,
    equal the JAX reader's and h5py's."""
    UPSTREAM[case](tmp_path)
    rewrite_capture(tmp_path, "latest")
    want = _reads(jreader.RFDataset(tmp_path))
    _same(_port_reads(tmp_path), want)
    _same(_port_reads(tmp_path, io_workers=0), want)
    props = next(tmp_path.glob("*/drf_properties.h5"))
    with h5py.File(props) as g:
        want_attrs = {k: g.attrs[k] for k in g.attrs}
    with no_h5py(), hdf5.File(props) as f:
        got = {k: f.attrs[k] for k in f.attrs}
    assert list(got) == list(want_attrs)
    for k, v in got.items():
        assert type(v) is type(want_attrs[k]) and v == want_attrs[k], k
    assert type(got["samples_per_second"]) is np.longdouble


WRITER = textwrap.dedent("""
    import sys, time
    import h5py
    import numpy as np
    from pyspectrogram_tpu.io import synthetic, writer

    top, first, blocks, block, sr = sys.argv[1], *map(int, sys.argv[2:6])
    opened = h5py.File
    h5py.File = lambda *a, **k: opened(*a, libver="latest", **k)
    w = writer.DigitalRFWriter(top, "live", np.complex64,
                               start_global_index=1_451_661_840 * sr
                               + first * block,
                               sample_rate_numerator=sr,
                               file_cadence_millisecs=100,
                               subdir_cadence_secs=1)
    for i in range(first, first + blocks):
        w.rf_write(synthetic.tone_signal(block, sr, [12_500.0],
                                         start_sample=i * block)
                   .astype(np.complex64))
        time.sleep(0.015)
""")


def test_streaming_processor_chases_a_latest_format_capture(tmp_path):
    """(f) An h5py writer (the JAX package's, every file opened with
    libver="latest") appends 20,000-sample blocks from another process
    while the port's streaming processor (device="cpu") reads the
    capture: the trailing window advances, every tail lies within the
    bounds, no loop error, and the bounds at the end are the JAX
    reader's."""
    sr, block = 100_000, 20_000

    def writer(first, blocks):
        return [sys.executable, "-c", WRITER, str(tmp_path), str(first),
                str(blocks), str(block), str(sr)]

    subprocess.run(writer(0, 1), cwd=REPO, check=True, timeout=120)
    first = next(tmp_path.rglob("rf@*.h5")).read_bytes()
    assert first[8] == 3                          # superblock version 3
    grower = subprocess.Popen(writer(1, 150), cwd=REPO)
    tails = []
    try:
        with no_h5py():
            def track(e):
                us = int(e.times[-1].astype("datetime64[us]")
                         .astype(np.int64))
                tails.append(us * sr // 1_000_000 + 256)
                if len(tails) >= 6 and tails[-1] > tails[0]:
                    proc.abort()

            proc = processor.SpectrogramProcessor(
                "streaming", tmp_path, tab_id=1,
                config=SpectrogramConfig(nfft=256, ntime=8,
                                         stream_seconds=0.05),
                callbacks=signals.ProcessorCallbacks(on_iterated=track),
                streaming_sleep=0.02, max_iterations=600, device="cpu")
            t0 = time.monotonic()
            proc.run()
            assert time.monotonic() - t0 < 120
    finally:
        grower.wait(timeout=120)
    assert grower.returncode == 0
    assert proc.reason == TerminateReason.OK
    assert len(tails) >= 6 and tails[-1] > tails[0]
    with no_h5py():
        lo, hi = reader.RFDataset(tmp_path).bnds["live"]
    assert all(lo <= tt <= hi + 1 for tt in tails)
    assert (lo, hi) == jreader.RFDataset(tmp_path).bnds["live"]


def test_chip_smoke_gui_directory_tabs_on_the_cpu(tmp_path, monkeypatch):
    """chip_smoke's GUI phase on the CPU with its directory tabs: a written
    tab on a committed fixture and a live tab (2 s window) on a capture
    the port wrote, each opened by a MainWindow without ``open_dataset``
    and bit-equal to the same tab over a MemoryDataset. The launch
    counters read as one launch a read."""
    import torch

    sys.path.insert(0, str(REPO))
    import chip_smoke
    from pyspectrogram_tpu_torch import bench
    from pyspectrogram_tpu_torch.io import DigitalRFWriter
    from pyspectrogram_tpu_torch.io.memory import MemoryDataset

    keys = list(bench.read_counts())
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(chip_smoke, "read_counts",
                        lambda: {k: 1 for k in keys})
    lines = []
    monkeypatch.setattr(chip_smoke, "emit", lines.append)
    sr = 100_000
    tones = [sr / 16.0, sr / 8.0]
    x = chip_smoke.two_tone(4 * sr, sr, tones, noise_rms=1e-3, seed=1)
    start = chip_smoke.FILES_START * sr
    manifest = json.loads((chip_smoke.FORMATS_DIR / "manifest.json")
                          .read_text())
    with no_h5py():
        DigitalRFWriter(tmp_path / "cap", "ch0", np.complex64,
                        start_global_index=start, sample_rate_numerator=sr,
                        num_subchannels=2).rf_write(x)
        fx_mem, fx_dir, _ = chip_smoke.fixture_dataset("latest_plain",
                                                       manifest)
        dirs = [("fixture", fx_dir, fx_mem, tones, False),
                ("capture", tmp_path / "cap",
                 MemoryDataset(x, sr, start=start), tones, True)]
        counts = chip_smoke.phase_gui("cpu", "cpu", MemoryDataset(
            x[:2 * sr], sr), MemoryDataset(x, sr), tones, tmp_path,
            window_s=2.0, dirs=dirs)
    assert [ln["phase"] for ln in lines] == [
        "gui_headless_written", "gui_headless_live",
        "gui_headless_fixture_files", "gui_headless_capture_files"]
    for ln in lines[2:]:
        assert ln["frames_bit_equal_memory"]
        assert ln["first_frame_s"] > 0 and ln["memory_first_frame_s"] > 0
    assert lines[3]["streaming"] and lines[3]["frames"] == 4
    assert all(v > 0 for v in counts.values())
