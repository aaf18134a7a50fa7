"""The port's own HDF5 layer (pyspectrogram_tpu_torch.io.hdf5) against h5py
and the JAX package's reader, on the CPU.

h5py is the oracle only: every call into the port runs with ``h5py``
blocked in ``sys.modules`` (``no_h5py``), so the port cannot reach it.

(a) captures the JAX writer (h5py) wrote read through the port equal to
    the JAX reader, and captures the port wrote read through the JAX reader
    the same: tone on 2 subchannels, the int16 chirp with a gap, noise at
    100000/3 S/s in 100 ms files, gzip levels 1 and 6 written in uneven
    appends, and one file of more than 64 chunks (a chunk B-tree of depth
    2);
(b) h5py opens every file the port's writer makes and finds the shapes,
    dtypes, chunks, maxshape, filters, attributes and data of the JAX
    writer's twin;
(c) upstream-shaped captures (tests/upstream_capture.py: contiguous
    layout, uint64 / longdouble / bool attributes, multi-run index, gapped
    int16) read through the port equal to the JAX reader, every attribute
    (the long double rate too) as h5py reads it;
(d) the port's streaming processor chases a capture a writer thread grows;
(e) files h5py writes with libver="latest", with shuffle + fletcher32 or
    big-endian read as the JAX reader reads them (once refused); the
    filters no Digital RF writer applies (szip, nbit, scaleoffset, lzf)
    and a port write into a file of a format it does not write raise
    FormatError naming the structure, the file's bytes untouched; shuffle
    alone reads;
(f) in a fresh interpreter where h5py cannot be imported, write_capture ->
    RFDataset -> StiPipeline(device="cpu").compute() matches the JAX
    package's request on the same capture.
"""

import contextlib
import json
import subprocess
import sys
import textwrap
import threading
import time
from pathlib import Path

import h5py
import numpy as np
import pytest

from pyspectrogram_tpu.io import reader as jreader
from pyspectrogram_tpu.io import synthetic as jsynthetic
from pyspectrogram_tpu.io import writer as jwriter
from pyspectrogram_tpu.models import sti as jsti
from pyspectrogram_tpu_torch.io import hdf5, reader, synthetic, writer
from pyspectrogram_tpu_torch.models import sti
from pyspectrogram_tpu_torch.runtime import processor, signals
from pyspectrogram_tpu_torch.utils.config import SpectrogramConfig
from pyspectrogram_tpu_torch.utils.errors import FormatError, TerminateReason

from port_pairs import jax_config
from upstream_capture import write_upstream_capture

REPO = Path(__file__).resolve().parents[1]
SR = 1_000_000
START = 1_451_661_840 * SR
INT16C = np.dtype([("r", np.int16), ("i", np.int16)])


@contextlib.contextmanager
def no_h5py():
    """``import h5py`` fails inside the block (the port's side of a case)."""
    saved = sys.modules.get("h5py")
    sys.modules["h5py"] = None
    try:
        yield
    finally:
        sys.modules["h5py"] = saved


# ------------------------------------------------------------ captures
CAPTURES = {
    "tone2": dict(kind="tone", num_subchannels=2, noise_rms=1e-3,
                  n_samples=40_000),
    "int16_chirp_gap": dict(kind="chirp", dtype=INT16C, gap=(20_000, 3_000),
                            n_samples=40_000),
    "noise_100ms": dict(kind="noise", sample_rate_numerator=100_000,
                        sample_rate_denominator=3,
                        file_cadence_millisecs=100, subdir_cadence_secs=1,
                        n_samples=40_000),
    # written through DigitalRFWriter in uneven appends
    "gzip1": dict(n_samples=40_000, num_subchannels=1, compression_level=1,
                  block=7_777),
    "gzip6": dict(n_samples=30_000, num_subchannels=2, compression_level=6,
                  block=5_000, noise_rms=0.1),
    "deep_btree": dict(n_samples=700_000, num_subchannels=1,
                       compression_level=0, block=123_457),
}


def _write(synth, wmod, top, case):
    """One capture of ``case`` through one package's writer."""
    kw = dict(CAPTURES[case])
    if "block" not in kw:
        return synth.write_capture(top, **kw)
    n, nsub, block = kw["n_samples"], kw["num_subchannels"], kw["block"]
    x = synthetic.tone_signal(n, SR, [62_500.0 * (i + 1) for i in range(nsub)],
                              noise_rms=kw.get("noise_rms", 0.0), seed=3)
    w = wmod.DigitalRFWriter(top, "ch0", np.complex64, start_global_index=START,
                             sample_rate_numerator=SR, num_subchannels=nsub,
                             compression_level=kw["compression_level"])
    for s in range(0, n, block):
        w.rf_write(x[s:s + block].astype(np.complex64))
    return None


def _port_write(top, case):
    with no_h5py():
        return _write(synthetic, writer, top, case)


def _jax_write(top, case):
    return _write(jsynthetic, jwriter, top, case)


def _reads(ds) -> dict:
    """A dataset's state and a set of reads, keyed for comparison."""
    out = {"channels": ds.channels, "sr": ds.sr_dict, "ref": ds.ref_dict,
           "bnds": ds.bnds, "time_bnds": ds.time_bnds,
           "entries": ds.chan_entries}
    for chan in ds.channels:
        out[("props", chan)] = ds.reader.get_properties(chan)
        lo, hi = ds.bnds[chan]
        for st, n in ((lo - 50, hi - lo + 101), (lo + 1234, 5000)):
            out[(chan, st, n)] = ds.reader.read_vector_raw(
                st, n, chan, return_mask=True)
        out[(chan, "runs")] = list(ds.reader.read(lo, hi - lo + 1, chan)
                                   .items())
        out[(chan, "read")] = ds.read(lo, 4096, f"{chan}:0")
        out[(chan, "sti")] = ds.read_sti(lo, chan, hi, 256, 2, 9)
    return out


def _port_reads(top, io_workers=None) -> dict:
    with no_h5py():
        return _reads(reader.RFDataset(top, io_workers=io_workers))


def _same(a, b, where="") -> None:
    """Equal structure, dtypes and values, bit for bit."""
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _same(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert a == b, where


@pytest.mark.parametrize("case", list(CAPTURES))
def test_captures_read_as_the_jax_reader_reads(tmp_path, case):
    """(a) The port reads the JAX writer's capture as the JAX reader does,
    through the pooled byte-range path and the chunk-decoding path; the
    JAX reader reads the port writer's capture the same; the two
    writers' captures read alike."""
    meta_port = _port_write(tmp_path / "port", case)
    assert meta_port == _jax_write(tmp_path / "jax", case)
    want = _reads(jreader.RFDataset(tmp_path / "jax"))
    _same(_port_reads(tmp_path / "jax"), want)
    _same(_port_reads(tmp_path / "jax", io_workers=0), want)
    _same(_reads(jreader.RFDataset(tmp_path / "port")), want)
    _same(_port_reads(tmp_path / "port"), want)
    _same(_port_reads(tmp_path / "port", io_workers=0), want)
    if case == "deep_btree":
        for top in ("port", "jax"):
            first = sorted((tmp_path / top).glob("ch0/*/rf@*.h5"))[0]
            with no_h5py(), hdf5.File(first) as f:
                ds = f["rf_data"]
                assert ds.id.get_num_chunks() > 64
                assert ds._tree().root.level >= 1


def _text(v):
    """An attribute as text where it is a string (h5py reads the JAX
    writer's variable-length strings as str, the port's fixed-length ones
    as bytes)."""
    return v.decode() if isinstance(v, bytes) else v


def _summary(path) -> dict:
    """Everything h5py finds in one file."""
    with h5py.File(path, "r") as f:
        out = {"attrs": {k: _text(v) for k, v in f.attrs.items()}}
        for name, d in f.items():
            out[name] = dict(shape=d.shape, dtype=d.dtype, chunks=d.chunks,
                             maxshape=d.maxshape, compression=d.compression,
                             compression_opts=d.compression_opts,
                             shuffle=d.shuffle, fletcher32=d.fletcher32,
                             scaleoffset=d.scaleoffset, data=d[...],
                             nchunks=d.id.get_num_chunks())
    return out


@pytest.mark.parametrize("case", list(CAPTURES))
def test_h5py_opens_what_the_port_writes(tmp_path, case):
    """(b) Every file of the port writer's capture opens in h5py with the
    contents of the JAX writer's twin file."""
    _port_write(tmp_path / "port", case)
    _jax_write(tmp_path / "jax", case)
    files = sorted(p.relative_to(tmp_path / "port")
                   for p in (tmp_path / "port").rglob("*.h5"))
    assert files == sorted(p.relative_to(tmp_path / "jax")
                           for p in (tmp_path / "jax").rglob("*.h5"))
    assert len(files) > 1
    for rel in files:
        _same(_summary(tmp_path / "port" / rel),
              _summary(tmp_path / "jax" / rel), str(rel))


def _upstream_complex(top):
    sr_num, sr_den = 48_000, 7
    rng = np.random.default_rng(21)
    n = 40_000
    data = (rng.standard_normal((n, 2)) + 1j * rng.standard_normal((n, 2))
            ).astype(np.complex64)
    g0 = int(1_451_661_839 * sr_num // sr_den)
    write_upstream_capture(top, "up0", [(g0, data)], sr_num=sr_num,
                           sr_den=sr_den, subdir_cadence_secs=2,
                           file_cadence_millisecs=250)


def _upstream_gapped_int16(top):
    sr = 100_000
    rng = np.random.default_rng(22)

    def blk(g, n):
        a = np.zeros((n, 1), dtype=INT16C)
        a["r"] = rng.integers(-3000, 3000, (n, 1))
        a["i"] = rng.integers(-3000, 3000, (n, 1))
        return g, a

    g0 = 1_451_661_840 * sr
    blocks = [blk(g0, 10_000), blk(g0 + 10_050, 5_000),
              blk(g0 + 92_000, 8_000)]
    write_upstream_capture(top, "gap0", blocks, sr_num=sr,
                           is_continuous=False, subdir_cadence_secs=4,
                           file_cadence_millisecs=500)


def _upstream_tone_gap(top):
    n = 1 << 15
    tone = np.exp(2j * np.pi * 125_000 * np.arange(n) / SR
                  ).astype(np.complex64)[:, None]
    write_upstream_capture(top, "sti0", [(START, tone[:n // 3]),
                                         (START + n // 2, tone[n // 2:])],
                           sr_num=SR, is_continuous=False)


UPSTREAM = {"complex64_rational_rate": _upstream_complex,
            "gapped_int16_multi_run": _upstream_gapped_int16,
            "tone_with_gap": _upstream_tone_gap}


@pytest.mark.parametrize("case", list(UPSTREAM))
def test_upstream_captures_read_as_the_jax_reader_reads(tmp_path, case):
    """(c) Upstream-shaped captures: the port's reads equal the JAX
    reader's, on both read paths; the uint64 cadences, bool flags,
    strings and the long double rate read as h5py reads them."""
    UPSTREAM[case](tmp_path)
    want = _reads(jreader.RFDataset(tmp_path))
    _same(_port_reads(tmp_path), want)
    _same(_port_reads(tmp_path, io_workers=0), want)
    props = next(tmp_path.glob("*/drf_properties.h5"))
    with h5py.File(props, "r") as g:
        want_attrs = {k: _text(v) for k, v in g.attrs.items()}
    with no_h5py(), hdf5.File(props) as f:
        assert sorted(f.attrs) == sorted(want_attrs)
        got = {k: _text(f.attrs[k]) for k in f.attrs}
    assert type(got["samples_per_second"]) is np.longdouble
    for k, v in got.items():
        assert type(v) is type(want_attrs[k]) and v == want_attrs[k], k


def test_streaming_processor_chases_a_growing_capture(tmp_path):
    """(d) A writer thread grows a capture while the port's streaming
    processor (device="cpu") reads it through io.hdf5: the trailing window
    advances, every tail lies within the bounds, no loop error."""
    sr = 100_000
    start = 1_451_661_840 * sr
    block = 20_000
    w = writer.DigitalRFWriter(tmp_path, "live", np.complex64,
                               start_global_index=start,
                               sample_rate_numerator=sr,
                               file_cadence_millisecs=100,
                               subdir_cadence_secs=1)
    with no_h5py():
        w.rf_write(synthetic.tone_signal(block, sr, [12_500.0])
                   .astype(np.complex64))
        tails = []

        def track(e):
            us = int(e.times[-1].astype("datetime64[us]").astype(np.int64))
            tails.append(us * sr // 1_000_000 + 256)
            if len(tails) >= 6 and tails[-1] > tails[0]:
                proc.abort()

        proc = processor.SpectrogramProcessor(
            "streaming", tmp_path, tab_id=1,
            config=SpectrogramConfig(nfft=256, ntime=8, stream_seconds=0.05),
            callbacks=signals.ProcessorCallbacks(on_iterated=track),
            streaming_sleep=0.02, max_iterations=400, device="cpu")
        stop = threading.Event()

        def grow():
            i = 1
            while not stop.is_set() and i < 400:
                w.rf_write(synthetic.tone_signal(block, sr, [12_500.0],
                                                 start_sample=i * block)
                           .astype(np.complex64))
                i += 1
                time.sleep(0.015)

        t = threading.Thread(target=grow, daemon=True)
        t.start()
        proc.run()
        stop.set()
        t.join(10)
        assert proc.reason == TerminateReason.OK
        assert len(tails) >= 6 and tails[-1] > tails[0]
        lo, hi = reader.RFDataset(tmp_path).bnds["live"]
    assert all(lo <= tt <= hi + 1 for tt in tails)
    assert (lo, hi) == jreader.RFDataset(tmp_path).bnds["live"]


# ------------------------------------------------------------ refusals
def _rewrite(path, **kw):
    """Rewrite one data file's datasets through h5py with ``kw`` (file
    options under "file", rf_data options under "data")."""
    with h5py.File(path, "r") as f:
        data, index = f["rf_data"][...], f["rf_data_index"][...]
    dtype = kw.get("dtype", data.dtype)
    with h5py.File(path, "w", **kw.get("file", {})) as f:
        f.create_dataset("rf_data", data=data.astype(dtype),
                         maxshape=(None, data.shape[1]),
                         chunks=(4096, data.shape[1]), **kw.get("data", {}))
        f.create_dataset("rf_data_index", data=index, maxshape=(None, 2))


REFUSED = {
    # refused until the HDF5 layer read them; now read as the JAX reader
    "libver_latest": (dict(file=dict(libver="latest")), None),
    "shuffle_fletcher32": (dict(data=dict(shuffle=True, fletcher32=True)),
                           None),
    "big_endian": (dict(dtype=np.dtype(">c8")), None),
    # still refused: filters no Digital RF writer applies ...
    "lzf": (dict(data=dict(compression="lzf")), r"filter 32000 \(lzf\)"),
    "szip": ("szip", r"filter 4 \(szip\)"),
    "nbit": ("nbit", r"filter 5 \(nbit\)"),
    "scaleoffset": ("scaleoffset", r"filter 6 \(scaleoffset\)"),
    # ... and a write into a file the port would not have written
    "port_write_latest": ("write", "write into a file with superblock "
                                   "version 3"),
    "port_write_v2_header": ("write_v2_header", "version 2 object header"),
}


def _filtered_file(path, kind) -> None:
    """An int16 dataset through one filter no Digital RF writer applies."""
    x = np.arange(4000, dtype=np.int16)
    with h5py.File(path, "w") as f:
        if kind == "nbit":
            dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
            dcpl.set_chunk((500,))
            dcpl.set_filter(h5py.h5z.FILTER_NBIT, 0, ())
            f.create_dataset("x", data=x, dcpl=dcpl)
        elif kind == "szip":
            f.create_dataset("x", data=x, chunks=(500,), compression="szip")
        else:
            f.create_dataset("x", data=x, chunks=(500,), scaleoffset=0)


@pytest.mark.parametrize("case", list(REFUSED))
def test_unsupported_files_raise_format_error(tmp_path, case):
    """(e) A structure io.hdf5 does not read raises FormatError naming it,
    through io.hdf5 itself and, for a capture, through the port's reader
    on both paths; a write the port does not make raises before it
    changes a byte. The three structures once refused here (libver
    "latest", fletcher32, big-endian samples) now read as the JAX reader
    reads them."""
    kw, match = REFUSED[case]
    jsynthetic.write_capture(tmp_path, n_samples=40_000)
    last = sorted(tmp_path.glob("ch0/*/rf@*.h5"))[-1]
    if kw in ("szip", "nbit", "scaleoffset"):
        path = tmp_path / "f.h5"
        _filtered_file(path, kw)
        with h5py.File(path) as g:
            np.testing.assert_array_equal(g["x"][...], np.arange(4000))
        with no_h5py(), pytest.raises(FormatError, match=match):
            with hdf5.File(path) as f:
                f["x"][...]
        return
    if kw in ("write", "write_v2_header"):
        if kw == "write":
            _rewrite(last, file=dict(libver="latest"))
        else:
            # superblock 0 with a version 2 root header and new-style root
            # group: h5py makes them for creation-order tracking
            with h5py.File(last, "w", track_order=True) as f:
                f.create_dataset("rf_data", data=np.zeros((4, 1), "<c8"),
                                 maxshape=(None, 1), chunks=(4, 1))
                f.attrs["a"] = 1
        before = last.read_bytes()
        assert before[8] == (3 if kw == "write" else 0)
        with no_h5py():
            if kw == "write":
                with pytest.raises(FormatError, match=match):
                    hdf5.File(last, "a")
            else:
                with hdf5.File(last, "a") as f:
                    with pytest.raises(FormatError, match=match):
                        f.attrs["b"] = 2
                    with pytest.raises(FormatError, match="new-style group"):
                        f.create_dataset("more", shape=(0, 1),
                                         maxshape=(None, 1), dtype="<c8")
        assert last.read_bytes() == before
        return
    _rewrite(last, **kw)
    if match is None:
        want = _reads(jreader.RFDataset(tmp_path))
        _same(_port_reads(tmp_path), want)
        _same(_port_reads(tmp_path, io_workers=0), want)
        return
    with no_h5py():
        with pytest.raises(FormatError, match=match):
            with hdf5.File(last) as f:
                f["rf_data"][...]
        for workers in (None, 0):
            with pytest.raises(FormatError, match=match):
                ds = reader.RFDataset(tmp_path, io_workers=workers)
                lo, hi = ds.bnds["ch0"]
                ds.reader.read_vector_raw(lo, hi - lo + 1, "ch0")


def test_shuffle_alone_reads(tmp_path):
    """(e) Shuffled (and shuffled + gzip) chunks decode to the JAX
    reader's samples."""
    jsynthetic.write_capture(tmp_path, n_samples=40_000, num_subchannels=2,
                             sample_rate_numerator=20_000)
    files = sorted(tmp_path.glob("ch0/*/rf@*.h5"))
    assert len(files) == 2
    _rewrite(files[0], data=dict(shuffle=True))
    _rewrite(files[-1], data=dict(shuffle=True, compression="gzip"))
    with no_h5py(), hdf5.File(files[0]) as f:
        assert f["rf_data"].shuffle and f["rf_data"].compression is None
    want = _reads(jreader.RFDataset(tmp_path))
    _same(_port_reads(tmp_path), want)
    _same(_port_reads(tmp_path, io_workers=0), want)


# ------------------------------------------------------------ the module
def test_attributes_cross_h5py(tmp_path):
    """Attributes h5py writes (every fixed-point width, both floats, bool,
    fixed and variable-length strings, arrays, a long double) read through
    io.hdf5 as h5py reads them; what io.hdf5 writes reads in h5py."""
    values = {f"{k}{n}": np.array(7, f"{k}{n}")[()]
              for k in "iu" for n in (1, 2, 4, 8)}
    values.update(f4=np.float32(1.5), f8=2.25, flag=np.bool_(True),
                  vstr="two words", fstr=np.bytes_(b"ab"),
                  arr=np.arange(5, dtype=np.int32))
    values["ld"] = np.longdouble(1) / 3
    with h5py.File(tmp_path / "h.h5", "w") as f:
        for k, v in values.items():
            f.attrs[k] = v
    with no_h5py(), hdf5.File(tmp_path / "h.h5") as f:
        assert sorted(f.attrs) == sorted(values)
        got = {k: f.attrs[k] for k in values}
    with h5py.File(tmp_path / "h.h5") as g:
        for k in values:
            want = g.attrs[k]
            assert type(got[k]) is type(want), k
            assert np.array_equal(got[k], want), k
    mine = dict(a=3, b=2.5, c="text é", d=np.uint16(9), e=np.arange(3.0))
    with no_h5py(), hdf5.File(tmp_path / "p.h5", "w") as f:
        for k, v in mine.items():
            f.attrs[k] = v
        f.attrs["a"] = 4                       # replaced in place
        for i in range(40):                    # past the first block
            f.attrs[f"n{i:02d}"] = i
    with h5py.File(tmp_path / "p.h5") as g:
        assert g.attrs["a"] == 4 and g.attrs["b"] == 2.5
        assert g.attrs["c"].decode() == "text é" and g.attrs["d"] == 9
        assert g.attrs["d"].dtype == np.uint16
        np.testing.assert_array_equal(g.attrs["e"], mine["e"])
        assert [g.attrs[f"n{i:02d}"] for i in range(40)] == list(range(40))


@pytest.mark.parametrize("compression", [None, "gzip"])
@pytest.mark.parametrize("chunk_rows", [4, 64])
def test_grown_datasets_match_h5py(tmp_path, compression, chunk_rows):
    """A dataset grown by many uneven appends (chunk B-trees of depth 2
    and 3 at 4-row chunks) reads in h5py as what was written, with h5py's
    chunk map equal to io.hdf5's; the port then appends to a file h5py
    grew, and both read the whole."""
    rng = np.random.default_rng(5)
    rows = (rng.standard_normal((50_000, 2)) * 100).astype(np.int16)
    sizes = rng.integers(1, 600, 60)
    kw = dict(compression=compression, compression_opts=1 if compression
              else None)
    path = tmp_path / "g.h5"
    with no_h5py():
        row = 0
        for n in sizes:
            with hdf5.File(path, "a") as f:
                if "x" not in f:
                    f.create_dataset("x", shape=(0, 2), maxshape=(None, 2),
                                     dtype=np.int16, chunks=(chunk_rows, 2),
                                     **kw)
                    f.create_dataset("i", shape=(0, 2), maxshape=(None, 2),
                                     dtype=np.uint64)
                x, i = f["x"], f["i"]
                x.resize(row + n, axis=0)
                x[row:] = rows[row:row + n]
                i.resize(i.shape[0] + 1, axis=0)
                i[-1] = (row, n)
                row += n
        with hdf5.File(path) as f:
            x = f["x"]
            got = x[...]
            depth = x._tree().root.level
            mine = [tuple(x.id.get_chunk_info(k))
                    for k in range(x.id.get_num_chunks())]
            assert f["i"].chunks == (512, 2)
    assert depth >= (2 if chunk_rows == 4 else 1)
    with h5py.File(path, "a") as g:
        np.testing.assert_array_equal(g["x"][...], rows[:row])
        np.testing.assert_array_equal(g["x"][...], got)
        np.testing.assert_array_equal(g["i"][:, 1], sizes)
        d = g["x"]
        assert [tuple(d.id.get_chunk_info(k))
                for k in range(d.id.get_num_chunks())] == mine
        d.resize(row + 999, axis=0)
        d[row:] = rows[row:row + 999]
    row += 999
    with no_h5py(), hdf5.File(path, "a") as f:
        x = f["x"]
        np.testing.assert_array_equal(x[...], rows[:row])
        x.resize(row + 1500, axis=0)
        x[row:] = rows[row:row + 1500]
    row += 1500
    with h5py.File(path) as g:
        np.testing.assert_array_equal(g["x"][...], rows[:row])
        np.testing.assert_array_equal(g["x"][-1], rows[row - 1])
        assert g["x"][3, 1] == rows[3, 1]


def test_locks_follow_hdf5(tmp_path, monkeypatch):
    """flock as HDF5 takes it: a writer is refused while anyone reads or
    writes; a reader waits for a writer up to LOCK_WAIT_S, then OSError;
    readers share; h5py and io.hdf5 exclude each other."""
    monkeypatch.setattr(hdf5, "LOCK_WAIT_S", 0.05)
    path = tmp_path / "l.h5"
    with no_h5py():
        with hdf5.File(path, "w") as f:
            f.attrs["a"] = 1
        with hdf5.File(path) as r1, hdf5.File(path) as r2:
            assert r1.attrs["a"] == r2.attrs["a"] == 1
            with pytest.raises(OSError):
                hdf5.File(path, "a")
        with hdf5.File(path, "a"):
            t0 = time.monotonic()
            with pytest.raises(OSError):
                hdf5.File(path)
            assert time.monotonic() - t0 >= 0.05
        w = hdf5.File(path, "a")
    with pytest.raises(OSError):
        h5py.File(path, "r")
    w.close()
    with h5py.File(path, "r"):
        with no_h5py(), pytest.raises(OSError):
            hdf5.File(path, "a")
    with no_h5py():
        with pytest.raises(OSError, match="not an HDF5 file"):
            (tmp_path / "empty.h5").write_bytes(b"")
            hdf5.File(tmp_path / "empty.h5")
        with pytest.raises(OSError):
            hdf5.File(tmp_path / "missing.h5")


def test_request_without_h5py_matches_jax(tmp_path, monkeypatch):
    """(f) A fresh interpreter that cannot import h5py writes a capture,
    opens it and runs a request on the CPU (prefetch branch included); the
    JAX package's request on the same capture agrees within 1e-4 dB on
    every bin within 60 dB of its column's peak."""
    code = textwrap.dedent(f"""
        import json, sys
        sys.modules["h5py"] = None
        import numpy as np
        from pyspectrogram_tpu_torch.io import RFDataset
        from pyspectrogram_tpu_torch.io.synthetic import write_capture
        from pyspectrogram_tpu_torch.models import sti
        from pyspectrogram_tpu_torch.utils.config import SpectrogramConfig
        write_capture({str(tmp_path)!r}, n_samples=200_000,
                      num_subchannels=2, noise_rms=1e-3)
        sti.PREFETCH_MIN_BYTES = 0
        cfg = SpectrogramConfig(nfft=1024, nint=2, ntime=40)
        r = sti.StiPipeline(RFDataset({str(tmp_path)!r}), cfg,
                            device="cpu").compute()
        np.savez({str(tmp_path / "out.npz")!r}, med=r.sxx_med_dbfs,
                 sxx=r.sxx_dbfs, starts=r.frame_starts, mask=r.mask)
        print(json.dumps(sorted(m for m in sys.modules
                                if m.split(".")[0] in ("h5py", "jax"))))
    """)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert json.loads(res.stdout.splitlines()[-1]) == ["h5py"]  # the block
    got = np.load(tmp_path / "out.npz")
    cfg = SpectrogramConfig(nfft=1024, nint=2, ntime=40)
    want = jsti.StiPipeline(jreader.RFDataset(tmp_path),
                            jax_config(cfg)).compute()
    np.testing.assert_array_equal(got["starts"], want.frame_starts)
    np.testing.assert_array_equal(got["mask"], want.mask)
    for g, w in ((got["med"], want.sxx_med_dbfs), (got["sxx"], want.sxx_dbfs)):
        assert g.shape == w.shape
        keep = w >= w.max(axis=0, keepdims=True) - 60.0
        np.testing.assert_allclose(g[keep], w[keep], atol=1e-4, rtol=0)
    # and the port's own request in this process, h5py blocked, is the same
    monkeypatch.setattr(sti, "PREFETCH_MIN_BYTES", 0)
    with no_h5py():
        again = sti.StiPipeline(reader.RFDataset(tmp_path), cfg,
                                device="cpu").compute()
    np.testing.assert_array_equal(again.sxx_med_dbfs, got["med"])


def test_chip_smoke_files_phase_on_the_cpu(tmp_path, monkeypatch):
    """chip_smoke's files phase, end to end on the CPU at 3 s of capture:
    every bit-equality it holds on the card (files against memory, gzip
    against plain, the grown capture's live view against memory's) holds
    through the kernels' plain versions, with h5py blocked. The launch
    counters read as one launch a read, since no kernel runs here."""
    import torch

    sys.path.insert(0, str(REPO))
    import chip_smoke
    from pyspectrogram_tpu_torch import bench

    keys = list(bench.read_counts())
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(chip_smoke, "read_counts",
                        lambda: {k: 1 for k in keys})
    for name, value in dict(FILES_SECONDS=3, GZIP_SECONDS=1, GROW_BLOCKS=3,
                            FILES_REQUESTS=1, FILES_ASSEMBLIES=1,
                            FILES_TICKS=3).items():
        monkeypatch.setattr(chip_smoke, name, value)
    lines = []
    monkeypatch.setattr(chip_smoke, "emit", lines.append)
    with no_h5py():
        counts, top = chip_smoke.phase_files("cpu", "cpu", tmp_path, {})
    assert top == tmp_path / "capture"
    phases = [ln["phase"] for ln in lines]
    assert phases == ["files_write", "files_request_headline",
                      "files_request_reference_default",
                      "files_request_nfft65536", "files_timing_headline",
                      "files_read_parts", "files_gzip", "files_growing",
                      "files"]
    grown = lines[phases.index("files_growing")]
    assert grown["final_view_bit_equal_memory"] and grown["ticks"] == 3
    assert lines[1]["bit_equal_memory"] and lines[1]["max_db_diff_vs_cpu"] == 0
    assert all(v > 0 for v in counts.values())
    # the write is timed alone, and a "cold" row says whether it read a disk
    assert lines[0]["write_mb_per_s"] > 0
    assert lines[0]["capture_mount"]["fs"] != "unknown"
    timing = lines[phases.index("files_timing_headline")]
    for row in ("files_cold", "files_io_workers0_cold"):
        share = timing[row]["resident_after_drop_max"]
        assert 0.0 <= share <= 1.0
        assert timing[row]["disk_read"] == ("note" not in timing[row])
    parts = lines[phases.index("files_read_parts")]
    assert parts["frames"] == 128 and parts["probed_files"] >= 1
    assert parts["syscalls"]["preadv"]["calls"] >= 128
    assert parts["syscalls"]["open"]["calls"] == \
        parts["syscalls"]["preadv"]["calls"]
    assert parts["preadv_bytes"] == 128 * parts["frame_bytes"]


def test_chip_smoke_read_probes(tmp_path):
    """The files phase's probes: mount_of names the mount that holds a
    path, resident_share sees a file just read in the page cache,
    drop_cache returns a share, and timed_os_calls counts and records the
    calls a read makes, then puts os back as it was."""
    import os

    sys.path.insert(0, str(REPO))
    import chip_smoke

    with open("/proc/self/mounts") as f:
        points = {ln.split()[1]: ln.split()[2] for ln in f}
    where = chip_smoke.mount_of(tmp_path)
    assert points[where["mount"]] == where["fs"]
    top = tmp_path / "cap"
    top.mkdir()
    path = top / "a.h5"
    path.write_bytes(os.urandom(1 << 20))
    assert path.read_bytes()
    assert chip_smoke.resident_share([path]) == 1.0
    assert 0.0 <= chip_smoke.drop_cache(top) <= 1.0
    real = {k: getattr(os, k) for k in chip_smoke.READ_CALLS}
    spent = {k: [0.0, 0] for k in chip_smoke.READ_CALLS}
    preads = []
    buf = bytearray(4096)
    with chip_smoke.timed_os_calls(spent, preads):
        os.stat(path)
        fd = os.open(path, os.O_RDONLY)
        assert os.preadv(fd, [buf], 8192) == 4096
        os.close(fd)
    assert {k: c for k, (_, c) in spent.items()} == {
        "stat": 1, "open": 1, "preadv": 1, "close": 1}
    assert preads == [(path, 8192, 4096)]
    assert buf == path.read_bytes()[8192:12288]
    assert {k: getattr(os, k) for k in chip_smoke.READ_CALLS} == real
