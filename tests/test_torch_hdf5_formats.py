"""The port's HDF5 layer (pyspectrogram_tpu_torch.io.hdf5) on every file
format h5py writes, against h5py itself, on the CPU.

h5py writes each file; io.hdf5 reads it with ``h5py`` blocked in
``sys.modules`` (``no_h5py``), and both must return the same: values and
dtype of every dataset, its shape, maxshape, chunks and filter
properties, ``get_offset`` and every ``get_chunk_info``, every attribute
(type and value), every group's member names in h5py's order. Values are
compared bit for bit (no tolerance anywhere in this file).

(a) the format matrix: libver (all six) x storage (contiguous, compact,
    fixed-shape chunked, one and two unlimited axes, single chunk,
    implicit index) x filters (none, fletcher32, shuffle + gzip +
    fletcher32), each file holding little- and big-endian datasets;
    extensible-array data blocks split into pages (140,000 one-row
    chunks), fixed-array pages left unwritten, a user block, paged file
    space;
(b) attributes of every type, more than 8 (dense storage from v108 on),
    on file, group and dataset, with and without creation order;
(c) groups of more than 8 links, nested, with and without creation order;
(d) a flipped byte in a fletcher32 chunk, an object header, an
    extensible-array data block and a version 3 superblock: h5py and
    io.hdf5 both raise on the checksum;
(h) the committed fixtures of the card run (tests/data/hdf5_formats):
    h5py and io.hdf5 read the same, equal to the manifest's regenerated
    samples, and chip_smoke.py regenerates them with its own copy.
"""

import itertools
import json
import sys
from pathlib import Path

import h5py
import numpy as np
import pytest

from pyspectrogram_tpu_torch.io import hdf5, hdf5_blocks

from test_torch_hdf5 import no_h5py
import torch_hdf5_fixtures as fixtures

REPO = Path(__file__).resolve().parents[1]
LIBVERS = ["earliest", "v108", "v110", "v112", "v114", "latest"]
STORAGE = ["contiguous", "compact", "fixed", "growable1", "growable2",
           "single", "implicit"]
FILTERS = {"none": {}, "fletcher32": dict(fletcher32=True),
           "shuffle_gzip_fletcher32": dict(shuffle=True, compression="gzip",
                                           fletcher32=True)}
DTYPES = {"le_c8": np.dtype("<c8"), "be_c8": np.dtype(">c8"),
          "le_i2c": np.dtype([("r", "<i2"), ("i", "<i2")]),
          "be_i2c": np.dtype([("r", ">i2"), ("i", ">i2")]),
          "be_f8": np.dtype(">f8")}
# HDF5 filters only chunked data, and the implicit index only unfiltered
MATRIX = [(lv, st, fl) for lv, st, fl in itertools.product(
    LIBVERS, STORAGE, FILTERS)
    if fl == "none" or st not in ("contiguous", "compact", "implicit")]


def _data(dt, shape, seed=0):
    rng = np.random.default_rng(seed)
    x = np.zeros(shape, dt)
    if dt.names:
        for n in dt.names:
            x[n] = rng.integers(-3000, 3000, shape)
    elif dt.kind == "c":
        x[...] = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    else:
        x[...] = rng.standard_normal(shape)
    return x


def _dcpl(**kw):
    dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
    if kw.get("compact"):
        dcpl.set_layout(h5py.h5d.COMPACT)
    if kw.get("early"):
        dcpl.set_alloc_time(h5py.h5d.ALLOC_TIME_EARLY)
    return dcpl


def _write_matrix_file(path, libver, storage, filt):
    shape = (700, 3)
    with h5py.File(path, "w", libver=libver) as f:
        for name, dt in DTYPES.items():
            x = _data(dt, shape)
            kw = dict(FILTERS[filt])
            if storage == "contiguous":
                f.create_dataset(name, data=x)
            elif storage == "compact":
                f.create_dataset(name, data=x, dcpl=_dcpl(compact=True))
            elif storage == "fixed":
                f.create_dataset(name, data=x, chunks=(50, 2), **kw)
            elif storage == "growable1":
                f.create_dataset(name, data=x, chunks=(50, 2),
                                 maxshape=(None, 3), **kw)
            elif storage == "growable2":
                f.create_dataset(name, data=x, chunks=(50, 2),
                                 maxshape=(None, None), **kw)
            elif storage == "single":
                f.create_dataset(name, data=x, chunks=shape, **kw)
            else:
                f.create_dataset(name, data=x, chunks=(50, 2),
                                 dcpl=_dcpl(early=True))


def _chunk_infos(d):
    """Every chunk's info, h5py's in one pass (get_chunk_info(k) walks the
    index from its start for each k)."""
    if isinstance(d, h5py.Dataset):
        if d.chunks is None:
            return []
        out = []
        d.id.chunk_iter(lambda si: out.append(tuple(si)))
        return out
    return [tuple(d.id.get_chunk_info(k))
            for k in range(d.id.get_num_chunks())]


def _attrs(obj) -> list:
    return [(k, obj.attrs[k]) for k in obj.attrs.keys()]


def _dataset(d) -> dict:
    n = len(d)
    out = {p: getattr(d, p) for p in (
        "shape", "maxshape", "chunks", "dtype", "compression",
        "compression_opts", "shuffle", "fletcher32", "scaleoffset")}
    out.update(data=d[...], offset=d.id.get_offset(),
               chunks_info=_chunk_infos(d),
               nchunks=d.id.get_num_chunks() if d.chunks else 0,
               attrs=_attrs(d))
    for key in (slice(5, 123), slice(n - 7, n + 3), -1,
                (n // 2, 1) if len(d.shape) > 1 else n // 2):
        out[f"read {key}"] = d[key]
    return out


def _view(mod, path) -> dict:
    """Everything a module finds in ``path``: per object, its attributes
    in order, a group's member names, a dataset's properties and reads."""
    out = {}
    with mod.File(path, "r") as f:
        def walk(g, where):
            out[where] = {"keys": list(g.keys()), "attrs": _attrs(g)}
            for k in g.keys():
                obj = g[k]
                if isinstance(obj, (h5py.Dataset, hdf5.Dataset)):
                    out[f"{where}/{k}"] = _dataset(obj)
                else:
                    walk(obj, f"{where}/{k}")
        walk(f, "")
    return out


def _same(a, b, where=""):
    """Equal structure; arrays of equal dtype and values; scalars of equal
    type and value."""
    if isinstance(a, dict):
        assert list(a) == list(b), where
        for k in a:
            _same(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, (list, tuple)) and not isinstance(a, np.ndarray):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    else:
        assert type(a) is type(b), (where, type(a), type(b))
        if isinstance(a, (np.ndarray, np.generic)):
            assert a.dtype == b.dtype, (where, a.dtype, b.dtype)
            assert np.array_equal(a, b), where
        else:
            assert a == b, where


def _same_file(path):
    """Everything h5py finds in ``path`` equals what io.hdf5 finds."""
    want = _view(h5py, path)
    with no_h5py():
        got = _view(hdf5, path)
    _same(got, want, str(path))


# ------------------------------------------------------------ (a)
@pytest.mark.parametrize("libver,storage,filt", MATRIX,
                         ids=["-".join(c) for c in MATRIX])
def test_format_matrix_reads_as_h5py(tmp_path, libver, storage, filt):
    """(a) Each libver x storage x filter case, little- and big-endian
    complex, int16 compounds and doubles: io.hdf5 equals h5py."""
    path = tmp_path / "m.h5"
    _write_matrix_file(path, libver, storage, filt)
    _same_file(path)


def test_paged_extensible_array_reads_as_h5py(tmp_path):
    """(a) 140,000 one-row chunks under libver="latest": the extensible
    array's data blocks past its 131,060th element are split into
    checksummed pages, each read and mapped to its chunks."""
    path = tmp_path / "ea.h5"
    x = (np.arange(140_000) % 251).astype(np.int8)
    with h5py.File(path, "w", libver="latest") as f:
        f.create_dataset("x", data=x, chunks=(1,), maxshape=(None,))
    with h5py.File(path) as g:
        want = _chunk_infos(g["x"]), g["x"][...]
    with no_h5py(), hdf5.File(path) as f:
        b = f["x"]
        assert _chunk_infos(b) == want[0]
        assert b.id.get_num_chunks() == 140_000
        np.testing.assert_array_equal(b[120_000:140_000], want[1][120_000:])
    np.testing.assert_array_equal(want[1], x)


def test_fixed_array_pages_and_unwritten_chunks(tmp_path):
    """(a) Fixed arrays of 5000 one-row chunks (pages of 1024 elements),
    only a few written: pages never written read as the fill value."""
    path = tmp_path / "fa.h5"
    with h5py.File(path, "w", libver="latest") as f:
        d = f.create_dataset("x", shape=(5000,), dtype="i4", chunks=(1,),
                             fillvalue=-7)
        d[10:20] = 5
        d[3000:3003] = 9
        e = f.create_dataset("y", shape=(5000, 2), dtype=">i4",
                             chunks=(1, 2), fletcher32=True)
        e[4100:4105] = 3
    _same_file(path)
    with no_h5py(), hdf5.File(path) as f:
        assert f["x"].id.get_num_chunks() == 13
        assert f["x"][2999] == -7 and f["x"][3001] == 9


@pytest.mark.parametrize("libver", ["earliest", "latest"])
def test_user_block_and_paged_file_space(tmp_path, libver):
    """(a) A 1024-byte user block (the superblock found past it, offsets
    reported from the file's start) and paged file-space aggregation."""
    path = tmp_path / "u.h5"
    with h5py.File(path, "w", libver=libver, userblock_size=1024) as f:
        f.create_dataset("e", data=np.arange(300).reshape(100, 3),
                         chunks=(7, 2), maxshape=(None, 3))
        f.create_dataset("c", data=np.arange(300).reshape(3, 100))
        f.attrs["a"] = 1
    _same_file(path)
    path = tmp_path / "p.h5"
    with h5py.File(path, "w", libver=libver, fs_strategy="page",
                   fs_page_size=4096) as f:
        f.create_dataset("x", data=np.arange(3000).reshape(1000, 3),
                         chunks=(10, 3), maxshape=(None, 3))
        for i in range(12):
            f.attrs[f"a{i}"] = i
    _same_file(path)


# ------------------------------------------------------------ (b), (c)
def _attr_values():
    v = {}
    for i in range(10):
        v.update({f"i8_{i}": np.int64(i), f"u2_{i}": np.uint16(i),
                  f"f4_{i}": np.float32(i / 3), f"f8_{i}": i / 7,
                  f"ld_{i}": np.longdouble(i) / 3, f"vs_{i}": f"text {i} é",
                  f"fs_{i}": np.bytes_(b"ab%d" % i),
                  f"b_{i}": np.bool_(i % 2),
                  f"arr_{i}": np.arange(i + 1, dtype=np.int32),
                  f"c_{i}": np.complex64(i + 1j),
                  f"be_{i}": np.array(i, ">i4")[()]})
    return v


@pytest.mark.parametrize("track", [False, True], ids=["name", "crt_order"])
@pytest.mark.parametrize("libver", LIBVERS)
def test_attributes_of_every_type(tmp_path, libver, track):
    """(b) 110 attributes of 11 types (long double and variable-length
    strings among them) on the file, a group and a dataset, in h5py's
    order."""
    path = tmp_path / "a.h5"
    with h5py.File(path, "w", libver=libver, track_order=track) as f:
        g = f.create_group("g")
        d = f.create_dataset("d", data=np.arange(10.0))
        for obj in (f, g, d):
            for k, v in _attr_values().items():
                obj.attrs[k] = v
    _same_file(path)
    with no_h5py(), hdf5.File(path) as f:
        assert len(f.attrs) == 110
        assert f["d"].attrs["ld_2"] == np.longdouble(2) / 3


@pytest.mark.parametrize("track", [False, True], ids=["name", "crt_order"])
@pytest.mark.parametrize("libver", LIBVERS)
def test_groups_of_many_links(tmp_path, libver, track):
    """(c) 20 groups at the root (created out of name order), 12 nested
    groups each holding a dataset: the links read by path, in h5py's
    order (name, or creation where the group tracks it)."""
    path = tmp_path / "g.h5"
    with h5py.File(path, "w", libver=libver, track_order=track) as f:
        for i in range(20):
            f.create_group(f"top{19 - i:02d}")
        g = f.create_group("nest", track_order=track)
        for i in range(12):
            s = g.create_group(f"sub{11 - i:02d}")
            s.attrs["i"] = i
            s.create_dataset("d", data=np.arange(i + 1))
    _same_file(path)
    with no_h5py(), hdf5.File(path) as f:
        assert "nest/sub03/d" in f and "nest/none" not in f
        np.testing.assert_array_equal(f["nest/sub03/d"][...], np.arange(9))
        assert len(f["nest"]) == 12


# ------------------------------------------------------------ checksums
def test_lookup3_matches_published_values():
    """Jenkins' own test vectors of hashlittle (initval 0)."""
    assert hdf5_blocks.lookup3(b"") == 0xDEADBEEF
    assert hdf5_blocks.lookup3(b"Four score and seven years ago") == \
        0x17770551


@pytest.mark.parametrize("fill", ["random", "zeros", "ones"])
def test_fletcher32_matches_hdf5(tmp_path, fill):
    """HDF5's stored fletcher32 of chunks of odd and even byte counts, of
    zeros and of 0xFF bytes (sums that fold to 0xFFFF), equals ours."""
    path = tmp_path / "f.h5"
    n = 1500
    x = {"random": np.random.default_rng(1).integers(0, 256, n),
         "zeros": np.zeros(n), "ones": np.full(n, 255)}[fill].astype(np.uint8)
    with h5py.File(path, "w") as f:
        for c in (1, 7, 360, 361, 722, 1499):
            f.create_dataset(f"c{c}", data=x, chunks=(c,), fletcher32=True)
    with h5py.File(path) as f:
        for name, d in f.items():
            for k in range(d.id.get_num_chunks()):
                off = d.id.get_chunk_info(k).chunk_offset
                _, raw = d.id.read_direct_chunk(off)
                assert hdf5_blocks.fletcher32(raw[:-4]) == \
                    int.from_bytes(raw[-4:], "little"), (name, k)
                assert hdf5_blocks.strip_fletcher32(raw, name) == raw[:-4]


# ------------------------------------------------------------ (d)
def _flip(path, at):
    b = bytearray(path.read_bytes())
    b[at] ^= 0x01
    path.write_bytes(bytes(b))


def _chunk_byte(d):
    return d.id.get_chunk_info(0).byte_offset + 3


CORRUPT = {
    # where the flipped byte lies, from h5py's view of the file
    "fletcher32_chunk": lambda raw, f: _chunk_byte(f["x"]),
    "object_header": lambda raw, f: raw.index(b"OHDR", 100) + 9,
    "extensible_array_data_block": lambda raw, f: raw.index(b"EADB") + 20,
    "superblock_v3": lambda raw, f: 20,
}


@pytest.mark.parametrize("case", list(CORRUPT))
def test_corruption_raises_where_h5py_raises(tmp_path, case):
    """(d) One flipped byte: h5py and io.hdf5 both raise on the checksum
    (io.hdf5 an OSError; h5py an OSError, or a KeyError for an object
    header it cannot open), and io.hdf5 returns no data of the block."""
    path = tmp_path / "c.h5"
    with h5py.File(path, "w", libver="latest") as f:
        f.create_dataset("x", data=np.arange(4000, dtype=np.int32),
                         chunks=(100,), maxshape=(None,), fletcher32=True)
    with h5py.File(path) as f:
        at = CORRUPT[case](path.read_bytes(), f)
    _flip(path, at)

    def read(mod):
        with mod.File(path, "r") as f:
            return f["x"][...]

    # h5py reports a header it cannot open as a KeyError of its group
    with pytest.raises((OSError, KeyError), match="checksum|filter returned"):
        read(h5py)
    with no_h5py(), pytest.raises(OSError, match="checksum"):
        read(hdf5)


def test_superblock_flagged_open_for_write_is_refused(tmp_path):
    """(d) A version 3 superblock whose flags say a writer holds the file
    (its checksum made right): h5py and io.hdf5 both refuse to open it."""
    path = tmp_path / "w.h5"
    with h5py.File(path, "w", libver="latest") as f:
        f.create_dataset("x", data=np.arange(10))
    b = bytearray(path.read_bytes())
    b[11] = 1
    b[44:48] = hdf5_blocks.lookup3(bytes(b[:44])).to_bytes(4, "little")
    path.write_bytes(bytes(b))
    with pytest.raises(OSError, match="already open for write"):
        h5py.File(path, "r")
    with no_h5py(), pytest.raises(OSError, match="already open for write"):
        hdf5.File(path)


# ------------------------------------------------------------ (h)
MANIFEST = json.loads((fixtures.HERE / "manifest.json").read_text())


@pytest.mark.parametrize("name", list(fixtures.FIXTURES))
def test_committed_fixtures_read_as_h5py_and_manifest(name):
    """(h) The card run's fixtures: every file reads the same through
    h5py and io.hdf5; rf_data over the files equals the samples the
    manifest regenerates (their digest too); each has the structures it
    is there for."""
    entry = MANIFEST["fixtures"][name]
    spec = MANIFEST["samples"]
    assert entry["seed"] == fixtures.FIXTURES[name]["seed"]
    samples = fixtures.fixture_samples(spec, entry["seed"])
    assert fixtures.sample_digest(samples) == entry["sha256"]
    top = fixtures.HERE / name
    for path in sorted(top.rglob("*.h5")):
        _same_file(path)
    rows = []
    with no_h5py():
        for rel in entry["files"]:
            with hdf5.File(top / rel) as f:
                d = f["rf_data"]
                rows.append(d[...])
                raw = (top / rel).read_bytes()
                assert raw[8] == (3 if entry["libver"] != "v108" else 2)
                assert (b"EAHD" if entry["growable"] else b"FAHD") in raw
                assert d.fletcher32 == bool(entry["filters"].get(
                    "fletcher32"))
                assert d.dtype.fields["r"][0].byteorder == (
                    ">" if entry["byteorder"] == ">" else "=")
        with hdf5.File(top / "ch0" / "drf_properties.h5") as f:
            assert len(f.attrs) == 16
            assert f.attrs["samples_per_second"] == spec["sample_rate"]
            assert b"FRHP" in (top / "ch0" / "drf_properties.h5").read_bytes()
    got = np.concatenate(rows)
    assert np.array_equal(got["r"], samples["r"])
    assert np.array_equal(got["i"], samples["i"])
    sizes = sum(p.stat().st_size for p in top.rglob("*.h5"))
    assert sizes <= 1 << 20


def test_chip_smoke_regenerates_the_fixture_samples():
    """(h) chip_smoke.py's own copy of fixture_samples makes the same
    samples as the fixture script, from the manifest alone."""
    sys.path.insert(0, str(REPO))
    import chip_smoke

    spec = MANIFEST["samples"]
    for name, entry in MANIFEST["fixtures"].items():
        a = chip_smoke.fixture_samples(spec, entry["seed"])
        b = fixtures.fixture_samples(spec, entry["seed"])
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    total = sum(p.stat().st_size for p in fixtures.HERE.rglob("*"))
    assert total <= 3 << 20


def test_chip_smoke_files_formats_phase_on_the_cpu(tmp_path, monkeypatch):
    """chip_smoke's files_formats phase on the CPU, h5py blocked: every
    equality it holds on the card (reads against the manifest's samples,
    requests and the live view from the fixtures against memory, bit for
    bit) holds through the kernels' plain versions, and its timing rows
    are filled. The launch counters read as one launch a read."""
    import torch

    sys.path.insert(0, str(REPO))
    import chip_smoke
    from pyspectrogram_tpu_torch import bench

    keys = list(bench.read_counts())
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(chip_smoke, "read_counts",
                        lambda: {k: 1 for k in keys})
    monkeypatch.setattr(chip_smoke, "FORMATS_PARSES", 2)
    monkeypatch.setattr(chip_smoke, "FORMATS_READS", 1)
    lines = []
    monkeypatch.setattr(chip_smoke, "emit", lines.append)
    with no_h5py():
        counts = chip_smoke.phase_files_formats("cpu", "cpu", tmp_path)
    assert [ln["phase"] for ln in lines] == [
        *(f"files_formats_{n}" for n in fixtures.FIXTURES), "files_formats"]
    for ln in lines[:-1]:
        assert ln["superblock"] == 3
        assert all(r["bit_equal_memory"] for r in ln["requests"].values())
        assert ln["live"]["bit_equal_memory"]
        for row in ("fixture", "earliest_twin"):
            assert all(v > 0 for v in ln[row].values())
    assert lines[1]["rf_data"]["fletcher32"]
    assert lines[1]["fletcher32_mb_per_s"] > 0
    assert lines[2]["chunk_index"] == "fixed array"
    assert all(v > 0 for v in counts.values())
