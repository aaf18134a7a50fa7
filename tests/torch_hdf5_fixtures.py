"""The Digital RF captures in HDF5's newer formats that the port's card run
reads (chip_smoke.py's ``files_formats`` phase), and how they are made.

    python tests/torch_hdf5_fixtures.py    # rewrites tests/data/hdf5_formats

The card's machine has no h5py, so these captures are written here by
h5py and committed. Each is a full channel directory: ``drf_properties.h5``
with upstream digital_rf's 16 attributes (the long double
``samples_per_second`` among them, so more than 8 attributes: dense
storage from libver v108 on) and two ``rf@*.h5`` files of int16 complex
``{r, i}`` samples on two subchannels, a tone each plus noise:

* ``latest_plain``: libver "latest", a growable ``rf_data`` written in
  appends (an extensible-array chunk index), no filters: the pooled
  ``preadv`` path;
* ``latest_gzip_fletcher32``: the same with shuffle + gzip + fletcher32
  (upstream's ``checksum=True``): the chunk-decoding path;
* ``v110_fixed_be``: libver "v110", a fixed-shape big-endian ``rf_data``
  (a fixed-array index): the chunk-decoding path, which io.fastread
  leaves big-endian data to.

``manifest.json`` records each fixture's seed, the h5py and HDF5 versions
that wrote it, and how its samples are made; ``fixture_samples`` makes
them with numpy integer arithmetic alone (a table of rounded tone values,
splitmix64 noise), so any machine regenerates them bit for bit.
chip_smoke.py keeps its own copy of that function (it imports nothing of
the tests); tests/test_torch_hdf5_formats.py holds the two, the manifest
and the files equal.
"""

from __future__ import annotations

import datetime
import hashlib
import json
import shutil
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent / "data" / "hdf5_formats"
CHANNEL = "ch0"
SAMPLES = dict(n=122_880, nsub=2, sample_rate=100_000,
               start_second=1_600_000_000, periods=[16, 8], amplitude=8192,
               noise=64)
CHUNK_ROWS = 4000
APPEND_ROWS = 10_000
FILE_CADENCE_MS = 1000
SUBDIR_CADENCE_S = 3600
FIXTURES = {
    "latest_plain": dict(seed=11, libver="latest", growable=True,
                         byteorder="<", filters={}),
    "latest_gzip_fletcher32": dict(
        seed=12, libver="latest", growable=True, byteorder="<",
        filters=dict(shuffle=True, compression="gzip", compression_opts=4,
                     fletcher32=True)),
    "v110_fixed_be": dict(seed=13, libver="v110", growable=False,
                          byteorder=">", filters={}),
}


def fixture_samples(spec: dict, seed: int) -> np.ndarray:
    """(n, nsub) int16 complex ``{r, i}`` samples: on subchannel s a tone
    of period ``periods[s]`` samples and amplitude ``amplitude`` (a table
    of rounded cos/sin values, none near a rounding tie), plus noise
    uniform on [-noise, noise] from splitmix64 of (seed, s, part, row)."""
    n, nsub, amp, na = spec["n"], spec["nsub"], spec["amplitude"], \
        spec["noise"]
    out = np.zeros((n, nsub), [("r", "<i2"), ("i", "<i2")])
    rows = np.arange(n, dtype=np.uint64)
    for s, period in enumerate(spec["periods"][:nsub]):
        ph = 2 * np.pi * np.arange(period) / period
        for part, table in (("r", amp * np.cos(ph)), ("i", amp * np.sin(ph))):
            frac = np.abs(table - np.floor(table) - 0.5)
            assert frac.min() > 1e-6, "a tone value lies on a rounding tie"
            tone = np.round(table).astype(np.int64)[np.arange(n) % period]
            z = (rows + np.uint64((seed * 8 + s * 2 + (part == "i")) << 32)
                 ) * np.uint64(0x9E3779B97F4A7C15)
            z ^= z >> np.uint64(30)
            z *= np.uint64(0xBF58476D1CE4E5B9)
            z ^= z >> np.uint64(27)
            z *= np.uint64(0x94D049BB133111EB)
            z ^= z >> np.uint64(31)
            noise = (z % np.uint64(2 * na + 1)).astype(np.int64) - na
            out[part][:, s] = tone + noise
    return out


def sample_digest(samples: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(samples).tobytes()).hexdigest()


def file_plan(spec: dict):
    """[(relative path of an rf file, first row, end row)]: files of
    FILE_CADENCE_MS, in SUBDIR_CADENCE_S directories, from a start on a
    whole second."""
    sr, start_s = spec["sample_rate"], spec["start_second"]
    per_file = sr * FILE_CADENCE_MS // 1000
    out = []
    for a in range(0, spec["n"], per_file):
        sec = start_s + a // sr
        sub = datetime.datetime.fromtimestamp(
            sec - sec % SUBDIR_CADENCE_S, datetime.timezone.utc
        ).strftime("%Y-%m-%dT%H-%M-%S")
        out.append((f"{CHANNEL}/{sub}/rf@{sec}.000.h5", a,
                    min(a + per_file, spec["n"])))
    return out


def properties(spec: dict, byteorder: str) -> dict:
    """upstream digital_rf's drf_properties attributes for the capture."""
    sr = spec["sample_rate"]
    return {
        "H5Tget_class": np.int64(0), "H5Tget_size": np.int64(2),
        "H5Tget_order": np.int64(1 if byteorder == ">" else 0),
        "H5Tget_offset": np.int64(0), "H5Tget_precision": np.int64(16),
        "subdir_cadence_secs": np.uint64(SUBDIR_CADENCE_S),
        "file_cadence_millisecs": np.uint64(FILE_CADENCE_MS),
        "sample_rate_numerator": np.uint64(sr),
        "sample_rate_denominator": np.uint64(1),
        "samples_per_second": np.longdouble(sr),
        "is_complex": np.bool_(True), "is_continuous": np.bool_(True),
        "num_subchannels": np.int64(spec["nsub"]),
        "epoch": "1970-01-01T00:00:00Z",
        "digital_rf_time_description": (
            "All times in this format are in number of samples since the "
            "epoch in the epoch attribute."),
        "digital_rf_version": "2.6.8",
    }


def write_fixture(top: Path, name: str, fx: dict, spec: dict) -> dict:
    """One fixture's channel directory under ``top``; its manifest entry."""
    import h5py

    samples = fixture_samples(spec, fx["seed"])
    disk = np.dtype([("r", f"{fx['byteorder']}i2"),
                     ("i", f"{fx['byteorder']}i2")])
    chan = top / CHANNEL
    chan.mkdir(parents=True)
    with h5py.File(chan / "drf_properties.h5", "w", libver=fx["libver"]) as f:
        for k, v in properties(spec, fx["byteorder"]).items():
            f.attrs[k] = v
    start = spec["start_second"] * spec["sample_rate"]
    files = []
    for rel, a, b in file_plan(spec):
        path = top / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        rows = samples[a:b].astype(disk)
        with h5py.File(path, "w", libver=fx["libver"]) as f:
            if fx["growable"]:
                d = f.create_dataset("rf_data", shape=(0, spec["nsub"]),
                                     maxshape=(None, spec["nsub"]),
                                     dtype=disk,
                                     chunks=(CHUNK_ROWS, spec["nsub"]),
                                     **fx["filters"])
                idx = f.create_dataset("rf_data_index", shape=(0, 2),
                                       maxshape=(None, 2), dtype=np.uint64)
                for r in range(0, len(rows), APPEND_ROWS):
                    blk = rows[r:r + APPEND_ROWS]
                    d.resize(r + len(blk), axis=0)
                    d[r:] = blk
                    if r == 0:
                        idx.resize(1, axis=0)
                        idx[0] = (start + a, 0)
            else:
                f.create_dataset("rf_data", data=rows,
                                 chunks=(CHUNK_ROWS, spec["nsub"]),
                                 **fx["filters"])
                f.create_dataset("rf_data_index", data=np.array(
                    [[start + a, 0]], np.uint64))
        files.append(rel)
    return {**fx, "files": files, "sha256": sample_digest(samples),
            "disk_dtype": disk.descr}


def main(top: Path = HERE) -> dict:
    import h5py

    if top.exists():
        shutil.rmtree(top)
    top.mkdir(parents=True)
    manifest = {"h5py": h5py.__version__,
                "hdf5": h5py.version.hdf5_version,
                "channel": CHANNEL, "samples": SAMPLES,
                "chunk_rows": CHUNK_ROWS, "append_rows": APPEND_ROWS,
                "fixtures": {}}
    for name, fx in FIXTURES.items():
        manifest["fixtures"][name] = write_fixture(top / name, name, fx,
                                                   SAMPLES)
    (top / "manifest.json").write_text(json.dumps(manifest, indent=1) + "\n")
    return manifest


if __name__ == "__main__":
    m = main()
    sizes = {n: sum(p.stat().st_size for p in (HERE / n).rglob("*.h5"))
             for n in m["fixtures"]}
    print(json.dumps({"fixtures": sizes, "total": sum(sizes.values())}))
