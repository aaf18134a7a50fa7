"""Digital RF v2 on-disk format: layout rules, dtype mapping, dBFS reference.

The reference delegates all of this to the external ``digital_rf`` C/HDF5
library (reference: drfProc.py:52, drfProc.py:63-92). This module is a
from-scratch implementation of the same on-disk convention so datasets are
interchangeable with the upstream tooling:

  <top>/<channel>/drf_properties.h5                  (channel metadata attrs)
  <top>/<channel>/<YYYY-MM-DDTHH-MM-SS>/rf@SEC.MMM.h5 (sample data files)

* Subdirectories cover ``subdir_cadence_secs`` each; files cover
  ``file_cadence_millisecs`` each; both boundaries are derived from the
  absolute sample index with integer-exact rational-rate math.
* Data files hold an ``rf_data`` dataset of shape (nrows, num_subchannels)
  and an ``rf_data_index`` uint64 dataset of (global_sample_index, row)
  pairs marking the start of each contiguous run.
* Complex data is stored as an HDF5 compound type with fields 'r' and 'i'
  (h5py's native complex mapping uses the same field names).

Copy of pyspectrogram_tpu/io/drf_format.py: the port imports nothing of that
package.
"""

from __future__ import annotations

import dataclasses
import datetime
import re
from fractions import Fraction
from pathlib import Path
from typing import List, Tuple

import numpy as np

from pyspectrogram_tpu_torch.io.time_util import (
    millisecond_to_sample_ceil,
    sample_to_millisecond,
)
from pyspectrogram_tpu_torch.utils import profiling
from pyspectrogram_tpu_torch.utils.errors import FormatError

PROPERTIES_FILENAME = "drf_properties.h5"
VERSION = "2.5.4"
SUBDIR_FMT = "%Y-%m-%dT%H-%M-%S"
FILE_RE = re.compile(r"^rf@(\d+)\.(\d{3})\.h5$")

# HDF5 class codes (H5T_class_t): the dBFS reference rule dispatches on them
# (reference: drfProc.py:197-201).
H5T_INTEGER = 0
H5T_FLOAT = 1


def get_ref(prop_dict) -> float:
    """dBFS full-scale reference from channel dtype properties.

    Float data is assumed already full-scale-1.0; integer data full scale is
    ``2**(precision-1 + 0.5*(size_bytes-1))`` — the extra half bit per
    additional byte-pair accounts for complex integer packing
    (reference: drfProc.py:182-201).
    """
    if int(prop_dict["H5Tget_class"]) == H5T_FLOAT:
        return 1.0
    npow = float(prop_dict["H5Tget_precision"]) - 1.0
    npow += 0.5 * (float(prop_dict["H5Tget_size"]) - 1.0)
    return float(2.0 ** npow)


def base_dtype_properties(dtype: np.dtype) -> Tuple[int, int, int, bool]:
    """(H5Tget_class, H5Tget_size, H5Tget_precision, is_complex) of a sample dtype.

    Properties describe the *scalar base* type: complex64 -> float32 base,
    compound ('r','i') int16 -> int16 base. This matches how upstream
    digital_rf records them, which is what makes the reference's
    ``get_ref`` produce e.g. 2**15.5 for complex int16.
    """
    dtype = np.dtype(dtype)
    if dtype.names is not None:
        if set(dtype.names) != {"r", "i"}:
            raise FormatError(f"compound sample dtype must have fields r,i: {dtype}")
        base = dtype["r"]
        is_complex = True
    elif dtype.kind == "c":
        base = np.dtype(f"f{dtype.itemsize // 2}")
        is_complex = True
    else:
        base = dtype
        is_complex = False
    if base.kind == "f":
        klass = H5T_FLOAT
    elif base.kind in ("i", "u"):
        klass = H5T_INTEGER
    else:
        raise FormatError(f"unsupported sample dtype {dtype}")
    return klass, base.itemsize, base.itemsize * 8, is_complex


def storage_dtype(dtype: np.dtype) -> np.dtype:
    """On-disk dtype for a user-facing sample dtype (complex -> r/i compound)."""
    dtype = np.dtype(dtype)
    if dtype.kind == "c":
        base = np.dtype(f"f{dtype.itemsize // 2}")
        return np.dtype([("r", base), ("i", base)])
    return dtype


def packed_view(arr: np.ndarray) -> np.ndarray:
    """View/convert a user array into its on-disk representation."""
    if arr.dtype.kind == "c":
        return np.ascontiguousarray(arr).view(storage_dtype(arr.dtype))
    return arr


def storage_dtype_of(props: "ChannelProperties") -> np.dtype:
    """On-disk sample dtype described by channel properties."""
    base = np.dtype(f"{'f' if props.h5_class == H5T_FLOAT else 'i'}{props.h5_size}")
    if props.is_complex:
        return np.dtype([("r", base), ("i", base)])
    return base


def memory_dtype_of(props: "ChannelProperties") -> np.dtype:
    """In-memory dtype h5py yields for this channel's data: float compound
    {r,i} comes back as native complex; integer compound stays structured."""
    if props.is_complex and props.h5_class == H5T_FLOAT:
        return np.dtype(f"c{2 * props.h5_size}")
    return storage_dtype_of(props)


@dataclasses.dataclass(frozen=True)
class ChannelProperties:
    """Metadata of one Digital RF channel (contents of drf_properties.h5)."""

    sample_rate_numerator: int
    sample_rate_denominator: int
    subdir_cadence_secs: int
    file_cadence_millisecs: int
    num_subchannels: int
    is_complex: bool
    is_continuous: bool
    h5_class: int
    h5_size: int
    h5_precision: int
    epoch: str = "1970-01-01T00:00:00Z"
    version: str = VERSION

    def __post_init__(self):
        if self.subdir_cadence_secs * 1000 % self.file_cadence_millisecs != 0:
            raise FormatError(
                "file_cadence_millisecs must divide subdir_cadence_secs*1000"
            )

    @property
    def sample_rate(self) -> Fraction:
        return Fraction(self.sample_rate_numerator, self.sample_rate_denominator)

    def as_dict(self) -> dict:
        """Property dict with the key names the reference consumes
        (reference: drfProc.py:75-81, drfProc.py:197-201)."""
        return {
            "H5Tget_class": self.h5_class,
            "H5Tget_size": self.h5_size,
            "H5Tget_precision": self.h5_precision,
            "H5Tget_offset": 0,
            "subdir_cadence_secs": self.subdir_cadence_secs,
            "file_cadence_millisecs": self.file_cadence_millisecs,
            "sample_rate_numerator": self.sample_rate_numerator,
            "sample_rate_denominator": self.sample_rate_denominator,
            "samples_per_second": float(self.sample_rate),
            "is_complex": self.is_complex,
            "is_continuous": self.is_continuous,
            "num_subchannels": self.num_subchannels,
            "epoch": self.epoch,
            "digital_rf_version": self.version,
        }

    # ---- sample-index <-> file/subdir placement (integer exact) ----

    def file_start_ms(self, sample: int) -> int:
        ms = sample_to_millisecond(
            sample, self.sample_rate_numerator, self.sample_rate_denominator
        )
        return ms - ms % self.file_cadence_millisecs

    def file_first_sample(self, file_ms: int) -> int:
        return millisecond_to_sample_ceil(
            file_ms, self.sample_rate_numerator, self.sample_rate_denominator
        )

    def file_sample_span(self, file_ms: int) -> Tuple[int, int]:
        """[first, end) sample range belonging to the file starting at file_ms."""
        return (
            self.file_first_sample(file_ms),
            self.file_first_sample(file_ms + self.file_cadence_millisecs),
        )

    def file_path(self, top: Path, channel: str, file_ms: int) -> Path:
        subdir_s = (file_ms // 1000) - (file_ms // 1000) % self.subdir_cadence_secs
        subdir = datetime.datetime.fromtimestamp(
            subdir_s, datetime.timezone.utc
        ).strftime(SUBDIR_FMT)
        name = f"rf@{file_ms // 1000}.{file_ms % 1000:03d}.h5"
        return Path(top) / channel / subdir / name


def write_properties(path: Path, props: ChannelProperties) -> None:
    from pyspectrogram_tpu_torch.io import hdf5 as h5py

    path.parent.mkdir(parents=True, exist_ok=True)
    with h5py.File(path, "w") as f:
        for k, v in props.as_dict().items():
            if isinstance(v, bool):
                v = int(v)
            f.attrs[k] = v
        f.attrs["digital_rf_time_description"] = (
            "All times in absolute samples since the Unix epoch at the "
            "channel's rational sample rate (numerator/denominator Hz)."
        )


def read_properties(path: Path) -> ChannelProperties:
    from pyspectrogram_tpu_torch.io import hdf5 as h5py

    with h5py.File(path, "r") as f:
        a = f.attrs

        def geti(key):
            return int(np.asarray(a[key]).item())

        return ChannelProperties(
            sample_rate_numerator=geti("sample_rate_numerator"),
            sample_rate_denominator=geti("sample_rate_denominator"),
            subdir_cadence_secs=geti("subdir_cadence_secs"),
            file_cadence_millisecs=geti("file_cadence_millisecs"),
            num_subchannels=geti("num_subchannels"),
            is_complex=bool(geti("is_complex")),
            is_continuous=bool(geti("is_continuous")) if "is_continuous" in a else True,
            h5_class=geti("H5Tget_class"),
            h5_size=geti("H5Tget_size"),
            h5_precision=geti("H5Tget_precision"),
        )


def list_data_files(channel_dir: Path) -> List[Tuple[int, Path]]:
    """All (file_start_ms, path) under a channel dir, sorted by time."""
    out = []
    for sub in channel_dir.iterdir():
        if not sub.is_dir():
            continue
        out.extend(subdir_data_files(sub))
    out.sort(key=lambda t: t[0])
    return out


def list_subdirs(channel_dir: Path) -> List[Path]:
    """Cadence subdirectories of a channel, chronological (the
    %Y-%m-%dT%H-%M-%S naming sorts lexicographically == by time)."""
    return sorted((s for s in channel_dir.iterdir() if s.is_dir()),
                  key=lambda s: s.name)


def subdir_data_files(sub: Path) -> List[Tuple[int, Path]]:
    """(file_start_ms, path) inside ONE cadence subdirectory, sorted."""
    out = []
    for p in sub.iterdir():
        m = FILE_RE.match(p.name)
        if m:
            out.append((int(m.group(1)) * 1000 + int(m.group(2)), p))
    profiling.count("files", len(out))
    out.sort(key=lambda t: t[0])
    return out


def files_overlapping(
    props: ChannelProperties, channel_dir: Path, start: int, end: int
) -> List[Tuple[int, Path]]:
    """(file_ms, path) for existing files whose sample span intersects [start, end).

    Walks candidate file windows directly (O(range/file_cadence)) instead of
    listing the whole channel — the reference's per-column read loop over
    the upstream C library does the equivalent internally.
    """
    if end <= start:
        return []
    out = []
    ms = props.file_start_ms(start)
    last_ms = props.file_start_ms(end - 1)
    top = channel_dir.parent
    chan = channel_dir.name
    while ms <= last_ms:
        p = props.file_path(top, chan, ms)
        profiling.count("syscalls")  # the stat of exists()
        if p.exists():
            out.append((ms, p))
        ms += props.file_cadence_millisecs
    return out
