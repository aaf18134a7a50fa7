"""Session checkpoint / resume — the port of
pyspectrogram_tpu/runtime/checkpoint.py, in the same ``.npz`` format.

Importing the JAX module loads jax (its package ``__init__`` imports the
live engine), so this is a copy, with the device half in torch:

* :func:`save_session` / :func:`load_session` persist the full request
  tuple — dataset path, SpectrogramConfig, channel, absolute sample
  bounds — so a stopped session re-opens exactly;
* :func:`save_stream_state` / :func:`load_stream_state` snapshot a
  streaming ring (carry samples + linear-power columns + column count),
  so an interrupted streaming session resumes mid-stream with no
  recompute.

The files are byte-compatible with the JAX package's (``FORMAT_VERSION``
2, ``ring_layout="rotated"``, ``total_cols`` an int32 array, extra arrays
under ``x_*``): a stream state written by either package loads in the
other. A test holds the copies to the originals.
"""

from __future__ import annotations

import dataclasses
import json
import zipfile
from pathlib import Path
from typing import Optional, Tuple, Union

import numpy as np
import torch

from pyspectrogram_tpu_torch.models.streaming import StreamState
from pyspectrogram_tpu_torch.utils.config import SpectrogramConfig

# v2: stream-state headers record ring_layout ("rotated": storage is
# rolled so the oldest column sits at total_cols % ring_len — the layout
# every StreamingSti uses). v1 stream states (written before the circular
# ring) stored the canonical oldest-at-tail layout and are re-rotated on
# load, so mid-stream resumes stay exact across the format change.
FORMAT_VERSION = 2


def _npz_path(path: Union[str, Path]) -> Path:
    """The exact on-disk path np.savez will write: np.savez APPENDS .npz to
    any other suffix (sess.ckpt -> sess.ckpt.npz), it does not replace it —
    so the final path must be computed up front and returned verbatim."""
    path = Path(path)
    return path if path.suffix == ".npz" else Path(str(path) + ".npz")


def _open_npz(path: Union[str, Path]):
    path = Path(path)
    if not path.exists() and _npz_path(path) != path:
        path = _npz_path(path)  # saved under an appended .npz suffix
    try:
        return np.load(path, allow_pickle=False)
    except zipfile.BadZipFile as e:
        # a truncated archive raises BadZipFile, which is neither a
        # ValueError nor an OSError — normalize it so every caller's
        # corrupt-state guard catches it
        raise ValueError(f"corrupt or truncated state file {path}: {e}") \
            from e


def _header_bytes(header: dict) -> np.ndarray:
    return np.frombuffer(json.dumps(header).encode(), dtype=np.uint8)


def _read_header(z) -> dict:
    return json.loads(bytes(z["header"].tobytes()).decode())


def save_session(
    path: Union[str, Path],
    dataset_dir: Union[str, Path],
    config: SpectrogramConfig,
    sample_bounds: Optional[Tuple[int, int]] = None,
    extra: Optional[dict] = None,
) -> Path:
    path = _npz_path(path)
    header = {
        "format_version": FORMAT_VERSION,
        "dataset_dir": str(dataset_dir),
        "config": _config_to_dict(config),
        "sample_bounds": list(sample_bounds) if sample_bounds else None,
        "extra": extra or {},
    }
    np.savez(path, header=_header_bytes(header))
    return path


def load_session(path: Union[str, Path]) -> dict:
    with _open_npz(path) as z:
        header = _read_header(z)
    if header["format_version"] > FORMAT_VERSION:
        raise ValueError(
            f"session written by a newer format ({header['format_version']})"
        )
    header["config"] = _config_from_dict(header["config"])
    if header["sample_bounds"] is not None:
        header["sample_bounds"] = tuple(int(v) for v in header["sample_bounds"])
    return header


def save_stream_state(path: Union[str, Path], state: StreamState, meta: dict,
                      extra_arrays: Optional[dict] = None) -> Path:
    """Persist a models.streaming.StreamState + its StreamingSti params.

    The ring is stored in the rotated storage layout every StreamingSti
    uses (oldest column at ``total_cols % ring_len``); the header records
    that so older/newer readers can convert instead of misinterpreting.
    ``extra_arrays`` (name -> array) rides along as ``x_<name>``; readers
    that don't know a name ignore it."""
    path = _npz_path(path)
    header = {"format_version": FORMAT_VERSION, "meta": meta,
              "ring_layout": "rotated"}
    np.savez(
        path,
        header=_header_bytes(header),
        carry=state.carry.cpu().numpy(),
        ring=state.ring.cpu().numpy(),
        total_cols=np.asarray(state.total_cols, np.int32),
        **{f"x_{k}": np.asarray(v)
           for k, v in (extra_arrays or {}).items()},
    )
    return path


def peek_stream_meta(path: Union[str, Path]) -> dict:
    """Header-only read of a stream-state file: the JSON meta without
    touching the (large) array payloads."""
    with _open_npz(path) as z:
        header = _read_header(z)
    return header.get("meta", {})


def load_stream_state(path: Union[str, Path],
                      device: Union[str, torch.device]):
    """Returns (StreamState on ``device``, meta dict). Arrays saved via
    ``extra_arrays`` come back under ``meta["arrays"]`` (host numpy)."""
    device = torch.device(device)
    with _open_npz(path) as z:
        header = _read_header(z)
        version = header.get("format_version", 1)
        if version > FORMAT_VERSION:
            raise ValueError(
                f"stream state written by a newer format ({version})")
        ring = np.asarray(z["ring"])
        total_cols = int(np.asarray(z["total_cols"]))
        layout = header.get("ring_layout")
        if layout is None:
            # v1 headers predate the layout flag, and v1 writers stored
            # either layout; they only coincide when the rotation is the
            # identity, so accept exactly that case and refuse the rest
            if ring.shape[0] and total_cols % ring.shape[0]:
                raise ValueError(
                    "v1 stream state with a mid-wrap ring: the stored "
                    "column layout is ambiguous (canonical vs rotated "
                    "writers both produced v1). Re-save the stream from "
                    "a live session with the current format."
                )
            layout = "rotated"  # identity rotation: both readings agree
        if layout == "canonical" and ring.shape[0]:
            # canonical stores oldest-at-tail; rotate into the storage
            # layout the circular ring expects
            ring = np.roll(ring, total_cols % ring.shape[0], axis=0)
        elif layout not in ("canonical", "rotated"):
            raise ValueError(f"unknown ring_layout {layout!r}")
        state = StreamState(
            carry=torch.from_numpy(np.asarray(z["carry"])).to(device),
            ring=torch.from_numpy(np.ascontiguousarray(ring)).to(device),
            total_cols=total_cols,
        )
        meta = dict(header["meta"])
        extras = {k[2:]: np.asarray(z[k]) for k in z.files
                  if k.startswith("x_")}
        if extras:
            meta["arrays"] = extras
    return state, meta


def _config_to_dict(cfg: SpectrogramConfig) -> dict:
    d = dataclasses.asdict(cfg)
    d["window"] = list(cfg.window) if isinstance(cfg.window, tuple) else cfg.window
    return d


def _config_from_dict(d: dict) -> SpectrogramConfig:
    d = dict(d)
    if isinstance(d.get("window"), list):
        d["window"] = tuple(d["window"])
    for k in ("time_span", "freq_window_khz", "color_range_db"):
        if isinstance(d.get(k), list):
            d[k] = tuple(d[k])
    return SpectrogramConfig(**d)
