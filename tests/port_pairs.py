"""The JAX package's request objects for a test that holds the port against
it: the same on-disk capture opened by the JAX package's own reader, the
same knobs in its own SpectrogramConfig and TileSpec. The port's side is
built from the port's own classes, which the JAX package never sees."""

import dataclasses

from pyspectrogram_tpu.display.tile import TileSpec as JTileSpec
from pyspectrogram_tpu.io.reader import RFDataset as JRFDataset
from pyspectrogram_tpu.utils.config import (
    SpectrogramConfig as JSpectrogramConfig,
)


def _fields(obj) -> dict:
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def jax_config(cfg) -> JSpectrogramConfig:
    """The JAX package's SpectrogramConfig with a port config's knobs."""
    return JSpectrogramConfig(**_fields(cfg))


def jax_spec(spec):
    """The JAX package's TileSpec with a port TileSpec's plan (None stays
    None)."""
    return None if spec is None else JTileSpec(**_fields(spec))


def jax_dataset(ds) -> JRFDataset:
    """The capture a port RFDataset reads, opened by the JAX reader."""
    return JRFDataset(ds.reader.top_dir)


def jax_requests(reqs):
    """[(port dataset, channel)] -> the same requests on the JAX reader."""
    return [(jax_dataset(ds), chan) for ds, chan in reqs]
