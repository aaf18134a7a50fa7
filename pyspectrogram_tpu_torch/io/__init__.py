"""Host I/O of the port: the Digital RF reader and writer, exact time
conversions, the prefetching ingest and the in-memory dataset.

The names below are those of pyspectrogram_tpu/io/__init__.py, from the
port's copies of its modules: the port imports nothing of that package.
"""

from pyspectrogram_tpu_torch.io.drf_format import ChannelProperties, get_ref
from pyspectrogram_tpu_torch.io.reader import DigitalRFReader, RFDataset
from pyspectrogram_tpu_torch.io.time_util import (
    sample_to_datetime,
    sample_to_time,
    time_to_sample,
)
from pyspectrogram_tpu_torch.io.writer import DigitalRFWriter

__all__ = [
    "ChannelProperties",
    "DigitalRFReader",
    "DigitalRFWriter",
    "RFDataset",
    "get_ref",
    "sample_to_datetime",
    "sample_to_time",
    "time_to_sample",
]
