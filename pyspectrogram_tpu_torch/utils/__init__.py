"""Configuration, errors, logging and instrumentation of the port.

The names below are those of pyspectrogram_tpu/utils/__init__.py, from the
port's copies of its modules: the port imports nothing of that package.
"""

from pyspectrogram_tpu_torch.utils.config import SpectrogramConfig
from pyspectrogram_tpu_torch.utils.errors import (
    ChannelNotFoundError,
    DataGapError,
    FormatError,
    PySpectrogramTPUError,
    TerminateReason,
)

__all__ = [
    "ChannelNotFoundError",
    "DataGapError",
    "FormatError",
    "PySpectrogramTPUError",
    "SpectrogramConfig",
    "TerminateReason",
]
