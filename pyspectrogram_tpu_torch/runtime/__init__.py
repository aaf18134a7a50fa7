"""Runtime of the port: the written and streaming processor loop, the
shared refresh scheduler, the live streaming engine, their callback
payloads, and stream checkpoints."""

from pyspectrogram_tpu_torch.runtime.live import LiveStreamEngine
from pyspectrogram_tpu_torch.runtime.processor import SpectrogramProcessor
from pyspectrogram_tpu_torch.runtime.scheduler import SharedRefreshScheduler
from pyspectrogram_tpu_torch.runtime.signals import (
    Iterated,
    ProcessorCallbacks,
    StatsUpdated,
    Terminated,
)

__all__ = [
    "Iterated",
    "LiveStreamEngine",
    "ProcessorCallbacks",
    "SharedRefreshScheduler",
    "SpectrogramProcessor",
    "StatsUpdated",
    "Terminated",
]
