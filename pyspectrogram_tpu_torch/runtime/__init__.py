"""Runtime of the port: the live streaming engine and stream checkpoints."""

from pyspectrogram_tpu_torch.runtime.live import LiveStreamEngine  # noqa: F401
