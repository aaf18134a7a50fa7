"""pyspectrogram_tpu_torch — the PyTorch + CUDA port of pyspectrogram_tpu.

Three paths run here on one torch device. The written-mode STI request: the
host read and plane-major assembly, the PSD in kernel B1 (B4 at nfft >=
65536) and the time-median in kernel B2 on an NVIDIA Hopper card (plain
torch versions on the CPU), and the dB or uint8 display epilogue. The
streaming path: :class:`StreamingSti` pushes blocks into a rotating ring
(kernel B3 for overlapping hops) and runtime.LiveStreamEngine serves a
growing capture's trailing window from it, with checkpoints that
cross-load with the JAX package's. The multi-tab runtime:
:class:`BatchedStiPipeline` runs several same-shape requests in one launch
(kernel B2 takes the batch of medians), and runtime.SpectrogramProcessor
and runtime.SharedRefreshScheduler drive written and streaming tabs. The
JAX package beside it is the reference the tests hold this one against;
this package imports neither jax nor anything of that package: the
request state (:class:`SpectrogramConfig`), the Digital RF reader and
writer, the native ingest, the colormaps and the headless widget kit are
the port's own copies (utils, io, native, display, clients).
"""

__version__ = "0.1.0"

from pyspectrogram_tpu_torch.utils.config import SpectrogramConfig  # noqa: F401,E402
from pyspectrogram_tpu_torch.utils.errors import TerminateReason  # noqa: F401,E402
from pyspectrogram_tpu_torch.models.batch import BatchedStiPipeline  # noqa: F401
from pyspectrogram_tpu_torch.models.sti import StiPipeline, StiResult  # noqa: F401
from pyspectrogram_tpu_torch.models.streaming import StreamingSti  # noqa: F401
