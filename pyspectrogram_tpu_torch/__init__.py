"""pyspectrogram_tpu_torch — the PyTorch + CUDA port of pyspectrogram_tpu.

The written-mode STI request runs here on one torch device: the host read
and plane-major assembly, the PSD in kernel B1 and the time-median in
kernel B2 on an NVIDIA Hopper card (plain torch versions on the CPU), and
the dB or uint8 display epilogue. The JAX package beside it is the
reference the tests hold this one against; this package never imports
jax. The request state, :class:`SpectrogramConfig`, is the JAX package's
own (its utils.config is jax-free).
"""

from pyspectrogram_tpu.utils.config import SpectrogramConfig  # noqa: F401
from pyspectrogram_tpu_torch.models.sti import StiPipeline, StiResult  # noqa: F401
