"""Device compute ops of the port (torch), with the JAX package's
``ops`` names."""

from pyspectrogram_tpu_torch.ops.stft import (
    gather_frames,
    make_sti_fn,
    make_sti_fn_pm,
    median_over_time,
    pack_complex_host,
    psd_frames,
    shifted_freqs,
    to_dbfs,
    to_reference_layout,
)
from pyspectrogram_tpu_torch.ops.windows import get_window

__all__ = [
    "gather_frames",
    "get_window",
    "make_sti_fn",
    "make_sti_fn_pm",
    "median_over_time",
    "pack_complex_host",
    "psd_frames",
    "shifted_freqs",
    "to_dbfs",
    "to_reference_layout",
]
