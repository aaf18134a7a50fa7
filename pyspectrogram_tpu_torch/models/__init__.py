"""Request pipelines of the port, with the JAX package's ``models``
names."""

from pyspectrogram_tpu_torch.models.batch import (
    BatchedStiPipeline,
    make_batched_sti_fn_pm,
)
from pyspectrogram_tpu_torch.models.sti import StiPipeline, StiResult

__all__ = [
    "BatchedStiPipeline",
    "StiPipeline",
    "StiResult",
    "make_batched_sti_fn_pm",
]
