"""The multi-rank tier of the port on torch.distributed, with the JAX
package's ``parallel`` names."""

from pyspectrogram_tpu_torch.parallel.mesh import (
    CHAN_AXIS,
    TIME_AXIS,
    make_mesh,
    pad_starts,
)
from pyspectrogram_tpu_torch.parallel.sharded import make_sharded_sti_fn

__all__ = [
    "CHAN_AXIS",
    "TIME_AXIS",
    "make_mesh",
    "make_sharded_sti_fn",
    "pad_starts",
]
