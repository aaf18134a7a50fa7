"""The run loads neither JAX nor the JAX package the port was made from.

Module names are compared by their top-level name (the part before the
first dot) as a whole: ``pyspectrogram_tpu_torch`` begins with
``pyspectrogram_tpu`` and is the program under test.
"""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "pyspectrogram_tpu")


class GuardError(RuntimeError):
    """A forbidden module is loaded."""


def forbidden(names: Iterable[str]) -> List[str]:
    """The names among ``names`` whose top-level name is forbidden."""
    return sorted({n for n in names if n.split(".", 1)[0] in FORBIDDEN})


def check(when: str) -> None:
    found = forbidden(list(sys.modules))
    if found:
        raise GuardError(f"{when}: forbidden modules loaded: "
                         + ", ".join(found[:20]))
