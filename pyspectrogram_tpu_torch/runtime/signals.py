"""Typed callback payloads of the port's processors — a copy of
pyspectrogram_tpu/runtime/signals.py, whose package ``__init__`` loads jax
(runtime/__init__.py:1 imports runtime.live). The fields, their order and
their defaults are the original's; a test pins them.

These mirror the reference's Qt signal signatures
(``ThreadProcessorSignals``, reference: drfProc.py:458-465) so a GUI client
can map them 1:1 onto slots, but they are plain frozen dataclasses carried
over a callback interface — no Qt in the core.
"""

from __future__ import annotations

import dataclasses
from fractions import Fraction
from typing import Callable, Optional, Tuple

import numpy as np

from pyspectrogram_tpu_torch.utils.errors import TerminateReason


@dataclasses.dataclass(frozen=True)
class Iterated:
    """One loop iteration's results (reference: drfProc.py:459-461,
    emitted drfProc.py:312-314)."""

    i: int
    tab_id: int
    times: np.ndarray          # (ntime,) datetimes
    freqs: np.ndarray          # (nfft,) Hz fftshifted
    #: (nfft, ntime, nsub) — None in display-tile mode (floats stay on
    #: device; clients render from ``tile``)
    sxx_dbfs: Optional[np.ndarray]
    sxx_med_dbfs: np.ndarray   # (nfft, nsub)
    #: display-tile mode: uint8 levels (ntime, nsub, nplot) + plot axis
    tile: Optional[np.ndarray] = None
    plot_freqs: Optional[np.ndarray] = None
    #: (ntime,) column validity — False where the column was computed
    #: over zero-filled gap samples (the reference crashed on gaps)
    mask: Optional[np.ndarray] = None


@dataclasses.dataclass(frozen=True)
class StatsUpdated:
    """Processor's effective settings echo (reference: drfProc.py:462,
    emitted drfProc.py:343-345)."""

    tab_id: int
    sample_rate: Fraction
    nfft: int
    nint: int
    ntime: int
    time_bounds: Tuple[float, float]


@dataclasses.dataclass(frozen=True)
class Terminated:
    """Loop end notification (reference: drfProc.py:463-465,
    emitted drfProc.py:359-361).

    ``detail`` carries the specific error when the generic
    reason.describe() text would mislead (e.g. an init failure on an
    existing directory); clients should show ``detail or
    reason.describe()``."""

    tab_id: int
    reason: TerminateReason
    detail: Optional[str] = None


@dataclasses.dataclass
class ProcessorCallbacks:
    """Wire-up point for clients; any subset may be provided."""

    on_iterated: Optional[Callable[[Iterated], None]] = None
    on_stats: Optional[Callable[[StatsUpdated], None]] = None
    on_terminated: Optional[Callable[[Terminated], None]] = None

    def emit_iterated(self, payload: Iterated) -> None:
        if self.on_iterated:
            self.on_iterated(payload)

    def emit_stats(self, payload: StatsUpdated) -> None:
        if self.on_stats:
            self.on_stats(payload)

    def emit_terminated(self, payload: Terminated) -> None:
        if self.on_terminated:
            self.on_terminated(payload)
