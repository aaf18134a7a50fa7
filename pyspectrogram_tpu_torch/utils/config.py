"""Frozen configuration for spectrogram requests.

The reference has no config system: its configuration is a mutable per-tab
``stats`` dict with hardcoded defaults (reference: drfview.py:219-231) plus
widget ranges, mutated concurrently by the GUI thread and read by the worker
loop (an actual benign data race, reference: drfview.py:933-940 vs
drfProc.py:335-341). Here configuration is a single immutable dataclass;
settings changes produce a *new* snapshot, so the pipeline is linearized by
construction.

Copy of pyspectrogram_tpu/utils/config.py: the port imports nothing of that
package.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

# Defaults mirror the reference tab defaults (reference: drfview.py:219-231)
# except nint, whose reference default 0.1 conflicts with its own spinbox
# minimum of 1 (reference: drfview.py:228 vs drfview.py:489-491); we use 1.
DEFAULT_NFFT = 1024
DEFAULT_NINT = 1
DEFAULT_NTIME = 100
DEFAULT_CRANGE = (-110.0, -40.0)
DEFAULT_FRANGE_KHZ = (-1000.0, 1000.0)

# Hardcoded constants in the reference, surfaced as named defaults:
DEFAULT_STREAM_SECONDS = 30.0   # trailing streaming window (reference: drfProc.py:241)
DEFAULT_EPS = 1e-15             # dB floor epsilon (reference: drfProc.py:308)
DEFAULT_KAISER_BETA = 1.7       # window shape (reference: drfProc.py:386)
MAX_PLOT_FREQS = 2 ** 15        # plot decimation cap (reference: drfview.py:180)

# Widget-range limits (reference: drfview.py:475, 489, 501)
NFFT_RANGE = (32, 1_048_576)
NINT_RANGE = (1, 100_000)
NTIME_RANGE = (2, 100_000)


@dataclasses.dataclass(frozen=True)
class SpectrogramConfig:
    """One immutable snapshot of all knobs for a PSD/STI computation.

    Used identically by the array API, the CLI and the GUI.
    """

    nfft: int = DEFAULT_NFFT
    nint: int = DEFAULT_NINT
    ntime: int = DEFAULT_NTIME
    #: ("kaiser", beta) periodic window; also "hann", "blackman", "boxcar".
    window: Tuple = ("kaiser", DEFAULT_KAISER_BETA)
    #: channel entry, "chan" or "chan:sub" (reference: drfProc.py:91-92)
    channel: Optional[str] = None
    #: absolute time bounds in seconds since epoch; None means full
    #: dataset, and a None ELEMENT means the dataset bound on that side
    #: (resolve with resolve_time_span before arithmetic)
    time_span: Optional[Tuple[Optional[float], Optional[float]]] = None
    #: displayed frequency window in kHz (reference: drfview.py:518-529)
    freq_window_khz: Tuple[float, float] = DEFAULT_FRANGE_KHZ
    #: colormap dB range (reference: drfview.py:454-465)
    color_range_db: Tuple[float, float] = DEFAULT_CRANGE
    #: "parity" replicates the reference's silent nint-truncation
    #: (scipy.signal.periodogram discards all but the first nfft samples when
    #: nint>1, reference: drfProc.py:387-396); "welch" does true
    #: nint-segment power averaging (the behavior the reference's GUI label
    #: "Number of integrations" implies, reference: drfview.py:482-483).
    mode: str = "welch"
    #: DFT numerics tier: "exact" (default, ~1e-5 dB vs the f32 FFT),
    #: "balanced" (~7e-4 dB, ~1.3x faster), "display" (single-pass bf16,
    #: ~0.12 dB, ~2x faster — waterfall-grade)
    precision: str = "exact"
    eps: float = DEFAULT_EPS
    #: streaming mode uses a trailing window (reference: drfProc.py:239-241)
    streaming: bool = False
    stream_seconds: float = DEFAULT_STREAM_SECONDS
    #: streaming column hop in samples (overlap-save): consecutive STI
    #: columns start ``hop`` samples apart and overlap by nfft*nint - hop.
    #: None (default) = nfft*nint, i.e. contiguous non-overlapping columns.
    #: Applies to the streaming paths (StreamingSti / the live engine /
    #: CLI stream+watch); written-mode STI spaces its columns by the
    #: ntime linspace instead (reference parity, drfProc.py:159).
    hop: Optional[int] = None
    #: display-tile mode: the pipeline fuses the display epilogue (freq
    #: crop + decimation + 256-level quantization) into the device program
    #: and reads back ONLY the uint8 tile + median PSD — never the float
    #: spectra (the north-star display path; see display.tile). Results
    #: then carry ``tile``/``plot_freqs`` and ``sxx_dbfs=None``.
    display_tile: bool = False

    def __post_init__(self):
        if not (NFFT_RANGE[0] <= self.nfft <= NFFT_RANGE[1]):
            raise ValueError(f"nfft {self.nfft} outside {NFFT_RANGE}")
        if not (NINT_RANGE[0] <= self.nint <= NINT_RANGE[1]):
            raise ValueError(f"nint {self.nint} outside {NINT_RANGE}")
        if not (NTIME_RANGE[0] <= self.ntime <= NTIME_RANGE[1]):
            raise ValueError(f"ntime {self.ntime} outside {NTIME_RANGE}")
        if self.mode not in ("parity", "welch"):
            raise ValueError(f"mode must be 'parity' or 'welch', got {self.mode!r}")
        if self.precision not in ("exact", "balanced", "display"):
            raise ValueError(
                "precision must be 'exact', 'balanced' or 'display', got "
                f"{self.precision!r}")
        validate_range(self.color_range_db, "color_range_db")
        validate_range(self.freq_window_khz, "freq_window_khz")
        if self.hop is not None and not (
                0 < int(self.hop) <= self.nfft * self.nint):
            raise ValueError(
                f"hop {self.hop} must be in (0, nfft*nint="
                f"{self.nfft * self.nint}] (hop == nfft*nint is the "
                f"contiguous case; smaller hops overlap columns)")
        if self.time_span is not None:
            try:
                lo, hi = self.time_span
            except (TypeError, ValueError):
                raise ValueError(
                    f"time_span must be a (start, end) pair, got "
                    f"{self.time_span!r}") from None
            for side, v in (("start", lo), ("end", hi)):
                if v is None:
                    continue
                try:
                    fv = float(v)
                except (TypeError, ValueError):
                    fv = math.nan
                if not math.isfinite(fv):
                    raise ValueError(
                        f"time_span {side} must be a finite time in "
                        f"seconds (or None for the dataset bound), got "
                        f"{v!r}")
            if lo is not None and hi is not None and not hi > lo:
                raise ValueError(
                    f"time_span: end ({hi}) must be greater than start "
                    f"({lo})")

    def replace(self, **kw) -> "SpectrogramConfig":
        return dataclasses.replace(self, **kw)


def resolve_time_span(time_span, ds_bounds) -> Tuple[float, float]:
    """Fill a config time_span's None sides from the dataset time bounds
    (None elements mean "that side of the capture" — e.g. a CLI call with
    only --tstart). A wholly-None span is the full dataset."""
    if time_span is None:
        return ds_bounds
    lo, hi = time_span
    return (ds_bounds[0] if lo is None else lo,
            ds_bounds[1] if hi is None else hi)


def validate_range(rng, name: str) -> None:
    """max must exceed min — the reference reverts + warns on violation
    (reference: drfview.py:883-912)."""
    lo, hi = rng
    if not hi > lo:
        raise ValueError(f"{name}: max ({hi}) must be greater than min ({lo})")
