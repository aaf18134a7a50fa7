"""Synthetic Digital RF captures with analytically known spectra.

The reference kept its test data untracked (``.gitignore`` ignores a
``testing`` dir; reference: .gitignore:1) and had no fixtures at all
(SURVEY.md section 4). These generators create deterministic tone / chirp /
noise captures used by the test suite and the benchmark harness.

Copy of pyspectrogram_tpu/io/synthetic.py: the port imports nothing of that
package.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Sequence, Union

import numpy as np

from pyspectrogram_tpu_torch.io.writer import DigitalRFWriter


def tone_signal(n: int, sample_rate: float, freqs_hz: Sequence[float],
                amps: Optional[Sequence[float]] = None, start_sample: int = 0,
                noise_rms: float = 0.0, seed: int = 0) -> np.ndarray:
    """Sum of complex exponentials (n, len(freqs)) — one tone per subchannel."""
    t = (np.arange(n, dtype=np.float64) + start_sample) / sample_rate
    amps = np.ones(len(freqs_hz)) if amps is None else np.asarray(amps, float)
    out = np.stack(
        [a * np.exp(2j * np.pi * f * t) for f, a in zip(freqs_hz, amps)], axis=1
    )
    if noise_rms > 0.0:
        rng = np.random.default_rng(seed)
        out = out + noise_rms * (
            rng.standard_normal(out.shape) + 1j * rng.standard_normal(out.shape)
        ) / np.sqrt(2.0)
    return out


def chirp_signal(n: int, sample_rate: float, f0: float, f1: float,
                 start_sample: int = 0) -> np.ndarray:
    """Complex linear chirp sweeping f0 -> f1 over the block, (n, 1)."""
    t = (np.arange(n, dtype=np.float64) + start_sample) / sample_rate
    T = n / sample_rate
    phase = 2 * np.pi * (f0 * t + 0.5 * (f1 - f0) / T * t * t)
    return np.exp(1j * phase)[:, None]


def write_capture(
    top_dir: Union[str, Path],
    channel: str = "ch0",
    kind: str = "tone",
    n_samples: int = 1 << 16,
    sample_rate_numerator: int = 1_000_000,
    sample_rate_denominator: int = 1,
    start_global_index: Optional[int] = None,
    dtype=np.complex64,
    num_subchannels: int = 1,
    freqs_hz: Optional[Sequence[float]] = None,
    noise_rms: float = 0.0,
    gap: Optional[tuple] = None,
    seed: int = 0,
    subdir_cadence_secs: int = 3600,
    file_cadence_millisecs: int = 1000,
    scale: Optional[float] = None,
) -> dict:
    """Write one synthetic channel; returns metadata incl. exact signal params.

    ``gap=(offset, length)`` skips samples mid-capture to exercise the
    reader's zero-fill path. Default start index corresponds to
    2016-01-01T14:44:00Z like the reference's fallback epoch constants
    (reference: drfview.py:828-830), at the channel rate.
    """
    sr = sample_rate_numerator / sample_rate_denominator
    if start_global_index is None:
        start_global_index = int(1451661840 * sr)
    if freqs_hz is None:
        freqs_hz = [(i + 1) * sr / 16.0 for i in range(num_subchannels)]

    if scale is None:
        if np.dtype(dtype).names is not None or np.dtype(dtype).kind in "iu":
            scale = 2 ** 14  # leave headroom below int16 full scale
        else:
            scale = 1.0

    w = DigitalRFWriter(
        top_dir, channel, dtype,
        start_global_index=start_global_index,
        sample_rate_numerator=sample_rate_numerator,
        sample_rate_denominator=sample_rate_denominator,
        subdir_cadence_secs=subdir_cadence_secs,
        file_cadence_millisecs=file_cadence_millisecs,
        num_subchannels=num_subchannels,
    )

    def gen(n, start_off):
        if kind == "tone":
            x = tone_signal(n, sr, freqs_hz, start_sample=start_off,
                            noise_rms=noise_rms, seed=seed)
        elif kind == "chirp":
            x = np.tile(chirp_signal(n, sr, -sr / 4, sr / 4, start_off),
                        (1, num_subchannels))
        elif kind == "noise":
            rng = np.random.default_rng(seed + start_off)
            x = (rng.standard_normal((n, num_subchannels))
                 + 1j * rng.standard_normal((n, num_subchannels))) / np.sqrt(2)
        else:
            raise ValueError(f"unknown kind {kind!r}")
        x = x * scale
        d = np.dtype(dtype)
        if d.names is not None:
            out = np.zeros(x.shape, dtype=d)
            out["r"] = np.round(x.real)
            out["i"] = np.round(x.imag)
            return out
        return x.astype(d)

    if gap is None:
        w.rf_write(gen(n_samples, 0))
    else:
        g_off, g_len = gap
        w.rf_write(gen(g_off, 0))
        w.skip(g_len)
        w.rf_write(gen(n_samples - g_off - g_len, g_off + g_len))

    return {
        "channel": channel,
        "start_global_index": start_global_index,
        "n_samples": n_samples,
        "sample_rate": sr,
        "freqs_hz": list(freqs_hz),
        "scale": scale,
        "kind": kind,
    }
