"""Plain reference of a spectrogram (STI) view, written from the published
description of the PySpectrogram viewer and of Digital RF, in numpy and
plain torch. It imports nothing of the program under test and takes
nothing the program made: it works from the samples the benchmark
generated.

A view of ``ntime`` columns over a span [st, en) of a channel:

* frame starts: ``numpy.linspace(st, en - nfft*nint, ntime, dtype=int)``
  (the viewer's rule, truncation included); times are the starts in
  microseconds since the epoch, rounded half to even;
* each column: ``nint`` consecutive segments of ``nfft`` samples, each
  multiplied by the periodic Kaiser(beta) window, transformed, |X|^2
  scaled by 1 / (sum w)^2 / ref^2 (a periodogram's "spectrum" scaling),
  averaged over the segments (Welch), then fftshifted;
* the median over the columns, per bin and subchannel (the mean of the
  two middle values for an even count), taken in linear power;
* dBFS = 10 log10(p + eps);
* the display tile: the bins inside the frequency window, decimated to at
  most 32768, levels round((dB - cmin) * 255 / (cmax - cmin)) clamped to
  0..255.

Everything runs in float64 (complex128 transforms). ``precision="bf16"``
is the control: every stored intermediate (windowed samples, power,
Welch average) rounded to bfloat16, as a pipeline that stored them in
bfloat16 would, with the transform itself in float32 (no bfloat16 FFT
exists in torch).
"""

from __future__ import annotations

import math
from fractions import Fraction

import numpy as np
import torch

#: most plot bins a tile keeps (the viewer's plot decimation cap)
MAX_PLOT_FREQS = 1 << 15
#: levels of a display tile
TILE_LEVELS = 256


def kaiser_periodic(nfft: int, beta: float) -> np.ndarray:
    """Periodic Kaiser window: the symmetric window of nfft + 1 points
    with its last point dropped (float64)."""
    return np.kaiser(nfft + 1, beta)[:-1]


def frame_starts(st: int, en: int, nfft: int, nint: int,
                 ntime: int) -> np.ndarray:
    """``ntime`` frame starts spread over [st, en - nfft*nint]."""
    top = max(int(st), int(en) - nfft * nint)
    return np.linspace(int(st), top, int(ntime), dtype=int)


def time_to_sample(t_sec: float, sr: int) -> int:
    """Seconds since the epoch -> sample index (floor, exact)."""
    s = Fraction(t_sec) * sr
    return s.numerator // s.denominator


def start_times_us(starts, sr: int) -> np.ndarray:
    """Sample indices -> microseconds since the epoch, half to even."""
    out = []
    for s in np.asarray(starts, np.int64).tolist():
        out.append(round(Fraction(int(s) * 1_000_000, sr)))
    return np.asarray(out, np.int64)


def shifted_freqs(nfft: int, sr: float) -> np.ndarray:
    return np.fft.fftshift(np.fft.fftfreq(nfft, 1.0 / float(sr)))


def tile_bins(freqs: np.ndarray, frange_khz) -> np.ndarray:
    """Indices of the plot bins: those inside the window, every fscale-th
    from floor(fscale / 2), fscale = ceil(kept / 32768)."""
    inds = np.flatnonzero((freqs >= 1e3 * frange_khz[0])
                          & (freqs <= 1e3 * frange_khz[1]))
    if len(inds) == 0:
        return inds
    fscale = math.ceil(len(inds) / MAX_PLOT_FREQS)
    return inds[fscale // 2::fscale]


def _round_bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(t.dtype)


def psd_columns(samples: np.ndarray, starts, *, nfft: int, nint: int,
                beta: float, ref: float = 1.0, device="cpu",
                precision: str = "float64", chunk: int = 512) -> torch.Tensor:
    """(n, nsub) complex samples + column starts (indices into them) ->
    fftshifted linear power (ncols, nsub, nfft) on ``device``, float64
    (float32 for the bf16 control), in chunks of ``chunk`` columns."""
    if precision not in ("float64", "bf16"):
        raise ValueError(f"unknown precision {precision!r}")
    frame_len = nfft * nint
    w = kaiser_periodic(nfft, beta)
    scale = 1.0 / (w.sum() ** 2 * float(ref) ** 2)
    starts = np.asarray(starts, np.int64)
    if len(starts) and (starts.min() < 0
                        or starts.max() + frame_len > len(samples)):
        raise ValueError("a frame reaches outside the samples")
    ctype = torch.complex128 if precision == "float64" else torch.complex64
    rtype = torch.float64 if precision == "float64" else torch.float32
    win = torch.as_tensor(w, dtype=rtype, device=device)
    offs = np.arange(frame_len)
    out = []
    for c0 in range(0, len(starts), chunk):
        idx = starts[c0:c0 + chunk, None] + offs            # (c, L)
        fr = torch.as_tensor(samples[idx]).to(device)      # (c, L, nsub)
        fr = fr.to(ctype).permute(0, 2, 1).reshape(
            len(idx), samples.shape[1], nint, nfft)
        if precision == "bf16":
            re = _round_bf16(_round_bf16(fr.real) * _round_bf16(win))
            im = _round_bf16(_round_bf16(fr.imag) * _round_bf16(win))
            x = torch.fft.fft(torch.complex(re, im))
            p = _round_bf16((x.real.square() + x.imag.square()) * scale)
            p = _round_bf16(p.mean(dim=2))
        else:
            x = torch.fft.fft(fr * win)
            p = ((x.real.square() + x.imag.square()) * scale).mean(dim=2)
        out.append(torch.fft.fftshift(p, dim=-1))
    return torch.cat(out)


def median_time(p: torch.Tensor) -> torch.Tensor:
    """Median over axis 0: the middle value, or the mean of the two
    middle values for an even count."""
    n = p.shape[0]
    s, _ = torch.sort(p, dim=0)
    if n % 2:
        return s[n // 2]
    return 0.5 * (s[n // 2 - 1] + s[n // 2])


def median_time_chunked(p: torch.Tensor, chunk: int = 512) -> torch.Tensor:
    """:func:`median_time` over the last axis in chunks (bounded
    scratch for a long window)."""
    flat = p.reshape(p.shape[0], -1)
    out = [median_time(flat[:, i:i + chunk])
           for i in range(0, flat.shape[1], chunk)]
    return torch.cat(out).reshape(p.shape[1:])


def dbfs(p: torch.Tensor, eps: float) -> torch.Tensor:
    return 10.0 * torch.log10(p + eps)


def tile_levels(db: torch.Tensor, bins: np.ndarray, crange_db) -> torch.Tensor:
    """dB (..., nfft) -> uint8 levels (..., len(bins))."""
    cmin, cmax = float(crange_db[0]), float(crange_db[1])
    sel = db[..., torch.as_tensor(bins, device=db.device)]
    q = torch.round((sel - cmin) * ((TILE_LEVELS - 1) / (cmax - cmin)))
    return q.clamp(0, TILE_LEVELS - 1).to(torch.uint8)
