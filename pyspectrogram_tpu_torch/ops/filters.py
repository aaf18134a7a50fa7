"""Spectral filtering and signal regeneration on one torch device — the
port of pyspectrogram_tpu/ops/filters.py.

The reference's README lists these as wished-for features (reference:
README.md:16-20): high/low-pass filtering of the data and regenerating a
time signal ("audio") from a spectrogram subset.

* complex STFT (analysis)  — strided frames (``unfold``, a view), window,
                             ``torch.fft.fft``;
* spectral masks           — low/high/band-pass or band-stop over the FFT
                             bin axis (a numpy copy of the JAX function);
* inverse STFT (synthesis) — ``torch.fft.ifft``, window, overlap-add, COLA
                             normalization;
* filter_signal            — STFT -> mask -> ISTFT round trip.

No TPU kernel serves these (the JAX module runs ``jnp.fft``), so
``torch.fft`` is their port. The API boundary is plane-packed float32
``(..., 2)``, as in the JAX module; inside, the tensors are complex views.

The overlap-add is deterministic: when ``hop`` divides ``nfft`` it adds the
``nfft // hop`` phase groups as strided slices, oldest frame first (the
JAX ``fori_loop``'s order), otherwise ``torch.nn.functional.fold``. An
``index_add_`` on CUDA would add with atomics, so its sums would change
from run to run where three or more frames overlap; a Python loop over
frames would launch once per frame.
"""

from __future__ import annotations

import functools
from typing import Optional, Union

import numpy as np
import torch

from pyspectrogram_tpu_torch.models.sti import check_device
from pyspectrogram_tpu_torch.ops.windows import WindowSpec, get_window

Device = Union[str, torch.device]


def _packed(a, device: torch.device) -> torch.Tensor:
    """A packed float32 host array or tensor as a contiguous float32
    tensor on ``device`` (a read-only host array is copied first)."""
    if isinstance(a, np.ndarray):
        a = torch.from_numpy(np.require(a, np.float32, ["C", "W"]))
    return torch.as_tensor(a, dtype=torch.float32, device=device).contiguous()


def band_mask(
    nfft: int,
    sample_rate: float,
    kind: str,
    cutoff_hz,
    shifted: bool = False,
) -> np.ndarray:
    """(nfft,) float32 {0,1} mask over the UNshifted FFT bin order
    (set ``shifted`` for an fftshifted-axis mask) — a numpy copy of the
    JAX module's, which a test pins to it.

    kind: "lowpass" | "highpass" (scalar cutoff, on |f|) or
          "bandpass" | "bandstop" ((f_lo, f_hi) band, signed frequencies).
    """
    f = np.fft.fftfreq(nfft, 1.0 / float(sample_rate))
    if kind == "lowpass":
        m = np.abs(f) <= float(cutoff_hz)
    elif kind == "highpass":
        m = np.abs(f) >= float(cutoff_hz)
    elif kind == "bandpass":
        lo, hi = cutoff_hz
        m = (f >= lo) & (f <= hi)
    elif kind == "bandstop":
        lo, hi = cutoff_hz
        m = ~((f >= lo) & (f <= hi))
    else:
        raise ValueError(f"unknown filter kind {kind!r}")
    m = m.astype(np.float32)
    return np.fft.fftshift(m) if shifted else m


@functools.lru_cache(maxsize=64)
def make_stft_fn(*, nfft: int, hop: int, window: WindowSpec = "hann",
                 device: Device):
    """Complex STFT on ``device``: packed (n, 2) float32 -> (nframes, nfft,
    2) packed spectra (unshifted bin order), nframes = (n - nfft)//hop + 1.
    A CUDA device on a machine without one raises here."""
    device = check_device(device)
    win = torch.from_numpy(get_window(window, nfft).astype(np.float32)).to(
        device)

    def stft(x_packed) -> torch.Tensor:
        x = _packed(x_packed, device)
        n = x.shape[0]
        if (n - nfft) // hop + 1 < 1:
            raise ValueError(
                f"signal too short for STFT: n={n} < nfft={nfft}")
        frames = torch.view_as_complex(x).unfold(0, nfft, hop)
        return torch.view_as_real(torch.fft.fft(frames * win, dim=-1))

    return stft


def _overlap_add(seg: torch.Tensor, hop: int) -> torch.Tensor:
    """(nframes, nfft, 2) frames -> (n_out, 2) overlap-add sum with frame k
    at k*hop, n_out = (nframes-1)*hop + nfft; deterministic."""
    nframes, nfft, _ = seg.shape
    n_out = (nframes - 1) * hop + nfft
    if nfft % hop == 0:
        r = nfft // hop
        # chunk j of frame k lands in output block k + j; adding the chunks
        # from j = r-1 down adds each block's frames oldest first
        chunks = seg.reshape(nframes, r, hop, 2)
        y = torch.zeros((nframes - 1 + r, hop, 2), dtype=seg.dtype,
                        device=seg.device)
        for j in range(r - 1, -1, -1):
            y[j:j + nframes] += chunks[:, j]
        return y.reshape(n_out, 2)
    cols = seg.permute(2, 1, 0).reshape(1, 2 * nfft, nframes)
    y = torch.nn.functional.fold(cols, output_size=(1, n_out),
                                 kernel_size=(1, nfft), stride=(1, hop))
    return y.reshape(2, n_out).T


@functools.lru_cache(maxsize=64)
def make_istft_fn(*, nfft: int, hop: int, window: WindowSpec = "hann",
                  nframes: int, device: Device):
    """Inverse STFT on ``device`` (windowed overlap-add, least-squares COLA
    normalization): (nframes, nfft, 2) packed spectra -> (n, 2) packed
    signal with n = (nframes-1)*hop + nfft."""
    if nframes < 1:
        raise ValueError(f"inverse STFT needs at least one frame, "
                         f"got nframes={nframes}")
    device = check_device(device)
    win64 = get_window(window, nfft)
    n_out = (nframes - 1) * hop + nfft
    # COLA normalization: sum of squared synthesis windows at each sample,
    # in float64 on the host as the JAX module builds it
    norm = np.zeros(n_out)
    for k in range(nframes):
        norm[k * hop: k * hop + nfft] += win64 ** 2
    inv_norm = torch.from_numpy(
        (1.0 / np.maximum(norm, 1e-30)).astype(np.float32)).to(device)
    win = torch.from_numpy(win64.astype(np.float32)).to(device)

    def istft(spectra_packed) -> torch.Tensor:
        X = torch.view_as_complex(_packed(spectra_packed, device))
        seg = torch.view_as_real(torch.fft.ifft(X, dim=-1) * win)
        return _overlap_add(seg, hop) * inv_norm[:, None]

    return istft


def filter_signal(
    x: np.ndarray,
    sample_rate: float,
    kind: str,
    cutoff_hz,
    nfft: int = 1024,
    hop: Optional[int] = None,
    window: WindowSpec = "hann",
    *,
    device: Device,
) -> np.ndarray:
    """High/low/band-pass filter a complex signal in the STFT domain on
    ``device`` and regenerate the time signal (README wishlist items,
    README.md:16-20).

    x: (n,) complex host array; returns (n',) complex host array with
    n' = nframes*hop + (nfft-hop) <= n (tail samples beyond the last full
    frame are dropped).
    """
    hop = nfft // 2 if hop is None else hop
    packed = np.ascontiguousarray(x.astype(np.complex64)).view(np.float32)
    packed = packed.reshape(-1, 2)
    stft = make_stft_fn(nfft=nfft, hop=hop, window=window, device=device)
    spectra = stft(torch.from_numpy(packed))
    mask = torch.from_numpy(band_mask(nfft, sample_rate, kind, cutoff_hz))
    spectra = spectra * mask.to(spectra.device)[None, :, None]
    istft = make_istft_fn(nfft=nfft, hop=hop, window=window,
                          nframes=spectra.shape[0], device=device)
    y = istft(spectra).cpu().numpy()
    return y[:, 0] + 1j * y[:, 1]


def save_wav(path: str, x: np.ndarray, sample_rate: int,
             mode: str = "real") -> str:
    """Write a regenerated signal as a 16-bit WAV file — the reference's
    audio-regeneration wishlist end product (README.md:17). A copy of the
    JAX module's host function (that module imports jax).

    mode: "real" takes the real part (baseband audio), "mag" the
    magnitude envelope. The signal is peak-normalized to 0.9 FS.
    """
    from scipy.io import wavfile

    if not path.lower().endswith(".wav"):
        path += ".wav"
    y = np.real(x) if mode == "real" else np.abs(x)
    peak = np.max(np.abs(y)) or 1.0
    pcm = np.round(y / peak * 0.9 * 32767).astype(np.int16)
    wavfile.write(path, int(sample_rate), pcm)
    return path


def regenerate_signal(
    spectra_packed,
    nfft: int,
    hop: Optional[int] = None,
    window: WindowSpec = "hann",
    freq_mask: Optional[np.ndarray] = None,
    *,
    device: Device,
) -> np.ndarray:
    """Regenerate a time signal from (a masked subset of) complex STFT
    spectra — the reference wishlist's 'regenerate audio from a spectrogram
    subset' (README.md:17). ``spectra_packed`` is a host array or a tensor
    (a tensor on another device is copied to ``device``)."""
    hop = nfft // 2 if hop is None else hop
    spectra = _packed(spectra_packed, check_device(device))
    if freq_mask is not None:
        m = torch.as_tensor(np.asarray(freq_mask, np.float32),
                            device=spectra.device)
        spectra = spectra * m[None, :, None]
    istft = make_istft_fn(nfft=nfft, hop=hop, window=window,
                          nframes=spectra.shape[0], device=device)
    y = istft(spectra).cpu().numpy()
    return y[:, 0] + 1j * y[:, 1]
