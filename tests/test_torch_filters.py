"""The PyTorch port's spectral filters (CPU) against the JAX package's
ops.filters, and its own reconstruction and tone tests mirroring
tests/test_filters.py.

Tolerances: masks equal; STFT spectra within 1e-5 of each frame's peak
magnitude (two float32 FFTs, torch's and XLA's); the ISTFT and the filtered
signal within 1e-5 on the fully covered interior (boundary samples have
single-window coverage, where the 1/w^2 normalization amplifies rounding).
"""

import numpy as np
import pytest
import torch

from pyspectrogram_tpu.ops import filters as jfilters
from pyspectrogram_tpu_torch.ops import filters

SR = 1e6


def _two_tone(n, sr, f1, f2):
    t = np.arange(n) / sr
    return np.exp(2j * np.pi * f1 * t) + np.exp(2j * np.pi * f2 * t)


def _noise(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n)
            + 1j * rng.standard_normal(n)).astype(np.complex64)


def _packed(x):
    return np.ascontiguousarray(x.astype(np.complex64)).view(
        np.float32).reshape(-1, 2)


@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("kind,cutoff", [
    ("lowpass", 100e3), ("highpass", 120e3), ("bandpass", (-50e3, 80e3)),
    ("bandstop", (0.0, 250e3))])
def test_band_mask_equals_jax(kind, cutoff, shifted):
    for nfft in (256, 1000):
        got = filters.band_mask(nfft, SR, kind, cutoff, shifted=shifted)
        want = jfilters.band_mask(nfft, SR, kind, cutoff, shifted=shifted)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="unknown filter kind"):
        filters.band_mask(256, SR, "nope", 1.0)


@pytest.mark.parametrize("window", ["hann", ("kaiser", 1.7)])
@pytest.mark.parametrize("nfft,hop", [(256, 128), (256, 64), (512, 200)])
def test_stft_matches_jax(nfft, hop, window):
    x = _packed(_noise(5000, nfft + hop))
    got = filters.make_stft_fn(nfft=nfft, hop=hop, window=window,
                               device="cpu")(x).numpy()
    want = np.asarray(jfilters.make_stft_fn(nfft=nfft, hop=hop,
                                            window=window)(x))
    assert got.shape == want.shape == ((5000 - nfft) // hop + 1, nfft, 2)
    peak = np.abs(want[..., 0] + 1j * want[..., 1]).max(axis=1)
    err = np.abs(got - want).max(axis=(1, 2))
    assert (err <= 1e-5 * peak).all()


@pytest.mark.parametrize("nfft,hop", [(256, 128), (256, 64), (256, 100),
                                      (512, 200)])
def test_istft_matches_jax(nfft, hop):
    """The same spectra through both inverses: hop | nfft adds strided
    phase groups, hop 100 and 200 go through ``fold``."""
    x = _packed(_noise(6000, hop))
    spectra = np.asarray(jfilters.make_stft_fn(nfft=nfft, hop=hop)(x))
    nframes = spectra.shape[0]
    got = filters.make_istft_fn(nfft=nfft, hop=hop, nframes=nframes,
                                device="cpu")(spectra).numpy()
    want = np.asarray(jfilters.make_istft_fn(nfft=nfft, hop=hop,
                                             nframes=nframes)(spectra))
    assert got.shape == want.shape == ((nframes - 1) * hop + nfft, 2)
    sl = slice(nfft, len(got) - nfft)
    np.testing.assert_allclose(got[sl], want[sl], atol=1e-5, rtol=0)
    y = filters.regenerate_signal(spectra, nfft, hop, device="cpu")
    np.testing.assert_array_equal(y, got[:, 0] + 1j * got[:, 1])


def test_overlap_add_paths_agree():
    """Strided phase groups and ``fold`` give the same overlap-add, and
    the phase groups add each sample's frames oldest first (the JAX
    fori_loop's order): bit-equal to a frame-by-frame float32 loop."""
    rng = np.random.default_rng(3)
    seg = torch.from_numpy(rng.standard_normal((9, 64, 2)).astype(np.float32))
    for hop in (16, 32, 64):
        loop = torch.zeros(((9 - 1) * hop + 64, 2))
        for k in range(9):
            loop[k * hop:k * hop + 64] += seg[k]
        strided = filters._overlap_add(seg, hop)
        assert torch.equal(strided, loop)
        cols = seg.permute(2, 1, 0).reshape(1, 128, 9)
        folded = torch.nn.functional.fold(
            cols, output_size=(1, loop.shape[0]), kernel_size=(1, 64),
            stride=(1, hop)).reshape(2, -1).T
        torch.testing.assert_close(folded, loop, atol=1e-6, rtol=0)


@pytest.mark.parametrize("kind,cutoff", [("lowpass", 120e3),
                                         ("highpass", 120e3),
                                         ("bandpass", (200e3, 400e3))])
@pytest.mark.parametrize("hop", [None, 384])
def test_filter_signal_matches_jax(kind, cutoff, hop):
    x = _two_tone(1 << 13, SR, 50e3, 300e3) + 0.01 * _noise(1 << 13, 7)
    got = filters.filter_signal(x, SR, kind, cutoff, nfft=1024, hop=hop,
                                device="cpu")
    want = jfilters.filter_signal(x, SR, kind, cutoff, nfft=1024, hop=hop)
    assert got.dtype == want.dtype and got.shape == want.shape
    sl = slice(1024, len(got) - 1024)
    np.testing.assert_allclose(got[sl], want[sl], atol=1e-5, rtol=0)


def test_regenerate_masked_matches_jax():
    nfft, hop = 512, 256
    x = _packed(_two_tone(1 << 13, SR, -200e3, 100e3))
    spectra = np.asarray(jfilters.make_stft_fn(nfft=nfft, hop=hop)(x))
    mask = filters.band_mask(nfft, SR, "bandpass", (0, 250e3))
    got = filters.regenerate_signal(spectra, nfft, hop, freq_mask=mask,
                                    device="cpu")
    want = jfilters.regenerate_signal(spectra, nfft, hop, freq_mask=mask)
    sl = slice(nfft, len(got) - nfft)
    np.testing.assert_allclose(got[sl], want[sl], atol=1e-5, rtol=0)
    # a tensor in, the same signal out
    y = filters.regenerate_signal(torch.from_numpy(spectra.copy()), nfft,
                                  hop, freq_mask=mask, device="cpu")
    np.testing.assert_array_equal(y, got)


def test_stft_istft_perfect_reconstruction():
    """Hann 50%-overlap analysis/synthesis reconstructs the interior
    (COLA) — tests/test_filters.py's case on the port."""
    n, nfft, hop = 4096, 256, 128
    x = _noise(n, 0)
    spectra = filters.make_stft_fn(nfft=nfft, hop=hop, device="cpu")(
        _packed(x))
    assert spectra.shape == ((n - nfft) // hop + 1, nfft, 2)
    y = filters.regenerate_signal(spectra, nfft, hop, device="cpu")
    sl = slice(hop, len(y) - hop)
    np.testing.assert_allclose(y[sl], x[: len(y)][sl], atol=2e-5)


@pytest.mark.parametrize("kind,keep,cut", [("lowpass", 50e3, 300e3),
                                           ("highpass", 300e3, 50e3)])
def test_filter_keeps_one_tone(kind, keep, cut):
    """The kept tone within 5e-3 of the ideal one, the cut tone more than
    60 dB down (tests/test_filters.py's thresholds)."""
    n = 1 << 14
    y = filters.filter_signal(_two_tone(n, SR, 50e3, 300e3), SR, kind,
                              120e3, nfft=1024, device="cpu")
    t = np.arange(len(y)) / SR
    sl = slice(1024, len(y) - 1024)
    assert np.abs(y[sl] - np.exp(2j * np.pi * keep * t)[sl]).max() < 5e-3
    spec = np.fft.fft(y[sl])
    f = np.fft.fftfreq(len(spec), 1 / SR)
    hi = np.abs(spec[np.argmin(np.abs(f - cut))])
    lo = np.abs(spec[np.argmin(np.abs(f - keep))])
    assert 20 * np.log10(hi / lo) < -60


def test_save_wav_equals_jax(tmp_path):
    from scipy.io import wavfile

    x = np.exp(2j * np.pi * 440 * np.arange(4000) / 8000)
    p = filters.save_wav(str(tmp_path / "tone"), x, 8000)
    q = jfilters.save_wav(str(tmp_path / "jtone"), x, 8000)
    assert p.endswith(".wav")
    (rate, data), (jrate, jdata) = wavfile.read(p), wavfile.read(q)
    assert rate == jrate == 8000 and data.dtype == np.int16
    np.testing.assert_array_equal(data, jdata)


def test_refusals_match_jax():
    """Signals shorter than one frame, and an inverse of no frames, refuse
    with the JAX module's messages; so does a CUDA device on a machine
    without one."""
    x = np.zeros(100, np.complex64)
    with pytest.raises(ValueError, match="too short"):
        filters.filter_signal(x, SR, "lowpass", 100e3, device="cpu")
    with pytest.raises(ValueError, match="too short"):
        jfilters.filter_signal(x, SR, "lowpass", 100e3)
    with pytest.raises(ValueError, match="at least one frame"):
        filters.make_istft_fn(nfft=256, hop=128, nframes=0, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            filters.filter_signal(np.zeros(4096), SR, "lowpass", 1e5,
                                  device="cuda")
