"""The PyTorch port's display renderer (CPU) against the JAX package's
display.render and display.tile.

Tolerances: against JAX's eager quantization (quantize_db_levels,
quantize_tile_linear outside jit, tile_from_db's numpy path) the levels are
bit-equal; against JAX's jitted quantize_on_device / sti_tile they are
within one level on <= 0.1% of pixels (XLA's fused CPU program rounds a
value like 23.500002 down where eager rounds it up — ROADMAP Queue 3).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pyspectrogram_tpu import display as jdisplay
from pyspectrogram_tpu.display import render as jrender
from pyspectrogram_tpu.display import tile as jtile
from pyspectrogram_tpu.display.colormap import get_colormap
from pyspectrogram_tpu_torch import display
from pyspectrogram_tpu_torch.display import render, tile
from pyspectrogram_tpu_torch.ops.stft import shifted_freqs

CRANGES = [(-110.0, -40.0), (-90.0, -55.5)]


def _db(shape, seed):
    """dBFS values over (and past) the colour ranges, float64 like the
    spectra save_sti_png clips."""
    return np.random.default_rng(seed).uniform(-130.0, -20.0, shape)


def _near(got, want):
    d = np.abs(got.astype(int) - want.astype(int))
    assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape
    assert d.max() <= 1 and np.count_nonzero(d) <= 1e-3 * d.size


def test_display_names_match_jax():
    assert sorted(display.__all__) == sorted(jdisplay.__all__)
    for name in display.__all__:
        assert hasattr(display, name)


@pytest.mark.parametrize("npoints", [256, 100])
@pytest.mark.parametrize("crange", CRANGES)
def test_quantize_on_device(crange, npoints):
    db = _db((64, 300), npoints)
    got = render.quantize_on_device(db, crange, npoints, device="cpu")
    _near(got, jrender.quantize_on_device(db, crange, npoints))
    eager = np.asarray(jrender.quantize_db_levels(
        jnp.asarray(db, jnp.float32), jrender.quantize_params(crange, npoints),
        npoints))
    np.testing.assert_array_equal(got, eager)
    # a tensor, and a negatively strided view, give the same levels
    np.testing.assert_array_equal(render.quantize_on_device(
        torch.from_numpy(db), crange, npoints, device="cpu"), got)
    np.testing.assert_array_equal(render.quantize_on_device(
        db[::-1], crange, npoints, device="cpu"), got[::-1])
    with pytest.raises(ValueError, match="uint8"):
        render.quantize_on_device(db, crange, 300, device="cpu")


@pytest.mark.parametrize("colors", [None, "legacy"])
@pytest.mark.parametrize("frange", [(-1e9, 1e9), (-120.0, 250.0)])
def test_sti_tile(frange, colors):
    nfft = 1024
    freqs = shifted_freqs(nfft, 1e6)
    sxx = _db((nfft, 40), nfft)
    cdata = None if colors is None else get_colormap(colors)
    rgba, pf = render.sti_tile(sxx, freqs, (-100.0, -30.0), frange, cdata,
                               max_nfreqs=300, device="cpu")
    jrgba, jpf = jrender.sti_tile(sxx, freqs, (-100.0, -30.0), frange, cdata,
                                  max_nfreqs=300)
    np.testing.assert_array_equal(pf, jpf)
    assert rgba.shape == jrgba.shape == (40, len(pf), 4)
    # the LUT maps levels to colours one to one: compare the levels
    idx, _ = render.freq_crop_decimate(freqs, frange, 300)
    npoints = 256 if cdata is None else min(len(cdata), 256)
    q = render.quantize_on_device(sxx[idx].T, (-100.0, -30.0), npoints,
                                  device="cpu")
    np.testing.assert_array_equal(rgba, render.apply_lut(q, cdata))
    _near(q, jrender.quantize_on_device(sxx[idx].T, (-100.0, -30.0),
                                        npoints))


@pytest.mark.parametrize("nfft", [256, 1024])
def test_tile_helpers_equal_eager_jax(nfft):
    """tile_from_linear / tile_from_db against JAX's eager
    quantize_tile_linear and tile_from_db's numpy path, bit for bit."""
    rng = np.random.default_rng(nfft)
    p = (rng.exponential(size=(16, 2, nfft))
         * 10.0 ** rng.uniform(-13, -3, (16, 2, nfft))).astype(np.float32)
    spec = tile.make_tile_spec(shifted_freqs(nfft, 1e6), (-300.0, 350.0),
                               (-110.0, -40.0), max_nfreqs=nfft // 4)
    got = tile.tile_from_linear(torch.from_numpy(p), spec)
    want = np.asarray(jtile.quantize_tile_linear(jnp.asarray(p), spec))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tile.tile_from_linear(p, spec), got)
    db = _db((16, 2, nfft), nfft).astype(np.float32)
    host = tile.tile_from_db(db, spec)
    np.testing.assert_array_equal(host, jtile.tile_from_db(db, spec))
    np.testing.assert_array_equal(
        tile.tile_from_db(torch.from_numpy(db), spec), host)


def _png_pixels(path):
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGBA"))


def test_save_sti_png_pixels(tmp_path):
    """The pixels branch quantizes on the device and writes what JAX's
    does (a read-back PNG), time and frequency crops included."""
    nfft, ntime = 256, 30
    freqs = shifted_freqs(nfft, 1e6)
    times = (np.datetime64("2016-01-01T00:00:00", "us")
             + np.arange(ntime) * np.timedelta64(1000, "us"))
    sxx = _db((nfft, ntime), 5)
    kw = dict(colorrange=(-100.0, -40.0), freqrange_khz=(-200.0, 300.0),
              timerange=(times[4], times[20]), renderer="pixels")
    out = render.save_sti_png(str(tmp_path / "port"), freqs, times, sxx,
                              device="cpu", **kw)
    jout = jrender.save_sti_png(str(tmp_path / "jax"), freqs, times, sxx,
                                **kw)
    assert out.endswith("port.png")
    got, want = _png_pixels(out), _png_pixels(jout)
    keepf = (freqs >= -200e3) & (freqs <= 300e3)
    assert got.shape == want.shape == (17, keepf.sum(), 4)
    assert np.count_nonzero((got != want).any(-1)) <= 1e-3 * got[..., 0].size


def test_save_sti_png_matplotlib_is_the_host_path(tmp_path):
    """renderer="matplotlib" (and "auto" where matplotlib imports) is the
    JAX function's host contour render."""
    pytest.importorskip("matplotlib")
    nfft, ntime = 64, 6
    freqs = shifted_freqs(nfft, 1e6)
    times = (np.datetime64("2016-01-01T00:00:00", "us")
             + np.arange(ntime) * np.timedelta64(1000, "us"))
    out = render.save_sti_png(str(tmp_path / "m.png"), freqs, times,
                              _db((nfft, ntime), 1), (-100.0, -40.0),
                              device="cpu")
    assert out.endswith("m.png") and (tmp_path / "m.png").stat().st_size > 1000


def test_cuda_device_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        render.quantize_on_device(np.zeros((2, 2)), (-1.0, 0.0),
                                  device="cuda")
