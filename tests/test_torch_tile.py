"""The PyTorch port's display epilogue (CPU) against the JAX package's,
each given its own package's TileSpec (port_pairs)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from port_pairs import jax_spec
from pyspectrogram_tpu.display.render import quantize_db_levels as jlevels
from pyspectrogram_tpu.display.tile import (
    quantize_tile_linear as jquantize_tile_linear,
)
from pyspectrogram_tpu.ops import stft as jstft
from pyspectrogram_tpu_torch.display import tile
from pyspectrogram_tpu_torch.display.tile import make_tile_spec
from pyspectrogram_tpu_torch.ops import stft


def _spec(nfft, frange=(-300.0, 350.0), crange=(-110.0, -40.0)):
    return make_tile_spec(stft.shifted_freqs(nfft, 1e6), frange, crange,
                          max_nfreqs=nfft // 4)


@pytest.mark.parametrize("crange", [(-110.0, -40.0), (-90.0, -55.5)])
@pytest.mark.parametrize("nfft", [256, 1024])
def test_tile_from_linear_bit_equal(nfft, crange):
    """Same linear input -> the same uint8 levels, bit for bit."""
    rng = np.random.default_rng(nfft)
    p = (rng.exponential(size=(16, 2, nfft))
         * 10.0 ** rng.uniform(-13, -3, (16, 2, nfft))).astype(np.float32)
    spec = _spec(nfft, crange=crange)
    want = np.asarray(jax.jit(
        lambda a: jquantize_tile_linear(a, jax_spec(spec)))(jnp.asarray(p)))
    got = tile.quantize_tile_linear(torch.from_numpy(p), spec).numpy()
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert got.shape[-1] == spec.plot_n
    np.testing.assert_array_equal(got, want)


def test_levels_round_half_to_even_and_clamp():
    qp = np.asarray([-100.0, 2.0], np.float32)
    db = np.asarray([-100.25, -100.0, -99.75, -99.25, -98.75, -30.0, -200.0,
                     -0.5], np.float32)
    want = np.asarray(jlevels(jnp.asarray(db), qp, 256))
    got = tile.quantize_db_levels(torch.from_numpy(db), qp, 256).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:5], [0, 0, 0, 2, 2])


def test_qparams_is_a_runtime_operand():
    """A colour range passed at call time equals a spec built with it."""
    nfft = 256
    rng = np.random.default_rng(1)
    p = torch.from_numpy(
        (rng.exponential(size=(4, 1, nfft)) * 1e-7).astype(np.float32))
    base, other = _spec(nfft), _spec(nfft, crange=(-95.0, -60.0))
    np.testing.assert_array_equal(
        tile.quantize_tile_linear(p, base, qparams=other.qparams).numpy(),
        tile.quantize_tile_linear(p, other).numpy())
    np.testing.assert_array_equal(
        tile.quantize_tile_linear(p, base, qparams=torch.from_numpy(
            other.qparams)).numpy(),
        tile.quantize_tile_linear(p, other).numpy())


@pytest.mark.parametrize("nsub", [1, 2])
@pytest.mark.parametrize("ntime", [8, 40])
def test_sti_tile_end_to_end(ntime, nsub):
    """Tile mode of the whole device program. The two FFTs differ by
    float32 rounding, so a pixel near a level boundary may land one level
    apart: |dlevel| <= 1 on at most 0.1% of pixels."""
    nfft, nint = 512, 2
    rng = np.random.default_rng(ntime + nsub)
    nsamp = nfft * nint * ntime
    x = (rng.standard_normal((2 * nsub, nsamp)) * 1e-3).astype(np.float32)
    starts = (np.arange(ntime) * nfft * nint).astype(np.int32)
    spec = _spec(nfft, crange=(-120.0, -70.0))
    want = jstft.make_sti_fn_pm(nfft=nfft, nint=nint, fft_impl="xla",
                                contiguous=True, tile=jax_spec(spec))(
        jnp.asarray(x), jnp.asarray(starts))
    got = stft.make_sti_fn_pm(nfft=nfft, nint=nint, contiguous=True,
                              tile=spec)(torch.from_numpy(x),
                                         torch.from_numpy(starts))
    assert set(got) == set(want) == {"tile", "sxx_med_dbfs"}
    g = got["tile"].numpy().astype(int)
    w = np.asarray(want["tile"]).astype(int)
    assert g.shape == w.shape == (ntime, nsub, spec.plot_n)
    assert np.abs(g - w).max() <= 1
    assert np.count_nonzero(g != w) <= 1e-3 * g.size
