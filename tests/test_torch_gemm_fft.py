"""The port's GEMM DFT (kernels.gemm_fft.make_gemm_fft, and
ops.stft.make_sti_fn(fft_impl="gemm")) against the JAX package's and
numpy's FFT on the same seeded inputs.

Tolerances: the transform within 1e-5 of max |X| of numpy's float64 FFT
(the port's matmuls run in complex128 on complex64-rounded constants) and
of the JAX package's (complex64 at Precision.HIGHEST); the STI at the
standing linear rtol 2e-4, atol 1e-6 and 1e-4 dB on bins within 30 dB of
their column's peak.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pyspectrogram_tpu.kernels import gemm_fft as jgemm
from pyspectrogram_tpu.ops import stft as jstft
from pyspectrogram_tpu_torch.kernels import make_gemm_fft
from pyspectrogram_tpu_torch.ops import stft

LIN = dict(rtol=2e-4, atol=1e-6)


def _noise(shape, seed, dtype=np.complex64):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(dtype)


@pytest.mark.parametrize("nfft", [1 << k for k in range(8, 17)])
def test_gemm_fft_matches_jax_and_numpy(nfft):
    x = _noise((3, nfft), seed=nfft)
    got = make_gemm_fft(nfft)(torch.from_numpy(x))
    assert got.dtype == torch.complex64 and got.shape == x.shape
    got = got.numpy()
    want = np.fft.fft(x.astype(np.complex128))
    jax_out = np.asarray(jgemm.make_gemm_fft(nfft)(jnp.asarray(x)))
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)
    np.testing.assert_allclose(got, jax_out, rtol=0, atol=1e-5 * scale)


def test_gemm_fft_keeps_complex128():
    """A complex128 input stays complex128 and is float64-exact, up to the
    complex64 rounding of the plan's constants."""
    x = _noise((2, 1024), seed=4, dtype=np.complex128)
    got = make_gemm_fft(1024)(torch.from_numpy(x))
    assert got.dtype == torch.complex128
    want = np.fft.fft(x)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def _assert_db_close(got, want, lin_want, floor_db=30.0):
    peak = lin_want.max(axis=-1, keepdims=True)
    keep = lin_want >= peak * 10.0 ** (-floor_db / 10.0)
    np.testing.assert_allclose(got[keep], want[keep], atol=1e-4, rtol=0)


@pytest.mark.parametrize("kind", ["complex", "int16"])
@pytest.mark.parametrize("mode,nint", [("parity", 1), ("welch", 3)])
@pytest.mark.parametrize("nfft", [256, 4096])
def test_sti_fn_gemm_matches_jax(nfft, mode, nint, kind):
    """make_sti_fn(fft_impl="gemm") against the JAX package's, every
    output key, on complex samples and raw int16 planes."""
    ntime, nsub = 9, 2
    nsamp = nfft * nint * ntime + 64
    rng = np.random.default_rng(nfft + nint)
    if kind == "int16":
        x = rng.integers(-2 ** 14, 2 ** 14, (nsamp, nsub, 2)).astype(np.int16)
        ref = 2.0 ** 15.5
    else:
        x, ref = _noise((nsamp, nsub), seed=nint), 1.0
    starts = np.linspace(0, nsamp - nfft * nint, ntime).astype(np.int32)
    kw = dict(nfft=nfft, nint=nint, mode=mode, ref=ref, fft_impl="gemm",
              return_linear=True)
    want = jstft.make_sti_fn(**kw)(jnp.asarray(x), jnp.asarray(starts))
    got = stft.make_sti_fn(**kw)(torch.from_numpy(x),
                                 torch.from_numpy(starts))
    assert set(got) == set(want)
    got = {k: v.numpy() for k, v in got.items()}
    want = {k: np.asarray(v) for k, v in want.items()}
    for k in got:
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype
    np.testing.assert_allclose(got["sxx"], want["sxx"], **LIN)
    np.testing.assert_allclose(got["sxx_med"], want["sxx_med"], **LIN)
    _assert_db_close(got["sxx_dbfs"], want["sxx_dbfs"], want["sxx"])
    _assert_db_close(got["sxx_med_dbfs"], want["sxx_med_dbfs"],
                     want["sxx_med"])
    # the median of the port's own linear power is exact
    np.testing.assert_array_equal(
        got["sxx_med"], np.median(got["sxx"], axis=0).astype(np.float32))
