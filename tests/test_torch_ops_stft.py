"""The PyTorch port's ops.stft and kernel plain versions (CPU) against the
JAX package's functions on the same numpy inputs.

Tolerances: linear power rtol 2e-4, atol 1e-6 — the JAX package's own
kernel-vs-XLA tolerance (test_pallas_kernel.py). dBFS 1e-4 dB on bins
within 30 dB of their column's peak: two float32 FFTs differ by ~1e-7 of
the column's energy, which near a spectral null of white noise is up to
~2e-3 dB, and the linear check already bounds those bins. Medians of the
same linear input are bit-exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pyspectrogram_tpu.kernels.median_pallas import median_over_time_pallas
from pyspectrogram_tpu.kernels.sti_pallas import make_pallas_sti_psd
from pyspectrogram_tpu.ops import stft as jstft
from pyspectrogram_tpu.ops.windows import get_window as jget_window
from pyspectrogram_tpu_torch.kernels import (
    big_cuda,
    median_cuda,
    stream_cuda,
    sti_cuda,
)
from pyspectrogram_tpu_torch.ops import plain, stft
from pyspectrogram_tpu_torch.ops.windows import get_window

LIN = dict(rtol=2e-4, atol=1e-6)


def _planes(nfft, nint, ntime, nsub, dtype, seed=0, contiguous=False):
    """Plane-major (nsub*2, nsamp) samples, starts and the full-scale ref."""
    rng = np.random.default_rng(seed)
    nsamp = nfft * nint * ntime + (0 if contiguous else 64)
    if dtype == "int16":
        x = rng.integers(-2 ** 14, 2 ** 14, (2 * nsub, nsamp)).astype(np.int16)
        ref = 2.0 ** 15.5
    else:
        x = rng.standard_normal((2 * nsub, nsamp)).astype(np.float32)
        ref = 1.0
    if contiguous:
        starts = (np.arange(ntime) * nfft * nint).astype(np.int32)
    else:
        starts = np.linspace(0, nsamp - nfft * nint, ntime).astype(np.int32)
    return x, starts, ref


def _assert_db_close(got, want, lin_want, floor_db=30.0, atol=1e-4):
    """dB agreement on bins within ``floor_db`` of their column's peak."""
    lin_want = np.asarray(lin_want)
    peak = lin_want.max(axis=-1, keepdims=True)
    keep = lin_want >= peak * 10.0 ** (-floor_db / 10.0)
    np.testing.assert_allclose(np.asarray(got)[keep], np.asarray(want)[keep],
                               atol=atol, rtol=0)


@pytest.mark.parametrize("ntime", [8, 40])
@pytest.mark.parametrize("dtype", ["float32", "int16"])
@pytest.mark.parametrize("nsub", [1, 2])
@pytest.mark.parametrize("mode,nint", [("welch", 1), ("welch", 4),
                                       ("parity", 3)])
@pytest.mark.parametrize("nfft", [256, 512])
def test_sti_fn_pm_matches_jax(nfft, mode, nint, nsub, dtype, ntime):
    """Both median tiers (network at 8, bisection at 40), f32 and raw
    int16 planes, every output key."""
    x, starts, ref = _planes(nfft, nint, ntime, nsub, dtype)
    kw = dict(nfft=nfft, nint=nint, mode=mode, ref=ref, return_linear=True,
              return_minmax=True)
    want = jstft.make_sti_fn_pm(fft_impl="xla", **kw)(jnp.asarray(x),
                                                      jnp.asarray(starts))
    got = stft.make_sti_fn_pm(**kw)(torch.from_numpy(x),
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
    for k in ("sxx_min_dbfs", "sxx_max_dbfs"):
        np.testing.assert_allclose(10.0 ** (got[k] / 10.0),
                                   10.0 ** (want[k] / 10.0), **LIN)
    # the median of the port's own linear power is exact
    np.testing.assert_array_equal(
        got["sxx_med"], np.median(got["sxx"], axis=0).astype(np.float32))


@pytest.mark.parametrize("contiguous", [True, False])
@pytest.mark.parametrize("mode,nint", [("welch", 1), ("welch", 4),
                                       ("parity", 3)])
def test_psd_plain_matches_pallas_kernel(mode, nint, contiguous):
    """Kernel B1's plain version against the Pallas kernel (interpret
    mode), in its contiguous and gathered forms."""
    nfft, ntime, nsub = 256, 4, 2
    x, starts, _ = _planes(nfft, nint, ntime, nsub, "float32", seed=3,
                           contiguous=contiguous)
    kernel = make_pallas_sti_psd(nfft=nfft, nint=nint, mode=mode,
                                 interpret=True, contiguous=contiguous)
    want = np.asarray(kernel(jnp.asarray(x), jnp.asarray(starts)))
    before = sti_cuda.sti_psd_cuda.launches
    got = sti_cuda.sti_psd_cuda(torch.from_numpy(x), torch.from_numpy(starts),
                                nfft=nfft, nint=nint, mode=mode)
    assert sti_cuda.sti_psd_cuda.launches == before  # CPU: plain version
    np.testing.assert_allclose(got.numpy(), want, **LIN)


def _median_input(n, m, nfft, seed):
    rng = np.random.default_rng(seed)
    p = rng.exponential(size=(n, m, nfft)).astype(np.float32)
    # ties, exact zeros and repeated middles
    p[: n // 3, :, : nfft // 4] = p[n // 3, :, : nfft // 4]
    p[:, :, -3:] = 0.0
    return p


@pytest.mark.parametrize("n", [33, 40, 64, 129])
def test_median_plain_matches_pallas_and_numpy(n):
    """Kernel B2's plain version: bit-exact against the Pallas kernel
    (interpret mode) and np.median, even n and ties included."""
    p = _median_input(n, 2, 256, seed=n)
    want = np.median(p, axis=0).astype(np.float32)
    pallas = np.asarray(median_over_time_pallas(jnp.asarray(p),
                                                interpret=True))
    before = median_cuda.median_over_time_cuda.launches
    got = median_cuda.median_over_time_cuda(torch.from_numpy(p)).numpy()
    assert median_cuda.median_over_time_cuda.launches == before
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(
        stft.median_over_time(torch.from_numpy(p)).numpy(), want)


@pytest.mark.parametrize("n", [1, 2, 3, 7, 8, 16, 31, 32])
def test_median_network_matches_jax(n):
    p = _median_input(n, 2, 64, seed=100 + n)
    got = stft.median_over_time(torch.from_numpy(p)).numpy()
    want = np.asarray(jstft.median_over_time(jnp.asarray(p)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.median(p, axis=0).astype(np.float32))


def test_median_float64_and_valid_prefix():
    rng = np.random.default_rng(7)
    p = rng.standard_normal((50, 3, 16))
    for n in (50, 41):
        got = stft.median_over_time(torch.from_numpy(p), ntime_valid=n)
        np.testing.assert_array_equal(got.numpy(), np.median(p[:n], axis=0))


def test_to_dbfs_matches_jax():
    rng = np.random.default_rng(8)
    x = (rng.exponential(size=4096) * 10.0 ** rng.uniform(-12, 0, 4096)
         ).astype(np.float32)
    got = plain.to_dbfs(torch.from_numpy(x)).numpy()
    want = np.asarray(jstft.to_dbfs(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("nfft,device,impl,want", [
    (4096, "cuda", "auto", "cuda"),
    (256, "cuda", "auto", "cuda"),
    (16384, "cuda", "auto", "cuda"),
    (32768, "cuda", "auto", "cuda"),     # the two-launch four-step split
    (65536, "cuda", "auto", "cuda"),     # kernel B4, through sti_psd_cuda
    (128, "cuda", "auto", "torch"),      # below the kernel's floor
    (1000, "cuda", "auto", "torch"),     # not a power of two
    (4096, "cpu", "auto", "torch"),
    (4096, "cuda", "torch", "torch"),
    (4096, "cpu", "cuda", "cuda"),       # the wrapper runs the plain version
])
def test_pick_impl_table(nfft, device, impl, want):
    assert stft.pick_impl(nfft, torch.device(device), impl) == want


@pytest.mark.parametrize("nfft", [128, 1000, 1 << 21])
def test_pick_impl_explicit_cuda_outside_range_raises(nfft):
    with pytest.raises(ValueError, match="covers power-of-two"):
        stft.pick_impl(nfft, torch.device("cuda"), "cuda")
    with pytest.raises(ValueError):
        stft.make_sti_fn_pm(nfft=nfft, impl="cuda")


def test_wrappers_refuse_other_devices():
    x = torch.empty((4, 4096), device="meta")
    with pytest.raises(ValueError, match="no STI kernel"):
        sti_cuda.sti_psd_cuda(x, torch.zeros(2, dtype=torch.int32),
                              nfft=1024)
    with pytest.raises(ValueError, match="no median kernel"):
        median_cuda.median_over_time_cuda(torch.empty((40, 8), device="meta"))
    with pytest.raises(ValueError, match="no big STI kernel"):
        big_cuda.big_psd_cuda(torch.empty((4, 1 << 17), device="meta"),
                              torch.zeros(2, dtype=torch.int32), nfft=65536)
    with pytest.raises(ValueError, match="no stream kernel"):
        stream_cuda.stream_psd_cuda(torch.empty((4, 1024 + 3 * 512),
                                                device="meta"),
                                    nfft=1024, hop=512)


def _stockham_numpy(x, tw=None):
    """csrc/sti_psd.cu's radix-2 Stockham index plan, in numpy; ``tw`` the
    W_n^m (m < n/2) the kernel reads, strided out of a longer table."""
    n = len(x)
    lg, half = n.bit_length() - 1, n // 2
    if tw is None:
        tw = np.exp(-2j * np.pi * np.arange(half) / n)
    i = np.arange(half)
    buf = np.empty(n, complex)
    a, b = x[i], x[i + half]
    buf[2 * i], buf[2 * i + 1] = a + b, a - b
    for lp in range(1, lg - 1):
        p = 1 << lp
        a, b = buf[i].copy(), buf[i + half].copy()
        k = i & (p - 1)
        bw = b * tw[k << (lg - 1 - lp)]
        buf[2 * i - k], buf[2 * i - k + p] = a + bw, a - bw
    bw = buf[i + half] * tw[i]
    return np.concatenate([buf[i] + bw, buf[i] - bw])


def _four_step_numpy(x, n1=128, n2=256):
    """csrc/sti_psd.cu's four-step plan for nfft = n1*n2: fs_cols_kernel's
    column DFTs and twiddle into the workspace Y[k1][n2], fs_rows_kernel's
    row DFTs and its bin k = k1 + n1*k2."""
    n = n1 * n2
    half = n // 2
    tw = np.exp(-2j * np.pi * np.arange(half) / n)  # the kernel's table
    cols = x.reshape(n1, n2).T     # cols[j][i] = x[n2 * i + j]
    y = np.stack([_stockham_numpy(c, tw[::n2]) for c in cols], axis=1)
    m = np.arange(n2)[None, :] * np.arange(n1)[:, None]       # n2 * k1
    y *= np.where(m & half, -1.0, 1.0) * tw[m & (half - 1)]   # y[k1][n2]
    rows = np.stack([_stockham_numpy(r, tw[::n1]) for r in y])  # [k1][k2]
    out = np.empty(n, complex)
    k1, k2 = np.meshgrid(np.arange(n1), np.arange(n2), indexing="ij")
    out[k1 + n1 * k2] = rows
    return out


#: the four-step splits (N1, N2) of csrc: B1 (and B3) at 32768, B4 above
FOUR_STEP = {32768: (128, 256), 65536: (256, 256), 131072: (512, 256),
             262144: (512, 512), 524288: (1024, 512),
             1048576: (1024, 1024)}


@pytest.mark.parametrize("nfft", [256, 4096, 16384, 32768, 65536, 131072,
                                  262144, 524288, 1048576])
def test_kernel_fft_index_plan(nfft):
    """The kernels' butterfly, twiddle and output-bin indexing is the DFT
    (the CUDA sources run only on the card; their plan is checked here):
    one block up to 16384 points, the four-step split above, B4's
    (N1, N2) table up to 1024 x 1024 included."""
    rng = np.random.default_rng(nfft)
    x = rng.standard_normal(nfft) + 1j * rng.standard_normal(nfft)
    plan = (_stockham_numpy(x) if nfft <= sti_cuda.ONE_BLOCK_MAX_NFFT
            else _four_step_numpy(x, *FOUR_STEP[nfft]))
    np.testing.assert_allclose(plan, np.fft.fft(x),
                               rtol=0, atol=1e-9 * np.sqrt(nfft))


@pytest.mark.parametrize("contiguous", [True, False])
@pytest.mark.parametrize("mode,nint", [("welch", 2), ("parity", 2)])
def test_big_psd_plain_matches_pallas_kernel(mode, nint, contiguous):
    """Kernel B4's plain version against the JAX package's 65536-point
    kernel (interpret mode), contiguous and gathered, at the rtol the JAX
    package holds that kernel to (test_pallas_kernel.py:467): at large
    nfft a white-noise bin's power is ~1/nfft, so an absolute tolerance
    bounds nothing there."""
    nfft, ntime, nsub = 1 << 16, 2, 1
    x, starts, _ = _planes(nfft, nint, ntime, nsub, "float32", seed=11,
                           contiguous=contiguous)
    kernel = make_pallas_sti_psd(nfft=nfft, nint=nint, mode=mode,
                                 interpret=True, contiguous=contiguous)
    want = np.asarray(kernel(jnp.asarray(x), jnp.asarray(starts)))
    before = big_cuda.big_psd_cuda.launches
    for fn in (big_cuda.big_psd_cuda, sti_cuda.sti_psd_cuda):
        got = fn(torch.from_numpy(x), torch.from_numpy(starts), nfft=nfft,
                 nint=nint, mode=mode)
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-3, atol=1e-9)
    assert big_cuda.big_psd_cuda.launches == before  # CPU: plain version


@pytest.mark.parametrize("spec", ["hann", "hamming", "blackman", "boxcar",
                                  ("kaiser", 1.7), ("kaiser", 8.0)])
@pytest.mark.parametrize("nfft", [32, 1000, 4096])
def test_copied_host_helpers_bit_equal(spec, nfft):
    np.testing.assert_array_equal(get_window(spec, nfft),
                                  jget_window(spec, nfft))
    np.testing.assert_array_equal(stft.shifted_freqs(nfft, 1e6 / 3),
                                  jstft.shifted_freqs(nfft, 1e6 / 3))
    a = np.arange(2 * 3 * nfft, dtype=np.float32).reshape(2, 3, nfft)
    np.testing.assert_array_equal(stft.to_reference_layout(a),
                                  jstft.to_reference_layout(a))
    assert stft._batcher_pairs(nfft % 40 + 1) == jstft._batcher_pairs(
        nfft % 40 + 1)
