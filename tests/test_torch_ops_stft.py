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


def _time_major(nsamp, nsub, kind, seed):
    """(nsamp, nsub) complex64, or (nsamp, nsub, 2) packed float32 / int16
    planes, and the full-scale ref that goes with them."""
    rng = np.random.default_rng(seed)
    if kind == "int16":
        return (rng.integers(-2 ** 14, 2 ** 14, (nsamp, nsub, 2))
                .astype(np.int16), 2.0 ** 15.5)
    x = (rng.standard_normal((nsamp, nsub))
         + 1j * rng.standard_normal((nsamp, nsub))).astype(np.complex64)
    return (x if kind == "complex" else jstft.pack_complex_host(x)), 1.0


@pytest.mark.parametrize("ntime", [9, 40])
@pytest.mark.parametrize("kind", ["complex", "float32", "int16"])
@pytest.mark.parametrize("mode,nint", [("parity", 1), ("parity", 3),
                                       ("welch", 4)])
def test_sti_fn_matches_jax(mode, nint, kind, ntime):
    """make_sti_fn, complex64: the oracle cases of test_ops_stft.py
    (nfft 128, nsub 2, spread starts) on complex, packed float32 and raw
    int16 planes, both median tiers (network at 9, bisection at 40)."""
    nfft, nsub = 128, 2
    x, ref = _time_major(nfft * nint * ntime + 64, nsub, kind, seed=ntime)
    starts = np.linspace(0, len(x) - nfft * nint, ntime).astype(np.int32)
    kw = dict(nfft=nfft, nint=nint, mode=mode, ref=ref, return_linear=True)
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


@pytest.mark.parametrize("kind", ["complex", "float32", "int16"])
@pytest.mark.parametrize("mode,nint", [("welch", 2), ("parity", 2)])
def test_sti_fn_complex128_matches_jax(mode, nint, kind):
    """compute_dtype complex128 against the JAX function under x64, to
    1e-9 relative: linear power and dB."""
    import jax

    nfft, ntime, nsub = 64, 7, 1
    x, ref = _time_major(nfft * nint * ntime, nsub, kind, seed=5)
    if kind == "complex":
        x = x.astype(np.complex128)
    starts = np.linspace(0, len(x) - nfft * nint, ntime).astype(np.int64)
    kw = dict(nfft=nfft, nint=nint, mode=mode, ref=ref, return_linear=True)
    with jax.enable_x64(True):
        want = jstft.make_sti_fn(compute_dtype=jnp.complex128, **kw)(
            jnp.asarray(x), jnp.asarray(starts))
        want = {k: np.asarray(v) for k, v in want.items()}
    got = stft.make_sti_fn(compute_dtype=torch.complex128, **kw)(
        torch.from_numpy(x), torch.from_numpy(starts))
    assert set(got) == set(want)
    for k, v in got.items():
        assert v.dtype == torch.float64 and v.shape == want[k].shape
        np.testing.assert_allclose(v.numpy(), want[k], rtol=1e-9, atol=0)


def test_sti_fn_packed_int16_is_normalized_complex():
    """Raw int16 planes with ref in the power scale equal the complex
    samples divided by ref on the host (test_ops_stft.py:69)."""
    raw, ref = _time_major(128 * 5, 1, "int16", seed=7)
    starts = torch.arange(5, dtype=torch.int32) * 128
    got = stft.make_sti_fn(nfft=128, ref=ref)(torch.from_numpy(raw), starts)
    c = torch.complex(torch.from_numpy(raw[..., 0].astype(np.float32)),
                      torch.from_numpy(raw[..., 1].astype(np.float32))) / ref
    want = stft.make_sti_fn(nfft=128)(c, starts)
    _assert_db_close(got["sxx_dbfs"].numpy(), want["sxx_dbfs"].numpy(),
                     10.0 ** (want["sxx_dbfs"].numpy() / 10.0))


def test_sti_fn_tone_peak():
    """An exact-bin tone puts its power in its bin at 0 dBFS
    (test_ops_stft.py:100)."""
    nfft, k = 256, -40
    n = np.arange(nfft * 4)
    x = np.exp(2j * np.pi * k * n / nfft).astype(np.complex64)[:, None]
    out = stft.make_sti_fn(nfft=nfft, window="boxcar")(
        torch.from_numpy(x), torch.tensor([0, nfft, 2 * nfft]))
    sxx = out["sxx_dbfs"][0, 0].numpy()
    peak = int(np.argmax(sxx))
    assert stft.shifted_freqs(nfft, 1e6)[peak] == pytest.approx(
        k * 1e6 / nfft)
    assert sxx[peak] == pytest.approx(0.0, abs=1e-3)


@pytest.mark.parametrize("shape", [(20,), (20, 2), (20, 2, 2)])
def test_gather_frames_matches_jax(shape):
    """Layout (ntime, nsub, frame_len[, 2]) and the dynamic_slice clamp of
    a start past the end, as the JAX function (test_ops_stft.py:91)."""
    samples = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
    starts = np.array([0, 5, 12, 19], np.int32)
    got = stft.gather_frames(torch.from_numpy(samples),
                             torch.from_numpy(starts), 4)
    want = np.asarray(jstft.gather_frames(jnp.asarray(samples),
                                          jnp.asarray(starts), 4))
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
def test_psd_frames_and_pack_complex_host_match_jax(dtype):
    import jax

    rng = np.random.default_rng(3)
    x = (rng.standard_normal((3, 2, 64))
         + 1j * rng.standard_normal((3, 2, 64))).astype(dtype)
    packed = stft.pack_complex_host(x)
    np.testing.assert_array_equal(packed, jstft.pack_complex_host(x))
    assert packed.base is not None                   # a view, no copy
    with pytest.raises(ValueError, match="expected complex"):
        stft.pack_complex_host(packed)
    win = get_window("hann", 64)
    with jax.enable_x64(dtype == np.complex128):
        want = np.asarray(jstft.psd_frames(jnp.asarray(x), jnp.asarray(win),
                                           0.25))
    got = stft.psd_frames(torch.from_numpy(x), win, 0.25).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=1e-9 if dtype == np.complex128
                               else 2e-4, atol=0 if dtype == np.complex128
                               else 1e-6)


def test_sti_fn_refuses_what_jax_refuses_and_gemm():
    """fft_impl="gemm" (the JAX package's GEMM DFT) runs and gives the
    torch.fft route's spectra; a bad mode, fft_impl or compute dtype raises
    as in JAX."""
    x = torch.from_numpy(_time_major(256 * 3, 1, "complex", seed=3)[0])
    starts = torch.tensor([0, 256, 512])
    got = stft.make_sti_fn(nfft=256, fft_impl="gemm", return_linear=True)(
        x, starts)
    want = stft.make_sti_fn(nfft=256, return_linear=True)(x, starts)
    np.testing.assert_allclose(got["sxx"].numpy(), want["sxx"].numpy(), **LIN)
    for kw in (dict(mode="median"), dict(fft_impl="pallas"),
               dict(compute_dtype=torch.float32)):
        with pytest.raises(ValueError):
            stft.make_sti_fn(nfft=256, **kw)
    with pytest.raises(ValueError, match="pack planes"):
        stft.make_sti_fn(nfft=64)(torch.zeros(256, 2), torch.tensor([0]))


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
    (4096, "cuda", "xla", "torch"),      # the JAX package's XLA FFT: torch.fft
    (4096, "cpu", "pallas", "cuda"),     # the wrapper runs the plain version
])
def test_pick_impl_table(nfft, device, impl, want):
    assert stft.pick_impl(nfft, torch.device(device), impl) == want


@pytest.mark.parametrize("nfft", [128, 1000, 1 << 21])
def test_pick_impl_explicit_cuda_outside_range_raises(nfft):
    with pytest.raises(ValueError, match="covers power-of-two"):
        stft.pick_impl(nfft, torch.device("cuda"), "pallas")
    with pytest.raises(ValueError):
        stft.make_sti_fn_pm(nfft=nfft, fft_impl="pallas")


def test_unknown_fft_impl_raises():
    """The port's own names for the two routes are not fft_impl values."""
    for v in ("cuda", "torch", "gemm"):
        with pytest.raises(ValueError, match="unknown fft_impl"):
            stft.make_sti_fn_pm(nfft=256, fft_impl=v)


@pytest.mark.parametrize("fft_impl", ["auto", "xla"])
def test_sti_fn_pm_fft_impl_matches_jax(fft_impl):
    """make_sti_fn_pm takes the JAX package's fft_impl: each value gives
    the JAX function's output with the same value on the same input (on
    the CPU both packages run their FFT library: "auto" is "xla" there)."""
    x, starts, ref = _planes(1024, 2, 40, 2, "float32", seed=11)
    kw = dict(nfft=1024, nint=2, mode="welch", ref=ref, return_linear=True,
              fft_impl=fft_impl)
    want = jstft.make_sti_fn_pm(**kw)(jnp.asarray(x), jnp.asarray(starts))
    got = stft.make_sti_fn_pm(**kw)(torch.from_numpy(x),
                                    torch.from_numpy(starts))
    assert set(got) == set(want)
    np.testing.assert_allclose(got["sxx"].numpy(), np.asarray(want["sxx"]),
                               **LIN)
    np.testing.assert_allclose(got["sxx_med"].numpy(),
                               np.asarray(want["sxx_med"]), **LIN)
    _assert_db_close(got["sxx_dbfs"].numpy(), want["sxx_dbfs"], want["sxx"])
    _assert_db_close(got["sxx_med_dbfs"].numpy(), want["sxx_med_dbfs"],
                     want["sxx_med"])


@pytest.mark.parametrize("name", ["make_sti_fn_pm", "make_batched_sti_fn_pm"])
def test_factories_take_every_jax_keyword(name):
    """The port's STI factories accept every keyword of their JAX
    counterparts, so a call written for the JAX package runs on the port."""
    import inspect

    from pyspectrogram_tpu.models import batch as jbatch
    from pyspectrogram_tpu_torch.models import batch

    port = {"make_sti_fn_pm": stft.make_sti_fn_pm,
            "make_batched_sti_fn_pm": batch.make_batched_sti_fn_pm}[name]
    ref = {"make_sti_fn_pm": jstft.make_sti_fn_pm,
           "make_batched_sti_fn_pm": jbatch.make_batched_sti_fn_pm}[name]
    want = inspect.signature(ref).parameters
    got = inspect.signature(port).parameters
    assert set(want) <= set(got)
    for k, p in want.items():
        assert got[k].kind == p.kind, k
        assert got[k].default == p.default, k


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


#: the four-step splits (N1, N2) of csrc (big_psd.cu PST_FOUR_STEP,
#: _build.FOUR_STEP): B1 (and B3) at 32768, B4 above
FOUR_STEP = {32768: (128, 256), 65536: (256, 256), 131072: (512, 256),
             262144: (512, 512), 524288: (1024, 512),
             1048576: (1024, 1024)}

#: the one-block register-pass kernel's sizes (csrc/fft_common.cuh,
#: reg_psd_kernel): B1 and B3 up to 16384 points
ONE_BLOCK = [256, 512, 1024, 2048, 4096, 8192, 16384]


def _radices(m):
    """SubPlan of fft_common.cuh: radix-16 passes, the small radix last."""
    a = (m.bit_length() - 1) // 4
    tail = m >> (4 * a)
    return [16] * a + ([tail] if tail > 1 else [])


def _reg_plan(n):
    """RegPlan of fft_common.cuh: (points per thread P, threads, radices
    first to last)."""
    p = 32 if n >= 16384 else 16
    return p, n // p, _radices(n)


def _cols_plan(n1):
    """ColsPlan: (points a thread, sub-FFTs (columns) a block)."""
    return (32 if n1 >= 512 else 16), 16


def _rows_plan(n2):
    """RowsPlan: (points a thread, sub-FFTs (rows) a block)."""
    return 16, 8


def _rpad(i):
    """The exchange buffer's padded index (rpad): one slot per 16."""
    return i + (i >> 4)


def _w16(m):
    """The kernel's constant W_16^m (w16); exact in complex128."""
    return torch.exp(torch.tensor(-2j * np.pi / 16, dtype=torch.complex128)
                     * m)


def _dft_regs(v):
    """dft_regs on v[..., R]: radix-2 Stockham stages, stage p multiplying
    v[i + R/2] by W_16^(8k/p), k = i mod p, into y[2i-k] and y[2i-k+p]."""
    r = v.shape[-1]
    for s in range(r.bit_length() - 1):
        p = 1 << s
        i = torch.arange(r // 2)
        k = i & (p - 1)
        a, b = v[..., i], v[..., i + r // 2] * _w16((8 * k) // p)
        y = torch.empty_like(v)
        y[..., 2 * i - k], y[..., 2 * i - k + p] = a + b, a - b
        v = y
    return v


def _tw_at(tw, e, m):
    """tw_at<M>: W_M^e from the table tw[j] = W_M^j, j < M/2, negated when
    e has bit M/2."""
    return tw[e & (m // 2 - 1)] * torch.where((e & (m // 2)) > 0, -1.0,
                                              1.0).to(tw.dtype)


def _reg_fft_model(x, tw, p=None):
    """The register passes' transform of sub-FFTs x (..., M), step for
    step (sub_passes of fft_common.cuh), P points a thread (RegPlan's by
    default): pass 0 reads x[d + r*M/16] from global memory (d = lane +
    q*threads); pass PASS >= 1 reads the exchange buffer at point d +
    r*M/R and multiplies point r by the product, over the set bits b of r,
    of tw_at(e1 << b), e1 = (d mod NS)*M/(NS*R); each non-last pass writes
    point r to (d/NS)*NS*R + d mod NS + r*NS. Returns the last pass's
    registers v (..., threads, Q, R) and their bins d + r*M/R, with the
    (write, read) point indices of each exchange."""
    n = x.shape[-1]
    if p is None:
        p = _reg_plan(n)[0]
    th = n // p
    buf = torch.full(x.shape[:-1] + (n,), float("nan"), dtype=x.dtype)
    ns, exchanges, dst = 1, [], None
    for pas, r in enumerate(_radices(n)):
        j = torch.arange(th)[:, None] + torch.arange(p // r)[None, :] * th
        src = j[..., None] + torch.arange(r) * (n // r)       # (th, Q, R)
        if pas == 0:
            v = x[..., src]
        else:
            buf[..., dst] = v_prev
            exchanges.append((dst, src))
            v = buf[..., src]
            # tw_at(e1 << b) for each bit b of r, multiplied together
            e1 = (j & (ns - 1)) * (n // (ns * r))
            w = torch.ones(src.shape, dtype=tw.dtype)
            for b in range(r.bit_length() - 1):
                wb = _tw_at(tw, e1 << b, n)
                bit = ((torch.arange(r) >> b) & 1).bool()
                w[..., bit] = w[..., bit] * wb[..., None]
            v = v * w
        v = _dft_regs(v)
        dst = ((j // ns) * ns * r + (j & (ns - 1)))[..., None] \
            + torch.arange(r) * ns
        v_prev = v
        ns *= r
    return v, src, exchanges


def _four_step_model(x, tw, n1, n2):
    """The four-step split of fft_common.cuh on segments x (..., N1*N2),
    step for step, with the kernels' packed tables tw (W_N1^m, m < N1/2;
    W_N2^m, m < N2/2; W_N^l, l < N2). Launch 1 (fs_cols_kernel): column n2
    of x viewed (N1, N2) through the register passes (ColsPlan's points a
    thread), bin k1 times tw_at<N1>(n2*k1 >> log2 N2) * W_N^(n2*k1 mod N2)
    into Y[k1][n2]. Launch 2 (fs_rows_kernel): each row of Y through the
    register passes (16 points a thread); bin k2 of row k1 is X[k1 +
    N1*k2]. Returns X (..., N) in natural order."""
    n = n1 * n2
    tw1, tw2, twlo = tw[:n1 // 2], tw[n1 // 2:(n1 + n2) // 2], \
        tw[(n1 + n2) // 2:]
    assert len(twlo) == n2
    cols = x.reshape(x.shape[:-1] + (n1, n2)).transpose(-1, -2)
    v, k1, _ = _reg_fft_model(cols, tw1, p=_cols_plan(n1)[0])
    c = torch.arange(n2)[:, None, None, None]                 # column n2
    e = c * k1                                                # < N
    w = _tw_at(tw1, e >> (n2.bit_length() - 1), n1) * twlo[e & (n2 - 1)]
    y = torch.empty(x.shape[:-1] + (n1, n2), dtype=x.dtype)
    y[..., k1.expand_as(e), c.expand_as(e)] = v * w
    v, k2, _ = _reg_fft_model(y, tw2, p=_rows_plan(n2)[0])
    out = torch.empty(x.shape, dtype=x.dtype)
    rows = torch.arange(n1)[:, None, None, None]
    out[..., (rows + n1 * k2).expand(v.shape[-4:])] = v
    return out


def _reg_psd_model(samples_pm, starts_fn, ntime, *, nfft, nint, mode, ref,
                   dtype=torch.complex128):
    """reg_psd_kernel's whole column loop (fs_cols_kernel's and
    fs_rows_kernel's at a four-step size): the clamped start, the widened
    and windowed segments, |X|^2 summed per bin in segment order, the scale
    and the fftshifted store out[(k + N/2) mod N]."""
    from pyspectrogram_tpu_torch.kernels._build import psd_device_constants

    win, tw, inv_scale = psd_device_constants(
        nfft, nint, mode, ("kaiser", 1.7), ref, torch.device("cpu"))
    tw = torch.view_as_complex(tw.view(-1, 2)).to(dtype)
    nseg = nint if mode == "welch" else 1
    nsub, nsamp = samples_pm.shape[0] // 2, samples_pm.shape[1]
    out = torch.full((ntime, nsub, nfft), float("nan"), dtype=torch.float64)
    for t in range(ntime):
        st = min(max(int(starts_fn(t)), 0), nsamp - nseg * nfft)
        seg = samples_pm[:, st:st + nseg * nfft].to(torch.float64)
        c = torch.complex(seg[0::2], seg[1::2]).reshape(nsub, nseg, nfft)
        c = c.to(dtype) * win.to(torch.float64)
        if nfft in FOUR_STEP:
            v, bins = _four_step_model(c, tw, *FOUR_STEP[nfft]), \
                torch.arange(nfft)
        else:
            v, bins, _ = _reg_fft_model(c, tw)
        acc = torch.zeros(v.shape[:1] + v.shape[2:], dtype=torch.float64)
        for s in range(nseg):
            acc += v[:, s].real ** 2 + v[:, s].imag ** 2
        out[t][:, (bins + nfft // 2) & (nfft - 1)] = acc * inv_scale
    return out


def _half_warps_distinct(addr, banks=16):
    """Every 16 consecutive threads (addr's first axis) touch distinct
    ``banks`` slots (8-byte bank pairs) at every other index."""
    a = addr.reshape(addr.shape[0], -1)
    lanes = a.reshape(-1, 16, a.shape[1]) % banks
    return all(len(set(lanes[h, :, k].tolist())) == 16
               for h in range(lanes.shape[0]) for k in range(a.shape[1]))


@pytest.mark.parametrize("nfft", ONE_BLOCK + [32768, 65536, 131072, 262144,
                                              524288, 1048576])
def test_kernel_fft_index_plan(nfft):
    """The kernels' butterfly, twiddle and output-bin indexing is the DFT
    (the CUDA sources run only on the card; their plan is checked here):
    the one-block register passes up to 16384 points, the four-step split
    above, B4's (N1, N2) table up to 1024 x 1024 included."""
    from pyspectrogram_tpu_torch.kernels._build import (
        FOUR_STEP as BUILD_FOUR_STEP,
        twiddle_table,
    )

    assert BUILD_FOUR_STEP == FOUR_STEP
    rng = np.random.default_rng(nfft)
    x = rng.standard_normal(nfft) + 1j * rng.standard_normal(nfft)
    tw = torch.from_numpy(twiddle_table(nfft))
    if nfft in ONE_BLOCK:
        v, bins, _ = _reg_fft_model(torch.from_numpy(x), tw)
        plan = np.empty(nfft, complex)
        plan[bins.numpy().ravel()] = v.numpy().ravel()
    else:
        plan = _four_step_model(torch.from_numpy(x), tw,
                                *FOUR_STEP[nfft]).numpy()
    np.testing.assert_allclose(plan, torch.fft.fft(torch.from_numpy(x)),
                               rtol=0, atol=1e-9 * np.sqrt(nfft))


@pytest.mark.parametrize("nfft", ONE_BLOCK)
def test_reg_plan_layout(nfft):
    """The register plan's shape: 16-point passes with the small radix
    last, 16 points a thread (32 at 16384); every exchange writes each
    padded slot once and reads each written slot once, and a half-warp's
    16 accesses fall on 16 distinct 8-byte bank pairs; each thread's bins
    are distinct and cover the spectrum once, so every bin is stored
    once."""
    p, th, radices = _reg_plan(nfft)
    assert np.prod(radices) == nfft and th * p == nfft
    assert all(r == 16 for r in radices[:-1]) and radices[0] == 16
    tw = torch.exp(-2j * np.pi * torch.arange(nfft // 2,
                                              dtype=torch.float64) / nfft)
    _, bins, exchanges = _reg_fft_model(
        torch.zeros(nfft, dtype=torch.complex128), tw)
    assert len(exchanges) == len(radices) - 1
    assert sorted(bins.ravel().tolist()) == list(range(nfft))
    for wr, rd in exchanges:
        wr, rd = _rpad(wr), _rpad(rd)
        assert sorted(wr.ravel().tolist()) == sorted(rd.ravel().tolist())
        assert len(set(wr.ravel().tolist())) == nfft
        for idx in (wr, rd):          # (threads, Q, R): lanes along dim 0
            assert _half_warps_distinct(idx)


@pytest.mark.parametrize("nfft", sorted(FOUR_STEP))
def test_four_step_layout(nfft):
    """Both launches of the four-step split as fs_cols_kernel and
    fs_rows_kernel map them. Launch 1: 16 columns a block, thread (lane j,
    column b) at j*16 + b, point i of column b at i*16 + b. Launch 2: 8
    rows a block, thread b*T + j, point i of row b at b*PADM +
    rpad(i). For every batched pass: each exchange writes each slot once
    and reads each written slot once, and a half-warp's 16 accesses fall
    on 16 distinct 8-byte bank pairs. Global memory: a half-warp's pass-0
    loads and launch 1's stores are 16 adjacent elements, launch 2's
    stores whole 32-byte sectors, and every bin is stored once. Shared
    memory within a block's 227 KB."""
    n1, n2 = FOUR_STEP[nfft]
    zeros = torch.zeros
    # launch 1: columns
    p, c = _cols_plan(n1)
    th = n1 // p
    tw = torch.ones(n1 // 2, dtype=torch.complex128)
    _, k1, exchanges = _reg_fft_model(zeros(n1, dtype=torch.complex128), tw,
                                      p=p)
    assert len(exchanges) == len(_radices(n1)) - 1
    assert sorted(k1.ravel().tolist()) == list(range(n1))
    b = torch.arange(c)
    for wr, rd in exchanges:                      # (th, Q, R) point indices
        # thread j*c + b: the column b fastest
        aw = (wr[:, None] * c + b[:, None, None]).reshape(th * c, -1)
        ar = (rd[:, None] * c + b[:, None, None]).reshape(th * c, -1)
        assert sorted(aw.ravel().tolist()) == list(range(n1 * c))
        assert sorted(ar.ravel().tolist()) == list(range(n1 * c))
        assert _half_warps_distinct(aw) and _half_warps_distinct(ar)
    bufs = 2 if 2 * n1 * c * 8 <= 64 * 1024 else 1
    assert bufs * n1 * c * 8 <= 227 * 1024
    # pass 0 loads x[n2*(d + r*n1/16) + c0 + b] and the last pass stores
    # Y[k1][c0 + b]: a half-warp (one lane, 16 columns) is 16 adjacent
    # elements
    d = torch.arange(th)[:, None] + torch.arange(p // 16) * th
    load = (n2 * (d[:, None, :, None] + torch.arange(16) * (n1 // 16))
            + b[:, None, None]).reshape(th * c, -1)
    store = (k1[:, None] * n2 + b[:, None, None]).reshape(th * c, -1)
    for a in (load, store):
        h = a.reshape(-1, 16, a.shape[1])
        assert ((h - h[:, :1]) == torch.arange(16)[None, :, None]).all()
    # launch 2: rows
    p, g = _rows_plan(n2)
    th = n2 // p
    padm = n2 + n2 // 16
    tw = torch.ones(n2 // 2, dtype=torch.complex128)
    _, k2, exchanges = _reg_fft_model(zeros(n2, dtype=torch.complex128), tw,
                                      p=p)
    nth = g * th                                      # threads a block
    assert len(exchanges) == len(_radices(n2)) - 1
    rows = torch.arange(g)[:, None, None, None]
    for wr, rd in exchanges:
        # thread b*th + j: the lane fastest
        aw = (rows * padm + _rpad(wr)[None]).reshape(g * th, -1)
        ar = (rows * padm + _rpad(rd)[None]).reshape(g * th, -1)
        assert sorted(aw.ravel().tolist()) == sorted(ar.ravel().tolist())
        assert len(set(aw.ravel().tolist())) == g * n2
        assert _half_warps_distinct(aw) and _half_warps_distinct(ar)
    assert 2 * g * padm * 8 <= 227 * 1024
    assert g * (n2 + 32 // g) * 4 <= 2 * g * padm * 8
    d = torch.arange(th)[:, None] + torch.arange(p // 16) * th
    load = (rows * n2 + d[None, :, :, None]
            + torch.arange(16) * (n2 // 16)).reshape(g * th, -1)
    h = load.reshape(-1, 16, load.shape[1])
    assert ((h - h[:, :1]) == torch.arange(16)[None, :, None]).all()
    # the transposed store: element e = thread + i*threads of group k10 to
    # bin k10 + e mod g + n1*(e / g), fftshifted
    e = torch.arange(nth)[:, None] + torch.arange(p) * nth
    seen = torch.zeros(nfft, dtype=torch.int64)
    for k10 in range(0, n1, g):
        k = (k10 + e % g + n1 * (e // g) + nfft // 2) % nfft
        seen[k.ravel()] += 1
        sectors = (k.reshape(-1, 16, p) // 8)     # 32-byte sectors of floats
        for hw in range(sectors.shape[0]):
            for i in range(p):
                assert len(set(sectors[hw, :, i].tolist())) == 16 * 4 // 32
    assert (seen == 1).all()


@pytest.mark.parametrize("policy", ["array", "hop"])
@pytest.mark.parametrize("nfft", ONE_BLOCK + [32768])
def test_reg_psd_model_matches_plain(nfft, policy):
    """The model of reg_psd_kernel (the four-step split at 32768), with
    float32 twiddles and window as the kernels read them, against
    ops.plain.psd_torch (B1's and B3's plain version) at the kernels'
    tolerance: gathered starts clamped at both ends (B1, StartsArray) and
    t*hop (B3, StartsHop); welch over 3 segments, parity, float32 and int16
    planes."""
    rng = np.random.default_rng(nfft)
    ntime, nsub = 3, 2
    for mode, nint, dtype in (("welch", 3, "float32"), ("parity", 2, "int16")):
        fl = nfft * nint if mode == "welch" else nfft
        hop = 3 * nfft // 8 + 12
        nsamp = fl - hop + ntime * hop if policy == "hop" else fl * ntime + 77
        if dtype == "int16":
            x = torch.from_numpy(rng.integers(-2 ** 14, 2 ** 14, (
                2 * nsub, nsamp)).astype(np.int16))
            ref = 2.0 ** 15.5
        else:
            x = torch.from_numpy(rng.standard_normal(
                (2 * nsub, nsamp)).astype(np.float32))
            ref = 1.0
        if policy == "hop":
            starts = torch.arange(ntime, dtype=torch.int32) * hop
        else:
            starts = torch.tensor([-40, nsamp // 3, nsamp], dtype=torch.int32)
        got = _reg_psd_model(x, lambda t: starts[t], ntime, nfft=nfft,
                             nint=nint, mode=mode, ref=ref)
        want = plain.psd_torch(x, starts, nfft=nfft, nint=nint, mode=mode,
                               ref=ref)
        np.testing.assert_allclose(got.numpy(), want.numpy(), **LIN)


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


@pytest.mark.parametrize("mode,nint", [("welch", 2), ("parity", 2)])
def test_four_step_model_matches_pallas_big_kernel(mode, nint):
    """The four-step split's model (fs_cols_kernel then fs_rows_kernel, step
    for step, with the float32 window and twiddle tables the kernels read)
    as B4's PSD against the JAX package's 65536-point kernel (interpret
    mode) on gathered starts, at the tolerance the JAX package holds that
    kernel to: rtol 2e-3, plus 1e-4 of the column's mean (a white-noise
    bin's power is ~1/nfft)."""
    nfft, ntime, nsub = 1 << 16, 2, 1
    x, starts, _ = _planes(nfft, nint, ntime, nsub, "float32", seed=11)
    kernel = make_pallas_sti_psd(nfft=nfft, nint=nint, mode=mode,
                                 interpret=True)
    want = np.asarray(kernel(jnp.asarray(x), jnp.asarray(starts)))
    got = _reg_psd_model(torch.from_numpy(x), lambda t: starts[t], ntime,
                         nfft=nfft, nint=nint, mode=mode, ref=1.0).numpy()
    lim = 2e-3 * np.abs(want) + 1e-4 * want.mean(axis=-1, keepdims=True)
    assert np.abs(got - want).max() > 0      # two computations, not one
    assert (np.abs(got - want) <= lim).all(), np.abs(got - want).max()


@pytest.mark.parametrize("nfft,nint,ntime,cap_cols,want", [
    (32768, 4, 10, 3, [3, 3, 3, 1]),   # B1 at 32768: chunks of 3 columns
    (32768, 4, 7, 7, [7]),             # one chunk: the whole call
    (1 << 20, 1, 3, 0, [1, 1, 1]),     # a column over the cap: one a chunk
])
def test_four_step_chunks_cover_columns(monkeypatch, nfft, nint, ntime,
                                        cap_cols, want):
    """The column chunks of big_cuda.four_step_psd (B4, and B1 at 32768),
    with the launches recorded on the CPU: each chunk's workspace is at
    most WORKSPACE_MAX_BYTES (at least one column), the launch pairs take
    the columns once and in order, launch 2 writes each chunk's own rows
    of the output, and each pair adds one to the caller's count. At the
    default cap, B1 at 32768 x 4 with 1000 columns and two subchannels
    takes 512 columns a chunk (1 GiB of workspace, not 2 GB)."""
    nsub = 2
    col = nsub * nint * nfft * 8
    assert big_cuda.chunk_columns(1000, 2 * 4 * 32768 * 8,
                                  big_cuda.WORKSPACE_MAX_BYTES) == 512
    monkeypatch.setattr(big_cuda, "WORKSPACE_MAX_BYTES", cap_cols * col + 5)
    calls = []

    def cols(samples_pm, starts, nfft_, nseg, win, tw, work):
        assert work.numel() * 4 <= max(col, big_cuda.WORKSPACE_MAX_BYTES)
        calls.append(("cols", starts.clone()))

    def rows(work, nsub_, n, nfft_, nseg, tw, inv_scale, out):
        calls.append(("rows", n, out.data_ptr()))

    monkeypatch.setattr(big_cuda, "launch_cols", cols)
    monkeypatch.setattr(big_cuda, "launch_rows", rows)

    def caller():
        pass

    caller.launches = 0
    x = torch.zeros((2 * nsub, nfft * nint * ntime), dtype=torch.float32)
    starts = torch.arange(ntime, dtype=torch.int32) * nfft * nint
    out = big_cuda.four_step_psd(x, starts, nfft=nfft, nint=nint,
                                 mode="welch", window=("kaiser", 1.7),
                                 ref=1.0, counter=caller)
    assert out.shape == (ntime, nsub, nfft)
    assert [c[0] for c in calls] == ["cols", "rows"] * len(want)
    assert [len(c[1]) for c in calls[0::2]] == want
    assert torch.equal(torch.cat([c[1] for c in calls[0::2]]), starts)
    c0 = np.cumsum([0] + want[:-1])
    assert [c[1] for c in calls[1::2]] == want
    assert [c[2] for c in calls[1::2]] == [out[i].data_ptr() for i in c0]
    assert caller.launches == len(want)


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
