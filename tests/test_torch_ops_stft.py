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
    """fft_impl="gemm" (the JAX package's GEMM DFT) is not ported and
    says so; a bad mode, fft_impl or compute dtype raises as in JAX."""
    with pytest.raises(ValueError, match="gemm"):
        stft.make_sti_fn(nfft=256, fft_impl="gemm")
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

#: the one-block register-pass kernel's sizes (csrc/fft_common.cuh,
#: reg_psd_kernel): B1 and B3 up to 16384 points
ONE_BLOCK = [256, 512, 1024, 2048, 4096, 8192, 16384]


def _reg_plan(n):
    """RegPlan of fft_common.cuh: (points per thread P, threads, radices
    first to last): radix-16 passes, the small radix last."""
    p = 32 if n >= 16384 else 16
    a = (n.bit_length() - 1) // 4
    tail = n >> (4 * a)
    return p, n // p, [16] * a + ([tail] if tail > 1 else [])


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


def _reg_fft_model(x, tw):
    """reg_psd_kernel's transform of windowed segments x (..., N), step for
    step: pass 0 reads x[j + r*N/16] from global memory (j = thread +
    q*threads); pass PASS >= 1 reads the exchange buffer at rpad(j +
    r*N/R) and multiplies point r by the product, over the set bits b of
    r, of tw_at(e1 << b) (tw[e mod N/2], negated when e has bit N/2),
    e1 = (j mod NS)*N/(NS*R); each non-last pass writes point r to
    rpad((j/NS)*NS*R + j mod NS + r*NS). Returns the last pass's
    registers v (..., threads, Q, R) and their bins j + r*N/R, with the
    (write, read) buffer indices of each exchange."""
    n = x.shape[-1]
    p, th, radices = _reg_plan(n)
    buf = torch.full(x.shape[:-1] + (_rpad(n - 1) + 1,), float("nan"),
                     dtype=x.dtype)
    ns, exchanges, dst = 1, [], None
    for pas, r in enumerate(radices):
        j = torch.arange(th)[:, None] + torch.arange(p // r)[None, :] * th
        src = j[..., None] + torch.arange(r) * (n // r)       # (th, Q, R)
        if pas == 0:
            v = x[..., src]
        else:
            buf[..., _rpad(dst)] = v_prev
            exchanges.append((_rpad(dst), _rpad(src)))
            v = buf[..., _rpad(src)]
            # tw_at(e1 << b) for each bit b of r, multiplied together
            e1 = (j & (ns - 1)) * (n // (ns * r))
            w = torch.ones(src.shape, dtype=tw.dtype)
            for b in range(r.bit_length() - 1):
                e = e1 << b
                wb = tw[e & (n // 2 - 1)] * torch.where(
                    (e & (n // 2)) > 0, -1.0, 1.0).to(tw.dtype)
                bit = ((torch.arange(r) >> b) & 1).bool()
                w[..., bit] = w[..., bit] * wb[..., None]
            v = v * w
        v = _dft_regs(v)
        dst = ((j // ns) * ns * r + (j & (ns - 1)))[..., None] \
            + torch.arange(r) * ns
        v_prev = v
        ns *= r
    return v, src, exchanges


def _reg_psd_model(samples_pm, starts_fn, ntime, *, nfft, nint, mode, ref,
                   dtype=torch.complex128):
    """reg_psd_kernel's whole column loop: the clamped start, the widened
    and windowed segments, |X|^2 summed per thread bin in segment order,
    the scale and the fftshifted store out[(k + N/2) mod N]."""
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
        v, bins, _ = _reg_fft_model(c.to(dtype) * win.to(torch.float64), tw)
        acc = torch.zeros(v.shape[:1] + v.shape[2:], dtype=torch.float64)
        for s in range(nseg):
            acc += v[:, s].real ** 2 + v[:, s].imag ** 2
        out[t][:, (bins + nfft // 2) & (nfft - 1)] = acc * inv_scale
    return out


@pytest.mark.parametrize("nfft", ONE_BLOCK + [32768, 65536, 131072, 262144,
                                              524288, 1048576])
def test_kernel_fft_index_plan(nfft):
    """The kernels' butterfly, twiddle and output-bin indexing is the DFT
    (the CUDA sources run only on the card; their plan is checked here):
    the one-block register passes up to 16384 points, the four-step split
    above, B4's (N1, N2) table up to 1024 x 1024 included."""
    rng = np.random.default_rng(nfft)
    x = rng.standard_normal(nfft) + 1j * rng.standard_normal(nfft)
    if nfft in ONE_BLOCK:
        tw = torch.exp(-2j * np.pi * torch.arange(nfft // 2,
                                                  dtype=torch.float64) / nfft)
        v, bins, _ = _reg_fft_model(torch.from_numpy(x), tw)
        plan = np.empty(nfft, complex)
        plan[bins.numpy().ravel()] = v.numpy().ravel()
    else:
        plan = _four_step_numpy(x, *FOUR_STEP[nfft])
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
        assert sorted(wr.ravel().tolist()) == sorted(rd.ravel().tolist())
        assert len(set(wr.ravel().tolist())) == nfft
        for idx in (wr, rd):          # (threads, Q, R): lanes along dim 0
            for q in range(idx.shape[1]):
                for r in range(idx.shape[2]):
                    lanes = idx[:, q, r].reshape(-1, 16) % 16
                    assert all(len(set(h.tolist())) == 16 for h in lanes)


@pytest.mark.parametrize("policy", ["array", "hop"])
@pytest.mark.parametrize("nfft", ONE_BLOCK)
def test_reg_psd_model_matches_plain(nfft, policy):
    """The model of reg_psd_kernel, with float32 twiddles and window as
    the kernel reads them, against ops.plain.psd_torch (B1's and B3's
    plain version) at the kernels' tolerance: gathered starts clamped at
    both ends (B1, StartsArray) and t*hop (B3, StartsHop); welch over 3
    segments, parity, float32 and int16 planes."""
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
