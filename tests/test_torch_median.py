"""Kernel B2's selection logic on the CPU, where the CUDA kernel cannot run.

:func:`radix_model` repeats csrc/median.cu's radix design step for step in
torch: the unsigned order keys, the per-column 8-bit digit histograms of
the keys that match the prefix (summed over the row chunks
kernels.median_cuda.radix_rows gives the grid, as the blocks' integer
atomics sum them), the select step's prefix and rank update, and the even-n
step (the k-th key's own bin, the next non-empty bin, or the least key above
the 24-bit prefix). The tile design's arithmetic is ops.plain.median_bisect
itself. Both are held bit for bit to median_bisect and to the JAX package's
median_over_time, and by value to np.median (which may return either sign
of a zero middle), on adversarial cubes: ties across the middle, +-0,
subnormals and +-inf, all-equal columns, odd and even n on both sides of the
designs' boundary, and a batch of 7 requests. XLA's CPU backend flushes
subnormals to zero in float arithmetic (the even-n mean), so on the cube
with subnormals the JAX result is held to the port's after the same flush.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pyspectrogram_tpu.ops import stft as jstft
from pyspectrogram_tpu_torch.kernels import median_cuda
from pyspectrogram_tpu_torch.ops import plain

U32 = 0xFFFFFFFF
#: the H100's SM count, for the model's row chunks
SMS = 132


def radix_key(x: torch.Tensor) -> torch.Tensor:
    """float32 -> its unsigned order key, held in int64."""
    b = x.contiguous().view(torch.int32).to(torch.int64) & U32
    return torch.where(b >= 0x80000000, b ^ U32, b ^ 0x80000000)


def radix_value(u: torch.Tensor) -> torch.Tensor:
    """Unsigned order key (int64) -> float32."""
    b = torch.where(u >= 0x80000000, u ^ 0x80000000, u ^ U32)
    b = torch.where(b >= 0x80000000, b - (1 << 32), b)
    return b.to(torch.int32).view(torch.float32)


def radix_model(p: torch.Tensor, batch: int = 1) -> torch.Tensor:
    """csrc/median.cu's radix design on a (batch * n, cols) float32 stack of
    ``batch`` requests' (n, cols) cubes -> (batch, cols)."""
    n = p.shape[0] // batch
    cols = p.shape[1]
    keys = radix_key(p).reshape(batch, n, cols).permute(1, 0, 2) \
        .reshape(n, batch * cols)
    rows = median_cuda.radix_rows(n, batch, cols, SMS)
    prefix = torch.zeros(batch * cols, dtype=torch.int64)
    rank = torch.full((batch * cols,), (n + 1) // 2, dtype=torch.int64)
    gmin = torch.full((batch * cols,), U32, dtype=torch.int64)
    idx = torch.arange(batch * cols)
    for shift in (24, 16, 8, 0):
        hi_mask = 0 if shift >= 24 else (U32 << (shift + 8)) & U32
        hist = torch.zeros(batch * cols, 256, dtype=torch.int64)
        for r0 in range(0, n, rows):          # one row chunk's blocks
            k = keys[r0:r0 + rows]
            match = ((k ^ prefix) & hi_mask) == 0
            part = torch.zeros_like(hist)
            part.scatter_add_(1, ((k >> shift) & 255).T, match.T.long())
            hist += part                      # the global atomics
            if shift == 0 and n % 2 == 0:
                above = ~match & ((k & hi_mask) > prefix)
                gmin = torch.minimum(gmin, torch.where(
                    above, k, torch.full_like(k, U32)).amin(dim=0))
        # select: the first bin whose running count reaches the rank
        cum = hist.cumsum(dim=1)
        d = (cum < rank[:, None]).sum(dim=1)
        below = torch.where(d > 0, cum[idx, (d - 1).clamp(min=0)], 0)
        in_bin = hist[idx, d]
        rank = rank - below
        prefix = prefix | (d << shift)
    v1 = radix_value(prefix)
    if n % 2:
        return v1.reshape(batch, cols)
    bins = torch.arange(256)
    nonempty = (hist > 0) & (bins[None, :] > d[:, None])
    nxt = torch.where(nonempty, bins[None, :], 256).amin(dim=1)
    key2 = torch.where(in_bin > rank, prefix,
                       torch.where(nxt < 256, (prefix & ~255) | nxt, gmin))
    v2 = radix_value(key2)
    v2 = torch.where(v2 == v1, v1, v2)
    return (0.5 * (v1 + v2)).reshape(batch, cols)


def _cube(kind: str, n: int, cols: int, seed: int) -> np.ndarray:
    """(n, cols) float32 adversarial cube."""
    rng = np.random.default_rng(seed)
    if kind == "exponential":
        return rng.exponential(size=(n, cols)).astype(np.float32)
    if kind == "ties":
        # few distinct values, so runs of equal values span the middle
        p = rng.integers(0, 4, (n, cols)).astype(np.float32)
        p[:, ::3] = np.float32(2.0)
        return p
    if kind == "specials":
        vals = np.array([-np.inf, -1.5, -1e-40, -1e-45, -0.0, 0.0, 1e-45,
                         1e-40, 1.17549435e-38, 3.0, np.inf], dtype=np.float32)
        p = vals[rng.integers(0, len(vals), (n, cols))]
        # columns that are half -0 and half +0, and zeros against subnormals
        p[:, 0] = np.where(np.arange(n) % 2, np.float32(-0.0), np.float32(0.0))
        p[:, 1] = np.where(np.arange(n) < n // 2, np.float32(-1e-45),
                           np.float32(0.0))
        return p.astype(np.float32)
    if kind == "equal":
        p = np.empty((n, cols), np.float32)
        p[:] = rng.exponential(size=cols).astype(np.float32)
        p[:, 0] = -0.0
        p[:, 1] = np.inf
        p[:, 2] = -np.inf
        return p
    raise ValueError(kind)


def _bits(x) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(x, np.float32)).view(np.int32)


def _assert_jax_equal(got, p, kind):
    """Bit-equal to the JAX median_over_time; by value after flushing
    subnormals to zero where the cube holds them."""
    want = np.asarray(jstft.median_over_time(jnp.asarray(p)))
    if kind != "specials":
        np.testing.assert_array_equal(_bits(got), _bits(want))
        return
    tiny = np.finfo(np.float32).tiny
    flush = lambda v: np.where(np.abs(v) < tiny, np.float32(0), v)  # noqa: E731
    assert np.array_equal(flush(np.asarray(got)), flush(want), equal_nan=True)


KINDS = ["exponential", "ties", "specials", "equal"]
NS = [33, 34, 127, 128, 129, 2047, 2048, 14649, 14650]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n", NS)
def test_radix_model_matches_plain_jax_and_numpy(n, kind):
    """The radix design's passes give median_bisect's bits, the JAX
    median_over_time's bits and np.median's values."""
    cols = 12 if n > 4096 else 40
    p = _cube(kind, n, cols, seed=n + len(kind))
    got = radix_model(torch.from_numpy(p))[0].numpy()
    plain_med = plain.median_bisect(torch.from_numpy(p)).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(plain_med))
    _assert_jax_equal(got, p, kind)
    assert np.array_equal(got, np.median(p, axis=0).astype(np.float32),
                          equal_nan=True)


@pytest.mark.parametrize("n", [100, 2048, 2049])
def test_radix_model_batch_of_seven(n):
    """A batch of 7 requests: each request's columns select on their own
    (the request index is a grid dimension), bit-equal to its solo plain
    median."""
    B, cols = 7, 24
    p = np.stack([_cube(KINDS[b % 4], n, cols, seed=10 * b + n)
                  for b in range(B)])
    got = radix_model(torch.from_numpy(p.reshape(B * n, cols)), batch=B)
    want = median_cuda.median_over_time_cuda(torch.from_numpy(p),
                                             batched=True)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    for b in range(B):
        assert np.array_equal(got[b].numpy(), np.median(p[b], axis=0),
                              equal_nan=True)


@pytest.mark.parametrize("n", NS)
def test_plain_median_on_adversarial_cubes(n):
    """The tile design's arithmetic (median_bisect, which the wrapper runs
    for a CPU tensor) on the same cubes: the JAX bits, np.median's values,
    through the wrapper and through ops.stft.median_over_time."""
    for kind in KINDS:
        p = _cube(kind, n, 16, seed=3 * n + len(kind))
        t = torch.from_numpy(p)
        got = median_cuda.median_over_time_cuda(t).numpy()
        _assert_jax_equal(got, p, kind)
        np.testing.assert_array_equal(
            _bits(got), _bits(plain.median_bisect(t).numpy()))
        assert np.array_equal(got, np.median(p, axis=0), equal_nan=True)


def test_zero_middles_keep_the_plain_sign():
    """Even n with -0 and +0 as the two middles: more than k values are <=
    -0 as floats, so v2 is v1 and the median is -0, in both designs — the
    key order alone would give +0."""
    p = np.zeros((34, 4), np.float32)
    p[:17] = -0.0
    got = radix_model(torch.from_numpy(p))[0]
    assert _bits(got).tolist() == [np.int32(-2 ** 31)] * 4
    np.testing.assert_array_equal(
        _bits(got), _bits(plain.median_bisect(torch.from_numpy(p))))


def test_regime_boundary():
    """The tile design takes n while n rows of 36 keys fit 96 KB of shared
    memory (682 rows); every row count above takes the radix design."""
    limit = median_cuda.TILE_MAX_BYTES // median_cuda.TILE_ROW_BYTES
    assert limit == 682
    assert median_cuda.regime(33) == median_cuda.regime(limit) == "tile"
    assert median_cuda.regime(limit + 1) == median_cuda.regime(14649) \
        == "radix"


@pytest.mark.parametrize("n,batch,cols", [
    (14649, 1, 8192), (2047, 1, 8192), (700, 7, 1024), (683, 1, 4),
    (10 ** 7, 1, 128), (5000, 3000, 1)])
def test_radix_rows_fill_the_card(n, batch, cols):
    """Row chunks: about 8 blocks per SM where the rows allow, no chunk
    under 64 rows unless n is, never more than 65,535 chunks."""
    rows = median_cuda.radix_rows(n, batch, cols, SMS)
    chunks = -(-n // rows)
    blocks = chunks * -(-cols // 128) * batch
    assert 1 <= chunks <= median_cuda.MAX_GRID_YZ
    assert rows >= min(n, median_cuda.RADIX_MIN_ROWS)
    assert blocks >= min(8 * SMS, max(1, n // 64) * -(-cols // 128) * batch)
    if (n, cols) == (14649, 8192):          # the live window
        assert (chunks, blocks) == (17, 1088)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    """Off the CPU the wrapper raises rather than falling back."""
    meta = torch.empty((40, 8), device="meta")
    with pytest.raises(ValueError, match="no median kernel"):
        median_cuda.median_over_time_cuda(meta)
    with pytest.raises(ValueError, match="no median kernel"):
        median_cuda.median_over_time_cuda(meta[None], batched=True)
