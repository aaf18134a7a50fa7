"""The PyTorch port's batched STI (models.batch, CPU) against the JAX
package's, and kernel B2's batched plain version against np.median.

Times, frame starts, masks and plot axes must be exact. Spectra: dB within
1e-4 dB on bins within 30 dB (noise planes) or 60 dB (tone captures) of
each column's peak; linear power at rtol 2e-4, atol 1e-6. uint8 tiles are
bit-equal to the eager JAX quantize of the same linear power, and within
one level on <= 0.1% of pixels against the jitted JAX launch (two float32
FFTs land on either side of a level boundary there). The port reads the
captures with its own reader and config; the JAX side gets its own
(port_pairs).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from port_pairs import jax_config, jax_requests, jax_spec
from pyspectrogram_tpu.display.tile import (
    quantize_tile_linear as jquantize_tile_linear,
)
from pyspectrogram_tpu.models import batch as jbatch
from pyspectrogram_tpu_torch.display.tile import make_tile_spec
from pyspectrogram_tpu_torch.io.reader import RFDataset
from pyspectrogram_tpu_torch.kernels import median_cuda
from pyspectrogram_tpu_torch.models import batch, sti
from pyspectrogram_tpu_torch.ops import plain, stft
from pyspectrogram_tpu_torch.utils.config import SpectrogramConfig


def _db_close(got, want, floor_db, axis=-1, atol=1e-4):
    keep = want >= want.max(axis=axis, keepdims=True) - floor_db
    np.testing.assert_allclose(got[keep], want[keep], atol=atol, rtol=0)


def _tiles_close(got, want):
    d = np.abs(got.astype(int) - want.astype(int))
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert d.max() <= 1 and np.count_nonzero(d) <= 1e-3 * d.size


@pytest.mark.parametrize("n", [16, 33, 40, 41])
def test_batched_median_matches_np_median(n):
    """Per-request medians of a (B, n, nsub, nfft) batch, bit-equal to
    np.median for odd and even n: the kernel's plain version for n > 32,
    the network on axis 1 below."""
    rng = np.random.default_rng(n)
    p = rng.exponential(size=(3, n, 2, 64)).astype(np.float32)
    p[1, : n // 3, :, :16] = p[1, n // 3, :, :16]     # duplicates
    want = np.median(p, axis=1).astype(np.float32)
    got = stft.median_over_time_batched(torch.from_numpy(p)).numpy()
    np.testing.assert_array_equal(got, want)
    got_k = median_cuda.median_over_time_cuda(torch.from_numpy(p),
                                              batched=True).numpy()
    np.testing.assert_array_equal(got_k, want)
    for b in range(3):
        np.testing.assert_array_equal(
            plain.median_bisect(torch.from_numpy(p[b])).numpy(), want[b])


def _merged_planes(B, nsub, ntime, frame_len, seed):
    rng = np.random.default_rng(seed)
    blocks = rng.standard_normal((B, 2 * nsub, ntime * frame_len))
    return np.concatenate(list(blocks.astype(np.float32)), axis=1)


@pytest.mark.parametrize("tile", [False, True])
@pytest.mark.parametrize("ntime", [16, 40])
def test_batched_fn_matches_jax(ntime, tile):
    """make_batched_sti_fn_pm on merged noise planes with per-request
    refs (and colour ranges) against the JAX function."""
    nfft, nint, nsub, B = 256, 2, 2, 3
    merged = _merged_planes(B, nsub, ntime, nfft * nint, ntime)
    refs = np.asarray([1.0, 2.0 ** 15.5, 0.5], np.float32)
    inv = (1.0 / refs ** 2).astype(np.float32)
    kw = dict(nfft=nfft, nint=nint, ntime=ntime)
    spec = qp = None
    if tile:
        spec = make_tile_spec(stft.shifted_freqs(nfft, 1e6), (-300.0, 350.0),
                              (-40.0, 10.0), max_nfreqs=nfft // 4)
        qp = np.stack([make_tile_spec(stft.shifted_freqs(nfft, 1e6),
                                      (-300.0, 350.0), cr,
                                      max_nfreqs=nfft // 4).qparams
                       for cr in ((-40.0, 10.0), (-130.0, -80.0),
                                  (-35.0, 0.0))])
    want = jbatch.make_batched_sti_fn_pm(tile=jax_spec(spec), **kw)(
        *((jnp.asarray(merged), jnp.asarray(inv))
          + ((qp,) if tile else ())))
    got = batch.make_batched_sti_fn_pm(tile=spec, **kw)(
        torch.from_numpy(merged), inv, qp)
    assert set(got) == set(want)
    _db_close(got["sxx_med_dbfs"].numpy(), np.asarray(want["sxx_med_dbfs"]),
              30.0)
    if not tile:
        g = got["sxx_dbfs"].numpy()
        assert g.shape == (B, ntime, nsub, nfft)
        _db_close(g, np.asarray(want["sxx_dbfs"]), 30.0)
        return
    g = got["tile"].numpy()
    assert g.shape == (B, ntime, nsub, spec.plot_n)
    _tiles_close(g, np.asarray(want["tile"]))
    # bit-equal to the eager JAX quantize of the port's own linear power
    starts = torch.arange(B * ntime, dtype=torch.int32) * nfft * nint
    p = plain.psd_torch(torch.from_numpy(merged), starts, nfft=nfft,
                        nint=nint).reshape(B, ntime, nsub, nfft)
    p = (p * torch.from_numpy(inv)[:, None, None, None]).numpy()
    for b in range(B):
        np.testing.assert_array_equal(
            g[b], np.asarray(jquantize_tile_linear(
                jnp.asarray(p[b]), jax_spec(spec), 1e-15, qp[b])))


def test_batched_fn_rejects_wrong_length():
    fn = batch.make_batched_sti_fn_pm(nfft=256, ntime=4)
    with pytest.raises(ValueError, match="merged length"):
        fn(torch.zeros((2, 256 * 4 * 2 + 1)), np.ones(2, np.float32))


def _requests(tone_capture, int16_capture):
    """Three one-subchannel requests: two subchannels of the complex64
    tone capture (1 MS/s, ref 1) and the int16 one (250 kS/s, its integer
    full-scale ref) — mixed storage dtypes, per-request refs."""
    tone = RFDataset(tone_capture[0])
    i16 = RFDataset(int16_capture[0])
    chan = tone.channels[0]
    return [(tone, f"{chan}:0"), (tone, f"{chan}:1"), (i16, None)]


def _check_axes(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.iteration == w.iteration == 0
        for f in ("times", "freqs", "frame_starts", "mask"):
            np.testing.assert_array_equal(getattr(g, f), getattr(w, f))
        assert g.sample_rate == w.sample_rate
        _db_close(g.sxx_med_dbfs, w.sxx_med_dbfs, 60.0, axis=0)


@pytest.mark.parametrize("prefetch", [False, True])
@pytest.mark.parametrize("ntime", [16, 40])
def test_batched_pipeline_matches_jax(tone_capture, int16_capture,
                                      monkeypatch, ntime, prefetch):
    """Float output over mixed dtypes and refs, through the host merge and
    (with the threshold lowered) the prefetch branch."""
    reqs = _requests(tone_capture, int16_capture)
    cfg = SpectrogramConfig(nfft=256, nint=2, ntime=ntime)
    want = jbatch.BatchedStiPipeline(jax_requests(reqs),
                                     jax_config(cfg)).compute()
    if prefetch:
        monkeypatch.setattr(batch, "BATCH_PREFETCH_MIN_BYTES", 1)
    got = batch.BatchedStiPipeline(reqs, cfg, device="cpu").compute()
    _check_axes(got, want)
    for g, w in zip(got, want):
        assert g.tile is None and g.sxx_dbfs.shape == w.sxx_dbfs.shape
        _db_close(g.sxx_dbfs, w.sxx_dbfs, 60.0, axis=0)


def test_prefetch_branch_equals_host_merge(tone_capture, int16_capture,
                                          monkeypatch):
    """Both assembly branches hand the launch the same merged buffer:
    results equal bit for bit, the mixed-dtype promotion included."""
    reqs = _requests(tone_capture, int16_capture)[::-1]   # int16 first
    cfg = SpectrogramConfig(nfft=256, nint=1, ntime=40)
    want = batch.BatchedStiPipeline(reqs, cfg, device="cpu").compute()
    monkeypatch.setattr(batch, "BATCH_PREFETCH_MIN_BYTES", 1)
    got = batch.BatchedStiPipeline(reqs, cfg, device="cpu").compute()
    for g, w in zip(got, want):
        for f in ("sxx_dbfs", "sxx_med_dbfs", "mask", "frame_starts"):
            np.testing.assert_array_equal(getattr(g, f), getattr(w, f))


@pytest.mark.parametrize("ntime", [16, 40])
def test_batched_tile_pipeline_matches_jax(tone_capture, int16_capture,
                                           ntime):
    """Tile mode with per-request colour ranges: one shared crop plan (a
    window wider than every Nyquist keeps all bins at either rate)."""
    reqs = _requests(tone_capture, int16_capture)
    cfg = SpectrogramConfig(nfft=256, nint=1, ntime=ntime, display_tile=True)
    cranges = [(-110.0, -40.0), (-95.0, -25.0), (-60.0, 0.0)]
    want = jbatch.BatchedStiPipeline(jax_requests(reqs), jax_config(cfg)) \
        .compute(color_ranges=cranges)
    got = batch.BatchedStiPipeline(reqs, cfg, device="cpu").compute(
        color_ranges=cranges)
    _check_axes(got, want)
    for g, w in zip(got, want):
        assert g.sxx_dbfs is None and w.sxx_dbfs is None
        np.testing.assert_array_equal(g.plot_freqs, w.plot_freqs)
        _tiles_close(g.tile, w.tile)


def test_merged_equals_solo(tone_capture):
    """At ref 1 a merged request runs the same PSD on the same samples as
    its solo request: tile and median equal to StiPipeline.compute()."""
    ds = RFDataset(tone_capture[0])
    chan = ds.channels[0]
    cfg = SpectrogramConfig(nfft=256, nint=1, ntime=40, display_tile=True)
    cranges = [(-110.0 - i, -40.0) for i in range(3)]
    reqs = [(ds, None)] * 3
    got = batch.BatchedStiPipeline(reqs, cfg, device="cpu").compute(
        color_ranges=cranges)
    assert ds.ref_dict[chan] == 1.0
    for g, cr in zip(got, cranges):
        want = sti.StiPipeline(ds, cfg.replace(color_range_db=cr),
                               device="cpu").compute()
        np.testing.assert_array_equal(g.tile, want.tile)
        np.testing.assert_array_equal(g.sxx_med_dbfs, want.sxx_med_dbfs)


def test_refuses_mixed_subchannel_counts(tone_capture, int16_capture):
    reqs = [(RFDataset(tone_capture[0]), None),
            (RFDataset(int16_capture[0]), None)]     # nsub 2 and 1
    cfg = SpectrogramConfig(nfft=256, ntime=8)
    for make in (lambda: jbatch.BatchedStiPipeline(jax_requests(reqs),
                                                   jax_config(cfg)),
                 lambda: batch.BatchedStiPipeline(reqs, cfg, device="cpu")):
        with pytest.raises(ValueError, match="subchannel"):
            make().compute()


def test_refuses_differing_crop_plans(tone_capture, int16_capture):
    """A window narrower than both Nyquists keeps a different bin count
    at 1 MS/s and 250 kS/s: two crop plans, refused in tile mode."""
    reqs = _requests(tone_capture, int16_capture)
    cfg = SpectrogramConfig(nfft=256, ntime=8, display_tile=True,
                            freq_window_khz=(-20.0, 20.0))
    for make in (lambda: jbatch.BatchedStiPipeline(jax_requests(reqs),
                                                   jax_config(cfg)),
                 lambda: batch.BatchedStiPipeline(reqs, cfg, device="cpu")):
        with pytest.raises(ValueError, match="crop plan"):
            make().compute()


def test_empty_window_falls_back_to_float(tone_capture, int16_capture):
    """A frequency window that keeps no bins makes no tile: the float
    path runs, as in JAX."""
    reqs = _requests(tone_capture, int16_capture)
    cfg = SpectrogramConfig(nfft=256, ntime=8, display_tile=True,
                            freq_window_khz=(-1e5, -9e4))
    want = jbatch.BatchedStiPipeline(jax_requests(reqs),
                                     jax_config(cfg)).compute()
    got = batch.BatchedStiPipeline(reqs, cfg, device="cpu").compute()
    _check_axes(got, want)
    for g, w in zip(got, want):
        assert g.tile is None and w.tile is None
        _db_close(g.sxx_dbfs, w.sxx_dbfs, 60.0, axis=0)


def test_cuda_device_raises_without_gpu(tone_capture):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        batch.BatchedStiPipeline([(RFDataset(tone_capture[0]), None)],
                                 SpectrogramConfig(), device="cuda")
