"""The port's distributed 4-step FFT (parallel.dist_fft) and big-FFT STI
(parallel.big_sti, StiPipeline's distributed-FFT tier) on four gloo ranks
of the CPU, against numpy and the JAX package's functions on meshes of
four of conftest's virtual CPU devices (the counterparts of
tests/test_dist_fft.py and tests/test_big_sti.py).

One spawn per file (tests/torch_mesh_ranks.py's "big" suite); each test
reads one case after checking that every rank returned the same. The
tolerances are the JAX tests': the distributed FFT within 2e-2 of max |X|
of numpy's (5e-6 for an impulse), the big-FFT STI within 2e-2 dB of the
one-device program and 0.2 dB through the pipeline on a tone capture
(test_big_sti.py:86-96 derives both), tiles within one level on at most
0.1% of pixels against the JAX package's jitted tiles. Those limits are
sized for the JAX package's bf16 stages; the port computes in float32, so
each case is also held to F32_REL, which a stage that slipped to bf16 or
TF32 (~1e-3 relative) fails.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import torch_mesh_ranks as R
from port_pairs import jax_config, jax_dataset, jax_spec
from pyspectrogram_tpu.kernels import sti_pallas
from pyspectrogram_tpu.models.sti import StiPipeline as JStiPipeline
from pyspectrogram_tpu.parallel import make_mesh as jmake_mesh
from pyspectrogram_tpu.parallel.big_sti import (
    frames_to_x2,
    make_bigfft_sti_fn,
    to_freq_order,
)
from pyspectrogram_tpu.parallel.dist_fft import split_for_devices
from pyspectrogram_tpu_torch.display.tile import make_tile_spec, tile_from_db
from pyspectrogram_tpu_torch.io.reader import RFDataset
from pyspectrogram_tpu_torch.ops import stft
from pyspectrogram_tpu_torch.utils.config import SpectrogramConfig


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, tone_capture):
    out = tmp_path_factory.mktemp("torch_big_ranks")
    return R.spawn("big", out, {"tone": str(tone_capture[0])})


def jmesh(tp, cp):
    return jmake_mesh(devices=jax.devices()[: tp * cp], time_parallel=tp,
                      chan_parallel=cp)


#: the port's float32 limit, as a fraction of the largest |X| (FFTs) or
#: of the largest linear power (STI outputs, compared in linear units)
F32_REL = 1e-5


def _fft_close(got, x):
    want = np.fft.fft(x)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2e-2 * np.abs(want).max())
    want = np.fft.fft(x.astype(np.complex128))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=F32_REL * np.abs(want).max())


def _f32_close(got_db, want_db):
    """Two dB arrays as linear powers, within F32_REL of the largest."""
    got, want = (10.0 ** (np.asarray(a, np.float64) / 10.0)
                 for a in (got_db, want_db))
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_REL * want.max())


@pytest.mark.parametrize("case,nfft,seed,ndev", [
    ("dist_fft_4096", 1 << 12, 0, 4),
    ("dist_fft_65536", 1 << 16, 0, 4),
    ("dist_fft_2x2", 1 << 12, 9, 2),           # a time axis of 2 in (2, 2)
    ("dist_fft_ceiling", 1 << 20, 11, 4),      # the reference's 2^20
])
def test_distributed_fft_matches_numpy(ranks, case, nfft, seed, ndev):
    got = R.case_result(ranks, case)
    assert got["n1n2"] == split_for_devices(nfft, ndev)
    _fft_close(got["got"], R.x_inputs(nfft, seed))


def test_distributed_fft_impulse_pins_bin_order(ranks):
    """delta[n0] -> exp(-2i pi k n0 / N): a different phase in every bin,
    so a wrong all-to-all layout or output order fails loudly."""
    got = R.case_result(ranks, "dist_fft_impulse")
    k = np.arange(1 << 12)
    for n0, x in got.items():
        np.testing.assert_allclose(x, np.exp(-2j * np.pi * k * n0 / k.size),
                                   atol=5e-6)


def test_distributed_fft_tone_pins_twiddle(ranks):
    got = R.case_result(ranks, "dist_fft_tone")
    nfft = 1 << 12
    for k0, x in got.items():
        assert np.argmax(np.abs(x)) == k0
        np.testing.assert_allclose(x[k0], nfft, rtol=1e-5)
        assert np.abs(np.delete(x, k0)).max() < 2e-3 * nfft


def test_distributed_fft_parseval(ranks):
    got = R.case_result(ranks, "dist_fft_parseval")["got"]
    x = R.x_inputs(1 << 14, 5)
    np.testing.assert_allclose(np.sum(np.abs(got) ** 2) / got.size,
                               np.sum(np.abs(x) ** 2), rtol=1e-5)


def _jax_bigfft(kind, mode="welch", precision="exact", tile=None,
                qparams=None):
    """The JAX package's big-FFT STI on the same frames, natural order."""
    pm, nfft, nint, ntime, nsub, ref = R.big_inputs(kind)
    fn = make_bigfft_sti_fn(jmesh(4, 1), "time", nfft=nfft, nint=nint,
                            mode=mode, ref=ref, precision=precision,
                            tile=tile)
    n1, n2 = fn.n1n2
    x2 = jax.device_put(jnp.asarray(frames_to_x2(
        R.frames_pm(pm, nfft, nint, fn.nseg, ntime, nsub), nfft, fn.nseg,
        n1, n2)), fn.input_sharding)
    out = fn(x2) if tile is None else fn(x2, qparams)
    return {k: np.asarray(v) if k == "tile" else to_freq_order(v)
            for k, v in out.items()}


@pytest.mark.parametrize("kind,mode", [("welch", "welch"),
                                       ("parity", "parity"),
                                       ("int16", "welch")])
def test_bigfft_sti_matches_jax(ranks, kind, mode):
    """Float k-matrix outputs in natural order against the JAX package's
    and the port's one-device program; int16 planes reach the ranks
    unwidened."""
    got = R.case_result(ranks, f"bigfft_{kind}")
    assert got["mesh"]["local_dtype"] == ("torch.int16" if kind == "int16"
                                          else "torch.float32")
    want = _jax_bigfft(kind, mode)
    for k in ("sxx_dbfs", "sxx_med_dbfs"):
        np.testing.assert_allclose(got["mesh"][k], want[k], atol=2e-2)
        np.testing.assert_allclose(got["mesh"][k], got["solo"][k],
                                   atol=2e-2)
        _f32_close(got["mesh"][k], got["solo"][k])


@pytest.mark.parametrize("precision", ["exact", "balanced", "display"])
def test_bigfft_precision_tiers_against_jax_exact(ranks, precision):
    """Every tier runs torch.fft stages in the port; each meets the JAX
    package's exact tier."""
    got = R.case_result(ranks, f"bigfft_{precision}")
    want = _jax_bigfft("tiers")
    np.testing.assert_allclose(got["mesh"]["sxx_dbfs"], want["sxx_dbfs"],
                               atol=2e-2)
    _f32_close(got["mesh"]["sxx_dbfs"], got["solo"]["sxx_dbfs"])


def test_bigfft_tile_mode(ranks):
    """Each rank gathers its own plot bins; the tile equals host
    quantization of the float tier's spectra and the JAX package's tile,
    a second colour range runs the same function, and a missing range
    refuses."""
    got = R.case_result(ranks, "bigfft_tile")
    assert got["same_fn"]
    assert "qparams" in got["error"]
    nfft = 1 << 12
    freqs = stft.shifted_freqs(nfft, 1_000_000)
    db = got["float"]["sxx_dbfs"]
    for tile, crange in zip(got["tiles"], ((-80.0, -20.0), (-90.0, -30.0))):
        spec = make_tile_spec(freqs, (-200.0, 200.0), crange)
        assert "sxx_dbfs" not in tile
        assert tile["sxx_med_dbfs"].shape == (2, nfft)
        np.testing.assert_array_equal(tile["tile"], tile_from_db(db, spec))
        np.testing.assert_array_equal(tile["sxx_med_dbfs"],
                                      got["float"]["sxx_med_dbfs"])
        js = jax_spec(spec)
        R.tiles_close(tile["tile"], _jax_bigfft(
            "tile", tile=js.crop_key(), qparams=js.qparams)["tile"])


@pytest.mark.parametrize("key", list(R.BIG_PIPELINES))
def test_pipeline_bigfft_tier(ranks, tone_capture, monkeypatch, key):
    """StiPipeline(mesh=) through the distributed-FFT tier (threshold
    lowered, kernel coverage taken away in the ranks, the fused kernel's
    in JAX) against the JAX package's pipeline and the port's one-device
    run: multi-subchannel on a (2, 2) mesh with nint 4 and odd ntime, and
    the display tile."""
    got = R.case_result(ranks, f"big_pipeline_{key}")
    assert got["use_bigfft"]
    shape, knobs = R.BIG_PIPELINES[key]
    cfg = SpectrogramConfig(**knobs)
    monkeypatch.setattr(sti_pallas, "pallas_supported",
                        lambda *a, **k: False)
    want = JStiPipeline(jax_dataset(RFDataset(tone_capture[0])),
                        jax_config(cfg), mesh=jmesh(*shape),
                        bigfft_threshold=cfg.nfft).compute()
    mesh, solo = got["mesh"], got["solo"]
    np.testing.assert_array_equal(mesh["frame_starts"], want.frame_starts)
    if cfg.display_tile:
        assert mesh["sxx_dbfs"] is None
        R.tiles_close(mesh["tile"], want.tile)
        spec = make_tile_spec(solo["freqs"], cfg.freq_window_khz,
                              cfg.color_range_db)
        R.tiles_close(mesh["tile"], tile_from_db(
            np.moveaxis(solo["sxx_dbfs"], 0, -1), spec))
    else:
        assert mesh["sxx_dbfs"].shape == (cfg.nfft, cfg.ntime, 2)
        np.testing.assert_allclose(mesh["sxx_dbfs"], want.sxx_dbfs,
                                   atol=0.2)
        np.testing.assert_allclose(mesh["sxx_dbfs"], solo["sxx_dbfs"],
                                   atol=0.2)
        _f32_close(mesh["sxx_dbfs"], solo["sxx_dbfs"])
    np.testing.assert_allclose(mesh["sxx_med_dbfs"], want.sxx_med_dbfs,
                               atol=0.2)
    np.testing.assert_allclose(mesh["sxx_med_dbfs"], solo["sxx_med_dbfs"],
                               atol=0.2)
    _f32_close(mesh["sxx_med_dbfs"], solo["sxx_med_dbfs"])


def test_tier_choice(ranks):
    """The port column-shards wherever its kernels cover nfft (every power
    of two to 2^20, any nsub) and the plane pairs divide over chan; the
    JAX package asks its fused kernel's VMEM budget, which 16
    subchannels at 2^18 overflow."""
    got = R.case_result(ranks, "tier_choice")
    assert got == {"2^18_nsub1": False, "2^18_nsub16": False,
                   "2^18_nsub3_chan2": True, "4096_nsub16": False}
    assert not sti_pallas.pallas_supported(1 << 18, 1, 16)
    assert sti_pallas.pallas_supported(1 << 18, 1, 1)


def test_to_freq_order_roundtrip():
    from pyspectrogram_tpu_torch.parallel.big_sti import (
        to_freq_order as port_order)

    a = np.arange(24.0).reshape(2, 3, 4)
    out = port_order(a)
    assert out.shape == (2, 12)
    for k1 in range(3):
        for k2 in range(4):
            assert out[0, 3 * k2 + k1] == a[0, k1, k2]
    np.testing.assert_array_equal(out, to_freq_order(a))
