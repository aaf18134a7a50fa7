"""The port's multi-rank tier (parallel.mesh, parallel.sharded,
ops.stft.median_over_time_psum, models.batch.make_batched_sti_fn_mesh,
StiPipeline(mesh=), BatchedStiPipeline(mesh=)) on four gloo ranks of the
CPU, held against the JAX package's functions on meshes of four of
conftest's virtual CPU devices, on the same numpy inputs and captures
(the counterparts of tests/test_parallel.py).

One spawn per file: a module-scoped fixture runs every case of
tests/torch_mesh_ranks.py's "parallel" suite on the four ranks, and each
test below reads one case, after checking that every rank returned the
same. Tolerances are the standing ones: dB 1e-4 on bins within 30 dB
(noise) or 60 dB (tones) of their column's peak, medians bit-equal to
np.median, tiles within one level on at most 0.1% of pixels against the
JAX package's jitted tiles.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import PartitionSpec as P

import torch_mesh_ranks as R
from port_pairs import jax_config, jax_dataset, jax_requests, jax_spec
from pyspectrogram_tpu.models import batch as jbatch
from pyspectrogram_tpu.models.sti import StiPipeline as JStiPipeline
from pyspectrogram_tpu.ops import stft as jstft
from pyspectrogram_tpu.parallel import make_mesh as jmake_mesh
from pyspectrogram_tpu.parallel import make_sharded_sti_fn as jsharded_fn
from pyspectrogram_tpu.parallel import sharded as jsharded
from pyspectrogram_tpu.parallel.mesh import pad_contiguous_block, pad_starts
from pyspectrogram_tpu_torch.io.reader import RFDataset
from pyspectrogram_tpu_torch.models import BatchedStiPipeline, StiPipeline
from pyspectrogram_tpu_torch.parallel import make_mesh
from pyspectrogram_tpu_torch.utils.config import SpectrogramConfig


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, tone_capture, int16_capture):
    out = tmp_path_factory.mktemp("torch_parallel_ranks")
    return R.spawn("parallel", out, {"tone": str(tone_capture[0]),
                                     "int16": str(int16_capture[0])})


def jmesh(tp, cp):
    return jmake_mesh(devices=jax.devices()[: tp * cp], time_parallel=tp,
                      chan_parallel=cp)


def _placed(fn, *host):
    """Host arrays placed with a JAX factory's input shardings."""
    return [jax.device_put(jnp.asarray(a), s)
            for a, s in zip(host, fn.input_shardings())]


def _host(out: dict) -> dict:
    return {k: np.asarray(v) for k, v in out.items()}


def test_mesh_shapes_and_errors(ranks):
    got = R.case_result(ranks, "mesh_shapes", per_rank=("coords",))
    assert got["default"] == (4, 1)
    assert got["2x2"] == got["chan2"] == (2, 2)
    assert got["names"] == ("time", "chan")
    assert got["device"] == "cpu"
    # a rank's coordinates on the (2, 2) mesh, rank-major as JAX lays out
    assert [r["mesh_shapes"]["coords"] for r in ranks] == [
        (0, 0), (0, 1), (1, 0), (1, 1)]
    with pytest.raises(ValueError) as e:
        jmake_mesh(devices=jax.devices()[:4], time_parallel=3)
    assert got["error"] == str(e.value)


def test_make_mesh_needs_a_process_group():
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_mesh("cpu")


def test_pipelines_on_cuda_without_a_card_raise():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    cfg = SpectrogramConfig()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StiPipeline(None, cfg, "cuda", mesh=object())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BatchedStiPipeline([], cfg, "cuda", mesh=object())


@pytest.mark.parametrize("layout", ["gathered", "contiguous"])
@pytest.mark.parametrize("mode", ["welch", "parity"])
@pytest.mark.parametrize("tp,cp", [(2, 2), (4, 1)])
def test_sharded_matches_jax(ranks, tp, cp, mode, layout):
    """Gathered (buffer replicated over time) and contiguous (buffer
    sharded over both axes) tiers against the JAX package's, and against
    the port's one-device program."""
    got = R.case_result(ranks, f"sharded_{tp}x{cp}_{mode}_{layout}")
    contiguous = layout == "contiguous"
    pm, starts = R.sharded_inputs(contiguous)
    fn = jsharded_fn(jmesh(tp, cp), nfft=64, nint=2, ntime_valid=16,
                     mode=mode, contiguous=contiguous)
    want = _host(fn(*_placed(fn, pm, starts)))
    assert got["specs"] == tuple(tuple(s.spec) for s in
                                 fn.input_shardings())
    for k in ("sxx_dbfs", "sxx_med_dbfs"):
        R.db_close(got["mesh"][k], want[k], 30.0)
        R.db_close(got["mesh"][k], got["solo"][k], 30.0)


def test_padded_time_axis(ranks):
    """ntime 13 over four time ranks: the gathered tier repeats the last
    start, the contiguous one extends the ladder into zeros; padding stays
    out of the median."""
    got = R.case_result(ranks, "padded")
    assert got["padded_len"] == 16 and got["contiguous_shape"] == (4, 1024)
    mesh = jmesh(4, 1)
    _, pm = R.buffer(64 * 13 + 200, 2, seed=3)
    starts = np.linspace(0, pm.shape[1] - 64, 13, dtype=np.int32)
    padded, nvalid = pad_starts(starts, 4)
    fn = jsharded_fn(mesh, nfft=64, ntime_valid=nvalid)
    want = _host(fn(jnp.asarray(pm), jnp.asarray(padded)))
    _, pm_c = R.buffer(64 * 13, 2, seed=12)
    pm_p, starts_p, nvalid_c = pad_contiguous_block(pm_c, 13, 64, 4)
    fn_c = jsharded_fn(mesh, nfft=64, ntime_valid=nvalid_c, contiguous=True)
    want_c = _host(fn_c(*_placed(fn_c, pm_p, starts_p)))
    for g, w in ((got["gathered"], want), (got["contiguous"], want_c)):
        R.db_close(g["sxx_dbfs"][:13], w["sxx_dbfs"][:13], 30.0)
        R.db_close(g["sxx_med_dbfs"], w["sxx_med_dbfs"], 30.0)


def test_int16_planes_widen_per_shard(ranks):
    got = R.case_result(ranks, "int16")
    assert got["local_dtype"] == "int16"
    pm, starts = R.int16_inputs()
    fn = jsharded_fn(jmesh(2, 2), nfft=64, ntime_valid=16, ref=2.0 ** 15.5)
    want = _host(fn(*_placed(fn, pm, starts)))
    for k in ("sxx_dbfs", "sxx_med_dbfs"):
        R.db_close(got["mesh"][k], want[k], 30.0)


def test_tile_epilogue_and_missing_qparams(ranks):
    """Each rank quantizes its own columns; the colour range is a runtime
    operand (one function for both ranges), and omitting it names the
    contract as the JAX package does."""
    got = R.case_result(ranks, "tile")
    assert got["specs"] == 3 and got["same_fn"]
    pm, starts = R.sharded_inputs(True, nint=1, nsub=2, seed=14)
    specs = [jax_spec(s) for s in R.tile_spec()]
    fn = jsharded_fn(jmesh(2, 2), nfft=64, ntime_valid=16, contiguous=True,
                     tile=specs[0].crop_key())
    for tile, spec in zip(got["tiles"], specs):
        assert set(tile) == {"tile", "sxx_med_dbfs"}
        want = _host(fn(*_placed(fn, pm, starts, spec.qparams)))
        R.tiles_close(tile["tile"], want["tile"])
        R.db_close(tile["sxx_med_dbfs"], want["sxx_med_dbfs"], 30.0)
    with pytest.raises(ValueError) as e:
        fn(jnp.asarray(pm), jnp.asarray(starts))
    assert got["error"] == str(e.value)


@pytest.mark.parametrize("case,nvalid,tp,cp,window", [
    ("psum_13_4x1", 13, 4, 1, None),      # odd: the exact middle
    ("psum_16_4x1", 16, 4, 1, None),      # even: the mean of two
    ("psum_13_2x2", 13, 2, 2, None),      # replicated over chan
    ("psum_window_4x1", 16, 4, 1, (3, 11)),   # a row window across ranks
])
def test_median_psum_is_numpy_median(ranks, case, nvalid, tp, cp, window):
    """The summed bisection equals np.median bit for bit, padding masked,
    and the JAX package's psum median."""
    got = R.case_result(ranks, case)["median"]
    p = R.psum_inputs(nvalid)
    rows = p[window[0]:window[1]] if window else p[:nvalid]
    np.testing.assert_array_equal(got, np.median(rows, axis=0))
    fn = jax.jit(shard_map(
        lambda x: jstft.median_over_time_psum(
            x, "time", None if window else nvalid, window),
        mesh=jmesh(tp, cp), in_specs=P("time", None, None), out_specs=P()))
    np.testing.assert_array_equal(got, np.asarray(fn(jnp.asarray(p))))


def test_psum_tier_equals_gathered(ranks):
    """The budget patched to 0 sends the sharded STI's median through the
    summed bisection: the same bits as the gathered median."""
    got = R.case_result(ranks, "psum_tier")
    for k in ("sxx_dbfs", "sxx_med_dbfs"):
        np.testing.assert_array_equal(got["psum"][k], got["gathered"][k])
    _, pm = R.buffer(64 * 13 + 200, 2, seed=9)
    starts = np.linspace(0, pm.shape[1] - 64, 13, dtype=np.int32)
    padded, nvalid = pad_starts(starts, 4)
    want = _host(jsharded_fn(jmesh(4, 1), nfft=64, ntime_valid=nvalid)(
        jnp.asarray(pm), jnp.asarray(padded)))
    R.db_close(got["psum"]["sxx_med_dbfs"], want["sxx_med_dbfs"], 30.0)


@pytest.mark.parametrize("case", ["batched_2x2", "batched_4x1",
                                  "batched_4x1_psum"])
def test_batched_mesh_fn_matches_jax(ranks, monkeypatch, case):
    """make_batched_sti_fn_mesh: per-column dBFS references, padding
    columns clamped to the last request, batched medians after the
    gather, or the per-request summed median above the budget."""
    got = R.case_result(ranks, case)
    shape, B, ntime, nsub = R.BATCHED[case[8:11]]
    if case.endswith("psum"):
        monkeypatch.setattr(jsharded, "GATHERED_MEDIAN_MAX_BYTES", 0)
        gathered = R.case_result(ranks, "batched_4x1")["mesh"]
        np.testing.assert_array_equal(got["mesh"]["sxx_med_dbfs"],
                                      gathered["sxx_med_dbfs"])
    jbatch.make_batched_sti_fn_mesh.cache_clear()
    fn = jbatch.make_batched_sti_fn_mesh(jmesh(*shape), nfft=64, ntime=ntime,
                                         B=B)
    jbatch.make_batched_sti_fn_mesh.cache_clear()
    assert fn.padded_cols == got["padded_cols"]
    merged, inv = R.batched_inputs(B, ntime, nsub, fn.padded_cols)
    want = _host(fn(*_placed(fn, merged, inv)))
    n = B * ntime
    R.db_close(got["mesh"]["sxx_dbfs"][:n], want["sxx_dbfs"][:n], 30.0)
    R.db_close(got["mesh"]["sxx_med_dbfs"], want["sxx_med_dbfs"], 30.0)
    solo = got["solo"]
    R.db_close(got["mesh"]["sxx_dbfs"][:n],
               solo["sxx_dbfs"].reshape(n, nsub, 64), 30.0)
    R.db_close(got["mesh"]["sxx_med_dbfs"], solo["sxx_med_dbfs"], 30.0)


def _same_axes(got: dict, want) -> None:
    np.testing.assert_array_equal(got["frame_starts"], want.frame_starts)
    np.testing.assert_array_equal(got["times"], want.times)
    np.testing.assert_array_equal(got["freqs"], want.freqs)
    np.testing.assert_array_equal(got["mask"], want.mask)


def test_batched_pipeline_on_a_mesh(ranks, tone_capture):
    """BatchedStiPipeline(mesh=) against the one-device batch and the JAX
    package's mesh batch on the same capture; tile batching on a mesh is
    refused with the JAX package's message."""
    got = R.case_result(ranks, "batched_pipeline")
    top = tone_capture[0]
    ds = RFDataset(top)
    cfg = jax_config(SpectrogramConfig(**R.BATCHED_CFG))
    spans = R.batched_pipeline_spans(ds.time_bnds)
    reqs = jax_requests([(ds, None), (ds, None)])
    want = jbatch.BatchedStiPipeline(reqs, cfg, mesh=jmesh(2, 2)).compute(
        time_spans=spans)
    for g, s, w in zip(got["mesh"], got["solo"], want):
        _same_axes(g, w)
        R.db_close(g["sxx_dbfs"], w.sxx_dbfs, 60.0, axis=0)
        R.db_close(g["sxx_med_dbfs"], w.sxx_med_dbfs, 60.0, axis=0)
        R.db_close(g["sxx_dbfs"], s["sxx_dbfs"], 60.0, axis=0)
        R.db_close(g["sxx_med_dbfs"], s["sxx_med_dbfs"], 60.0, axis=0)
    with pytest.raises(ValueError) as e:
        jbatch.BatchedStiPipeline(reqs, cfg.replace(display_tile=True),
                                  mesh=jmesh(2, 2)).compute()
    assert got["error"] == str(e.value)


@pytest.mark.parametrize("key", list(R.PIPELINES))
def test_pipeline_on_a_mesh(ranks, tone_capture, int16_capture, key):
    """StiPipeline(mesh=) against StiPipeline() and the JAX package's
    StiPipeline(mesh=) on a capture the JAX writer wrote: float spectra,
    display tiles, int16 planes, a padded time axis."""
    got = R.case_result(ranks, f"pipeline_{key}")
    cap, shape, knobs = R.PIPELINES[key]
    top = (tone_capture if cap == "tone" else int16_capture)[0]
    cfg = SpectrogramConfig(**knobs)
    want = JStiPipeline(jax_dataset(RFDataset(top)), jax_config(cfg),
                        mesh=jmesh(*shape)).compute()
    mesh, solo = got["mesh"], got["solo"]
    _same_axes(mesh, want)
    if cfg.display_tile:
        assert mesh["sxx_dbfs"] is None
        R.tiles_close(mesh["tile"], want.tile)
        np.testing.assert_array_equal(mesh["tile"], solo["tile"])
        np.testing.assert_array_equal(mesh["plot_freqs"], want.plot_freqs)
    else:
        R.db_close(mesh["sxx_dbfs"], want.sxx_dbfs, 60.0, axis=0)
        R.db_close(mesh["sxx_dbfs"], solo["sxx_dbfs"], 60.0, axis=0)
    R.db_close(mesh["sxx_med_dbfs"], want.sxx_med_dbfs, 60.0, axis=0)
    R.db_close(mesh["sxx_med_dbfs"], solo["sxx_med_dbfs"], 60.0, axis=0)


def test_pipeline_refusals(ranks, tone_capture):
    """Two subchannels over a 4-way chan axis refuse with the JAX
    package's message; a device that is not the rank's mesh device
    raises."""
    got = R.case_result(ranks, "pipeline_refusals")
    jds = jax_dataset(RFDataset(tone_capture[0]))
    with pytest.raises(ValueError) as e:
        JStiPipeline(jds, jax_config(SpectrogramConfig(nfft=256, ntime=8)),
                     mesh=jmesh(1, 4)).compute()
    assert got["nsub"] == str(e.value)
    assert "mesh device" in got["device"]
