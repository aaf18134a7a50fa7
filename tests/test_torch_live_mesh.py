"""The port's meshed live path — LiveStreamEngine(mesh=), its checkpoint
and resume(mesh=), SpectrogramProcessor(mesh=), the scheduler's mesh key —
on four gloo ranks of the CPU, held against the JAX package's on meshes of
four of conftest's virtual CPU devices with the same (time, chan) split,
on the same Digital RF captures (the counterparts of tests/test_live.py:
394-413 and 747, tests/test_pipeline_runtime.py:284-309 and
tests/test_scheduler.py:268), and bit for bit against the port's
one-device run.

One spawn per file: a module-scoped fixture writes the captures and the
JAX package's meshed checkpoints, then runs every case of
tests/torch_mesh_ranks.py's "live" suite on the four ranks; each test
reads one case after checking that every rank returned the same. Both 2x2
(chan 2, two subchannels) and 1x4 (chan 4, four) are covered, and a case
where the ranks see different capture bounds. Times, frame starts and
masks exact; dB within 1e-4 dB on bins within 60 dB of the column's peak
(tone captures); tiles within one level on at most 0.1% of pixels; the
mesh against the port's one-device run bit for bit.
"""

import jax
import numpy as np
import pytest

import torch_mesh_ranks as R
from port_pairs import jax_config
from pyspectrogram_tpu.io.reader import RFDataset as JRFDataset
from pyspectrogram_tpu.io.synthetic import write_capture
from pyspectrogram_tpu.parallel import make_mesh as jmake_mesh
from pyspectrogram_tpu.runtime import ProcessorCallbacks as JCallbacks
from pyspectrogram_tpu.runtime import SpectrogramProcessor as JProcessor
from pyspectrogram_tpu.runtime.live import LiveStreamEngine as JEngine
from pyspectrogram_tpu_torch.utils.config import SpectrogramConfig

MESHES = list(R.STREAM_MESHES)


def jmesh(mkey):
    tp, cp = R.STREAM_MESHES[mkey]
    return jmake_mesh(devices=jax.devices()[: tp * cp], time_parallel=tp,
                      chan_parallel=cp)


def _cfg(knobs):
    return jax_config(SpectrogramConfig(**knobs))


@pytest.fixture(scope="module")
def live(tmp_path_factory):
    """(rank results, {capture name: path}, out dir)."""
    out = tmp_path_factory.mktemp("torch_live_mesh_ranks")
    caps = {}
    for mkey, name in R.LIVE_CAPS.items():
        caps[name] = str(out / name)
        write_capture(caps[name], channel="m", kind="tone",
                      n_samples=40_000, sample_rate_numerator=R.LIVE_SR,
                      num_subchannels=R.STREAM_MESHES[mkey][1])
        # the JAX package's meshed checkpoint, which a port mesh resumes
        cfg = _cfg(R.LIVE_CFG)
        eng = JEngine(JRFDataset(caps[name]), cfg, mesh=jmesh(mkey),
                      target_block_samples=4096)
        eng.tick(cfg)
        eng.save(R.live_checkpoint_path(out, mkey, "jax"))
    ranks = R.spawn("live", out, {"out": str(out), **caps})
    return ranks, caps, out


def _close_to_jax(got, want):
    """A port tick's (or Iterated payload's) arrays against the JAX
    package's StiResult (or Iterated): axes exact, spectra and tiles at
    the standing tolerances."""
    for k in ("times", "frame_starts", "mask", "freqs"):
        if hasattr(want, k):
            np.testing.assert_array_equal(got[k], getattr(want, k))
    R.db_close(got["sxx_med_dbfs"], want.sxx_med_dbfs, 60.0, axis=0)
    if want.tile is not None:
        R.tiles_close(got["tile"], want.tile)
    else:
        R.db_close(got["sxx_dbfs"], want.sxx_dbfs, 60.0, axis=0)


@pytest.mark.parametrize("mkey", MESHES)
def test_tick_matches_jax_and_solo(live, mkey):
    ranks, caps, _ = live
    got = R.case_result(ranks, f"live_{mkey}")
    R._same(got["tick"], got["solo_tick"], "mesh vs solo tick")
    cfg = _cfg(R.LIVE_CFG)
    want = JEngine(JRFDataset(caps[R.LIVE_CAPS[mkey]]), cfg,
                   mesh=jmesh(mkey), target_block_samples=4096).tick(cfg)
    _close_to_jax(got["tick"], want)


@pytest.mark.parametrize("mkey", MESHES)
def test_checkpoint_resumes_sharded(live, mkey):
    """A meshed session saved and resumed on the mesh: each rank holds its
    slice of the restored ring, the cursor is the saved one, and the
    resumed tick equals the port's solo resume of the same file."""
    ranks, _, _ = live
    got = R.case_result(ranks, f"live_{mkey}")
    ring_len = got["local_ring"][0]
    assert got["local_ring"] == got["resumed_local_ring"] == (ring_len, 1,
                                                              64)
    assert got["local_carry"] == (2, 0)
    assert got["resumed_next_sample"] == got["next_sample"]
    R._same(got["resumed_tick"], got["solo_resumed_tick"],
            "mesh vs solo resume")
    # no new data: the ring's rows are the pre-save tick's
    n = len(got["tick"]["frame_starts"])
    np.testing.assert_array_equal(got["resumed_tick"]["frame_starts"][:n],
                                  got["tick"]["frame_starts"])
    np.testing.assert_array_equal(got["resumed_tick"]["sxx_med_dbfs"],
                                  got["tick"]["sxx_med_dbfs"])


@pytest.mark.parametrize("mkey", MESHES)
def test_meshed_checkpoint_is_the_solo_file(live, mkey):
    """Global rank 0 writes the file the one-device engine writes."""
    ranks, _, out = live
    assert R.case_result(ranks, f"live_{mkey}")["saved"] == \
        f"live_{mkey}_mesh.npz"
    with np.load(R.live_checkpoint_path(out, mkey, "mesh")) as a, \
            np.load(R.live_checkpoint_path(out, mkey, "solo")) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("mkey", MESHES)
def test_meshed_checkpoint_resumes_in_jax(live, mkey):
    """The port's meshed checkpoint resumes in the JAX package's engine,
    on its mesh and on one device, and ticks as the port's resume does."""
    ranks, caps, out = live
    got = R.case_result(ranks, f"live_{mkey}")["resumed_tick"]
    cfg = _cfg(R.LIVE_CFG)
    ck = R.live_checkpoint_path(out, mkey, "mesh")
    for mesh in (jmesh(mkey), None):
        eng = JEngine.resume(JRFDataset(caps[R.LIVE_CAPS[mkey]]), cfg, ck,
                             mesh=mesh)
        _close_to_jax(got, eng.tick(cfg))


@pytest.mark.parametrize("mkey", MESHES)
def test_jax_checkpoint_resumes_on_port_mesh(live, mkey):
    ranks, caps, out = live
    got = R.case_result(ranks, f"live_{mkey}")["from_jax_tick"]
    cfg = _cfg(R.LIVE_CFG)
    eng = JEngine.resume(JRFDataset(caps[R.LIVE_CAPS[mkey]]), cfg,
                         R.live_checkpoint_path(out, mkey, "jax"),
                         mesh=jmesh(mkey))
    _close_to_jax(got, eng.tick(cfg))


@pytest.mark.parametrize("mkey", MESHES)
def test_overlap_hop_on_mesh(live, mkey):
    """An overlap-save stream seeds each rank's carry slice; every column,
    the carry-seeded first included, equals the solo engine's and JAX's
    meshed engine's."""
    ranks, caps, _ = live
    got = R.case_result(ranks, f"overlap_{mkey}")
    assert got["carry_len"] == 32 and got["local_carry"] == (2, 32)
    R._same(got["mesh"], got["solo"], "mesh vs solo overlap tick")
    assert np.all(np.diff(got["mesh"]["frame_starts"]) == 32)
    cfg = _cfg(R.OVERLAP_CFG)
    want = JEngine(JRFDataset(caps[R.LIVE_CAPS[mkey]]), cfg,
                   mesh=jmesh(mkey), target_block_samples=4096).tick(cfg)
    _close_to_jax(got["mesh"], want)


def _jax_processor(datasource, cap, knobs, mesh):
    events = []
    proc = JProcessor(datasource, cap, 11, _cfg(knobs),
                      callbacks=JCallbacks(on_iterated=events.append),
                      written_sleep=0.0, streaming_sleep=0.0,
                      max_iterations=2, mesh=mesh)
    proc.run()
    return events[-1]


@pytest.mark.parametrize("mkey", MESHES)
def test_processor_on_mesh(live, mkey):
    """SpectrogramProcessor(mesh=) in written mode (StiPipeline(mesh=)) and
    streaming mode (the chan-sharded live ring), and a streaming one
    preloaded from the meshed checkpoint: each the solo processor's
    payload bit for bit, and the JAX meshed processor's."""
    ranks, caps, _ = live
    got = R.case_result(ranks, f"processor_{mkey}")
    nsub = R.STREAM_MESHES[mkey][1]
    cap = caps[R.LIVE_CAPS[mkey]]
    for label, knobs in (("written", R.PROC_WRITTEN),
                         ("streaming", R.PROC_STREAMING)):
        assert got[f"{label}_mesh_is_pipeline_mesh"]
        assert got[label]["n"] == 2 and got[label]["reasons"] == [0]
        R._same(got[label], got[f"{label}_solo"], f"{label} mesh vs solo")
        _close_to_jax(got[label]["last"],
                      _jax_processor(label, cap, knobs, jmesh(mkey)))
    assert got["written"]["last"]["sxx_dbfs"].shape == (128, 6, nsub)
    assert got["streaming"]["last"]["sxx_med_dbfs"].shape == (128, nsub)
    assert got["engine_mesh"] and got["skipped"] == 1
    R._same(got["preloaded"], got["preloaded_solo"],
            "preloaded mesh vs solo")


def test_meshed_tab_is_never_merged(live):
    """A meshed tab's group key is None: beside a one-device tab it keeps
    its own sharded dispatch (two solo launches, no merged one), both
    re-emit on an unchanged cycle, and its frames are the one-device
    tab's bit for bit."""
    ranks, _, _ = live
    got = R.case_result(ranks, "scheduler")
    assert got["mesh_key_is_none"] and not got["solo_key_is_none"]
    assert got["merged"] == 0 and got["solo"] == 2
    assert got["skipped"] == [1, 1] and got["threads"] == [True, True]
    solo, mesh = got["results"]
    assert len(solo) == len(mesh) == 2
    R._same(mesh, solo, "meshed tab vs one-device tab")


def test_ranks_with_different_bounds_agree(live):
    """Rank 1 reads a longer capture than the others: every rank pushes
    the agreed blocks (the one-device engine's over the shortest
    capture), returns the same ticks before and after the captures grow
    past a window (a backlog restart),
    and a meshed written request and processor compute the span every
    rank sees; the spawn finishes inside its timeout."""
    ranks, _, _ = live
    got = R.case_result(ranks, "bounds")
    assert got["counters"] == got["solo_counters"]
    # the captures grew by more than a window, so each rank restarted its
    # ring at the agreed trailing window (the backlog restart) and read on
    next0, next1 = got["counters"][0][1], got["counters"][1][1]
    assert next1 - next0 > R.BOUNDS_GROW - 2048
    R._same(got["ticks"], got["solo_ticks"], "ticks vs solo")
    R._same(got["written"], got["written_solo"], "written vs solo")
    R._same(got["processor"], got["processor_solo"], "processor vs solo")
