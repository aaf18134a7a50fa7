"""The port's cookbook (docs/cookbook_torch.md) against the JAX package's
(docs/cookbook.md) on the CPU.

Each cookbook's session blocks run as a reader pastes them, in order, in
a namespace of their own: the JAX ones as tests/test_cookbook.py runs
them, the port's with ``DEVICE = "cpu"``; both write their captures under
tmp_path. Every named result of the port is then held against the JAX
one at the standing tolerances (ROADMAP Queue 3): dB at 1e-4 on bins
within 60 dB of a tone's column peak (30 dB of a noise column's), tiles
within one level, and on <= 0.1% of the pixels within 60 dB of the peak
(further under these full-scale tones the dB itself is not held), frame
axes and counters equal.
§5's rank script runs on four gloo ranks under torchrun, and rank 0's
result is held against the JAX §5 mesh result.

chip_smoke.py runs the same blocks on a card, their captures written and
read as Digital RF files by the port's own HDF5 layer (io.hdf5): the last
tests run its helpers here and hold their results to this file's own run
of the blocks bit for bit.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402

JAX_COOKBOOK = REPO / "docs" / "cookbook.md"
COOKBOOK = REPO / "docs" / "cookbook_torch.md"
DB_ATOL = 1e-4


def _session(path: Path, root: Path, device_line=None) -> dict:
    """Every ```python block of ``path`` in one namespace, its paths under
    ``root`` (and the device line replaced)."""
    blocks = re.findall(r"```python\n(.*?)```", path.read_text(), re.DOTALL)
    src = "\n\n".join(blocks).replace("/tmp/cookbook_", f"{root}/")
    if device_line:
        src = src.replace('DEVICE = "cuda"', device_line)
    ns = {}
    exec(compile(src, str(path), "exec"), ns)  # noqa: S102
    return ns


@pytest.fixture(scope="module")
def jax_ns(tmp_path_factory):
    return _session(JAX_COOKBOOK, tmp_path_factory.mktemp("jax"))


@pytest.fixture(scope="module")
def port_ns(tmp_path_factory):
    return _session(COOKBOOK, tmp_path_factory.mktemp("port"),
                    'DEVICE = "cpu"')


def _db_close(got, want, floor_db, axis=-1):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    keep = want >= want.max(axis=axis, keepdims=True) - floor_db
    np.testing.assert_allclose(got[keep], want[keep], atol=DB_ATOL, rtol=0)


def _tiles_close(got, want, near):
    """Within one level everywhere, and on <= 0.1% of the pixels within
    60 dB of their column's peak (chip_smoke.near_peak): the recipes' tones
    are full scale, and the tiles' colour ranges reach 110 dB under them,
    where the dB of two float32 FFTs is not held."""
    assert got.dtype == want.dtype == np.uint8
    chip_smoke.check_tiles(got, want, "tile", near)


def _results_close(got, want):
    """Two StiResults of a tone capture: frame axes equal, dB close."""
    for f in ("freqs", "times", "frame_starts", "mask"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    _db_close(got.sxx_dbfs, want.sxx_dbfs, 60.0, axis=0)
    _db_close(got.sxx_med_dbfs, want.sxx_med_dbfs, 60.0, axis=0)


def test_every_jax_section_has_a_port_section():
    def sections(path):
        return re.findall(r"^## (\d+)\. ", path.read_text(), re.M)

    assert sections(COOKBOOK) == sections(JAX_COOKBOOK) == [
        str(i) for i in range(1, 9)]
    recipes = chip_smoke.cookbook_recipes(COOKBOOK.read_text())
    assert [r[0] for r in recipes] == [f"cookbook_{i}" for i in range(9)]
    assert all(r[1] for r in recipes)       # every section runs a block
    assert [r[0] for r in recipes if r[2]] == ["cookbook_5"]


def test_cookbook_states_no_tpu_figure():
    """The port's text quotes no TPU figure or TPU-only mechanism."""
    text = COOKBOOK.read_text()
    for word in ("TPU", "v5e", "VMEM", "ICI", "XLA", "jnp", "jax",
                 "us/push", "1.71x", "5-6x"):
        assert word not in text, word


@pytest.mark.parametrize("name", ["res", "res_1"])
def test_request_matches_jax(jax_ns, port_ns, name):
    """§1's request and §5's one-device request of the two-subchannel
    capture."""
    _results_close(port_ns[name], jax_ns[name])


def test_display_tile_matches_jax(jax_ns, port_ns):
    assert port_ns["res_t"].sxx_dbfs is None
    res, want = jax_ns["res"], jax_ns["res_t"]
    np.testing.assert_array_equal(port_ns["res_t"].plot_freqs,
                                  want.plot_freqs)
    _tiles_close(port_ns["res_t"].tile, want.tile, chip_smoke.near_peak(
        np.moveaxis(res.sxx_dbfs, 0, -1), res.freqs, want.plot_freqs))
    np.testing.assert_array_equal(port_ns["rgba"].shape,
                                  jax_ns["rgba"].shape)


@pytest.mark.parametrize("name", ["med", "view"])
def test_streaming_views_match_jax(jax_ns, port_ns, name):
    """§3: the median of the newest 32 columns and the strided view of a
    ring fed white noise."""
    _db_close(port_ns[name], jax_ns[name], 30.0)


def test_live_processor_matches_jax(jax_ns, port_ns):
    """§4: three streaming iterations, the last one's tile."""
    assert len(port_ns["frames"]) == len(jax_ns["frames"]) == 3
    got, want = port_ns["frames"][-1], jax_ns["frames"][-1]
    np.testing.assert_array_equal(got.plot_freqs, want.plot_freqs)
    _db_close(got.sxx_med_dbfs, want.sxx_med_dbfs, 60.0, axis=0)
    _tiles_close(got.tile, want.tile, chip_smoke.near_peak(
        want.sxx_med_dbfs.T, want.freqs, want.plot_freqs))


def test_batch_matches_jax(jax_ns, port_ns):
    """§6: the merged request over two datasets."""
    assert len(port_ns["results"]) == len(jax_ns["results"]) == 2
    for got, want in zip(port_ns["results"], jax_ns["results"]):
        _results_close(got, want)


def test_wide_batch_matches_jax(jax_ns, port_ns):
    """§6's 64-column batch (kernel B2 over the batch on a card) against
    the JAX package's BatchedStiPipeline on the JAX cookbook's captures."""
    from pyspectrogram_tpu.models import BatchedStiPipeline as JBatched

    want = JBatched([(jax_ns["ds"], None), (jax_ns["ds2"], "x:1")],
                    jax_ns["cfg"].replace(ntime=64)).compute()
    assert len(port_ns["wide"]) == 2
    for got, w in zip(port_ns["wide"], want):
        _results_close(got, w)


def test_scheduler_counters_match_jax(jax_ns, port_ns):
    """§7: one merged launch for three tabs, then a cycle of cache
    re-emits."""
    def counters(ns):
        return (ns["sched"].merged_launches, ns["sched"].merged_requests,
                [p.skipped_recomputes for p, _ in ns["tabs"]],
                [len(got) for _, got in ns["tabs"]])

    # each tab got the merged result, then its cache re-emitted
    assert counters(port_ns) == counters(jax_ns) == (1, 3, [1, 1, 1],
                                                     [2, 2, 2])
    for (_, got), (_, want) in zip(port_ns["tabs"], jax_ns["tabs"]):
        _db_close(got[0].sxx_dbfs, want[0].sxx_dbfs, 60.0, axis=0)


def test_hop_tick_matches_jax(jax_ns, port_ns):
    """§8: the overlap-save tick's frame starts and spectra."""
    r, jr = port_ns["r"], jax_ns["r"]
    np.testing.assert_array_equal(r.frame_starts, jr.frame_starts)
    _db_close(r.sxx_dbfs, jr.sxx_dbfs, 60.0, axis=0)


def test_mesh_script_under_torchrun(tmp_path, jax_ns):
    """§5's rank script as written, on four gloo CPU ranks started by
    torchrun (a 2x2 mesh): each rank asserts its mesh result equals its
    one-device request bit for bit, and rank 0's saved result is held
    against the JAX cookbook's 4x2 mesh result."""
    (script,) = [s for _, _, s in chip_smoke.cookbook_recipes(
        COOKBOOK.read_text()) if s]
    path = tmp_path / "cookbook_mesh.py"
    path.write_text(chip_smoke.for_device(script, "cpu", tmp_path))
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [str(REPO), os.environ.get("PYTHONPATH", "")]))
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4", str(path)],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stderr[-4000:]
    with np.load(tmp_path / "mesh.npz") as z:
        want = jax_ns["res_m"]
        _db_close(z["sxx_dbfs"], want.sxx_dbfs, 60.0, axis=0)
        _db_close(z["sxx_med_dbfs"], want.sxx_med_dbfs, 60.0, axis=0)


@pytest.fixture(scope="module")
def smoke_run(tmp_path_factory):
    """chip_smoke's run of the port's blocks on the CPU."""
    return chip_smoke.run_cookbook("cpu", tmp_path_factory.mktemp("smoke"))


def test_memory_captures_equal_the_files(port_ns, smoke_run):
    """chip_smoke's run of the blocks, which write and read their captures
    as files as a user does, gives every result bit for bit as this file's
    own run does, section by section."""
    ns, runs = smoke_run
    assert list(runs) == [f"cookbook_{i}" for i in range(9)]
    for name in ("res", "res_1"):
        for f in ("sxx_dbfs", "sxx_med_dbfs", "freqs", "times",
                  "frame_starts", "mask"):
            np.testing.assert_array_equal(getattr(ns[name], f),
                                          getattr(port_ns[name], f))
    np.testing.assert_array_equal(ns["res_t"].tile, port_ns["res_t"].tile)
    np.testing.assert_array_equal(ns["frames"][-1].tile,
                                  port_ns["frames"][-1].tile)
    for name in ("results", "wide"):
        for got, want in zip(ns[name], port_ns[name]):
            np.testing.assert_array_equal(got.sxx_dbfs, want.sxx_dbfs)
    np.testing.assert_array_equal(ns["r"].sxx_dbfs, port_ns["r"].sxx_dbfs)
    # the phase's own comparison of two runs passes on them
    held = chip_smoke.cookbook_vs(ns, port_ns)
    assert sorted(held) == [f"cookbook_{i}" for i in range(1, 9)]


def test_memory_mesh_script_equals_one_device(tmp_path, port_ns):
    """chip_smoke's §5 run: four spawned gloo ranks with torchrun's
    environment (rank 0 writes the capture's files, every rank opens
    them); rank 0's result equals the port's one-device §5 request on the
    files bit for bit."""
    saved, ranks = chip_smoke.run_cookbook_mesh("cpu", tmp_path)
    assert len(ranks) == chip_smoke.MESH_RANKS
    assert all(set(r) == {"seconds", "launches"} for r in ranks)
    assert chip_smoke.capture_files(tmp_path)
    np.testing.assert_array_equal(saved["sxx_dbfs"],
                                  port_ns["res_1"].sxx_dbfs)
    np.testing.assert_array_equal(saved["sxx_med_dbfs"],
                                  port_ns["res_1"].sxx_med_dbfs)
