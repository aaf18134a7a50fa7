"""The port's chan-sharded StreamingSti (StreamingSti(mesh=)) and the mesh
agreement helpers (parallel.mesh.agree_bounds, every_rank) on four gloo
ranks of the CPU, held against the JAX package's StreamingSti on meshes of
four of conftest's virtual CPU devices with the same (time, chan) split,
on the same numpy blocks (the counterparts of tests/test_streaming.py:
156-305 and 537-552), and bit for bit against the port's one-device
stream.

One spawn per file: a module-scoped fixture runs every case of
tests/torch_mesh_ranks.py's "stream" suite on the four ranks, and each
test reads one case after checking that every rank returned the same.
Both meshes the JAX tests shard over chan are covered: 2x2 (chan 2, nsub
2) and 1x4 (chan 4, nsub 4), each rank holding one subchannel.
Tolerances are the standing ones: dB 1e-4 on bins within 30 dB of their
column's peak (noise), tiles within one level on at most 0.1% of pixels
against the JAX package's jitted tiles, the meshed stream against the
one-device one bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_mesh_ranks as R
from port_pairs import jax_spec
from pyspectrogram_tpu.models.streaming import StreamingSti as JStreamingSti
from pyspectrogram_tpu.parallel import make_mesh as jmake_mesh

MESHES = list(R.STREAM_MESHES)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_stream_mesh_ranks")
    return R.spawn("stream", out, {"out": str(out)})


def jmesh(mkey):
    tp, cp = R.STREAM_MESHES[mkey]
    return jmake_mesh(devices=jax.devices()[: tp * cp], time_parallel=tp,
                      chan_parallel=cp)


def jax_stream(key, mkey):
    """The JAX package's meshed stream after the case's pushes: (dB
    columns of each push, the reads of stream_reads, carry, ring)."""
    kw, _, _, view = R.STREAMS[key]
    nsub = R.STREAM_MESHES[mkey][1]
    s = JStreamingSti(nsub=nsub, mesh=jmesh(mkey), **kw)
    st = s.init_state()
    bsh = s.block_sharding()
    cols = []
    for b in R.stream_blocks_of(key, nsub):
        st, c = s.push(st, jax.device_put(jnp.asarray(b), bsh))
        cols.append(np.asarray(c))
    reads = R.stream_reads(s, st, view,
                           jax_spec(R.stream_spec(kw["nfft"])))
    return {"cols": np.stack(cols), "carry": np.asarray(st.carry),
            **reads}


def _check_against_jax(got, want):
    for k in ("cols", "snapshot", "median", "median_window", "strided",
              "refresh_view", "refresh_median", "refresh_tile_median"):
        R.db_close(got[k], want[k], 30.0)
    for k in ("tile", "strided_tile", "refresh_tile"):
        R.tiles_close(got[k], want[k])
    assert got["n_valid"] == want["n_valid"]
    np.testing.assert_array_equal(got["carry"], want["carry"])


def _check_case(ranks, key, mkey):
    name = f"{key}_{mkey}"
    got = R.case_result(ranks, name, per_rank=("state",))
    # the whole state (a checkpoint's) reaches global rank 0 alone
    assert all(res[name]["state"]["mesh"] is None for res in ranks[1:])
    got = {**got, **{label: dict(got[label], carry=got["state"][label][0],
                                 ring=got["state"][label][1])
                     for label in ("mesh", "solo")}}
    # the meshed stream is the one-device stream, bit for bit
    R._same(got["mesh"], got["solo"], f"{key}_{mkey} mesh vs solo")
    _check_against_jax(got["mesh"], jax_stream(key, mkey))
    # each rank holds one subchannel of the ring and carry
    kw = R.STREAMS[key][0]
    frame = kw["nfft"]
    assert got["local_shapes"] == ((2, frame - kw.get("hop", frame)),
                                   (kw["ring_len"], 1, kw["nfft"]))
    return got


@pytest.mark.parametrize("mkey", MESHES)
def test_push_snapshot_median_tile_match_jax(ranks, mkey):
    """Five pushes wrap the 8-column ring; every read path on the mesh
    against JAX's meshed stream and the port's one-device one."""
    got = _check_case(ranks, "push", mkey)
    assert got["mesh"]["total_cols"] == 20 and got["mesh"]["n_valid"] == 8


@pytest.mark.parametrize("mkey", MESHES)
def test_overlap_hop_matches_jax(ranks, mkey):
    """hop < frame_len: the carry shards with the planes, and the gathered
    carry holds the same trailing samples as JAX's."""
    got = _check_case(ranks, "overlap", mkey)
    assert got["mesh"]["carry"].shape == (2 * R.STREAM_MESHES[mkey][1], 64)


@pytest.mark.parametrize("mkey", MESHES)
def test_bisection_median_matches_jax(ranks, mkey):
    """48 columns fill the ring: the median over more than 32 columns
    (kernel B2's route, per rank) and the 40-column windowed one."""
    got = _check_case(ranks, "bisect", mkey)
    assert got["mesh"]["n_valid"] == 48


@pytest.mark.parametrize("mkey", MESHES)
def test_refresh_view_matches_jax(ranks, mkey):
    """refresh_view on a mesh (per-rank view and median, gathered) equals
    JAX's fused meshed refresh and the port's two-call path."""
    got = _check_case(ranks, "refresh", mkey)["mesh"]
    np.testing.assert_array_equal(got["refresh_view"], got["strided"])
    np.testing.assert_array_equal(got["refresh_tile"], got["strided_tile"])
    np.testing.assert_array_equal(got["refresh_median"],
                                  got["median_window"])


def test_block_sharding_is_jax_spec(ranks):
    got = R.case_result(ranks, "push_2x2", per_rank=("state",))
    s = JStreamingSti(nfft=128, nsub=2, block_len=512, ring_len=8,
                      mesh=jmesh("2x2"))
    assert got["block_sharding"] == tuple(s.block_sharding().spec)


@pytest.mark.parametrize("mkey", MESHES)
def test_nsub_refusal_matches_jax(ranks, mkey):
    got = R.case_result(ranks, "refusals")
    with pytest.raises(ValueError) as e:
        JStreamingSti(nfft=64, nsub=3, block_len=256, mesh=jmesh(mkey))
    assert got[f"nsub_{mkey}"] == str(e.value)


def test_device_and_block_refusals(ranks):
    """A device other than the rank's mesh device is refused, and a push
    takes the global block, not a rank's rows of it."""
    got = R.case_result(ranks, "refusals")
    assert got["device"] == "device meta is not this rank's mesh device cpu"
    assert got["local_block"] == "block of shape (2, 256), expected (4, 256)"


@pytest.mark.parametrize("mkey", MESHES)
def test_agree_bounds_and_every_rank(ranks, mkey):
    """Rank r offers (10r, 100-r) and (0.5r, 9.25-0.25r): every rank gets
    (max lo, min hi) over all four; every_rank is a logical and."""
    got = R.case_result(ranks, "agree_bounds")[mkey]
    assert got["ints"] == (30, 97)
    assert got["floats"] == (1.5, 8.5)
    assert got["every_true"] is True and got["every_one_false"] is False
