"""The rank side of the port's multi-rank CPU tests (test_torch_parallel.py,
test_torch_big_sti.py, test_torch_streaming_mesh.py,
test_torch_live_mesh.py): :func:`spawn` starts WORLD gloo ranks with
torch.multiprocessing (spawn), each rank runs every case of one suite on a
``DeviceMesh`` of the CPU and pickles its results, and the test files hold
them against the JAX package's functions, one test per case
(:func:`case_result`).

Imports torch, numpy and the port only. The inputs of every case are
built here from a seed with numpy (``*_inputs``), so the test process
builds the same arrays for the JAX side. A case that raises records its
traceback under ``rank_error``, and that case's test fails with it.
"""

from __future__ import annotations

import os
import pickle
import socket
import time
import traceback
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from pyspectrogram_tpu_torch.display.tile import make_tile_spec
from pyspectrogram_tpu_torch.io.memory import MemoryDataset
from pyspectrogram_tpu_torch.io.reader import RFDataset
from pyspectrogram_tpu_torch.kernels import sti_cuda
from pyspectrogram_tpu_torch.models import batch, sti
from pyspectrogram_tpu_torch.models.streaming import StreamingSti
from pyspectrogram_tpu_torch.ops import stft
from pyspectrogram_tpu_torch.parallel import big_sti, dist_fft
from pyspectrogram_tpu_torch.parallel import mesh as pmesh
from pyspectrogram_tpu_torch.parallel import sharded
from pyspectrogram_tpu_torch.parallel.mesh import CHAN_AXIS, TIME_AXIS
from pyspectrogram_tpu_torch.runtime import (
    LiveStreamEngine,
    ProcessorCallbacks,
    SharedRefreshScheduler,
    SpectrogramProcessor,
)
from pyspectrogram_tpu_torch.utils.config import SpectrogramConfig

#: ranks per spawn, as the JAX side's meshes of jax.devices()[:4]
WORLD = 4
#: the tile tests' display colour ranges (dBFS)
CRANGES = ((-110.0, -40.0), (-90.0, -10.0))


# ------------------------------------------------------------ the spawn
def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(suite: str, out_dir, args: dict, timeout: float = 240.0):
    """Run every case of ``SUITES[suite]`` on WORLD gloo ranks -> one
    {case: result} dict per rank. A rank that dies raises here; ranks
    still running at ``timeout`` seconds are killed and raise."""
    ctx = mp.start_processes(
        _rank_main, args=(WORLD, _free_port(), str(out_dir), suite, args),
        nprocs=WORLD, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"suite {suite!r}: ranks still running after "
                               f"{timeout} s")
    out = []
    for r in range(WORLD):
        with open(os.path.join(out_dir, f"{suite}_rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def _rank_main(rank: int, world: int, port: int, out_dir: str, suite: str,
               args: dict) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=60))
    try:
        results = {}
        for name, case in SUITES[suite]:
            try:
                results[name] = case(args)
            except Exception:
                results[name] = {"rank_error": traceback.format_exc()}
        with open(os.path.join(out_dir, f"{suite}_rank{rank}.pkl"),
                  "wb") as f:
            pickle.dump(results, f)
    finally:
        dist.destroy_process_group()


def _same(a, b, where: str) -> None:
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f"), where
    else:
        assert a == b, where


def case_result(ranks: list, name: str, per_rank=()) -> dict:
    """Rank 0's result of case ``name``, after failing on any rank's
    traceback and checking that every rank returned the same (but for the
    keys ``per_rank``, which are this rank's own)."""
    for r, res in enumerate(ranks):
        err = res[name].get("rank_error") if isinstance(res[name],
                                                        dict) else None
        assert err is None, f"rank {r}, case {name}:\n{err}"
    strip = [{k: v for k, v in res[name].items() if k not in per_rank}
             for res in ranks]
    for r in range(1, len(ranks)):
        _same(strip[r], strip[0], f"rank {r} {name}")
    return ranks[0][name]


def db_close(got, want, floor_db: float, axis: int = -1,
             atol: float = 1e-4) -> None:
    """dB agreement on the bins within ``floor_db`` of their column's peak
    along ``axis`` (the standing dB tolerance)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    keep = want >= want.max(axis=axis, keepdims=True) - floor_db
    np.testing.assert_allclose(got[keep], want[keep], atol=atol, rtol=0)


def tiles_close(got, want) -> None:
    """uint8 tiles within one level on at most 0.1% of pixels."""
    assert got.shape == want.shape, (got.shape, want.shape)
    d = np.abs(got.astype(int) - want.astype(int))
    assert d.max() <= 1 and np.count_nonzero(d) <= 1e-3 * d.size, \
        (d.max(), np.count_nonzero(d))


_MESHES: dict = {}


def mesh_of(tp: int, cp: int):
    """The (tp, cp) CPU mesh, made once per rank (every rank makes its
    meshes in the same order)."""
    if (tp, cp) not in _MESHES:
        _MESHES[(tp, cp)] = pmesh.make_mesh("cpu", tp, cp)
    return _MESHES[(tp, cp)]


def run_sharded(fn, mesh, *host_args):
    """Call a sharded factory's ``fn`` on this rank's blocks of the host
    arrays (``fn.input_specs()``) -> the assembled outputs, numpy."""
    local = [torch.from_numpy(np.ascontiguousarray(
        pmesh.local_shard(a, mesh, sp)))
        for a, sp in zip(host_args, fn.input_specs())]
    out = pmesh.assemble_outputs(fn(*local), mesh, fn.output_specs)
    return {k: v.numpy() for k, v in out.items()}


def _np(out: dict) -> dict:
    return {k: v.numpy() for k, v in out.items()}


# ------------------------------------------------------------ inputs
def buffer(nsamp: int, nsub: int, seed: int):
    """(time-major packed (nsamp, nsub, 2), plane-major (nsub*2, nsamp))
    float32 white noise (tests/test_parallel.py's _buffer)."""
    rng = np.random.default_rng(seed)
    packed = rng.standard_normal((nsamp, nsub, 2)).astype(np.float32)
    pm = np.ascontiguousarray(
        np.moveaxis(packed, 0, -1).reshape(nsub * 2, nsamp))
    return packed, pm


def sharded_inputs(contiguous: bool, nfft=64, nint=2, ntime=16, nsub=4,
                   seed=11):
    """(plane-major samples, starts) of the sharded STI cases: frames at
    t*frame_len (contiguous) or spread over a longer buffer."""
    frame_len = nfft * nint
    nsamp = frame_len * ntime + (0 if contiguous else 32)
    _, pm = buffer(nsamp, nsub, seed)
    if contiguous:
        starts = (np.arange(ntime) * frame_len).astype(np.int32)
    else:
        starts = np.linspace(0, nsamp - frame_len, ntime, dtype=np.int32)
    return pm, starts


def int16_inputs(nfft=64, ntime=16, nsub=2, seed=9):
    rng = np.random.default_rng(seed)
    pm = rng.integers(-(1 << 12), 1 << 12,
                      size=(nsub * 2, nfft * ntime)).astype(np.int16)
    return pm, (np.arange(ntime) * nfft).astype(np.int32)


def tile_spec(nfft=64):
    """The sharded tile case's spec and its second colour range's."""
    freqs = stft.shifted_freqs(nfft, 100_000)
    return [make_tile_spec(freqs, (-30.0, 30.0), c, max_nfreqs=23)
            for c in CRANGES]


def psum_inputs(nvalid: int):
    """(16, 3, 64) float32 powers whose rows from ``nvalid`` on are
    poisoned padding."""
    rng = np.random.default_rng(5)
    p = rng.standard_normal((16, 3, 64)).astype(np.float32) ** 2
    p[nvalid:] = 1e12
    return p


#: the mesh-batched cases: (mesh, B, ntime, nsub) — 120 columns over 2
#: time ranks, and 39 columns padded to 40 over 4
BATCHED = {"2x2": ((2, 2), 3, 40, 2), "4x1": ((4, 1), 3, 13, 2)}


def batched_inputs(B: int, ntime: int, nsub: int, padded_cols: int,
                   nfft=64, seed=21):
    """(merged plane-major buffer zero-padded to ``padded_cols`` columns of
    nfft, (B,) float32 1/ref^2)."""
    rng = np.random.default_rng(seed)
    merged = np.zeros((nsub * 2, padded_cols * nfft), np.float32)
    merged[:, :B * ntime * nfft] = rng.standard_normal(
        (nsub * 2, B * ntime * nfft))
    inv = np.asarray([1.0, 0.25, 4.0][:B], np.float32)
    return merged, inv


def x_inputs(nfft: int, seed: int) -> np.ndarray:
    """(nfft,) complex128 white noise for the distributed FFT."""
    rng = np.random.default_rng(seed)
    return rng.standard_normal(nfft) + 1j * rng.standard_normal(nfft)


def frames_pm(pm: np.ndarray, nfft: int, nint: int, nseg: int, ntime: int,
              nsub: int) -> np.ndarray:
    """(nsub*2, ntime*frame_len) plane-major -> (ntime, nsub, 2,
    nseg*nfft) column frames (the pipeline's host reshape)."""
    fp = pm.reshape(nsub, 2, ntime, nfft * nint)
    return np.ascontiguousarray(np.moveaxis(fp, 2, 0)[..., : nseg * nfft])


def big_inputs(kind: str):
    """(plane-major samples, nfft, nint, ntime, nsub, ref) of the big-FFT
    STI cases."""
    rng = np.random.default_rng({"welch": 0, "parity": 1, "int16": 3,
                                 "tiers": 7, "tile": 8}[kind])
    nfft = 1 << 12
    if kind == "int16":
        pm = rng.integers(-3000, 3000, (2, 4 * 2 * nfft)).astype(np.int16)
        return pm, nfft, 2, 4, 1, 2.0 ** 15.5
    nint, ntime, nsub = {"welch": (2, 4, 2), "parity": (1, 4, 2),
                         "tiers": (1, 3, 1), "tile": (1, 3, 2)}[kind]
    pm = 0.3 * rng.standard_normal((nsub * 2, ntime * nint * nfft))
    return pm.astype(np.float32), nfft, nint, ntime, nsub, 1.0


def result_of(res) -> dict:
    """A StiResult's arrays."""
    return {k: getattr(res, k) for k in ("sxx_dbfs", "sxx_med_dbfs", "tile",
                                         "plot_freqs", "frame_starts",
                                         "times", "freqs", "mask")}


# ------------------------------------------------------- suite "parallel"
def case_mesh_shapes(args):
    m22 = mesh_of(2, 2)
    out = {"default": tuple(pmesh.make_mesh("cpu").mesh.shape),
           "2x2": tuple(m22.mesh.shape),
           "chan2": tuple(pmesh.make_mesh("cpu", chan_parallel=2)
                          .mesh.shape),
           "names": tuple(m22.mesh_dim_names),
           "coords": (pmesh.axis_index(m22, TIME_AXIS),
                      pmesh.axis_index(m22, CHAN_AXIS)),
           "device": str(pmesh.mesh_device(m22))}
    try:
        pmesh.make_mesh("cpu", time_parallel=3)
    except ValueError as e:
        out["error"] = str(e)
    return out


def _sharded_case(tp, cp, mode, contiguous):
    def case(args):
        pm, starts = sharded_inputs(contiguous)
        mesh = mesh_of(tp, cp)
        fn = sharded.make_sharded_sti_fn(
            mesh, nfft=64, nint=2, ntime_valid=len(starts), mode=mode,
            contiguous=contiguous)
        solo = stft.make_sti_fn_pm(nfft=64, nint=2, mode=mode)(
            torch.from_numpy(pm), torch.from_numpy(starts))
        return {"mesh": run_sharded(fn, mesh, pm, starts),
                "solo": _np(solo), "specs": fn.input_specs()}
    return case


def case_padded(args):
    nfft, ntime, nsub = 64, 13, 2
    _, pm = buffer(nfft * ntime + 200, nsub, seed=3)
    starts = np.linspace(0, pm.shape[1] - nfft, ntime, dtype=np.int32)
    mesh = mesh_of(4, 1)
    padded, nvalid = pmesh.pad_starts(starts, 4)
    fn = sharded.make_sharded_sti_fn(mesh, nfft=nfft, ntime_valid=nvalid)
    gathered = run_sharded(fn, mesh, pm, padded)
    _, pm_c = buffer(nfft * ntime, nsub, seed=12)
    pm_p, starts_p, nvalid_c = pmesh.pad_contiguous_block(pm_c, ntime, nfft,
                                                          4)
    fn_c = sharded.make_sharded_sti_fn(mesh, nfft=nfft, ntime_valid=nvalid_c,
                                       contiguous=True)
    return {"gathered": gathered, "padded_len": len(padded),
            "contiguous": run_sharded(fn_c, mesh, pm_p, starts_p),
            "contiguous_shape": pm_p.shape}


def case_int16(args):
    pm, starts = int16_inputs()
    mesh = mesh_of(2, 2)
    fn = sharded.make_sharded_sti_fn(mesh, nfft=64, ntime_valid=16,
                                     ref=2.0 ** 15.5)
    local = pmesh.local_shard(pm, mesh, fn.input_specs()[0])
    return {"mesh": run_sharded(fn, mesh, pm, starts),
            "local_dtype": str(local.dtype)}


def case_tile(args):
    pm, starts = sharded_inputs(True, nint=1, nsub=2, seed=14)
    spec, spec2 = tile_spec()
    mesh = mesh_of(2, 2)
    fn = sharded.make_sharded_sti_fn(mesh, nfft=64, ntime_valid=16,
                                     contiguous=True, tile=spec.crop_key())
    out = {"specs": len(fn.input_specs()),
           "tiles": [run_sharded(fn, mesh, pm, starts, s.qparams)
                     for s in (spec, spec2)],
           "same_fn": fn is sharded.make_sharded_sti_fn(
               mesh, nfft=64, ntime_valid=16, contiguous=True, tile=spec2)}
    local = [torch.from_numpy(np.ascontiguousarray(
        pmesh.local_shard(a, mesh, sp)))
        for a, sp in zip((pm, starts), fn.input_specs())]
    try:
        fn(*local)
    except ValueError as e:
        out["error"] = str(e)
    return out


def _psum_case(nvalid, tp, cp, row_window=None):
    def case(args):
        p = psum_inputs(nvalid)
        mesh = mesh_of(tp, cp)
        local = pmesh.local_shard(p, mesh, (TIME_AXIS, None, None))
        med = stft.median_over_time_psum(
            torch.from_numpy(np.ascontiguousarray(local)), mesh, TIME_AXIS,
            None if row_window else nvalid, row_window)
        return {"median": med.numpy()}
    return case


def case_psum_tier(args):
    nfft, ntime = 64, 13
    _, pm = buffer(nfft * ntime + 200, 2, seed=9)
    starts = np.linspace(0, pm.shape[1] - nfft, ntime, dtype=np.int32)
    padded, nvalid = pmesh.pad_starts(starts, 4)
    mesh = mesh_of(4, 1)
    gathered = run_sharded(sharded.make_sharded_sti_fn(
        mesh, nfft=nfft, ntime_valid=nvalid), mesh, pm, padded)
    budget = sharded.GATHERED_MEDIAN_MAX_BYTES
    sharded.GATHERED_MEDIAN_MAX_BYTES = 0
    sharded._make_sharded_sti_fn.cache_clear()
    try:
        psum = run_sharded(sharded.make_sharded_sti_fn(
            mesh, nfft=nfft, ntime_valid=nvalid), mesh, pm, padded)
    finally:
        sharded.GATHERED_MEDIAN_MAX_BYTES = budget
        sharded._make_sharded_sti_fn.cache_clear()
    return {"gathered": gathered, "psum": psum}


def _batched_case(key, psum=False):
    def case(args):
        shape, B, ntime, nsub = BATCHED[key]
        mesh = mesh_of(*shape)
        budget = sharded.GATHERED_MEDIAN_MAX_BYTES
        if psum:
            sharded.GATHERED_MEDIAN_MAX_BYTES = 0
            batch.make_batched_sti_fn_mesh.cache_clear()
        try:
            fn = batch.make_batched_sti_fn_mesh(mesh, nfft=64, ntime=ntime,
                                                B=B)
            merged, inv = batched_inputs(B, ntime, nsub, fn.padded_cols)
            out = run_sharded(fn, mesh, merged, inv)
        finally:
            sharded.GATHERED_MEDIAN_MAX_BYTES = budget
            batch.make_batched_sti_fn_mesh.cache_clear()
        solo = batch.make_batched_sti_fn_pm(nfft=64, ntime=ntime)(
            torch.from_numpy(merged[:, :B * ntime * 64]), inv)
        return {"mesh": out, "solo": _np(solo),
                "padded_cols": fn.padded_cols}
    return case


def batched_pipeline_spans(ds_time_bnds):
    """Two time spans inside a capture's bounds for the batched pipeline
    (requests over the same capture, different columns)."""
    t0, t1 = ds_time_bnds
    return [None, (t0 + 0.01, t1 - 0.005)]


BATCHED_CFG = dict(nfft=256, nint=1, ntime=40)


def case_batched_pipeline(args):
    ds = RFDataset(args["tone"])
    cfg = SpectrogramConfig(**BATCHED_CFG)
    spans = batched_pipeline_spans(ds.time_bnds)
    reqs = [(ds, None), (ds, None)]
    mesh = mesh_of(2, 2)
    got = batch.BatchedStiPipeline(reqs, cfg, "cpu", mesh=mesh).compute(
        time_spans=spans)
    want = batch.BatchedStiPipeline(reqs, cfg, "cpu").compute(
        time_spans=spans)
    out = {"mesh": [result_of(r) for r in got],
           "solo": [result_of(r) for r in want]}
    try:
        batch.BatchedStiPipeline(reqs, cfg.replace(display_tile=True), "cpu",
                                 mesh=mesh).compute()
    except ValueError as e:
        out["error"] = str(e)
    return out


#: the pipeline cases: (capture, mesh, config knobs)
PIPELINES = {
    "tone_2x2": ("tone", (2, 2), dict(nfft=256, nint=2, ntime=13)),
    "tone_4x1_tile": ("tone", (4, 1), dict(nfft=256, nint=2, ntime=13,
                                           display_tile=True)),
    "tone_4x1_parity": ("tone", (4, 1), dict(nfft=512, nint=3, ntime=40,
                                             mode="parity")),
    "int16_4x1": ("int16", (4, 1), dict(nfft=128, nint=2, ntime=16)),
}


def _pipeline_case(key):
    def case(args):
        cap, shape, knobs = PIPELINES[key]
        cfg = SpectrogramConfig(**knobs)
        mesh = mesh_of(*shape)
        got = sti.StiPipeline(RFDataset(args[cap]), cfg, "cpu",
                              mesh=mesh).compute()
        want = sti.StiPipeline(RFDataset(args[cap]), cfg, "cpu").compute()
        return {"mesh": result_of(got), "solo": result_of(want)}
    return case


def case_pipeline_refusals(args):
    ds = RFDataset(args["tone"])            # two subchannels
    out = {}
    try:
        sti.StiPipeline(ds, SpectrogramConfig(nfft=256, ntime=8), "cpu",
                        mesh=pmesh.make_mesh("cpu", 1, 4)).compute()
    except ValueError as e:
        out["nsub"] = str(e)
    try:
        sti.StiPipeline(ds, SpectrogramConfig(), "meta", mesh=mesh_of(4, 1))
    except ValueError as e:
        out["device"] = str(e)
    return out


SUITES = {"parallel": [
    ("mesh_shapes", case_mesh_shapes),
    *[(f"sharded_{tp}x{cp}_{mode}_{'contiguous' if c else 'gathered'}",
       _sharded_case(tp, cp, mode, c))
      for tp, cp in ((2, 2), (4, 1)) for mode in ("welch", "parity")
      for c in (False, True)],
    ("padded", case_padded),
    ("int16", case_int16),
    ("tile", case_tile),
    ("psum_13_4x1", _psum_case(13, 4, 1)),
    ("psum_16_4x1", _psum_case(16, 4, 1)),
    ("psum_13_2x2", _psum_case(13, 2, 2)),
    ("psum_window_4x1", _psum_case(16, 4, 1, row_window=(3, 11))),
    ("psum_tier", case_psum_tier),
    *[(f"batched_{k}", _batched_case(k)) for k in BATCHED],
    ("batched_4x1_psum", _batched_case("4x1", psum=True)),
    ("batched_pipeline", case_batched_pipeline),
    *[(f"pipeline_{k}", _pipeline_case(k)) for k in PIPELINES],
    ("pipeline_refusals", case_pipeline_refusals),
]}


# ------------------------------------------------------------ suite "big"
def _dist_fft_run(fft, mesh, x):
    n1, n2 = fft.n1n2
    x2 = np.asarray(x).reshape(n1, n2)
    planes = [np.ascontiguousarray(pmesh.local_shard(
        a.astype(np.float32), mesh, fft.input_spec)) for a in (x2.real,
                                                              x2.imag)]
    Xr, Xi = fft(*(torch.from_numpy(a) for a in planes))
    Xr, Xi = (pmesh.assemble(v, mesh, sp).numpy()
              for v, sp in zip((Xr, Xi), fft.output_specs))
    return dist_fft.reference_order(Xr) + 1j * dist_fft.reference_order(Xi)


def _dist_fft_case(nfft, shape, seed):
    def case(args):
        mesh = mesh_of(*shape)
        fft = dist_fft.make_distributed_fft(mesh, TIME_AXIS, nfft)
        return {"got": _dist_fft_run(fft, mesh, x_inputs(nfft, seed)),
                "n1n2": fft.n1n2}
    return case


def case_dist_fft_impulse(args):
    nfft = 1 << 12
    mesh = mesh_of(4, 1)
    fft = dist_fft.make_distributed_fft(mesh, TIME_AXIS, nfft)
    out = {}
    for n0 in (0, 1, 517, nfft - 1):
        x = np.zeros(nfft, np.complex64)
        x[n0] = 1.0
        out[n0] = _dist_fft_run(fft, mesh, x)
    return out


def case_dist_fft_tone(args):
    nfft = 1 << 12
    mesh = mesh_of(4, 1)
    fft = dist_fft.make_distributed_fft(mesh, TIME_AXIS, nfft)
    n = np.arange(nfft)
    return {k0: _dist_fft_run(fft, mesh, np.exp(2j * np.pi * k0 * n / nfft))
            for k0 in (3, 1033, nfft // 2)}


def _bigfft_fn(mesh, nfft, nint, mode, **kw):
    return big_sti.make_bigfft_sti_fn(mesh, TIME_AXIS, nfft=nfft, nint=nint,
                                      mode=mode, **kw)


def run_bigfft(fn, mesh, pm, nfft, nint, ntime, nsub, *qparams):
    """A big-FFT STI on this rank's q-slice of ``pm``'s frames -> {key:
    assembled output}: k-matrices in natural fftshifted order, the tile as
    every rank has it."""
    n1, n2 = fn.n1n2
    x2 = big_sti.frames_to_x2(frames_pm(pm, nfft, nint, fn.nseg, ntime, nsub),
                              nfft, fn.nseg, n1, n2)
    local = torch.from_numpy(np.ascontiguousarray(
        pmesh.local_shard(x2, mesh, fn.input_spec)))
    out = {}
    for k, v in fn(local, *qparams).items():
        if k == "tile":
            out[k] = v.numpy()
        else:
            out[k] = big_sti.to_freq_order(
                pmesh.assemble(v, mesh, fn.output_specs[k]).numpy())
    out["local_dtype"] = str(local.dtype)
    return out


def _bigfft_case(kind, mode="welch", precision="exact"):
    def case(args):
        pm, nfft, nint, ntime, nsub, ref = big_inputs(kind)
        mesh = mesh_of(4, 1)
        fn = _bigfft_fn(mesh, nfft, nint, mode, ref=ref,
                        precision=precision)
        solo = stft.make_sti_fn_pm(nfft=nfft, nint=nint, mode=mode, ref=ref)(
            torch.from_numpy(pm), torch.from_numpy(
                (np.arange(ntime) * nfft * nint).astype(np.int32)))
        return {"mesh": run_bigfft(fn, mesh, pm, nfft, nint, ntime, nsub),
                "solo": _np(solo), "n1n2": fn.n1n2}
    return case


def case_bigfft_tile(args):
    pm, nfft, nint, ntime, nsub, _ = big_inputs("tile")
    mesh = mesh_of(4, 1)
    freqs = stft.shifted_freqs(nfft, 1_000_000)
    spec, spec2 = (make_tile_spec(freqs, (-200.0, 200.0), c)
                   for c in ((-80.0, -20.0), (-90.0, -30.0)))
    plain = _bigfft_fn(mesh, nfft, 1, "welch")
    tiled = _bigfft_fn(mesh, nfft, 1, "welch", tile=spec.crop_key())
    out = {"float": run_bigfft(plain, mesh, pm, nfft, 1, ntime, nsub),
           "tiles": [run_bigfft(tiled, mesh, pm, nfft, 1, ntime, nsub,
                                s.qparams) for s in (spec, spec2)],
           "same_fn": _bigfft_fn(mesh, nfft, 1, "welch", tile=spec2)
           is tiled and _bigfft_fn(mesh, nfft, 1, "welch", tile=spec)
           is tiled}
    try:
        run_bigfft(tiled, mesh, pm, nfft, 1, ntime, nsub)
    except ValueError as e:
        out["error"] = str(e)
    return out


#: the big-FFT pipeline cases: (mesh, config knobs), on the tone capture
BIG_PIPELINES = {
    "4x1": ((4, 1), dict(nfft=4096, nint=2, ntime=4)),
    "2x2_welch4": ((2, 2), dict(nfft=2048, nint=4, ntime=5)),
    "4x1_tile": ((4, 1), dict(nfft=4096, ntime=4, display_tile=True)),
}


def _big_pipeline_case(key):
    def case(args):
        shape, knobs = BIG_PIPELINES[key]
        cfg = SpectrogramConfig(**knobs)
        mesh = mesh_of(*shape)
        pipe = sti.StiPipeline(RFDataset(args["tone"]), cfg, "cpu",
                               mesh=mesh, bigfft_threshold=cfg.nfft)
        # the kernels cover every nfft here, so column sharding would run:
        # take their coverage away to reach the distributed-FFT tier
        supported = sti_cuda.supported
        sti_cuda.supported = lambda nfft: False
        try:
            use = pipe._use_bigfft(cfg, nsub=2)
            got = pipe.compute()
        finally:
            sti_cuda.supported = supported
        want = sti.StiPipeline(RFDataset(args["tone"]),
                               cfg.replace(display_tile=False),
                               "cpu").compute()
        return {"use_bigfft": use, "mesh": result_of(got),
                "solo": result_of(want)}
    return case


def case_tier_choice(args):
    ds = RFDataset(args["tone"])
    big = SpectrogramConfig(nfft=1 << 18, nint=1, ntime=4)
    small = SpectrogramConfig(nfft=4096, nint=1, ntime=4)
    pipe = sti.StiPipeline(ds, big, "cpu", mesh=mesh_of(4, 1))
    pipe2 = sti.StiPipeline(ds, big, "cpu", mesh=mesh_of(2, 2))
    return {"2^18_nsub1": pipe._use_bigfft(big, nsub=1),
            "2^18_nsub16": pipe._use_bigfft(big, nsub=16),
            "2^18_nsub3_chan2": pipe2._use_bigfft(big, nsub=3),
            "4096_nsub16": pipe._use_bigfft(small, nsub=16)}


SUITES["big"] = [
    ("dist_fft_4096", _dist_fft_case(1 << 12, (4, 1), 0)),
    ("dist_fft_65536", _dist_fft_case(1 << 16, (4, 1), 0)),
    ("dist_fft_impulse", case_dist_fft_impulse),
    ("dist_fft_tone", case_dist_fft_tone),
    ("dist_fft_parseval", _dist_fft_case(1 << 14, (4, 1), 5)),
    ("dist_fft_2x2", _dist_fft_case(1 << 12, (2, 2), 9)),
    ("dist_fft_ceiling", _dist_fft_case(1 << 20, (4, 1), 11)),
    ("bigfft_welch", _bigfft_case("welch")),
    ("bigfft_parity", _bigfft_case("parity", mode="parity")),
    ("bigfft_int16", _bigfft_case("int16")),
    *[(f"bigfft_{p}", _bigfft_case("tiers", precision=p))
      for p in ("exact", "balanced", "display")],
    ("bigfft_tile", case_bigfft_tile),
    *[(f"big_pipeline_{k}", _big_pipeline_case(k)) for k in BIG_PIPELINES],
    ("tier_choice", case_tier_choice),
]


# ---------------------------------------------------------- suite "stream"
#: the streaming meshes: (time, chan); nsub equals the chan size, so a rank
#: holds one subchannel (JAX's tests shard chan 4 ways)
STREAM_MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
#: the streaming cases (tests/test_streaming.py:156-305, 537-552): the
#: StreamingSti knobs, the pushes, the blocks' seed, and the view read
#: after them, (n_disp, stride, n_med); "bisect" takes a median of 40
#: columns (kernel B2's plain version, not the sorting network)
STREAMS = {
    "push": (dict(nfft=128, block_len=512, ring_len=8), 5, 11, (4, 2, 6)),
    "overlap": (dict(nfft=128, hop=64, block_len=512, ring_len=16), 4, 23,
                (6, 2, 8)),
    "bisect": (dict(nfft=64, block_len=512, ring_len=48), 6, 21,
               (6, 2, 40)),
    "refresh": (dict(nfft=128, block_len=512, ring_len=16), 3, 55,
                (6, 2, 8)),
}


def stream_blocks_of(key: str, nsub: int) -> list:
    """The pushed plane-major (nsub*2, block_len) float32 blocks of a
    streaming case, made from its seed."""
    kw, n_push, seed, _ = STREAMS[key]
    rng = np.random.default_rng(seed)
    return [(0.1 * rng.standard_normal((nsub * 2, kw["block_len"])))
            .astype(np.float32) for _ in range(n_push)]


def stream_spec(nfft: int):
    """The streaming cases' display tile."""
    return make_tile_spec(stft.shifted_freqs(nfft, 100_000), (-30.0, 30.0),
                          (-110.0, -40.0))


def stream_reads(s, st, view, spec) -> dict:
    """Every read path of a stream (port or JAX: the same method names)
    -> host arrays; ``spec`` the package's own TileSpec."""
    n_disp, stride, n_med = view
    snap, n_valid = s.snapshot(st)
    tile, _ = s.snapshot_quantized(st, spec)
    v, med = s.refresh_view(st, n_disp, stride, n_med=n_med)
    vt, med_t = s.refresh_view(st, n_disp, stride, spec=spec, n_med=n_med)
    return {"snapshot": snap, "n_valid": n_valid, "tile": tile,
            "median": s.median_psd(st),
            "median_window": s.median_psd(st, n_cols=n_med),
            "strided": s.snapshot_strided(st, n_disp, stride),
            "strided_tile": s.snapshot_strided(st, n_disp, stride,
                                               spec=spec),
            "refresh_view": v, "refresh_median": med,
            "refresh_tile": vt, "refresh_tile_median": med_t}


def _stream_case(key: str, mkey: str):
    def case(args):
        kw, _, _, view = STREAMS[key]
        tp, cp = STREAM_MESHES[mkey]
        mesh = mesh_of(tp, cp)
        multi = StreamingSti(nsub=cp, device="cpu", mesh=mesh, **kw)
        solo = StreamingSti(nsub=cp, device="cpu", **kw)
        st_m, st_s = multi.init_state(), solo.init_state()
        local = (tuple(st_m.carry.shape), tuple(st_m.ring.shape))
        cols_m, cols_s = [], []
        for b in stream_blocks_of(key, cp):
            st_m, c = multi.push(st_m, b)
            cols_m.append(c.numpy())
            st_s, c = solo.push(st_s, torch.from_numpy(b))
            cols_s.append(c.numpy())
        spec = stream_spec(kw["nfft"])
        out = {"state": {}}
        for label, s, st, cols in (("mesh", multi, st_m, cols_m),
                                   ("solo", solo, st_s, cols_s)):
            # the checkpoint's state: on global rank 0 alone on a mesh
            g = s.global_state(st)
            out["state"][label] = None if g is None else (
                g.carry.numpy(), g.ring.numpy())
            out[label] = {"cols": np.stack(cols),
                          "total_cols": st.total_cols,
                          **stream_reads(s, st, view, spec)}
        out["local_shapes"] = local
        out["block_sharding"] = multi.block_sharding()
        return out
    return case


def case_stream_refusals(args):
    out = {}
    for mkey, (tp, cp) in STREAM_MESHES.items():
        try:
            StreamingSti(nfft=64, nsub=3, block_len=256, device="cpu",
                         mesh=mesh_of(tp, cp))
        except ValueError as e:
            out[f"nsub_{mkey}"] = str(e)
    try:
        StreamingSti(nfft=64, nsub=2, block_len=256, device="meta",
                     mesh=mesh_of(2, 2))
    except ValueError as e:
        out["device"] = str(e)
    s = StreamingSti(nfft=64, nsub=2, block_len=256, device="cpu",
                     mesh=mesh_of(2, 2))
    try:
        s.push(s.init_state(), np.zeros((2, 256), np.float32))
    except ValueError as e:
        out["local_block"] = str(e)
    return out


def case_agree_bounds(args):
    """agree_bounds and every_rank with each rank's own values."""
    r = dist.get_rank()
    out = {}
    for mkey, (tp, cp) in STREAM_MESHES.items():
        mesh = mesh_of(tp, cp)
        out[mkey] = {
            "ints": pmesh.agree_bounds(mesh, 10 * r, 100 - r),
            "floats": pmesh.agree_bounds(mesh, 0.5 * r, 9.25 - 0.25 * r),
            "every_true": pmesh.every_rank(mesh, True),
            "every_one_false": pmesh.every_rank(mesh, r != 2),
        }
    return out


SUITES["stream"] = [
    *[(f"{k}_{m}", _stream_case(k, m)) for k in STREAMS
      for m in STREAM_MESHES],
    ("refusals", case_stream_refusals),
    ("agree_bounds", case_agree_bounds),
]


# ------------------------------------------------------------ suite "live"
#: the live cases' captures by mesh: "cap2" two subchannels (2x2),
#: "cap4" four (1x4), both tones at LIVE_SR written by the test process
LIVE_CAPS = {"2x2": "cap2", "1x4": "cap4"}
LIVE_SR = 100_000
#: the live engine (tests/test_live.py:394-413) and its overlap-hop
#: configuration (tests/test_live.py:747)
LIVE_CFG = dict(nfft=64, ntime=16, stream_seconds=0.2, streaming=True)
OVERLAP_CFG = dict(nfft=64, ntime=200, stream_seconds=0.05, hop=32,
                   streaming=True)
#: the processor configurations (tests/test_pipeline_runtime.py:284-309)
PROC_WRITTEN = dict(nfft=128, ntime=6)
PROC_STREAMING = dict(nfft=128, ntime=6, stream_seconds=0.005)
#: the differing-bounds case: a capture of BOUNDS_N samples at LIVE_SR on
#: every rank, BOUNDS_EXTRA more on rank 1, then BOUNDS_GROW appended to
#: each rank's capture, its tick config and its written config
BOUNDS_N, BOUNDS_EXTRA, BOUNDS_GROW = 30_000, 9_000, 12_000
BOUNDS_CFG = dict(nfft=64, ntime=16, stream_seconds=0.1, streaming=True)
BOUNDS_WRITTEN = dict(nfft=128, ntime=8)


def live_checkpoint_path(out_dir, mkey: str, kind: str) -> str:
    """Where a live case's checkpoint goes: "mesh" (global rank 0 of the
    port's mesh writes it), "solo" (the port's one-device engine, rank 0)
    and "jax" (the JAX package's meshed engine, written by the test
    process before the spawn)."""
    return os.path.join(str(out_dir), f"live_{mkey}_{kind}.npz")


def bounds_capture(n: int) -> np.ndarray:
    """(n, 2) complex64 two-tone capture of the differing-bounds case."""
    rng = np.random.default_rng(7)
    t = np.arange(n) / LIVE_SR
    x = np.stack([np.exp(2j * np.pi * 12_500.0 * t),
                  np.exp(2j * np.pi * 25_000.0 * t)], axis=1)
    x += 1e-3 * (rng.standard_normal(x.shape)
                 + 1j * rng.standard_normal(x.shape))
    return x.astype(np.complex64)


def _live_case(mkey: str):
    def case(args):
        mesh = mesh_of(*STREAM_MESHES[mkey])
        cap = args[LIVE_CAPS[mkey]]
        cfg = SpectrogramConfig(**LIVE_CFG)
        eng = LiveStreamEngine(RFDataset(cap), cfg, "cpu", mesh=mesh,
                               target_block_samples=4096)
        solo = LiveStreamEngine(RFDataset(cap), cfg, "cpu",
                                target_block_samples=4096)
        out = {"tick": result_of(eng.tick(cfg)),
               "solo_tick": result_of(solo.tick(cfg)),
               "local_ring": tuple(eng.state.ring.shape),
               "local_carry": tuple(eng.state.carry.shape)}
        ck = eng.save(live_checkpoint_path(args["out"], mkey, "mesh"))
        if dist.get_rank() == 0:
            solo.save(live_checkpoint_path(args["out"], mkey, "solo"))
        out["saved"] = os.path.basename(str(ck))
        resumed = LiveStreamEngine.resume(RFDataset(cap), cfg, ck, "cpu",
                                          mesh=mesh)
        out["resumed_local_ring"] = tuple(resumed.state.ring.shape)
        out["resumed_next_sample"] = resumed.next_sample
        out["next_sample"] = eng.next_sample
        out["resumed_tick"] = result_of(resumed.tick(cfg))
        out["solo_resumed_tick"] = result_of(LiveStreamEngine.resume(
            RFDataset(cap), cfg, ck, "cpu").tick(cfg))
        jck = live_checkpoint_path(args["out"], mkey, "jax")
        out["from_jax_tick"] = result_of(LiveStreamEngine.resume(
            RFDataset(cap), cfg, jck, "cpu", mesh=mesh).tick(cfg))
        return out
    return case


def _overlap_case(mkey: str):
    def case(args):
        cap = args[LIVE_CAPS[mkey]]
        cfg = SpectrogramConfig(**OVERLAP_CFG)
        eng = LiveStreamEngine(RFDataset(cap), cfg, "cpu",
                               mesh=mesh_of(*STREAM_MESHES[mkey]),
                               target_block_samples=4096)
        solo = LiveStreamEngine(RFDataset(cap), cfg, "cpu",
                                target_block_samples=4096)
        return {"carry_len": eng.carry_len,
                "local_carry": tuple(eng.state.carry.shape),
                "mesh": result_of(eng.tick(cfg)),
                "solo": result_of(solo.tick(cfg))}
    return case


def iterated_of(it) -> dict:
    """An Iterated payload's arrays."""
    return {k: getattr(it, k) for k in ("sxx_dbfs", "sxx_med_dbfs", "tile",
                                        "plot_freqs", "times", "freqs",
                                        "mask")}


def _run_processor(datasource, ds, tab, cfg, mesh, ck=None):
    """The last Iterated payload of a two-iteration processor run (its
    live engine seeded from the checkpoint ``ck`` where given), its
    terminate reasons and its iteration count."""
    events = []
    terms = []
    proc = SpectrogramProcessor(
        datasource, ds, tab, cfg,
        callbacks=ProcessorCallbacks(on_iterated=events.append,
                                     on_terminated=terms.append),
        written_sleep=0.0, streaming_sleep=0.0, max_iterations=2,
        device="cpu", mesh=mesh)
    if ck is not None:
        proc.preload_live_state(ck)
    proc.run()
    return proc, {"last": iterated_of(events[-1]), "n": len(events),
                  "reasons": [int(t.reason) for t in terms]}


def _processor_case(mkey: str):
    def case(args):
        mesh = mesh_of(*STREAM_MESHES[mkey])
        cap = args[LIVE_CAPS[mkey]]
        out = {}
        for label, datasource, knobs in (
                ("written", "written", PROC_WRITTEN),
                ("streaming", "streaming", PROC_STREAMING)):
            cfg = SpectrogramConfig(**knobs)
            proc, out[label] = _run_processor(datasource, RFDataset(cap),
                                              11, cfg, mesh)
            _, out[f"{label}_solo"] = _run_processor(
                datasource, RFDataset(cap), 12, cfg, None)
            out[f"{label}_mesh_is_pipeline_mesh"] = \
                proc.pipeline.mesh is mesh
            if label == "written":
                out["skipped"] = proc.skipped_recomputes
            else:
                out["engine_mesh"] = proc._live.engine.sti.mesh is mesh
        # a streaming processor seeded from the meshed live checkpoint
        cfg = SpectrogramConfig(**LIVE_CFG)
        ck = live_checkpoint_path(args["out"], mkey, "mesh")
        _, out["preloaded"] = _run_processor("streaming", RFDataset(cap), 13,
                                             cfg, mesh, ck)
        _, out["preloaded_solo"] = _run_processor(
            "streaming", RFDataset(cap), 14, cfg, None, ck)
        return out
    return case


def case_scheduler(args):
    """A meshed tab beside a one-device tab in one scheduler
    (tests/test_scheduler.py:268): never merged, equal results."""
    mesh = mesh_of(2, 2)
    cap = args["cap2"]
    cfg = SpectrogramConfig(nfft=256, nint=1, ntime=16)
    sched = SharedRefreshScheduler(autostart=False)
    seen = {0: [], 1: []}
    procs = []
    for tab, m in ((0, None), (1, mesh)):
        p = SpectrogramProcessor(
            "written", RFDataset(cap), tab, cfg,
            callbacks=ProcessorCallbacks(on_iterated=seen[tab].append),
            scheduler=sched, device="cpu", mesh=m)
        p.start()
        procs.append(p)
    keys = [sched._group_key(p, cfg) for p in procs]
    sched.tick_once()
    sched.tick_once()                      # unchanged: both re-emit
    out = {"solo_key_is_none": keys[0] is None,
           "mesh_key_is_none": keys[1] is None,
           "merged": sched.merged_launches, "solo": sched.solo_launches,
           "skipped": [p.skipped_recomputes for p in procs],
           "threads": [p._thread is None for p in procs],
           "results": [[iterated_of(it) for it in seen[t]] for t in (0, 1)]}
    for p in procs:
        p.abort()
    return out


def case_bounds(args):
    """Ranks that see different capture bounds (rank 1 a longer capture)
    agree on them: every rank pushes the same blocks and returns the same
    result as a one-device engine over the shortest capture, then again
    after each capture grows; a meshed written request and processor
    compute the span every rank sees."""
    r = dist.get_rank()
    mesh = mesh_of(2, 2)
    full = bounds_capture(BOUNDS_N + BOUNDS_EXTRA + BOUNDS_GROW)
    n = BOUNDS_N + (BOUNDS_EXTRA if r == 1 else 0)
    mine = MemoryDataset(full[:n], LIVE_SR)
    short = MemoryDataset(full[:BOUNDS_N], LIVE_SR)
    cfg = SpectrogramConfig(**BOUNDS_CFG)
    eng = LiveStreamEngine(mine, cfg, "cpu", mesh=mesh,
                           target_block_samples=2048)
    solo = LiveStreamEngine(short, cfg, "cpu", target_block_samples=2048)
    out = {"ticks": [], "solo_ticks": [], "counters": [],
           "solo_counters": []}

    def tick():
        out["ticks"].append(result_of(eng.tick(cfg)))
        out["solo_ticks"].append(result_of(solo.tick(cfg)))
        for key, e in (("counters", eng), ("solo_counters", solo)):
            out[key].append((e.total_cols, e.next_sample, e.samples_read,
                             e._tail_pending, e.cols_per_block))
    tick()
    # every capture grows by BOUNDS_GROW: rank 1's stays the longer
    for ds in (mine, short):
        held = ds.bnds["ch0"][1] + 1
        ds.append(full[held:held + BOUNDS_GROW])
        ds.bnds_update()
    tick()
    wcfg = SpectrogramConfig(**BOUNDS_WRITTEN)
    out["written"] = result_of(sti.StiPipeline(mine, wcfg, "cpu",
                                               mesh=mesh).compute())
    out["written_solo"] = result_of(sti.StiPipeline(short, wcfg,
                                                    "cpu").compute())
    _, out["processor"] = _run_processor("written", mine, 21, wcfg, mesh)
    _, out["processor_solo"] = _run_processor("written", short, 22, wcfg,
                                              None)
    return out


SUITES["live"] = [
    *[(f"live_{m}", _live_case(m)) for m in STREAM_MESHES],
    *[(f"overlap_{m}", _overlap_case(m)) for m in STREAM_MESHES],
    *[(f"processor_{m}", _processor_case(m)) for m in STREAM_MESHES],
    ("scheduler", case_scheduler),
    ("bounds", case_bounds),
]
