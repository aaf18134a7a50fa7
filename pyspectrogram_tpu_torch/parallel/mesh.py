"""The (time, chan) device mesh on torch.distributed, its sharding specs and
every collective of the port — the counterpart of
pyspectrogram_tpu/parallel/mesh.py.

The port is SPMD: every rank runs the same call on its own device, and a
``DeviceMesh`` with dims ("time", "chan") stands where the JAX Mesh stands:

* ``time`` — STI columns have independent frame starts (reference:
  drfProc.py:159), so columns shard with no communication;
* ``chan`` — subchannel plane pairs shard over it (each rank transforms
  its own subchannels).

A sharding spec is a tuple with one entry per array dim, ``"time"``,
``"chan"`` or None, as a JAX PartitionSpec is. :func:`local_shard` slices
this rank's block out of an array every rank holds (the host block, as the
JAX host holds it before ``device_put``) with no communication, and
:func:`assemble` gathers the blocks back into the global tensor, what the
JAX caller gets from ``np.asarray`` of a sharded array.

The collectives (:func:`all_gather`, :func:`gather_to_root`,
:func:`all_reduce`, :func:`all_to_all`, and on them :func:`agree_bounds`,
:func:`every_rank` and :func:`barrier`) live here and nowhere else. The
process group's backend, read once per call with ``dist.get_backend``,
picks the route: on NCCL they take the tensors on the rank's device; on
gloo, a host transport (the CPU tests, and several ranks sharing one
card), they copy through host memory explicitly and bring the result back
to the tensor's device (:func:`gather_to_root` leaves it on rank 0's
host). An axis of size 1 makes no call. :func:`pad_to_multiple`,
:func:`pad_starts` and :func:`pad_contiguous_block` are copies of
pyspectrogram_tpu/parallel/mesh.py's: the port imports nothing of that
package.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

TIME_AXIS = "time"
CHAN_AXIS = "chan"

#: a sharding spec: one entry per array dim, an axis name or None
Spec = Tuple[Optional[str], ...]


def make_mesh(device_type: str = "cuda",
              time_parallel: Optional[int] = None,
              chan_parallel: Optional[int] = None):
    """2-D (time, chan) DeviceMesh over every rank of the initialised
    default process group.

    With no explicit split, every rank goes to the time axis — STI columns
    are the most abundant parallel work (ntime up to 1e5, reference:
    drfview.py:501). ``device_type`` is the ranks' device type: "cuda"
    (each rank on :func:`mesh_device`) or "cpu"."""
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs an initialised process group: call "
            "torch.distributed.init_process_group(backend, init_method=..., "
            "rank=..., world_size=...) on every rank first")
    n = dist.get_world_size()
    if time_parallel is None and chan_parallel is None:
        time_parallel, chan_parallel = n, 1
    elif time_parallel is None:
        time_parallel = n // chan_parallel
    elif chan_parallel is None:
        chan_parallel = n // time_parallel
    if time_parallel * chan_parallel != n:
        raise ValueError(
            f"mesh {time_parallel}x{chan_parallel} != {n} devices"
        )
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, (time_parallel, chan_parallel),
                            mesh_dim_names=(TIME_AXIS, CHAN_AXIS))


def axis_size(mesh, axis: str) -> int:
    """Ranks along ``axis`` of ``mesh``."""
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate along ``axis`` (``jax.lax.axis_index``)."""
    return mesh.get_local_rank(axis)


def mesh_device(mesh) -> torch.device:
    """This rank's device: ``cuda:{local_rank % device_count}`` for a CUDA
    mesh (so several ranks on one card share it), else the CPU. The local
    rank is LOCAL_RANK where a launcher set it, else the global rank."""
    if mesh.device_type != "cuda":
        return torch.device(mesh.device_type)
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
    return torch.device("cuda", local % torch.cuda.device_count())


def check_mesh_device(mesh, device: torch.device) -> torch.device:
    """``device`` if it is this rank's mesh device, else raise."""
    want = mesh_device(mesh)
    index = device.index
    if device.type == "cuda" and index is None:
        index = torch.cuda.current_device()
    if device.type != want.type or (want.type == "cuda"
                                    and index != want.index):
        raise ValueError(f"device {device} is not this rank's mesh device "
                         f"{want}")
    return want


def local_shard(x: Union[np.ndarray, torch.Tensor], mesh,
                spec: Spec) -> Union[np.ndarray, torch.Tensor]:
    """This rank's block of ``x`` (numpy or torch) under ``spec``: each
    sharded dim is cut into equal blocks, one per coordinate of its axis.
    No communication; a numpy block is a view."""
    index = []
    for d, axis in enumerate(spec):
        if axis is None:
            index.append(slice(None))
            continue
        n = axis_size(mesh, axis)
        if x.shape[d] % n:
            raise ValueError(f"dim {d} of size {x.shape[d]} does not divide "
                             f"over the {n}-way {axis!r} axis")
        blk = x.shape[d] // n
        i = axis_index(mesh, axis)
        index.append(slice(i * blk, (i + 1) * blk))
    return x[tuple(index)]


def assemble(local: torch.Tensor, mesh, spec: Spec) -> torch.Tensor:
    """The global tensor from every rank's block ``local`` under ``spec``
    (an all-gather along each sharded dim), on ``local``'s device."""
    for d, axis in enumerate(spec):
        if axis is not None:
            local = all_gather(local, mesh, axis, dim=d)
    return local


def assemble_outputs(out: dict, mesh, specs: dict) -> dict:
    """:func:`assemble` of each output of a sharded function, by the
    function's ``output_specs``."""
    return {k: assemble(v, mesh, specs[k]) for k, v in out.items()}


def _route(mesh, axis: str):
    """(process group of ``axis``, whether the collective stages through
    host memory): NCCL takes the tensors on their device, any other
    backend (gloo) takes host copies."""
    group = mesh.get_group(axis)
    host = dist.get_backend(group) != dist.Backend.NCCL
    return group, host


def _real(x: torch.Tensor) -> torch.Tensor:
    """A complex tensor as its (..., 2) float view: every backend moves
    real dtypes, and real and imaginary parts travel in one buffer."""
    return torch.view_as_real(x) if x.is_complex() else x


def all_gather(x: torch.Tensor, mesh, axis: str, dim: int = 0
               ) -> torch.Tensor:
    """Every rank's ``x`` along ``axis``, concatenated along ``dim`` in
    coordinate order (``jax.lax.all_gather(..., tiled=True)``)."""
    n = axis_size(mesh, axis)
    if n == 1:
        return x
    group, host = _route(mesh, axis)
    src = _real(x.movedim(dim, 0)).contiguous()
    send = src.cpu() if host else src
    parts = [torch.empty_like(send) for _ in range(n)]
    dist.all_gather(parts, send, group=group)
    out = torch.cat(parts).to(x.device)
    if x.is_complex():
        out = torch.view_as_complex(out)
    return out.movedim(0, dim)


def gather_to_root(x: torch.Tensor, mesh, axis: str, dim: int = 0
                   ) -> Optional[torch.Tensor]:
    """What :func:`all_gather` returns for a real ``x``, but on the host
    of global rank 0 alone (None on every other rank), for a file that
    rank 0 writes. Only the ranks of rank 0's group along ``axis`` take
    part: each sends its ``x`` to rank 0, which copies the blocks to its
    host one at a time, so no device holds more than its own block and
    one received one."""
    group, host = _route(mesh, axis)
    ranks = dist.get_process_group_ranks(group)
    src = x.contiguous()
    if dist.get_rank() != 0:
        if len(ranks) > 1 and 0 in ranks:
            dist.send(src.cpu() if host else src, dst=0, group=group)
        return None
    parts = [src.cpu()]
    for r in ranks[1:]:
        buf = torch.empty_like(src, device="cpu" if host else x.device)
        dist.recv(buf, src=r, group=group)
        parts.append(buf.cpu())
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=dim)


def all_reduce(x: torch.Tensor, mesh, axis: str, op: str = "sum"
               ) -> torch.Tensor:
    """Elementwise reduction of ``x`` over ``axis``: "sum" (``psum``) or
    "min" (``pmin``). Returns a new tensor on ``x``'s device."""
    ops = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN}
    if op not in ops:
        raise ValueError(f"all_reduce op must be 'sum' or 'min', got {op!r}")
    if axis_size(mesh, axis) == 1:
        return x
    group, host = _route(mesh, axis)
    buf = x.detach().to("cpu" if host else x.device, copy=True)
    dist.all_reduce(buf, op=ops[op], group=group)
    return buf.to(x.device)


def _mesh_min(mesh, values, dtype: torch.dtype) -> list:
    """Elementwise minimum of the numbers ``values`` over every rank of
    ``mesh`` (the whole default group, as :func:`barrier` takes it): one
    all-reduce, on the rank's device under NCCL and in host memory under
    any other backend. A 1x1 mesh makes no call."""
    if mesh.size() == 1:
        return list(values)
    host = dist.get_backend() != dist.Backend.NCCL
    t = torch.tensor(values, dtype=dtype,
                     device="cpu" if host else mesh_device(mesh))
    dist.all_reduce(t, op=dist.ReduceOp.MIN)
    return t.tolist()


def agree_bounds(mesh, lo, hi):
    """(max ``lo``, min ``hi``) over every rank of ``mesh``: the span every
    rank can see. SPMD ranks read a growing capture's bounds at different
    moments, where the JAX controller reads them once, so a decision that
    gates a collective (the blocks to push, a backlog restart, the tail's
    length, a request's span) is taken on agreed bounds, or one rank
    pushes a block the others do not and the next gather hangs. Integers
    agree as int64, floats (a capture's time bounds) as float64. A 1x1
    mesh makes no call."""
    dtype = (torch.float64 if isinstance(lo, float) or isinstance(hi, float)
             else torch.int64)
    neg_lo, hi = _mesh_min(mesh, [-lo, hi], dtype)
    return -neg_lo, hi


def every_rank(mesh, flag: bool) -> bool:
    """Whether ``flag`` holds on every rank of ``mesh`` (a logical and over
    the mesh): a per-rank observation that decides whether the ranks run a
    collective (the written loop's skip of an unchanged request) is taken
    together. A 1x1 mesh makes no call."""
    return _mesh_min(mesh, [int(flag)], torch.int64)[0] == 1


def barrier(mesh) -> None:
    """Wait until every rank of ``mesh`` (the whole default group) arrives
    here; a 1x1 mesh makes no call."""
    if mesh.size() > 1:
        dist.barrier()


def all_to_all(x: torch.Tensor, mesh, axis: str, split_dim: int,
               concat_dim: int) -> torch.Tensor:
    """``jax.lax.all_to_all(x, axis, split_dim, concat_dim, tiled=False)``:
    ``x.shape[split_dim]`` equals the axis size n; block i along it goes to
    coordinate i, and the result has that dim removed and a new dim of
    size n, indexing the source coordinate, inserted at ``concat_dim``."""
    n = axis_size(mesh, axis)
    if x.shape[split_dim] != n:
        raise ValueError(f"all_to_all splits dim {split_dim} of size "
                         f"{x.shape[split_dim]} over {n} ranks")
    if n == 1:
        return x.movedim(split_dim, concat_dim)
    group, host = _route(mesh, axis)
    src = _real(x.movedim(split_dim, 0)).contiguous()
    send = src.cpu() if host else src
    # all_to_all_single splits dim 0 into n blocks in rank order and
    # stacks the received blocks the same way: dim 0 of the result indexes
    # the source
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    out = recv.to(x.device)
    if x.is_complex():
        out = torch.view_as_complex(out)
    return out.movedim(0, concat_dim)


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def pad_starts(starts: np.ndarray, multiple: int) -> Tuple[np.ndarray, int]:
    """Pad frame starts to a multiple of the time-axis size by repeating the
    last start; returns (padded, original_len). Padded columns recompute the
    final column and are dropped on the host — cheap and shape-static."""
    n = len(starts)
    target = pad_to_multiple(n, multiple)
    if target == n:
        return starts, n
    pad = np.full(target - n, starts[-1], dtype=starts.dtype)
    return np.concatenate([starts, pad]), n


def pad_contiguous_block(
    samples_pm: np.ndarray, ntime: int, frame_len: int, multiple: int
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Pad a PACKED contiguous frame block (column t's frame at
    t*frame_len — the layout models.sti.assemble_device_block always
    produces) to a column count divisible by the time-axis size.

    Unlike :func:`pad_starts` (which repeats the last start and therefore
    needs the sample buffer replicated across the time axis so every
    device can reach it), the padded columns here EXTEND the ladder into
    appended zero samples, keeping column t's frame at t*frame_len
    everywhere — so the buffer itself shards over ``time``: each device
    stores and receives only its own span (1/time_axis of the bytes) and
    the per-shard kernel keeps the gather-free contiguous layout.

    Returns (samples_padded, starts_padded, original_ntime); padded
    columns are excluded from the median via ntime_valid and dropped on
    the host.
    """
    target = pad_to_multiple(ntime, multiple)
    starts = np.arange(target, dtype=np.int32) * frame_len
    if target != ntime:
        pad = np.zeros(
            (samples_pm.shape[0], (target - ntime) * frame_len),
            samples_pm.dtype,
        )
        samples_pm = np.concatenate([samples_pm, pad], axis=1)
    return samples_pm, starts, ntime
