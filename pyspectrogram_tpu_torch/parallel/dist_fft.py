"""Distributed 4-step FFT over the ranks of a mesh axis — the port of
pyspectrogram_tpu/parallel/dist_fft.py on torch.distributed.

Classic 4-step factorization N = N1 * N2 with x2[p, q] = x[p*N2 + q]
sharded over the q (column) axis:

  1. local stage:  Y = DFT_N1 along p      (each rank holds all p for its
                                            q-slice -> a local FFT)
  2. local twiddle Z[p, q] = Y[p, q] * W_N^(q p)
  3. all-to-all:   transpose the shard axis q -> p (parallel.mesh)
  4. local stage:  X' = DFT_N2 along q     (each rank now holds all q for
                                            its p-slice)

Output element X[N1*k2 + k1] = X'[k1, k2]; the function returns this rank's
rows of the (N1, N2) matrix, sharded over k1 (natural order =
transpose-flatten: :func:`reference_order` of the assembled matrix). The
local stages are torch.fft.fft, as the JAX package's are jnp.fft.fft.
:func:`split_for_devices` and :func:`reference_order` are copies of
pyspectrogram_tpu/parallel/dist_fft.py's: the port imports nothing of that
package.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from pyspectrogram_tpu_torch.kernels.gemm_fft import twiddle_mat
from pyspectrogram_tpu_torch.parallel import mesh as pmesh


def split_for_devices(nfft: int, ndev: int) -> Tuple[int, int]:
    """(n1, n2) power-of-two split with both axes divisible by ndev."""
    if nfft & (nfft - 1):
        raise ValueError("distributed FFT requires power-of-two nfft")
    n1 = 1 << ((nfft.bit_length() - 1) // 2)
    n2 = nfft // n1
    if n1 % ndev or n2 % ndev:
        raise ValueError(f"nfft {nfft} not splittable over {ndev} devices")
    return n1, n2


@functools.lru_cache(maxsize=16)
def _twiddle_cols(n1: int, n2: int, nfft: int, q0: int, q1: int,
                  device: torch.device) -> torch.Tensor:
    """Columns [q0, q1) of the (n1, n2) twiddle exp(-2pi*i*pq/nfft), built
    in float64 on the host, rounded to complex64, on ``device``."""
    t = twiddle_mat(n1, n2, nfft)[:, q0:q1].astype(np.complex64)
    return torch.from_numpy(np.ascontiguousarray(t)).to(device)


def local_twiddle(mesh, axis: str, n1: int, n2: int, nfft: int,
                  device: torch.device) -> torch.Tensor:
    """This rank's q-slice of the twiddle: the columns of its coordinate
    along ``axis``."""
    ndev = pmesh.axis_size(mesh, axis)
    q0 = pmesh.axis_index(mesh, axis) * (n2 // ndev)
    return _twiddle_cols(n1, n2, nfft, q0, q0 + n2 // ndev,
                         torch.device(device))


def transpose_shards(z: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """(..., n1, n2/ndev) q-sharded -> (..., n1/ndev, n2) k1-sharded, by
    one all-to-all over ``axis``: row block i goes to coordinate i, and
    the received blocks (indexed by their source, i.e. by q block) are
    laid side by side along q."""
    ndev = pmesh.axis_size(mesh, axis)
    n1, nq = z.shape[-2:]
    lead = z.shape[:-2]
    z = z.reshape(lead + (ndev, n1 // ndev, nq))
    d = len(lead)
    z = pmesh.all_to_all(z, mesh, axis, split_dim=d, concat_dim=d)
    # dim d now indexes the SOURCE coordinate = the global q block
    return z.movedim(d, d + 1).reshape(lead + (n1 // ndev, ndev * nq))


@functools.lru_cache(maxsize=16)
def make_distributed_fft(mesh, axis: str, nfft: int):
    """Build ``f(xr, xi) -> (Xr, Xi)``: an nfft-point complex FFT sharded
    over ``mesh``'s ``axis``, on this rank's shards.

    Inputs are this rank's columns of the (n1, n2) real/imag planes
    (``f.input_spec`` = (None, axis)), float32 on the rank's device;
    outputs its rows (``f.output_specs``: (axis, None)) with
    X[n1*k2 + k1] = out[k1, k2]. All communication is one all-to-all."""
    ndev = pmesh.axis_size(mesh, axis)
    n1, n2 = split_for_devices(nfft, ndev)

    def dist_fft(xr: torch.Tensor, xi: torch.Tensor):
        tw = local_twiddle(mesh, axis, n1, n2, nfft, xr.device)
        # stage 1: DFT along p (dim 0) — the shard holds all p
        y = torch.fft.fft(torch.complex(xr.float(), xi.float()), dim=0) * tw
        # q -> k1 sharding, then stage 2: DFT along q (dim 1)
        x = torch.fft.fft(transpose_shards(y, mesh, axis), dim=1)
        return x.real, x.imag

    dist_fft.input_spec = (None, axis)
    dist_fft.output_specs = ((axis, None), (axis, None))
    dist_fft.n1n2 = (n1, n2)
    return dist_fft


def reference_order(xm: np.ndarray) -> np.ndarray:
    """(n1, n2) 4-step output -> natural (nfft,) bin order."""
    return np.asarray(xm).T.reshape(-1)
