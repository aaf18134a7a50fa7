"""On-device display tiles: crop + decimate + quantize on the samples'
device — the port of quantize_tile_linear / quantize_db_tile /
tile_from_linear / tile_from_db (pyspectrogram_tpu/display/tile.py:109-195)
and quantize_db_levels (pyspectrogram_tpu/display/render.py:44-55).

Only the uint8 level-index tile leaves the device. The crop plan and the
colour range come from the JAX package's jax-free :class:`TileSpec`; the
colour range is a runtime operand (``TileSpec.qparams``), so a re-clim
changes no code path. The elementwise math is the reference's, step for
step: strided slice, ``10*log10(x + eps)``, ``(db - cmin) * scale``,
round half to even, clamp, uint8.
"""

from __future__ import annotations

import numpy as np
import torch

from pyspectrogram_tpu.display import tile as _host
from pyspectrogram_tpu.display.tile import (  # noqa: F401  (re-exported)
    TileSpec,
    make_tile_spec,
    tile_freqs,
)
from pyspectrogram_tpu_torch.ops.plain import to_dbfs


def quantize_db_levels(db: torch.Tensor, qparams, npoints: int):
    """dB values -> uint8 levels with the colour range as a (2,)
    [cmin, scale] float32 operand, or (B, 2) for a batch of requests
    along ``db``'s leading axis (what ``jax.vmap`` over qparams gives the
    JAX package's merged launch, models/batch.py:132-134). One pair enters
    the arithmetic as float32 scalars, so no host-to-device copy waits on
    the stream; B pairs as float32 (B, 1, ...) tensors. Either way the
    arithmetic is float32 ``(db - cmin) * scale``, round half to even,
    clamp."""
    if isinstance(qparams, torch.Tensor):
        qparams = qparams.detach().cpu().numpy()
    qp = np.asarray(qparams, np.float32)
    if qp.ndim == 2:
        col = torch.from_numpy(np.ascontiguousarray(qp.T)).to(db.device)
        shape = (qp.shape[0],) + (1,) * (db.dim() - 1)
        cmin, scale = col[0].reshape(shape), col[1].reshape(shape)
    else:
        cmin, scale = (float(v) for v in qp)
    q = (db - cmin) * scale
    return torch.clamp(torch.round(q), 0, npoints - 1).to(torch.uint8)


def quantize_db_tile(db: torch.Tensor, spec: TileSpec, qparams=None):
    """dBFS values -> uint8 levels (the quantization half of the epilogue,
    reference: drfview.py:1057 + clamp drfview.py:1515-1516)."""
    if qparams is None:
        qparams = spec.qparams
    return quantize_db_levels(db, qparams, spec.npoints)


def quantize_tile_linear(p_linear: torch.Tensor, spec: TileSpec,
                         eps: float = 1e-15, qparams=None):
    """LINEAR fftshifted power (..., nfft) -> uint8 tile (..., plot_n).
    Crop and decimation come first (one strided slice), so the dB and the
    quantization touch only the kept bins."""
    hi = spec.plot_lo + spec.plot_step * (spec.plot_n - 1) + 1
    sl = p_linear[..., spec.plot_lo:hi:spec.plot_step]
    return quantize_db_tile(to_dbfs(sl, eps), spec, qparams)


def tile_from_linear(p_linear, spec: TileSpec, eps: float = 1e-15
                     ) -> np.ndarray:
    """One-shot helper: linear power (a tensor on any device, or a host
    array) -> host uint8 tile, quantized on the tensor's device."""
    return quantize_tile_linear(torch.as_tensor(p_linear), spec,
                                eps).cpu().numpy()


def tile_from_db(db, spec: TileSpec) -> np.ndarray:
    """dBFS spectra (..., nfft) -> host uint8 tile. A tensor is cropped and
    quantized on its device before the readback; a host array takes the
    JAX module's numpy path (the same float32 ops, bit-identical levels)."""
    if isinstance(db, np.ndarray):
        return _host.tile_from_db(db, spec)
    hi = spec.plot_lo + spec.plot_step * (spec.plot_n - 1) + 1
    return quantize_db_tile(db[..., spec.plot_lo:hi:spec.plot_step],
                            spec).cpu().numpy()
