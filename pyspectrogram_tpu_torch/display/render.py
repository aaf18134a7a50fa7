"""Display preparation on one torch device — the port of the device half of
pyspectrogram_tpu/display/render.py.

Colour quantization (clamp to the dB range, map linearly onto npoints
levels; reference: drfview.py:1057, 1515-1516) runs on ``device``, so only
a uint8 level tile comes back to the host, where the RGBA LUT applies.
:func:`quantize_on_device` runs display.tile.quantize_db_levels, the same
arithmetic as the on-device display tiles; :func:`sti_tile` and the
``pixels`` branch of :func:`save_sti_png` call it.

The host helpers — the crop/decimation plan, the LUT, the PNG, CSV and
``.npz`` writers — are the JAX module's own, re-exported here: that module
imports jax only inside its device functions. So is the ``matplotlib``
branch of :func:`save_sti_png` (filled contours on the host).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from pyspectrogram_tpu.display import render as _host
from pyspectrogram_tpu.display.colormap import get_colormap
from pyspectrogram_tpu.display.render import (  # noqa: F401  (re-exported)
    apply_lut,
    freq_crop_decimate,
    quantize_params,
    resample_colors,
    save_psd_csv,
    save_result_npz,
    save_tile_png,
)
from pyspectrogram_tpu.utils.config import MAX_PLOT_FREQS
from pyspectrogram_tpu_torch.display.tile import quantize_db_levels

Device = Union[str, torch.device]


def quantize_on_device(sxx_dbfs, crange: Tuple[float, float],
                       npoints: int = 256, *, device: Device) -> np.ndarray:
    """dB array (host array or tensor) -> uint8 level indices, computed in
    float32 on ``device``.

    Values outside crange clamp to the end levels (the reference clamps
    before contouring, drfview.py:1515-1516). npoints <= 256 so a single
    byte per pixel comes back to the host.
    """
    # models.sti imports ops.stft, which imports this package
    from pyspectrogram_tpu_torch.models.sti import check_device

    if npoints > 256:
        raise ValueError("npoints must fit uint8 (<=256)")
    if isinstance(sxx_dbfs, np.ndarray):
        sxx_dbfs = torch.from_numpy(np.ascontiguousarray(sxx_dbfs,
                                                         np.float32))
    db = sxx_dbfs.to(check_device(device), torch.float32)
    return quantize_db_levels(db, quantize_params(crange, npoints),
                              npoints).cpu().numpy()


def sti_tile(
    sxx_dbfs: np.ndarray,
    freqs_hz: np.ndarray,
    crange: Tuple[float, float],
    frange_khz: Tuple[float, float] = (-1e9, 1e9),
    colors: Optional[np.ndarray] = None,
    max_nfreqs: int = MAX_PLOT_FREQS,
    *,
    device: Device,
) -> Tuple[np.ndarray, np.ndarray]:
    """One STI image tile: (rgba (ntime, nplot, 4) uint8, plot_freqs_hz).

    ``sxx_dbfs`` is (nfft, ntime) — one subchannel in reference layout.
    Time ascends upward in the reference's waterfall (README.md:11);
    orientation is left to the client, this returns time-major rows.
    """
    idx, plot_freqs = freq_crop_decimate(freqs_hz, frange_khz, max_nfreqs)
    npoints = len(colors) if colors is not None else 256
    q = quantize_on_device(np.asarray(sxx_dbfs)[idx, :].T, crange,
                           min(npoints, 256), device=device)
    return apply_lut(q, colors), plot_freqs


def save_sti_png(
    filename: str,
    freqs_hz: np.ndarray,
    times: Sequence,
    sxx_dbfs: np.ndarray,
    colorrange: Tuple[float, float],
    freqrange_khz: Tuple[float, float] = (-1e9, 1e9),
    timerange: Optional[Tuple] = None,
    colors: Optional[np.ndarray] = None,
    renderer: str = "auto",
    *,
    device: Device,
) -> str:
    """Save an STI waterfall PNG (reference saveSpectroFile,
    drfview.py:1459-1527), with the JAX function's contract.

    sxx_dbfs: (nfft, ntime) single-subchannel spectra. Appends ``.png`` if
    missing; crops by frequency (kHz) and time masks with np.ix_ semantics
    (reference: drfview.py:1490-1502); clamps to colorrange
    (drfview.py:1515-1516); renders 500-level filled contours via
    matplotlib when available (the JAX function's host code), else
    quantizes the pixel tile on ``device`` and writes it via PIL.
    """
    if renderer == "auto":
        try:
            import matplotlib  # noqa: F401

            renderer = "matplotlib"
        except ImportError:
            renderer = "pixels"
    if renderer == "matplotlib":
        return _host.save_sti_png(filename, freqs_hz, times, sxx_dbfs,
                                  colorrange, freqrange_khz, timerange,
                                  colors, renderer="matplotlib")
    from PIL import Image

    if filename[-4:].lower() != ".png":
        filename += ".png"
    fvec_khz = np.asarray(freqs_hz) * 1e-3
    times = np.asarray(times)
    keepf = (fvec_khz >= freqrange_khz[0]) & (fvec_khz <= freqrange_khz[1])
    if timerange is not None:
        keept = (times >= timerange[0]) & (times <= timerange[1])
    else:
        keept = np.ones(len(times), bool)
    spectra = np.asarray(sxx_dbfs)[np.ix_(keepf, keept)].astype(float)
    np.clip(spectra, colorrange[0], colorrange[1], out=spectra)
    cdata = get_colormap("viridis", 500) if colors is None else colors
    q = quantize_on_device(spectra.T[::-1], colorrange,
                           min(len(cdata), 256), device=device)
    Image.fromarray(apply_lut(q, cdata), mode="RGBA").save(filename)
    return filename
