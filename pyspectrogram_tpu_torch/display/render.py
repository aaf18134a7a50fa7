"""Display preparation on one torch device — the port of the device half of
pyspectrogram_tpu/display/render.py.

Colour quantization (clamp to the dB range, map linearly onto npoints
levels; reference: drfview.py:1057, 1515-1516) runs on ``device``, so only
a uint8 level tile comes back to the host, where the RGBA LUT applies.
:func:`quantize_on_device` runs display.tile.quantize_db_levels, the same
arithmetic as the on-device display tiles; :func:`sti_tile` and the
``pixels`` branch of :func:`save_sti_png` call it.

The host helpers — the crop/decimation plan, the quantization operand, the
LUT, the PNG, CSV and ``.npz`` writers, and the ``matplotlib`` branch of
:func:`save_sti_png` (filled contours on the host) — are copies of
pyspectrogram_tpu/display/render.py's host code, without its jax code: the
port imports nothing of that package.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from pyspectrogram_tpu_torch.display.colormap import get_colormap, rgba_lut
from pyspectrogram_tpu_torch.utils.config import MAX_PLOT_FREQS

Device = Union[str, torch.device]


def freq_crop_decimate(
    freqs_hz: np.ndarray,
    frange_khz: Tuple[float, float],
    max_nfreqs: int = MAX_PLOT_FREQS,
) -> Tuple[np.ndarray, np.ndarray]:
    """(plot_indices, plot_freqs_hz) — the reference's decimation plan
    (reference: drfview.py:1006-1023)."""
    keep = (freqs_hz >= 1e3 * frange_khz[0]) & (freqs_hz <= 1e3 * frange_khz[1])
    kept = freqs_hz[keep]
    inds = np.flatnonzero(keep)
    if len(kept) == 0:
        return np.asarray([], int), np.asarray([])
    fscale = int(np.ceil(len(kept) / max_nfreqs))
    rel = np.arange(int(np.floor(fscale / 2)), len(kept), fscale)
    return inds[rel], kept[rel]


def quantize_params(crange: Tuple[float, float], npoints: int) -> np.ndarray:
    """(2,) float32 [cmin, scale] runtime operand for quantize_db_levels;
    scale computed in float64 here so traced math matches host numpy."""
    scale = (npoints - 1) / (float(crange[1]) - float(crange[0]))
    return np.asarray([crange[0], scale], np.float32)


def resample_colors(colors: np.ndarray, nlevels: int) -> np.ndarray:
    """Resample a color ramp to exactly nlevels entries spanning the FULL
    ramp (level nlevels-1 maps to the ramp's last color — slicing the
    head of a 500-entry ramp would leave the top half unreachable)."""
    colors = np.asarray(colors)
    if len(colors) == nlevels:
        return colors
    idx = np.round(np.linspace(0, len(colors) - 1, nlevels)).astype(int)
    return colors[idx]


def apply_lut(indices: np.ndarray, colors: Optional[np.ndarray] = None) -> np.ndarray:
    """uint8 level indices -> (..., 4) uint8 RGBA on host. Ramps longer
    than 256 entries are resampled across the full span so the maximum
    level renders the ramp's top color."""
    cdata = get_colormap("viridis") if colors is None else np.asarray(colors)
    if len(cdata) > 256:
        cdata = resample_colors(cdata, 256)
    lut = rgba_lut(cdata)
    return lut[indices]


def quantize_on_device(sxx_dbfs, crange: Tuple[float, float],
                       npoints: int = 256, *, device: Device) -> np.ndarray:
    """dB array (host array or tensor) -> uint8 level indices, computed in
    float32 on ``device``.

    Values outside crange clamp to the end levels (the reference clamps
    before contouring, drfview.py:1515-1516). npoints <= 256 so a single
    byte per pixel comes back to the host.
    """
    # models.sti imports ops.stft, which imports this package, and
    # display.tile imports this module
    from pyspectrogram_tpu_torch.display.tile import quantize_db_levels
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
    f_khz = fvec_khz[keepf]
    t = times[keept]
    np.clip(spectra, colorrange[0], colorrange[1], out=spectra)
    cdata = get_colormap("viridis", 500) if colors is None else colors

    if renderer == "auto":
        try:
            import matplotlib  # noqa: F401

            renderer = "matplotlib"
        except ImportError:
            renderer = "pixels"

    if renderer == "matplotlib":
        # Object-oriented Agg path, no pyplot: pyplot's global figure
        # manager is not thread-safe, and the GUI runs saves on a worker
        # thread concurrently with GUI-thread canvas drawing.
        from matplotlib.backends.backend_agg import FigureCanvasAgg
        from matplotlib.figure import Figure

        fig = Figure()
        FigureCanvasAgg(fig)
        fig.set_size_inches(8, 4)
        ax = fig.add_axes([0.1, 0.15, 0.8, 0.80])
        levels = np.linspace(colorrange[0], colorrange[1], len(cdata))
        ax.contourf(f_khz, t, spectra.T, levels=levels, colors=list(cdata))
        ax.set_ylabel("Time")
        ax.set_xlabel("Frequency (kHz)")
        fig.savefig(filename, format="png", dpi=300)
    else:
        from PIL import Image

        q = quantize_on_device(spectra.T[::-1], colorrange,
                               min(len(cdata), 256), device=device)
        Image.fromarray(apply_lut(q, cdata), mode="RGBA").save(filename)
    return filename


def save_tile_png(filename: str, tile: np.ndarray,
                  colors: Optional[np.ndarray] = None) -> str:
    """Write a display tile (uint8 level indices, (ntime, nplot)) straight
    to PNG: apply the RGBA LUT on host and store the pixels — no float
    spectra, no matplotlib. This is the terminal stage of the on-device
    display path (display.tile): crop/decimate/quantize ran on device, the
    host only colorizes. Rows render oldest-at-bottom (time ascending
    upward, reference README.md:11)."""
    if filename[-4:].lower() != ".png":
        filename += ".png"
    from PIL import Image

    cdata = get_colormap("viridis") if colors is None else np.asarray(colors)
    if len(cdata) > 256:
        cdata = resample_colors(cdata, 256)
    lut = rgba_lut(cdata)
    if tile.dtype != np.uint8:
        raise ValueError(f"expected a uint8 level tile, got {tile.dtype}")
    rgba = lut[np.minimum(tile, len(lut) - 1)][::-1]
    Image.fromarray(rgba, mode="RGBA").save(filename)
    return filename


def save_psd_csv(filename: str, freqs_hz: np.ndarray,
                 psd_dbfs: np.ndarray) -> str:
    """Save a median PSD as CSV (the reference README wishlist's 'save PSD'
    item, README.md:18)."""
    if not filename.lower().endswith(".csv"):
        filename += ".csv"
    np.savetxt(filename, np.column_stack([freqs_hz, psd_dbfs]),
               delimiter=",", header="freq_hz,psd_dbfs", comments="")
    return filename


def save_result_npz(filename: str, freqs_hz: np.ndarray, times,
                    sxx_dbfs: np.ndarray, sxx_med_dbfs: np.ndarray,
                    timerange=None, freqrange_khz=None) -> str:
    """Save the full-array artifact (.npz with freqs/times/spectra — the
    reference README wishlist's 'save arrays' item, README.md:17), with
    the same optional time-subset and frequency-window crops the PNG
    artifact honors. One writer for the GUI save sub-tab and the CLI
    --npz sidecar, so the payload layout cannot drift between clients.

    ``sxx_dbfs`` is (nfft, ntime, nsub) frequency-major (StiResult
    layout); ``timerange`` is a (start, end) datetime64 pair,
    ``freqrange_khz`` a (lo, hi) kHz pair."""
    if not filename.lower().endswith(".npz"):
        filename += ".npz"
    keepf = (np.ones(len(freqs_hz), bool) if freqrange_khz is None
             else (freqs_hz * 1e-3 >= freqrange_khz[0])
             & (freqs_hz * 1e-3 <= freqrange_khz[1]))
    keept = (np.ones(len(times), bool) if timerange is None
             else (times >= timerange[0]) & (times <= timerange[1]))
    np.savez(
        filename, freqs=freqs_hz[keepf],
        times=np.datetime_as_string(times[keept], unit="us"),
        sxx_dbfs=sxx_dbfs[np.ix_(keepf, keept)],
        sxx_med_dbfs=sxx_med_dbfs[keepf],
    )
    return filename
