"""Colormaps and level quantization.

The reference builds a 256-color viridis ListedColormap with an alpha
column (reference: drfview.py:1043-1049) and quantizes the dB range into
``npoints`` linear levels (reference: drfview.py:1057); a dormant 500-entry
"spectral" text colormap ships with it (reference: spectralcolors.txt,
loading commented out at drfview.py:1044-1045). Both capabilities exist
here: viridis (from matplotlib when present, else a procedural fallback)
and a procedurally generated 500-level legacy-style ramp.

Copy of pyspectrogram_tpu/display/colormap.py: the port imports nothing of that
package.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def viridis_colors(n: int = 256) -> np.ndarray:
    """(n, 3) float RGB in [0,1]. Uses matplotlib's table when available
    (what the reference uses, drfview.py:1043); otherwise a smooth
    polynomial approximation of the same perceptually-uniform ramp."""
    try:
        from matplotlib import cm

        base = np.asarray(cm.viridis.colors)
    except Exception:
        t = np.linspace(0.0, 1.0, 256)
        # smooth approx: dark purple -> teal -> green -> yellow
        r = 0.277 + t * (0.105 + t * (-2.341 + t * (6.343 + t * (-4.784 + t * 1.393))))
        g = 0.005 + t * (1.405 + t * (-1.383 + t * (1.174 + t * (-0.296))))
        b = 0.334 + t * (1.385 + t * (-5.231 + t * (7.706 + t * (-4.060))))
        base = np.clip(np.stack([r, g, b], axis=1), 0.0, 1.0)
    if n == len(base):
        return base
    idx = np.linspace(0, len(base) - 1, n)
    out = np.empty((n, 3))
    for c in range(3):
        out[:, c] = np.interp(idx, np.arange(len(base)), base[:, c])
    return out


def spectral_legacy_colors(n: int = 500) -> np.ndarray:
    """(n, 3) procedural dark-gray -> blue -> green -> yellow -> red ramp —
    the capability slot of the reference's dormant 500-level
    spectralcolors table (same role, independently generated values)."""
    anchors_pos = np.array([0.0, 0.15, 0.35, 0.55, 0.75, 0.9, 1.0])
    anchors_rgb = np.array([
        [0.15, 0.15, 0.15],   # dark gray
        [0.10, 0.15, 0.55],   # deep blue
        [0.05, 0.45, 0.85],   # blue
        [0.10, 0.70, 0.30],   # green
        [0.95, 0.90, 0.15],   # yellow
        [0.90, 0.35, 0.05],   # orange
        [0.55, 0.05, 0.05],   # dark red
    ])
    t = np.linspace(0.0, 1.0, n)
    out = np.empty((n, 3))
    for c in range(3):
        out[:, c] = np.interp(t, anchors_pos, anchors_rgb[:, c])
    return out


def get_colormap(name: str = "viridis", n: Optional[int] = None) -> np.ndarray:
    if name == "viridis":
        return viridis_colors(n or 256)
    if name in ("spectral_legacy", "legacy"):
        return spectral_legacy_colors(n or 500)
    raise ValueError(f"unknown colormap {name!r}")


def rgba_lut(colors: np.ndarray) -> np.ndarray:
    """(n,3) float RGB -> (n,4) uint8 RGBA with opaque alpha (the reference
    appends an all-ones alpha column, drfview.py:1047-1049)."""
    rgba = np.concatenate([colors, np.ones((len(colors), 1))], axis=1)
    return np.round(rgba * 255.0).astype(np.uint8)


def quantize_levels(crange: Tuple[float, float], npoints: int) -> np.ndarray:
    """Linear dB level edges (reference: drfview.py:1057)."""
    return np.linspace(crange[0], crange[1], npoints)
