"""Analysis windows, computed in float64 on the host.

A numpy copy of pyspectrogram_tpu/ops/windows.py: importing that module
loads jax through its package (pyspectrogram_tpu/ops/__init__.py imports
ops.stft), and this package never imports jax. A test pins the copy to the
original bit for bit.

The reference uses ``scipy.signal.get_window(("kaiser", 1.7), nfft)``
(reference: drfProc.py:386), i.e. a *periodic* (fftbins=True) Kaiser window.
Windows here are generated from the defining formulas in numpy float64 and
passed to the device as float32 constants, so device kernels never recompute
Bessel functions and the oracle/device paths share one definition.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import numpy as np

WindowSpec = Union[str, Tuple]


def get_window(spec: WindowSpec, nfft: int, dtype=np.float64) -> np.ndarray:
    """Periodic window of length nfft.

    Accepts "hann", "hamming", "blackman", "boxcar"/"rect", or
    ("kaiser", beta) — the reference's default is ("kaiser", 1.7)
    (reference: drfProc.py:386).
    """
    if isinstance(spec, str):
        name, args = spec.lower(), ()
    else:
        name, *args = spec
        name = name.lower()

    if name == "kaiser":
        beta = float(args[0]) if args else 1.7
        w = _kaiser_periodic(nfft, beta)
    elif name == "hann":
        w = _cosine_sum(nfft, [0.5, 0.5])
    elif name == "hamming":
        w = _cosine_sum(nfft, [0.54, 0.46])
    elif name == "blackman":
        w = _cosine_sum(nfft, [0.42, 0.5, 0.08])
    elif name in ("boxcar", "rect", "rectangular"):
        w = np.ones(nfft)
    else:
        raise ValueError(f"unknown window {spec!r}")
    return w.astype(dtype)


def _kaiser_periodic(nfft: int, beta: float) -> np.ndarray:
    # periodic = symmetric window of length nfft+1 with the last point dropped
    n = np.arange(nfft + 1, dtype=np.float64)
    ratio = 2.0 * n / nfft - 1.0
    w = np.i0(beta * np.sqrt(np.maximum(1.0 - ratio * ratio, 0.0))) / np.i0(beta)
    return w[:-1]


def _cosine_sum(nfft: int, coeffs: Sequence[float]) -> np.ndarray:
    n = np.arange(nfft, dtype=np.float64)
    w = np.zeros(nfft)
    for k, a in enumerate(coeffs):
        w += (-1.0) ** k * a * np.cos(2.0 * np.pi * k * n / nfft)
    return w
