"""The yardstick of the kernel layers: the card's peaks and the least time
a request's or a tick's device work could take, worked out from shapes.

The bound arithmetic is that of the port's bench (``bound``: bytes each
read or written once at the HBM rate, float32 operations at the rate
outside the tensor cores, the larger time wins; a PSD's operations are
5 N log2 N for the FFT plus 7 N for the window, |X|^2, the Welch sum and
the scale, per transform; the median one comparison per element), kept
here so that no change to the program can move it.
"""

from __future__ import annotations

import math

#: an H100 SXM's published peaks at 700 W (NVIDIA's data sheet): HBM
#: bandwidth and float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12


def bound_s(nbytes: float, flops: float) -> float:
    """The least seconds for work that moves ``nbytes`` and does
    ``flops`` float32 operations."""
    return max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S)


def psd_flops(nfft: int, n_transforms: int) -> float:
    return n_transforms * (5 * nfft * math.log2(nfft) + 7 * nfft)


def request_work(*, nfft: int, nint: int, ntime: int, nsub: int,
                 sample_bytes: int, tile_bins: int = 0) -> tuple:
    """(bytes, flops) of one view's device half: the block read once,
    the spectra (dB float32, or a uint8 tile of ``tile_bins`` bins) and
    the median written once; the transforms and one comparison per
    element for the median."""
    block = nsub * ntime * nfft * nint * sample_bytes
    spectra = ntime * nsub * (tile_bins if tile_bins else nfft * 4)
    median = nsub * nfft * 4
    flops = psd_flops(nfft, ntime * nsub * nint) + ntime * nsub * nfft
    return block + spectra + median, flops


def tick_work(*, nfft: int, hop: int, nsub: int, new_samples: int,
              window_cols: int, view_rows: int, tile_bins: int,
              sample_bytes: int) -> tuple:
    """(bytes, flops) of one live tick: its new samples read once, their
    new columns written once, the window's columns read once by the
    median, the median and the view (uint8 tile) written once; the new
    columns' transforms and one comparison per window element."""
    new_cols = new_samples // hop
    nbytes = (new_samples * nsub * sample_bytes
              + new_cols * nsub * nfft * 4
              + window_cols * nsub * nfft * 4
              + nsub * nfft * 4
              + view_rows * nsub * tile_bins)
    flops = psd_flops(nfft, new_cols * nsub) + window_cols * nsub * nfft
    return nbytes, flops
