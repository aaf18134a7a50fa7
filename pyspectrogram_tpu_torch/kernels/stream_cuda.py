"""Kernel B3: the overlap-hop streaming push on the card
(csrc/stream_psd.cu).

Replaces pyspectrogram_tpu/kernels/sti_pallas.py::make_pallas_stream_psd:
column t's frame starts at element offset t*hop of the push buffer (the
carry followed by the block), so columns overlap when hop < frame_len. It
is B1's FFT with the frame start computed in the kernel, for power-of-two
256 <= nfft <= 32768 and any 0 < hop < frame_len (the TPU kernel's
lane-alignment and VMEM gate has no counterpart on the card). The source
says what bounds it and why.

:func:`stream_psd_cuda` launches the kernel for a CUDA tensor and raises on
anything the kernel does not take; a CPU tensor takes the plain version,
ops.plain.psd_torch at starts t*hop.
"""

from __future__ import annotations

import torch

from pyspectrogram_tpu_torch.kernels import _build, sti_cuda
from pyspectrogram_tpu_torch.ops.plain import psd_torch

#: B1's sizes: one block per column up to sti_cuda.ONE_BLOCK_MAX_NFFT,
#: the four-step split through a workspace at 32768
MIN_NFFT = sti_cuda.MIN_NFFT
MAX_NFFT = sti_cuda.B1_MAX_NFFT


def stream_psd_cuda(buf_pm: torch.Tensor, *, nfft: int, nint: int = 1,
                    hop: int, mode: str = "welch", window=("kaiser", 1.7),
                    ref: float = 1.0) -> torch.Tensor:
    """Plane-major push buffer (nsub*2, frame_len - hop + k*hop) float32
    -> fftshifted linear power (k, nsub, nfft), column t framed at t*hop.
    Launches on the current stream without synchronising."""
    frame_len = nfft * nint
    if not 0 < hop < frame_len:
        raise ValueError(f"hop must be in (0, frame_len={frame_len}), "
                         f"got {hop}")
    width = buf_pm.shape[1]
    k = (width - (frame_len - hop)) // hop
    if k < 1 or width != frame_len - hop + k * hop:
        # the message of make_pallas_stream_psd (sti_pallas.py:892-895)
        raise ValueError(f"buffer width {width} is not carry + k*hop "
                         f"(frame_len={frame_len}, hop={hop})")
    if buf_pm.device.type == "cpu":
        starts = torch.arange(k, dtype=torch.int32) * hop
        return psd_torch(buf_pm, starts, nfft=nfft, nint=nint, mode=mode,
                         window=window, ref=ref)
    if not (MIN_NFFT <= nfft <= MAX_NFFT) or nfft & (nfft - 1):
        raise ValueError(f"kernel B3 covers power-of-two nfft in "
                         f"[{MIN_NFFT}, {MAX_NFFT}], got {nfft}")
    _build.check_psd_args(buf_pm, mode, (torch.float32,), "stream")
    if width >= 1 << 31:
        raise ValueError("push buffer beyond 2^31 samples")
    nsub = buf_pm.shape[0] // 2
    nseg = nint if mode == "welch" else 1
    win, tw, inv_scale = _build.psd_device_constants(
        nfft, nint, mode, window, ref, buf_pm.device)
    out = torch.empty((k, nsub, nfft), dtype=torch.float32,
                      device=buf_pm.device)
    work = None
    if nfft > sti_cuda.ONE_BLOCK_MAX_NFFT:
        work = torch.empty((k, nsub, nseg, nfft, 2), dtype=torch.float32,
                           device=buf_pm.device)
    rc = _build.library().pst_stream_psd(
        buf_pm.data_ptr(), width, nsub, hop, k, nfft, nseg,
        win.data_ptr(), tw.data_ptr(), inv_scale,
        None if work is None else work.data_ptr(), out.data_ptr(),
        _build.stream_of(buf_pm))
    _build.check(rc, "stream_psd")
    _build.count(stream_psd_cuda)
    return out


#: kernel launches in this process (set to 0 to count a run's own)
stream_psd_cuda.launches = 0
