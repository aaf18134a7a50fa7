"""Hand-written CUDA kernels for Hopper and their ctypes wrappers, and the
GEMM DFT.

B1 (sti_cuda), B2 (median_cuda), B3 (stream_cuda) and B4 (big_cuda); the
sources live in ../csrc and build on the first CUDA use (_build). Nothing
here needs nvcc at import. gemm_fft is the JAX package's XLA GEMM DFT as
torch matmuls, exported under the JAX package's names; the Pallas-only
names have no counterpart here.
"""

from pyspectrogram_tpu_torch.kernels.gemm_fft import make_gemm_fft, make_plan

__all__ = [
    "make_gemm_fft",
    "make_plan",
]
