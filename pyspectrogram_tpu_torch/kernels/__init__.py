"""Hand-written CUDA kernels for Hopper and their ctypes wrappers.

B1 (sti_cuda), B2 (median_cuda), B3 (stream_cuda) and B4 (big_cuda); the
sources live in ../csrc and build on the first CUDA use (_build). Nothing
here needs nvcc at import.
"""
