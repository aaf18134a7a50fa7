"""Hand-written CUDA kernels for Hopper and their ctypes wrappers.

B1 (sti_cuda) and B2 (median_cuda); the sources live in ../csrc and build
on the first CUDA use (_build). Nothing here needs nvcc at import.
"""
