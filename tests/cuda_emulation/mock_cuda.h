// The CUDA subset of pyspectrogram_tpu_torch/csrc/fft_common.cuh's
// register-pass kernel, on the CPU: one std::thread per CUDA thread of a
// block, std::barrier for __syncthreads, the shared buffer a global array
// (blocks run one after another). tests/test_torch_csrc_emulation.py
// compiles the kernel's own source against it with g++.
#pragma once
#include <barrier>
#include <cstdint>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__

struct float2 {
  float x, y;
};
inline float2 make_float2(float a, float b) { return {a, b}; }

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
inline thread_local dim3 threadIdx, blockIdx;
inline std::barrier<>* block_barrier = nullptr;
inline void __syncthreads() { block_barrier->arrive_and_wait(); }
template <class T>
T __ldg(const T* p) {
  return *p;
}

typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
typedef void* cudaStream_t;
enum { cudaFuncAttributeMaxDynamicSharedMemorySize = 0 };
template <class K>
int cudaFuncSetAttribute(K, int, int) {
  return 0;
}
inline int cudaGetLastError() { return 0; }
