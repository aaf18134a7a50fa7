// Kernel B2 on Hopper: exact median over the time axis of a (batch, n,
// cols) float32 array, one thread per (request, output column). A batch of
// 1 is one request's (n, cols) median; a merged multi-request launch
// (models/batch.py) passes its requests' cubes side by side, request b's
// rows starting at b * n * cols, so no transposed copy is made.
//
// Replaces pyspectrogram_tpu/kernels/median_pallas.py::_make_median_kernel
// (the pallas_call at median_pallas.py:130, reached through
// median_over_time_pallas). Same arithmetic: the float's bits become an
// order-preserving int32 key (sign-magnitude -> two's complement, as
// median_pallas._flip and ops.stft._float_order_key), 33 bisection steps
// over [-0x7F800001, 0x7F800000] find the k-th smallest key exactly, and
// for even n the count/min step gives the (k+1)-th value, so the result is
// the mean of the two middles, bit-equal to np.median on float32.
//
// What bounds it: 33 compare-count passes over each column, i.e. 33 * n
// loads per output, against one read of n * cols * 4 bytes of input.
// Adjacent threads take adjacent columns, so every row read is one
// coalesced transaction per warp; at the STI shapes of the main path
// (n = 128, cols = 2 * 4096, 4 MB) the input stays in the 50 MB L2 after
// the first pass, so the 32 later passes are L2 reads. A shared-memory
// tile would cut that traffic further and is left for later work.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

__device__ __forceinline__ int order_key(float v) {
  const int b = __float_as_int(v);
  return b ^ ((b >> 31) & 0x7FFFFFFF);
}

__global__ void median_kernel(const float* __restrict__ x, int n,
                              long long cols, long long total,
                              float* __restrict__ out) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= total) return;
  const long long b = i / cols;
  const long long c = i - b * cols;
  const float* col = x + b * n * cols + c;
  const int k = (n + 1) / 2;
  int lo = -0x7F800001;
  int hi = 0x7F800000;
  for (int step = 0; step < 33; ++step) {
    // overflow-free floor((lo + hi) / 2): the bracket spans > int32 range
    const int mid = (lo & hi) + ((lo ^ hi) >> 1);
    int cnt = 0;
    for (int r = 0; r < n; ++r)
      cnt += order_key(__ldg(col + r * cols)) <= mid;
    if (cnt >= k)
      hi = mid;
    else
      lo = mid + 1;
  }
  const int kb = hi ^ ((hi >> 31) & 0x7FFFFFFF);
  const float v1 = __int_as_float(kb);
  float med = v1;
  if (!(n & 1)) {
    // if duplicates of v1 span the midpoint it IS the next value; else the
    // next value is the least one strictly above v1
    int cnt_le = 0;
    float bigger = __int_as_float(0x7F800000);  // +inf
    for (int r = 0; r < n; ++r) {
      const float v = __ldg(col + r * cols);
      cnt_le += v <= v1;
      if (v > v1) bigger = fminf(bigger, v);
    }
    const float v2 = cnt_le > k ? v1 : bigger;
    med = 0.5f * (v1 + v2);
  }
  out[i] = med;
}

}  // namespace

// x: (batch, n, cols) contiguous; out: (batch, cols). Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int pst_median(const void* x, int batch, int n, long long cols,
                          void* out, void* stream) {
  if (batch <= 0 || n <= 0 || cols <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int THREADS = 64;
  const long long total = static_cast<long long>(batch) * cols;
  const long long blocks = (total + THREADS - 1) / THREADS;
  median_kernel<<<static_cast<unsigned int>(blocks), THREADS, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), n, cols, total,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
