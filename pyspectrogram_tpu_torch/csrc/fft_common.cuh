// The FFT building blocks shared by kernels B1 (sti_psd.cu), B3
// (stream_psd.cu) and B4 (big_psd.cu): complex arithmetic, the radix-2
// Stockham stage, the one-block periodogram kernel, the two launches of the
// four-step split and the frame-start policies that tell them apart.
//
// Layout, for every kernel here: x is plane-major (2*nsub, nsamp), row 2s
// the real plane and row 2s+1 the imaginary plane of subchannel s, float32
// or int16; out is (ntime, nsub, nfft) float32, each column's fftshifted
// power summed over its nseg segments and scaled by inv_scale. A frame
// start is clamped into the buffer the way jax.lax.dynamic_slice clamps it.
// tw[m] = W_nfft^m for m < nfft/2 (one table; a sub-transform of n points
// reads it at stride nfft/n).
//
// Everything here has internal linkage: each source that includes the
// header instantiates and registers its own kernels.

#pragma once

#include <cuda_runtime.h>
#include <cstdint>

namespace {

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}

__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}

__host__ __device__ constexpr int ilog2(int n) { return n <= 1 ? 0 : 1 + ilog2(n / 2); }

template <typename T>
__device__ __forceinline__ float widen(T v) {
  return static_cast<float>(v);
}

// Clamp a frame start into the buffer, as jax.lax.dynamic_slice does.
__device__ __forceinline__ long long clamp_start(int st, long long nsamp,
                                                 long long span) {
  return st < 0 ? 0 : (st > nsamp - span ? nsamp - span : st);
}

// Frame starts read from an (ntime,) int32 array on the device: contiguous
// (t*frame_len) and gathered starts are one code path (B1, B4).
struct StartsArray {
  const int* p;
  __device__ __forceinline__ int operator()(int t) const { return p[t]; }
};

// Frame starts t*hop computed in the kernel: the overlapping columns of a
// streaming push buffer (B3). No starts tensor crosses to the device.
struct StartsHop {
  int hop;
  __device__ __forceinline__ int operator()(int t) const { return t * hop; }
};

// Stockham radix-2 stage lp of B independent N-point FFTs held in buf at
// stride S (FFT b in buf[b*S, b*S + N)). The stage with half-span p = 2^lp:
// butterfly i (0 <= i < N/2) reads a = x[i], b = x[i + N/2], k = i mod p,
// multiplies b by W_N^(k * N/(2p)) and writes a + b to y[2i - k] and a - b
// to y[2i - k + p]. After stages 0 .. log2(N)-1 y is the DFT in natural
// order. Each thread holds all of its butterflies' inputs in registers
// across one __syncthreads, so x and y share one buffer; the caller
// synchronises before reading the last stage's output.
// tw[m * TWS] = W_N^m for m < N/2.
template <int N, int B, int S, int TWS, int THREADS>
__device__ __forceinline__ void fft_stage(float2* buf,
                                          const float2* __restrict__ tw,
                                          int lp) {
  constexpr int HALF = N / 2;
  constexpr int LOG2N = ilog2(N);
  constexpr int R = B * HALF / THREADS;  // butterflies per thread
  static_assert(R >= 1 && R * THREADS == B * HALF, "THREADS must divide B*N/2");
  const int p = 1 << lp;
  float2 a[R], b[R];
  __syncthreads();
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int g = threadIdx.x + r * THREADS;
    const int base = B == 1 ? 0 : (g / HALF) * S;
    const int i = B == 1 ? g : g % HALF;
    a[r] = buf[base + i];
    b[r] = buf[base + i + HALF];
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int g = threadIdx.x + r * THREADS;
    const int base = B == 1 ? 0 : (g / HALF) * S;
    const int i = B == 1 ? g : g % HALF;
    const int k = i & (p - 1);
    const float2 bw = cmul(b[r], __ldg(tw + (k << (LOG2N - 1 - lp)) * TWS));
    const int j = 2 * i - k;
    buf[base + j] = cadd(a[r], bw);
    buf[base + j + p] = csub(a[r], bw);
  }
}

// One block per (column t, subchannel s) for N <= 16384: the whole segment
// stays in shared memory. The first stage is fused with the load, widening
// and window (its twiddle is 1), the last with |X|^2, which each thread
// sums in registers for its fixed bins over every segment; each bin is
// written once, already fftshifted. The stages stay unrolled with a
// compile-time twiddle stride: rolled, the kernel spilled at 4096-16384.
template <int N, int THREADS, typename T, typename Starts>
__global__ void __launch_bounds__(THREADS)
sti_psd_kernel(const T* __restrict__ x, long long nsamp, int nsub,
               Starts starts, int nseg, const float* __restrict__ win,
               const float2* __restrict__ tw, float inv_scale,
               float* __restrict__ out) {
  constexpr int HALF = N / 2;
  constexpr int LOG2N = ilog2(N);
  constexpr int R = HALF / THREADS;  // butterflies per thread
  static_assert(R >= 1 && R * THREADS == HALF, "THREADS must divide N/2");
  extern __shared__ float2 buf[];     // N complex values

  const int t = blockIdx.x;
  const int s = blockIdx.y;
  const long long st =
      clamp_start(starts(t), nsamp, static_cast<long long>(nseg) * N);
  const T* re = x + (2LL * s) * nsamp + st;
  const T* im = x + (2LL * s + 1) * nsamp + st;

  float acc_lo[R];  // bin i
  float acc_hi[R];  // bin i + N/2
#pragma unroll
  for (int r = 0; r < R; ++r) {
    acc_lo[r] = 0.f;
    acc_hi[r] = 0.f;
  }

  for (int seg = 0; seg < nseg; ++seg) {
    const T* sr = re + static_cast<long long>(seg) * N;
    const T* si = im + static_cast<long long>(seg) * N;
    __syncthreads();  // the previous segment's last stage is done reading
    // stage p = 1 fused with the load, widening and window (twiddle 1)
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = threadIdx.x + r * THREADS;
      const float wa = __ldg(win + i);
      const float wb = __ldg(win + i + HALF);
      const float2 a = make_float2(widen(sr[i]) * wa, widen(si[i]) * wa);
      const float2 b =
          make_float2(widen(sr[i + HALF]) * wb, widen(si[i + HALF]) * wb);
      buf[2 * i] = cadd(a, b);
      buf[2 * i + 1] = csub(a, b);
    }
#pragma unroll
    for (int lp = 1; lp < LOG2N - 1; ++lp)
      fft_stage<N, 1, N, 1, THREADS>(buf, tw, lp);
    __syncthreads();
    // last stage p = N/2: butterfly i yields bins i and i + N/2
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = threadIdx.x + r * THREADS;
      const float2 bw = cmul(buf[i + HALF], __ldg(tw + i));
      const float2 a = buf[i];
      const float2 y0 = cadd(a, bw);
      const float2 y1 = csub(a, bw);
      acc_lo[r] += y0.x * y0.x + y0.y * y0.y;
      acc_hi[r] += y1.x * y1.x + y1.y * y1.y;
    }
  }

  // fftshift: bin i lands at i + N/2 and bin i + N/2 at i
  float* o = out + (static_cast<long long>(t) * nsub + s) * N;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = threadIdx.x + r * THREADS;
    o[i + HALF] = acc_lo[r] * inv_scale;
    o[i] = acc_hi[r] * inv_scale;
  }
}

// N = N1 * N2 beyond one block's shared memory: the four-step split in two
// launches. With n = N2*n1 + n2 and k = k1 + N1*k2,
//   X[k] = sum_n2 W_N^(n2*k1) W_N2^(n2*k2) sum_n1 x[n] W_N1^(n1*k1).
// Launch 1 (fs_cols_kernel) runs the inner N1-point DFTs over n1 for C
// adjacent n2 per block, one block per (column, segment, n2 chunk, sub),
// multiplies by W_N^(n2*k1) and stores Y[k1][n2] to the workspace, one
// N-point slab per (column, sub, segment). Launch 2 (fs_rows_kernel) runs
// the N2-point DFTs over n2 for G adjacent k1 per block, one block per
// (column, k1 group, sub), sums |X|^2 over the segments in registers and
// writes its bins once, fftshifted. Every bin has one owner: no atomics.
// Shared memory is dynamic (C*(N1+1) and G*(N2+1) complex values); its rows
// are padded by one element so the transposing loads and stores hit
// distinct banks. The stage loops are not unrolled: unrolled, fs_rows_kernel
// took 255 registers and spilled (ptxas for sm_90a).
template <int N1, int N2, int C, int THREADS, typename T, typename Starts>
__global__ void __launch_bounds__(THREADS)
fs_cols_kernel(const T* __restrict__ x, long long nsamp, int nsub,
               Starts starts, int nseg, const float* __restrict__ win,
               const float2* __restrict__ tw, float2* __restrict__ work) {
  constexpr int N = N1 * N2;
  constexpr int S = N1 + 1;
  constexpr int E = N1 * C / THREADS;  // elements per thread
  static_assert(E * THREADS == N1 * C, "THREADS must divide N1*C");
  extern __shared__ float2 buf[];      // C * S complex values

  constexpr int CHUNKS = N2 / C;
  const int chunk = blockIdx.x % CHUNKS;
  const int seg = (blockIdx.x / CHUNKS) % nseg;
  const int t = blockIdx.x / CHUNKS / nseg;
  const int s = blockIdx.y;
  const int c0 = chunk * C;
  const long long st =
      clamp_start(starts(t), nsamp, static_cast<long long>(nseg) * N) +
      static_cast<long long>(seg) * N;
  const T* re = x + (2LL * s) * nsamp + st;
  const T* im = x + (2LL * s + 1) * nsamp + st;

#pragma unroll
  for (int r = 0; r < E; ++r) {
    const int e = threadIdx.x + r * THREADS;
    const int cc = e % C;
    const int n = N2 * (e / C) + c0 + cc;
    const float w = __ldg(win + n);
    buf[cc * S + e / C] = make_float2(widen(re[n]) * w, widen(im[n]) * w);
  }
#pragma unroll 1
  for (int lp = 0; lp < ilog2(N1); ++lp)
    fft_stage<N1, C, S, N2, THREADS>(buf, tw, lp);
  __syncthreads();

  float2* y = work + ((static_cast<long long>(t) * nsub + s) * nseg + seg) * N;
#pragma unroll
  for (int r = 0; r < E; ++r) {
    const int e = threadIdx.x + r * THREADS;
    const int cc = e % C;
    const int k1 = e / C;
    const int m = (c0 + cc) * k1;  // < N
    float2 w = __ldg(tw + (m & (N / 2 - 1)));
    if (m & (N / 2)) w = make_float2(-w.x, -w.y);  // W_N^(m) = -W_N^(m-N/2)
    y[static_cast<long long>(k1) * N2 + c0 + cc] = cmul(buf[cc * S + k1], w);
  }
}

template <int N1, int N2, int G, int THREADS>
__global__ void __launch_bounds__(THREADS)
fs_rows_kernel(const float2* __restrict__ work, int nsub, int nseg,
               const float2* __restrict__ tw, float inv_scale,
               float* __restrict__ out) {
  constexpr int N = N1 * N2;
  constexpr int S = N2 + 1;
  constexpr int E = G * N2 / THREADS;  // elements per thread
  static_assert(E * THREADS == G * N2, "THREADS must divide G*N2");
  extern __shared__ float2 buf[];      // G * S complex values

  constexpr int GROUPS = N1 / G;
  const int k10 = (blockIdx.x % GROUPS) * G;
  const int t = blockIdx.x / GROUPS;
  const int s = blockIdx.y;

  float acc[E];  // bin k1 = k10 + e % G, k2 = e / G
#pragma unroll
  for (int r = 0; r < E; ++r) acc[r] = 0.f;

  for (int seg = 0; seg < nseg; ++seg) {
    const float2* y =
        work + ((static_cast<long long>(t) * nsub + s) * nseg + seg) * N +
        static_cast<long long>(k10) * N2;
    __syncthreads();  // the previous segment's sums are read
#pragma unroll
    for (int r = 0; r < E; ++r) {
      const int e = threadIdx.x + r * THREADS;
      buf[(e / N2) * S + e % N2] = y[e];
    }
#pragma unroll 1
    for (int lp = 0; lp < ilog2(N2); ++lp)
      fft_stage<N2, G, S, N1, THREADS>(buf, tw, lp);
    __syncthreads();
#pragma unroll
    for (int r = 0; r < E; ++r) {
      const int e = threadIdx.x + r * THREADS;
      const float2 v = buf[(e % G) * S + e / G];
      acc[r] += v.x * v.x + v.y * v.y;
    }
  }

  float* o = out + (static_cast<long long>(t) * nsub + s) * N;
#pragma unroll
  for (int r = 0; r < E; ++r) {
    const int e = threadIdx.x + r * THREADS;
    const int k = k10 + e % G + N1 * (e / G);
    o[(k + N / 2) & (N - 1)] = acc[r] * inv_scale;
  }
}

// Raise a kernel's dynamic shared-memory limit where it needs more than
// the default 48 KB.
template <typename K>
cudaError_t allow_smem(K kern, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

template <int N, typename T, typename Starts>
cudaError_t launch_one_block(const T* x, long long nsamp, int nsub,
                             Starts starts, int ntime, int nseg,
                             const float* win, const float2* tw,
                             float inv_scale, float* out,
                             cudaStream_t stream) {
  constexpr int THREADS = (N / 2) < 512 ? (N / 2) : 512;
  constexpr int SMEM = N * static_cast<int>(sizeof(float2));
  auto kern = sti_psd_kernel<N, THREADS, T, Starts>;
  cudaError_t e = allow_smem(kern, SMEM);
  if (e != cudaSuccess) return e;
  kern<<<dim3(ntime, nsub), THREADS, SMEM, stream>>>(
      x, nsamp, nsub, starts, nseg, win, tw, inv_scale, out);
  return cudaGetLastError();
}

// work: ntime * nsub * nseg * N1 * N2 complex values.
template <int N1, int N2, int C, int G, int THREADS, typename T,
          typename Starts>
cudaError_t launch_four_step(const T* x, long long nsamp, int nsub,
                             Starts starts, int ntime, int nseg,
                             const float* win, const float2* tw,
                             float inv_scale, float2* work, float* out,
                             cudaStream_t stream) {
  constexpr int SMEM_COLS = C * (N1 + 1) * static_cast<int>(sizeof(float2));
  constexpr int SMEM_ROWS = G * (N2 + 1) * static_cast<int>(sizeof(float2));
  const long long cols_blocks =
      static_cast<long long>(ntime) * nseg * (N2 / C);
  const long long rows_blocks = static_cast<long long>(ntime) * (N1 / G);
  if (work == nullptr || cols_blocks > 0x7FFFFFFFLL ||
      rows_blocks > 0x7FFFFFFFLL)
    return cudaErrorInvalidValue;
  auto cols = fs_cols_kernel<N1, N2, C, THREADS, T, Starts>;
  auto rows = fs_rows_kernel<N1, N2, G, THREADS>;
  cudaError_t e = allow_smem(cols, SMEM_COLS);
  if (e == cudaSuccess) e = allow_smem(rows, SMEM_ROWS);
  if (e != cudaSuccess) return e;
  cols<<<dim3(static_cast<unsigned int>(cols_blocks), nsub), THREADS,
         SMEM_COLS, stream>>>(x, nsamp, nsub, starts, nseg, win, tw, work);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  rows<<<dim3(static_cast<unsigned int>(rows_blocks), nsub), THREADS,
         SMEM_ROWS, stream>>>(work, nsub, nseg, tw, inv_scale, out);
  return cudaGetLastError();
}

// Power-of-two 256 <= nfft <= 32768: one block per (column, subchannel) up
// to 16384 points (128 KB of shared memory); 32768 points (256 KB) exceed a
// block's 227 KB and run as the four-step split 128 x 256.
template <typename T, typename Starts>
cudaError_t dispatch_small(int nfft, const T* x, long long nsamp, int nsub,
                           Starts starts, int ntime, int nseg,
                           const float* win, const float2* tw,
                           float inv_scale, float2* work, float* out,
                           cudaStream_t stream) {
  switch (nfft) {
#define PST_CASE(n)                                                         \
  case n:                                                                   \
    return launch_one_block<n>(x, nsamp, nsub, starts, ntime, nseg, win, tw, \
                               inv_scale, out, stream);
    PST_CASE(256)
    PST_CASE(512)
    PST_CASE(1024)
    PST_CASE(2048)
    PST_CASE(4096)
    PST_CASE(8192)
    PST_CASE(16384)
#undef PST_CASE
    case 32768:
      return launch_four_step<128, 256, 32, 16, 256>(
          x, nsamp, nsub, starts, ntime, nseg, win, tw, inv_scale, work, out,
          stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
