// Kernel B1 on Hopper: windowed FFT periodogram -> Welch sum -> scale ->
// fftshift, one thread block per (STI column t, subchannel s).
//
// Replaces pyspectrogram_tpu/kernels/sti_pallas.py::make_pallas_sti_psd
// (the pallas_call at sti_pallas.py:555) over its whole range, power-of-two
// 256 <= nfft <= 32768. It computes what that kernel computes, not how: the
// TPU kernel factors the DFT into two MXU matmuls; here each segment runs a
// radix-2 Stockham FFT in shared memory. Up to 16384 points (128 KB) one
// block holds the whole segment; 32768 points (256 KB) exceed a block's
// 227 KB, so that size runs as a four-step split over two launches (below).
//
// What bounds it: at nfft = 4096 one segment is ~5*N*log2(N) = 0.25 MFLOP
// against 32 KB of samples read, far under the float32 ridge, so the kernel
// is bound by shared-memory traffic (2 * 8N bytes per stage, log2(N)
// stages) and by the global read of the samples, not by FLOPs. The design
// keeps the segment resident in shared memory for all stages, fuses the
// load, int16 widening and window into the first stage, keeps the |X|^2
// sum in registers (each thread owns fixed bins for every segment) and
// writes each bin once, already fftshifted. The four-step split adds one
// round trip of the segment through device memory (8 bytes per sample
// written and read back), which at these sizes stays mostly in the L2.
//
// Layout: x is plane-major (2*nsub, nsamp), row 2s the real plane and row
// 2s+1 the imaginary plane of subchannel s, float32 or int16. starts (ntime,)
// int32 lives on the device, so contiguous (t*frame_len) and gathered frame
// starts are one code path; a start is clamped into the buffer the way
// jax.lax.dynamic_slice clamps it. out is (ntime, nsub, nfft) float32.

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
// and window (its twiddle is 1), the last with |X|^2.
template <int N, int THREADS, typename T>
__global__ void __launch_bounds__(THREADS)
sti_psd_kernel(const T* __restrict__ x, long long nsamp, int nsub,
               const int* __restrict__ starts, int nseg,
               const float* __restrict__ win, const float2* __restrict__ tw,
               float inv_scale, float* __restrict__ out) {
  constexpr int HALF = N / 2;
  constexpr int LOG2N = ilog2(N);
  constexpr int R = HALF / THREADS;  // butterflies per thread
  static_assert(R >= 1 && R * THREADS == HALF, "THREADS must divide N/2");
  extern __shared__ float2 buf[];     // N complex values

  const int t = blockIdx.x;
  const int s = blockIdx.y;
  const long long st =
      clamp_start(starts[t], nsamp, static_cast<long long>(nseg) * N);
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
// Shared-memory rows are padded by one element so the transposing loads
// and stores hit distinct banks. The stage loops are not unrolled: unrolled,
// fs_rows_kernel took 255 registers and spilled (ptxas for sm_90a), where
// rolled both kernels fit in 128 without spills.
template <int N1, int N2, int C, int THREADS, typename T>
__global__ void __launch_bounds__(THREADS)
fs_cols_kernel(const T* __restrict__ x, long long nsamp, int nsub,
               const int* __restrict__ starts, int nseg,
               const float* __restrict__ win, const float2* __restrict__ tw,
               float2* __restrict__ work) {
  constexpr int N = N1 * N2;
  constexpr int S = N1 + 1;
  constexpr int E = N1 * C / THREADS;  // elements per thread
  static_assert(E * THREADS == N1 * C, "THREADS must divide N1*C");
  __shared__ float2 buf[C * S];

  constexpr int CHUNKS = N2 / C;
  const int chunk = blockIdx.x % CHUNKS;
  const int seg = (blockIdx.x / CHUNKS) % nseg;
  const int t = blockIdx.x / CHUNKS / nseg;
  const int s = blockIdx.y;
  const int c0 = chunk * C;
  const long long st =
      clamp_start(starts[t], nsamp, static_cast<long long>(nseg) * N) +
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
    y[k1 * N2 + c0 + cc] = cmul(buf[cc * S + k1], w);
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
  __shared__ float2 buf[G * S];

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

template <int N, typename T>
cudaError_t launch(const void* x, long long nsamp, int nsub,
                   const void* starts, int ntime, int nseg, const void* win,
                   const void* tw, float inv_scale, void* out,
                   cudaStream_t stream) {
  constexpr int THREADS = (N / 2) < 512 ? (N / 2) : 512;
  constexpr int SMEM = N * static_cast<int>(sizeof(float2));
  auto kern = sti_psd_kernel<N, THREADS, T>;
  if (SMEM > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (e != cudaSuccess) return e;
  }
  dim3 grid(ntime, nsub);
  kern<<<grid, THREADS, SMEM, stream>>>(
      static_cast<const T*>(x), nsamp, nsub, static_cast<const int*>(starts),
      nseg, static_cast<const float*>(win), static_cast<const float2*>(tw),
      inv_scale, static_cast<float*>(out));
  return cudaGetLastError();
}

template <int N1, int N2, typename T>
cudaError_t launch_four_step(const void* x, long long nsamp, int nsub,
                             const void* starts, int ntime, int nseg,
                             const void* win, const void* tw, float inv_scale,
                             void* work, void* out, cudaStream_t stream) {
  constexpr int C = 32, G = 16, THREADS = 256;
  const long long cols_blocks = static_cast<long long>(ntime) * nseg * (N2 / C);
  if (work == nullptr || cols_blocks > 0x7FFFFFFFLL)
    return cudaErrorInvalidValue;
  fs_cols_kernel<N1, N2, C, THREADS, T>
      <<<dim3(static_cast<unsigned int>(cols_blocks), nsub), THREADS, 0,
         stream>>>(static_cast<const T*>(x), nsamp, nsub,
                   static_cast<const int*>(starts), nseg,
                   static_cast<const float*>(win),
                   static_cast<const float2*>(tw), static_cast<float2*>(work));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  fs_rows_kernel<N1, N2, G, THREADS>
      <<<dim3(ntime * (N1 / G), nsub), THREADS, 0, stream>>>(
          static_cast<const float2*>(work), nsub, nseg,
          static_cast<const float2*>(tw), inv_scale, static_cast<float*>(out));
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int nfft, const void* x, long long nsamp, int nsub,
                     const void* starts, int ntime, int nseg, const void* win,
                     const void* tw, float inv_scale, void* work, void* out,
                     cudaStream_t stream) {
  switch (nfft) {
#define PST_CASE(n)                                                        \
  case n:                                                                  \
    return launch<n, T>(x, nsamp, nsub, starts, ntime, nseg, win, tw,      \
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
      return launch_four_step<128, 256, T>(x, nsamp, nsub, starts, ntime,
                                           nseg, win, tw, inv_scale, work,
                                           out, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32 planes, 1 = int16 planes. work: for nfft 32768, a
// float2 workspace of ntime * nsub * nseg * nfft elements (ignored below).
// Returns cudaGetLastError() after the launches (0 on success).
extern "C" int pst_sti_psd(const void* x, int dtype, long long nsamp,
                           int nsub, const void* starts, int ntime, int nfft,
                           int nseg, const void* win, const void* tw,
                           float inv_scale, void* work, void* out,
                           void* stream) {
  if (ntime <= 0 || nsub <= 0 || nsub > 65535 || nseg <= 0 ||
      nsamp < static_cast<long long>(nseg) * nfft)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e =
      dtype == 0
          ? dispatch<float>(nfft, x, nsamp, nsub, starts, ntime, nseg, win, tw,
                            inv_scale, work, out, st)
      : dtype == 1
          ? dispatch<int16_t>(nfft, x, nsamp, nsub, starts, ntime, nseg, win,
                              tw, inv_scale, work, out, st)
          : cudaErrorInvalidValue;
  return static_cast<int>(e);
}
