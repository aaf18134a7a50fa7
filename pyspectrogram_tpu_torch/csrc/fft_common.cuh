// The FFT building blocks shared by kernels B1 (sti_psd.cu), B3
// (stream_psd.cu) and B4 (big_psd.cu): complex arithmetic, the frame-start
// policies that tell B1 and B3 apart, the one-block register-pass
// periodogram kernel (B1 and B3 up to 16384 points), and the radix-2
// Stockham stage with the two launches of the four-step split (B1 and B3 at
// 32768, B4).
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

// trailing zero bits of r > 0
__host__ __device__ constexpr int ctz(int r) { return r & 1 ? 0 : 1 + ctz(r >> 1); }

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

// ---- The one-block periodogram for 256 <= N <= 16384 (B1, B3) ----
//
// One block per (column t, subchannel s) transforms each segment of its
// frame with register-resident radix-16 passes: N = 16^a * TAIL with the
// small radix TAIL in {2, 4, 8} last (256 = 16*16, 512 = 16*16*2, 2048 =
// 16*16*8, 4096 = 16^3, 8192 = 16^3*2, 16384 = 16^3*4). Each of the
// N/P threads holds P points (16; 32 at 16384) and runs P/R R-point DFTs in
// registers per pass, with constant internal twiddles. This is the radix-R
// Stockham formulation (Govindaraju et al., SC'08): at the pass whose
// earlier radices multiply to NS, DFT j (0 <= j < N/R) reads x[j + r*N/R],
// multiplies point r by W_N^((j mod NS)*r*N/(NS*R)) (from the tw table),
// transforms and writes point r to (j/NS)*NS*R + j mod NS + r*NS. The
// segment crosses shared memory once between passes: 2 exchanges at 4096
// against 12 radix-2 stages. Every index i is stored at i + i/16, so a
// half-warp's 8-byte accesses fall on 16 distinct bank pairs for the
// strided writes of the radix-16 passes and the unit-stride reads.
//
// Pass 0 reads straight from global memory (thread j reads x[j + r*N/16]:
// a warp's loads are coalesced), fused with the int16 widening and the
// window; its twiddles are 1. The last pass leaves DFT j's point r in
// registers as bin j + r*N/R, whose |X|^2 each thread sums over the
// segments in a fixed order (no atomics); the fftshifted store writes
// each bin once, coalesced. Up to 8192 the exchanges alternate between
// two buffers, so one barrier serves each exchange and a DFT's outputs
// are written as soon as it is done. At 16384 two 136 KiB buffers do not
// fit, so each exchange takes two barriers, and a thread's 32 sums live
// in shared memory (each thread touching only its own bins). The
// inter-pass twiddles are log2(R) table loads per DFT and their products.
// A block is capped at 128 registers a thread; no instance spills.
//
// Reads overlap compute across the blocks on an SM (two at 4096: 256
// threads, ~103 registers), and each thread has its 16 pass-0 loads in
// flight at once. Two in-block prefetches of the next segment were
// measured on an H100 and dropped, both slower at the headline: the next
// segment's samples held in registers (the cap then squeezed the passes)
// and a cp.async copy into a shared staging area (32 KB more shared
// memory a block, so less L1 for the window and twiddles).

// W_16^m = exp(-2 pi i m / 16) for m < 8
__device__ __forceinline__ float2 w16(int m) {
  switch (m) {
    case 0: return make_float2(1.f, 0.f);
    case 1: return make_float2(0.923879532511286756f, -0.382683432365089772f);
    case 2: return make_float2(0.707106781186547524f, -0.707106781186547524f);
    case 3: return make_float2(0.382683432365089772f, -0.923879532511286756f);
    case 4: return make_float2(0.f, -1.f);
    case 5: return make_float2(-0.382683432365089772f, -0.923879532511286756f);
    case 6: return make_float2(-0.707106781186547524f, -0.707106781186547524f);
    default: return make_float2(-0.923879532511286756f, -0.382683432365089772f);
  }
}

// b * W_16^m; the factors 1 and -i are moves
__device__ __forceinline__ float2 mul_w16(float2 b, int m) {
  if (m == 0) return b;
  if (m == 4) return make_float2(b.y, -b.x);
  return cmul(b, w16(m));
}

// In-place R-point DFT (R <= 16) of v[base .. base + R), natural order in
// and out: radix-2 Stockham stages on registers, where stage p multiplies
// by W_R^(k*R/(2p)) = W_16^(8k/p). Indices are compile-time constants once
// the caller's loops are unrolled, so v stays in registers.
template <int R, int P>
__device__ __forceinline__ void dft_regs(float2 (&v)[P], int base) {
#pragma unroll
  for (int s = 0; s < ilog2(R); ++s) {
    const int p = 1 << s;
    float2 y[R];
#pragma unroll
    for (int i = 0; i < R / 2; ++i) {
      const int k = i & (p - 1);
      const float2 a = v[base + i];
      const float2 b = mul_w16(v[base + i + R / 2], (8 * k) / p);
      y[2 * i - k] = cadd(a, b);
      y[2 * i - k + p] = csub(a, b);
    }
#pragma unroll
    for (int i = 0; i < R; ++i) v[base + i] = y[i];
  }
}

__device__ __forceinline__ int rpad(int i) { return i + (i >> 4); }

template <int N>
struct RegPlan {
  static constexpr int P = N >= 16384 ? 32 : 16;  // points per thread
  static constexpr int THREADS = N / P;
  static constexpr int P16 = ilog2(N) / 4;        // radix-16 passes
  static constexpr int TAIL = N >> (4 * P16);     // last radix, 1 = none
  static constexpr int PASSES = P16 + (TAIL > 1 ? 1 : 0);
  static constexpr int BUFS = N <= 8192 ? 2 : 1;
  // at 16384 the |X|^2 sums live in shared memory, after the buffer
  static constexpr bool ACC_SMEM = N >= 16384;
  static constexpr int PADN = N + N / 16;
  // enough blocks per SM to cap a thread at 128 registers (a block of
  // fewer than 32 threads still holds a whole warp's registers)
  static constexpr int WARP_THREADS = THREADS < 32 ? 32 : THREADS;
  static constexpr int MIN_BLOCKS =
      WARP_THREADS * 128 >= 65536 ? 1 : 65536 / (WARP_THREADS * 128);
  static constexpr int SMEM =
      BUFS * PADN * static_cast<int>(sizeof(float2)) +
      (ACC_SMEM ? N * static_cast<int>(sizeof(float)) : 0);
  static_assert(N >= 256 && N <= 16384 && (N & (N - 1)) == 0,
                "one-block plan: power-of-two 256..16384");
};

template <int N, int PASS>
struct RegPass {
  static constexpr int R = PASS < RegPlan<N>::P16 ? 16 : RegPlan<N>::TAIL;
  static constexpr int NS = 1 << (4 * PASS);  // the earlier radices' product
  static constexpr int Q = RegPlan<N>::P / R;  // DFTs per thread
  static constexpr bool LAST = PASS == RegPlan<N>::PASSES - 1;
  // padded distance between a DFT's points: read (N/R apart) and written
  // (NS apart); both are multiples of 16 except NS = 1, where a DFT's 16
  // points are one padded row
  static constexpr int READ_STEP = N / R + N / R / 16;
  static constexpr int WRITE_STEP = NS == 1 ? 1 : NS + NS / 16;
};

// W_N^e for 0 <= e < N from tw[m] = W_N^m, m < N/2
template <int N>
__device__ __forceinline__ float2 tw_at(const float2* __restrict__ tw, int e) {
  const float2 w = __ldg(tw + (e & (N / 2 - 1)));
  return (e & (N / 2)) ? make_float2(-w.x, -w.y) : w;  // W^e = -W^(e-N/2)
}

// Pass 0's raw inputs of DFT q: a[q*16 + r] = x[j + r*N/16], j = thread +
// q*THREADS (a warp's loads are coalesced)
template <int N, typename T>
__device__ __forceinline__ void reg_load(const T* __restrict__ re,
                                         const T* __restrict__ im,
                                         T (&a)[RegPlan<N>::P],
                                         T (&b)[RegPlan<N>::P], int q) {
  const int j = threadIdx.x + q * RegPlan<N>::THREADS;
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    a[q * 16 + r] = re[j + r * (N / 16)];
    b[q * 16 + r] = im[j + r * (N / 16)];
  }
}

// DFT q's raw samples widened and windowed into v
template <int N, typename T>
__device__ __forceinline__ void reg_window(const T (&a)[RegPlan<N>::P],
                                           const T (&b)[RegPlan<N>::P],
                                           const float* __restrict__ win,
                                           float2 (&v)[RegPlan<N>::P], int q) {
  const int j = threadIdx.x + q * RegPlan<N>::THREADS;
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const float w = __ldg(win + j + r * (N / 16));
    v[q * 16 + r] =
        make_float2(widen(a[q * 16 + r]) * w, widen(b[q * 16 + r]) * w);
  }
}

// DFT q's outputs of pass PASS into the exchange buffer: point r of DFT j
// to (j/NS)*NS*R + j mod NS + r*NS, padded
template <int N, int PASS>
__device__ __forceinline__ void reg_write(float2* buf,
                                          const float2 (&v)[RegPlan<N>::P],
                                          int q) {
  using Ps = RegPass<N, PASS>;
  const int j = threadIdx.x + q * RegPlan<N>::THREADS;
  float2* d = buf + rpad((j / Ps::NS) * Ps::NS * Ps::R + (j & (Ps::NS - 1)));
#pragma unroll
  for (int r = 0; r < Ps::R; ++r) d[r * Ps::WRITE_STEP] = v[q * Ps::R + r];
}

// Pass PASS >= 1: read exchange xchg, twiddle, DFT; then write exchange
// xchg + 1, or, in the last pass, add |X|^2 of thread j's bins j + r*N/R
// into acc[q*R + r] (registers) or sacc[bin] (shared memory, at 16384).
// Each DFT q is read, transformed and (with two buffers) written before
// the next, so few of its registers live at once.
template <int N, int PASS>
__device__ __forceinline__ void reg_passes(float2 (&v)[RegPlan<N>::P],
                                           float2* sbuf, int& xchg,
                                           const float2* __restrict__ tw,
                                           float (&acc)[RegPlan<N>::P],
                                           float* sacc) {
  using Pl = RegPlan<N>;
  using Ps = RegPass<N, PASS>;
  constexpr int TH = Pl::THREADS;
  const float2* rbuf = sbuf + (Pl::BUFS == 2 ? (xchg & 1) * Pl::PADN : 0);
  ++xchg;
  float2* wbuf = sbuf + (Pl::BUFS == 2 ? (xchg & 1) * Pl::PADN : 0);
  __syncthreads();  // the exchange is written
#pragma unroll
  for (int q = 0; q < Ps::Q; ++q) {
    const int j = threadIdx.x + q * TH;
    const float2* src = rbuf + rpad(j);
#pragma unroll
    for (int r = 0; r < Ps::R; ++r) v[q * Ps::R + r] = src[r * Ps::READ_STEP];
    // point r times W_N^(e1*r): log2(R) table loads W_N^(e1*2^b), and each
    // other factor the product of those its set bits name (at most three
    // rounded multiplies), so few registers hold twiddles
    const int e1 = (j & (Ps::NS - 1)) * (N / (Ps::NS * Ps::R));
    float2 wb[ilog2(Ps::R)];
#pragma unroll
    for (int b = 0; b < ilog2(Ps::R); ++b) wb[b] = tw_at<N>(tw, e1 << b);
#pragma unroll
    for (int r = 1; r < Ps::R; ++r) {
      float2 w = wb[ctz(r)];
#pragma unroll
      for (int b = ctz(r) + 1; b < ilog2(Ps::R); ++b)
        if (r & (1 << b)) w = cmul(w, wb[b]);
      v[q * Ps::R + r] = cmul(v[q * Ps::R + r], w);
    }
    dft_regs<Ps::R>(v, q * Ps::R);
    if constexpr (Ps::LAST) {
#pragma unroll
      for (int r = 0; r < Ps::R; ++r) {
        const float2 y = v[q * Ps::R + r];
        const float p2 = y.x * y.x + y.y * y.y;
        if constexpr (Pl::ACC_SMEM)
          sacc[j + r * (N / Ps::R)] += p2;
        else
          acc[q * Ps::R + r] += p2;
      }
    } else if constexpr (Pl::BUFS == 2) {
      reg_write<N, PASS>(wbuf, v, q);
    }
  }
  if constexpr (!Ps::LAST) {
    if constexpr (Pl::BUFS == 1) {
      __syncthreads();  // every thread has read the buffer
#pragma unroll
      for (int q = 0; q < Ps::Q; ++q) reg_write<N, PASS>(wbuf, v, q);
    }
    reg_passes<N, PASS + 1>(v, sbuf, xchg, tw, acc, sacc);
  }
}

template <int N, typename T, typename Starts>
__global__ void __launch_bounds__(RegPlan<N>::THREADS, RegPlan<N>::MIN_BLOCKS)
reg_psd_kernel(const T* __restrict__ x, long long nsamp, int nsub,
               Starts starts, int nseg, const float* __restrict__ win,
               const float2* __restrict__ tw, float inv_scale,
               float* __restrict__ out) {
  using Pl = RegPlan<N>;
  using Pz = RegPass<N, Pl::PASSES - 1>;
  constexpr int P = Pl::P;
  constexpr int Q0 = P / 16;
  constexpr int TH = Pl::THREADS;
  extern __shared__ float2 sbuf[];  // BUFS * PADN complex (+ N sums)
  float* sacc = reinterpret_cast<float*>(sbuf + Pl::BUFS * Pl::PADN);

  const int t = blockIdx.x;
  const int s = blockIdx.y;
  const long long st =
      clamp_start(starts(t), nsamp, static_cast<long long>(nseg) * N);
  const T* re = x + (2LL * s) * nsamp + st;
  const T* im = x + (2LL * s + 1) * nsamp + st;

  float acc[P];
#pragma unroll
  for (int i = 0; i < P; ++i) acc[i] = 0.f;
  if constexpr (Pl::ACC_SMEM) {
    // each thread's own bins: no other thread reads or writes them
#pragma unroll
    for (int q = 0; q < Pz::Q; ++q)
#pragma unroll
      for (int r = 0; r < Pz::R; ++r)
        sacc[threadIdx.x + q * TH + r * (N / Pz::R)] = 0.f;
  }
  int xchg = 0;

  for (int seg = 0; seg < nseg; ++seg) {
    const long long off = static_cast<long long>(seg) * N;
    float2 v[P];
    // with one buffer, the previous segment's last pass has read it
    if (Pl::BUFS == 1) __syncthreads();
    float2* wbuf = sbuf + (Pl::BUFS == 2 ? (xchg & 1) * Pl::PADN : 0);
#pragma unroll
    for (int q = 0; q < Q0; ++q) {
      T raw_re[P], raw_im[P];
      reg_load<N>(re + off, im + off, raw_re, raw_im, q);
      reg_window<N>(raw_re, raw_im, win, v, q);
      dft_regs<16>(v, q * 16);  // pass 0: twiddles 1
      reg_write<N, 0>(wbuf, v, q);
    }
    reg_passes<N, 1>(v, sbuf, xchg, tw, acc, sacc);
  }

  // fftshift: bin k lands at (k + N/2) mod N
  float* o = out + (static_cast<long long>(t) * nsub + s) * N;
#pragma unroll
  for (int q = 0; q < Pz::Q; ++q)
#pragma unroll
    for (int r = 0; r < Pz::R; ++r) {
      const int k = threadIdx.x + q * TH + r * (N / Pz::R);
      const float a = Pl::ACC_SMEM ? sacc[k] : acc[q * Pz::R + r];
      o[(k + N / 2) & (N - 1)] = a * inv_scale;
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
cudaError_t launch_reg_psd(const T* x, long long nsamp, int nsub,
                           Starts starts, int ntime, int nseg,
                           const float* win, const float2* tw,
                           float inv_scale, float* out, cudaStream_t stream) {
  using Pl = RegPlan<N>;
  auto kern = reg_psd_kernel<N, T, Starts>;
  cudaError_t e = allow_smem(kern, Pl::SMEM);
  if (e != cudaSuccess) return e;
  kern<<<dim3(ntime, nsub), Pl::THREADS, Pl::SMEM, stream>>>(
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
// to 16384 points (the register-pass kernel, 136 KB of shared memory at
// 16384); 32768 points (256 KB) exceed a block's 227 KB and run as the
// four-step split 128 x 256.
template <typename T, typename Starts>
cudaError_t dispatch_small(int nfft, const T* x, long long nsamp, int nsub,
                           Starts starts, int ntime, int nseg,
                           const float* win, const float2* tw,
                           float inv_scale, float2* work, float* out,
                           cudaStream_t stream) {
  switch (nfft) {
#define PST_CASE(n)                                                       \
  case n:                                                                 \
    return launch_reg_psd<n>(x, nsamp, nsub, starts, ntime, nseg, win, tw, \
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
