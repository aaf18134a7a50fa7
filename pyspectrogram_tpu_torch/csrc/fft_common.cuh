// The FFT building blocks shared by kernels B1 (sti_psd.cu), B3
// (stream_psd.cu) and B4 (big_psd.cu): complex arithmetic, the frame-start
// policies that tell B1 and B3 apart, register-resident radix-16 passes
// over a batch of sub-FFTs, and the two kernels built from them: the
// one-block periodogram (B1 and B3 up to 16384 points) and the two
// launches of the four-step split (B1 and B3 at 32768, B4 up to 2^20).
//
// Layout, for every kernel here: x is plane-major (2*nsub, nsamp), row 2s
// the real plane and row 2s+1 the imaginary plane of subchannel s, float32
// or int16; out is (ntime, nsub, nfft) float32, each column's fftshifted
// power summed over its nseg segments and scaled by inv_scale. A frame
// start is clamped into the buffer the way jax.lax.dynamic_slice clamps it.
// Twiddles come from tables built on the host in float64: up to 16384
// points tw[m] = W_nfft^m for m < nfft/2; for the four-step split N = N1*N2
// three small tables one after the other, W_N1^m (m < N1/2), W_N2^m
// (m < N2/2) and W_N^l (l < N2), 5.6-16 KB.
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


// ---- Register passes over a batch of M-point sub-FFTs ----
//
// A block transforms G sub-FFTs of M points each, P points (16 or 32) a
// thread, T = M/P threads a sub-FFT, with radix-16 passes in registers and
// the small radix TAIL in {2, 4, 8} last (128 = 16*8, 256 = 16*16, 512 =
// 16*16*2, 1024 = 16*16*4, 4096 = 16^3, 16384 = 16^3*4). Each pass runs
// P/R R-point DFTs a thread with constant internal twiddles: the radix-R
// Stockham formulation (Govindaraju et al., SC'08). At the pass whose
// earlier radices multiply to NS, DFT d (0 <= d < M/R) reads point d +
// r*M/R, multiplies point r by W_M^((d mod NS)*r*M/(NS*R)) (from the
// sub-FFT's own table), transforms and writes point r to (d/NS)*NS*R + d
// mod NS + r*NS. Pass 0 reads its inputs from global memory (its twiddles
// are 1); a sub-FFT crosses shared memory once between passes. The last
// pass leaves DFT d's point r in registers as bin d + r*M/R and hands it
// to the caller. Thread lane() of sub-FFT sub() runs DFTs lane() + q*T.
//
// A layout places point i of sub-FFT b in the exchange buffer and maps the
// threads; both keep a half-warp's 8-byte accesses on 16 distinct bank
// pairs for every read and write of every pass:
// - RowLayout: each sub-FFT's points contiguous, every index i stored at
//   i + i/16 (rpad), the lane fastest. For M >= 256 a DFT's points lie a
//   multiple of 16 apart (or are one run of 16), so a half-warp of one
//   sub-FFT falls on 16 bank pairs. The one-block kernel (G = 1) and
//   launch 2 (rows) of the four-step split.
// - ColLayout: point i of sub-FFT b at i*B + b, the sub-FFT fastest: a
//   half-warp (B = 16) touches 16 adjacent slots. Launch 1 (columns), whose
//   sub-FFTs are 16 adjacent columns of the N1 x N2 matrix, so that the
//   same thread order reads and writes global memory in whole sectors.

template <int M, int P>
struct SubPlan {
  static constexpr int T = M / P;                 // threads a sub-FFT
  static constexpr int P16 = ilog2(M) / 4;        // radix-16 passes
  static constexpr int TAIL = M >> (4 * P16);     // last radix, 1 = none
  static constexpr int PASSES = P16 + (TAIL > 1 ? 1 : 0);
  static_assert((P == 16 || P == 32) && M >= 128 && M <= 16384 &&
                    (M & (M - 1)) == 0,
                "sub-FFTs: power-of-two 128..16384, 16 or 32 points a thread");
};

template <int M, int P, int PASS>
struct SubPass {
  static constexpr int R =
      PASS < SubPlan<M, P>::P16 ? 16 : SubPlan<M, P>::TAIL;
  static constexpr int NS = 1 << (4 * PASS);  // the earlier radices' product
  static constexpr int Q = P / R;             // DFTs a thread
  static constexpr bool LAST = PASS == SubPlan<M, P>::PASSES - 1;
};

template <int M, int T, int G>
struct RowLayout {
  static constexpr int PADM = M + M / 16;
  static constexpr int SIZE = G * PADM;  // complex slots of one buffer
  static_assert(M >= 256, "a DFT's points must lie 16 or more apart");
  __device__ static int sub() { return G == 1 ? 0 : threadIdx.x / T; }
  __device__ static int lane() {
    return G == 1 ? threadIdx.x : threadIdx.x % T;
  }
  __device__ static int at(int b, int i) { return b * PADM + rpad(i); }
  // padded distance of points dist apart (1, or a multiple of 16)
  __host__ __device__ static constexpr int step(int dist) {
    return dist == 1 ? 1 : dist + dist / 16;
  }
};

template <int M, int B>
struct ColLayout {
  static constexpr int SIZE = M * B;
  static_assert(B == 16, "a half-warp spans the batch");
  __device__ static int sub() { return threadIdx.x % B; }
  __device__ static int lane() { return threadIdx.x / B; }
  __device__ static int at(int b, int i) { return i * B + b; }
  __host__ __device__ static constexpr int step(int dist) { return dist * B; }
};

// W_M^e for 0 <= e < M from tw[m] = W_M^m, m < M/2
template <int M>
__device__ __forceinline__ float2 tw_at(const float2* __restrict__ tw, int e) {
  const float2 w = __ldg(tw + (e & (M / 2 - 1)));
  return (e & (M / 2)) ? make_float2(-w.x, -w.y) : w;  // W^e = -W^(e-M/2)
}

// Pass 0's raw inputs of DFT q: a[q*16 + r] = x[S*(d + r*M/16)], d = lane +
// q*T (S = 1: a warp's loads are coalesced along the lanes; S = N2 in
// launch 1, whose pointers are offset to the thread's column)
template <int M, int P, int S, typename T>
__device__ __forceinline__ void reg_load(const T* __restrict__ re,
                                         const T* __restrict__ im,
                                         T (&a)[P], T (&b)[P], int q,
                                         int lane) {
  const int d = lane + q * SubPlan<M, P>::T;
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    a[q * 16 + r] = re[S * (d + r * (M / 16))];
    b[q * 16 + r] = im[S * (d + r * (M / 16))];
  }
}

// DFT q's raw samples widened and windowed into v
template <int M, int P, int S, typename T>
__device__ __forceinline__ void reg_window(const T (&a)[P], const T (&b)[P],
                                           const float* __restrict__ win,
                                           float2 (&v)[P], int q, int lane) {
  const int d = lane + q * SubPlan<M, P>::T;
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const float w = __ldg(win + S * (d + r * (M / 16)));
    v[q * 16 + r] =
        make_float2(widen(a[q * 16 + r]) * w, widen(b[q * 16 + r]) * w);
  }
}

// DFT q's outputs of pass PASS into the exchange buffer: point r of DFT d
// to (d/NS)*NS*R + d mod NS + r*NS of sub-FFT b
template <int M, int P, class L, int PASS>
__device__ __forceinline__ void sub_write(float2* buf, const float2 (&v)[P],
                                          int q, int b, int lane) {
  using Ps = SubPass<M, P, PASS>;
  const int d = lane + q * SubPlan<M, P>::T;
  float2* dst =
      buf + L::at(b, (d / Ps::NS) * Ps::NS * Ps::R + (d & (Ps::NS - 1)));
#pragma unroll
  for (int r = 0; r < Ps::R; ++r) dst[r * L::step(Ps::NS)] = v[q * Ps::R + r];
}

// Pass PASS >= 1: read exchange xchg, twiddle, DFT; then write exchange
// xchg + 1, or, in the last pass, hand each DFT q (index d) to
// last(v, q, d): its bins d + r*M/R are v[q*R + r]. With two buffers each
// DFT is read, transformed and written before the next (one barrier an
// exchange, few registers live); with one, the writes wait for a second
// barrier.
template <int M, int P, class L, int BUFS, int PASS, class Last>
__device__ __forceinline__ void sub_passes(float2 (&v)[P], float2* sbuf,
                                           int& xchg,
                                           const float2* __restrict__ tw,
                                           int b, int lane, Last& last) {
  using Ps = SubPass<M, P, PASS>;
  constexpr int T = SubPlan<M, P>::T;
  const float2* rbuf = sbuf + (BUFS == 2 ? (xchg & 1) * L::SIZE : 0);
  ++xchg;
  float2* wbuf = sbuf + (BUFS == 2 ? (xchg & 1) * L::SIZE : 0);
  __syncthreads();  // the exchange is written
#pragma unroll
  for (int q = 0; q < Ps::Q; ++q) {
    const int d = lane + q * T;
    const float2* src = rbuf + L::at(b, d);
#pragma unroll
    for (int r = 0; r < Ps::R; ++r)
      v[q * Ps::R + r] = src[r * L::step(M / Ps::R)];
    // point r times W_M^(e1*r): log2(R) table loads W_M^(e1*2^k), and each
    // other factor the product of those its set bits name (at most three
    // rounded multiplies), so few registers hold twiddles
    const int e1 = (d & (Ps::NS - 1)) * (M / (Ps::NS * Ps::R));
    float2 wb[ilog2(Ps::R)];
#pragma unroll
    for (int k = 0; k < ilog2(Ps::R); ++k) wb[k] = tw_at<M>(tw, e1 << k);
#pragma unroll
    for (int r = 1; r < Ps::R; ++r) {
      float2 w = wb[ctz(r)];
#pragma unroll
      for (int k = ctz(r) + 1; k < ilog2(Ps::R); ++k)
        if (r & (1 << k)) w = cmul(w, wb[k]);
      v[q * Ps::R + r] = cmul(v[q * Ps::R + r], w);
    }
    dft_regs<Ps::R>(v, q * Ps::R);
    if constexpr (Ps::LAST) {
      last(v, q, d);
    } else if constexpr (BUFS == 2) {
      sub_write<M, P, L, PASS>(wbuf, v, q, b, lane);
    }
  }
  if constexpr (!Ps::LAST) {
    if constexpr (BUFS == 1) {
      __syncthreads();  // every thread has read the buffer
#pragma unroll
      for (int q = 0; q < Ps::Q; ++q)
        sub_write<M, P, L, PASS>(wbuf, v, q, b, lane);
    }
    sub_passes<M, P, L, BUFS, PASS + 1>(v, sbuf, xchg, tw, b, lane, last);
  }
}

// ---- The one-block periodogram for 256 <= N <= 16384 (B1, B3) ----
//
// One block per (column t, subchannel s) transforms each segment of its
// frame as one sub-FFT of the passes above (RowLayout, G = 1): 2
// exchanges at 4096 against 12 radix-2 stages. Each of the N/P threads
// holds P points (16; 32 at 16384). Pass 0 reads straight from global
// memory (thread j reads x[j + r*N/16]: a warp's loads are coalesced),
// fused with the int16 widening and the window. Each thread sums the
// |X|^2 of its last-pass bins over the segments in a fixed order (no
// atomics); the fftshifted store writes each bin once, coalesced. Up to
// 8192 the exchanges alternate between two buffers. At 16384 two 136 KiB
// buffers do not fit, so each exchange takes two barriers, and a thread's
// 32 sums live in shared memory (each thread touching only its own bins).
// A block is capped at 128 registers a thread; no instance spills.
//
// Reads overlap compute across the blocks on an SM (two at 4096: 256
// threads, ~103 registers), and each thread has its 16 pass-0 loads in
// flight at once. Two in-block prefetches of the next segment were
// measured on an H100 and dropped, both slower at the headline: the next
// segment's samples held in registers (the cap then squeezed the passes)
// and a cp.async copy into a shared staging area (32 KB more shared
// memory a block, so less L1 for the window and twiddles).

template <int N>
struct RegPlan {
  static constexpr int P = N >= 16384 ? 32 : 16;  // points per thread
  static constexpr int THREADS = N / P;
  static constexpr int BUFS = N <= 8192 ? 2 : 1;
  // at 16384 the |X|^2 sums live in shared memory, after the buffer
  static constexpr bool ACC_SMEM = N >= 16384;
  using L = RowLayout<N, THREADS, 1>;
  // enough blocks per SM to cap a thread at 128 registers (a block of
  // fewer than 32 threads still holds a whole warp's registers)
  static constexpr int WARP_THREADS = THREADS < 32 ? 32 : THREADS;
  static constexpr int MIN_BLOCKS =
      WARP_THREADS * 128 >= 65536 ? 1 : 65536 / (WARP_THREADS * 128);
  static constexpr int SMEM =
      BUFS * L::SIZE * static_cast<int>(sizeof(float2)) +
      (ACC_SMEM ? N * static_cast<int>(sizeof(float)) : 0);
  static_assert(N >= 256 && N <= 16384 && (N & (N - 1)) == 0,
                "one-block plan: power-of-two 256..16384");
};

template <int N, typename T, typename Starts>
__global__ void __launch_bounds__(RegPlan<N>::THREADS, RegPlan<N>::MIN_BLOCKS)
reg_psd_kernel(const T* __restrict__ x, long long nsamp, int nsub,
               Starts starts, int nseg, const float* __restrict__ win,
               const float2* __restrict__ tw, float inv_scale,
               float* __restrict__ out) {
  using Pl = RegPlan<N>;
  using L = typename Pl::L;
  constexpr int P = Pl::P;
  using Pz = SubPass<N, P, SubPlan<N, P>::PASSES - 1>;
  constexpr int TH = Pl::THREADS;
  extern __shared__ float2 sbuf[];  // BUFS * SIZE complex (+ N sums)
  float* sacc = reinterpret_cast<float*>(sbuf + Pl::BUFS * L::SIZE);

  const int t = blockIdx.x;
  const int s = blockIdx.y;
  const int lane = threadIdx.x;
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
        sacc[lane + q * TH + r * (N / Pz::R)] = 0.f;
  }
  // the last pass: |X|^2 of thread lane's bins d + r*N/R into acc[q*R + r]
  // (registers) or sacc[bin] (shared memory, at 16384)
  auto last = [&](const float2 (&y)[P], int q, int d) {
#pragma unroll
    for (int r = 0; r < Pz::R; ++r) {
      const float2 v = y[q * Pz::R + r];
      const float p2 = v.x * v.x + v.y * v.y;
      if constexpr (Pl::ACC_SMEM)
        sacc[d + r * (N / Pz::R)] += p2;
      else
        acc[q * Pz::R + r] += p2;
    }
  };
  int xchg = 0;

  for (int seg = 0; seg < nseg; ++seg) {
    const long long off = static_cast<long long>(seg) * N;
    float2 v[P];
    // with one buffer, the previous segment's last pass has read it
    if (Pl::BUFS == 1) __syncthreads();
    float2* wbuf = sbuf + (Pl::BUFS == 2 ? (xchg & 1) * L::SIZE : 0);
#pragma unroll
    for (int q = 0; q < P / 16; ++q) {
      T raw_re[P], raw_im[P];
      reg_load<N, P, 1>(re + off, im + off, raw_re, raw_im, q, lane);
      reg_window<N, P, 1>(raw_re, raw_im, win, v, q, lane);
      dft_regs<16>(v, q * 16);  // pass 0: twiddles 1
      sub_write<N, P, L, 0>(wbuf, v, q, 0, lane);
    }
    sub_passes<N, P, L, Pl::BUFS, 1>(v, sbuf, xchg, tw, 0, lane, last);
  }

  // fftshift: bin k lands at (k + N/2) mod N
  float* o = out + (static_cast<long long>(t) * nsub + s) * N;
#pragma unroll
  for (int q = 0; q < Pz::Q; ++q)
#pragma unroll
    for (int r = 0; r < Pz::R; ++r) {
      const int k = lane + q * TH + r * (N / Pz::R);
      const float a = Pl::ACC_SMEM ? sacc[k] : acc[q * Pz::R + r];
      o[(k + N / 2) & (N - 1)] = a * inv_scale;
    }
}

// ---- The four-step split for N = N1 * N2, 32768 <= N <= 2^20 ----
//
// Beyond one block's shared memory (32768 points take 256 KB) the
// transform runs in two launches through a workspace. With n = N2*n1 + n2
// and k = k1 + N1*k2,
//   X[k] = sum_n2 W_N^(n2*k1) W_N2^(n2*k2) sum_n1 x[n] W_N1^(n1*k1).
// Splits: 32768 = 128*256, 65536 = 256*256, 131072 = 512*256, 262144 =
// 512*512, 524288 = 1024*512, 1048576 = 1024*1024. Both launches run the
// register passes above over a batch of sub-FFTs:
// - Launch 1 (fs_cols_kernel): one block per (column, segment, 16 adjacent
//   n2, subchannel) runs the 16 N1-point DFTs over n1 (ColLayout; 16
//   points a thread, 32 from N1 = 512). Pass 0 reads the samples straight
//   from global memory, fused with the int16 widening and the window;
//   adjacent threads take adjacent n2, so a warp's loads fill whole
//   32-byte sectors. The last pass multiplies bin k1 by W_N^(n2*k1) =
//   W_N1^(n2*k1 / N2) * W_N^(n2*k1 mod N2) (two small tables, one more
//   rounded multiply) in registers and stores Y[k1][n2] to the workspace,
//   a half-warp's 16 stores adjacent.
// - Launch 2 (fs_rows_kernel): one block per (column, G = 8 adjacent k1,
//   subchannel), N2/2 threads, runs the N2-point DFTs over each row
//   (RowLayout, 16 points a thread), reading the workspace rows
//   contiguously, sums |X|^2 over the segments in registers, and stores
//   through shared memory transposed, so that each bin is written once,
//   fftshifted, a half-warp's stores adjacent k1. Every bin has one owner:
//   no atomics, the same bits on every call.
// What bounds it: per segment ~5*N*log2(N) flop against 4-8 bytes of
// samples per point read, 8 written to the workspace and 8 read back, and 4
// written per column: ~3-4 flop/B, under the float32 ridge (~20 flop/B),
// so memory traffic bounds it, the workspace's round trip through HBM the
// largest part. The wrapper (kernels/big_cuda.py) launches the pair over
// chunks of columns of at most 1 GiB of workspace; chunks of half the L2
// were measured on an H100 and were slower.

template <int N1, int N2>
struct ColsPlan {
  static constexpr int C = 16;                  // columns n2 a block
  static constexpr int P = N1 >= 512 ? 32 : 16;  // points a thread
  static constexpr int THREADS = C * N1 / P;    // 128, 256, 256, 512
  using L = ColLayout<N1, C>;
  static constexpr int BUFS =
      2 * L::SIZE * static_cast<int>(sizeof(float2)) <= 64 * 1024 ? 2 : 1;
  static constexpr int SMEM =
      BUFS * L::SIZE * static_cast<int>(sizeof(float2));
  static constexpr int MIN_BLOCKS = 65536 / (THREADS * 128);  // <= 128 regs
};

template <int N1, int N2>
struct RowsPlan {
  static constexpr int P = 16;
  static constexpr int T = N2 / P;
  // rows k1 a block: a half-warp's transposed stores are runs of 8
  // adjacent floats, whole 32-byte sectors
  static constexpr int G = 8;
  static constexpr int THREADS = G * T;  // 128, 256, 512
  using L = RowLayout<N2, T, G>;
  static constexpr int BUFS = 2;
  static constexpr int SMEM =
      BUFS * L::SIZE * static_cast<int>(sizeof(float2));
  // the transposed store's padded row of floats: a warp's reads (4
  // adjacent k2 in each of the 8 rows) fall on 32 distinct banks
  static constexpr int TPAD = N2 + 32 / G;
  static constexpr int MIN_BLOCKS = 65536 / (THREADS * 128);
  static_assert(G * TPAD * static_cast<int>(sizeof(float)) <= SMEM,
                "the transposed sums fit the buffers");
};

template <int N1, int N2, typename T, typename Starts>
__global__ void __launch_bounds__(ColsPlan<N1, N2>::THREADS,
                                  ColsPlan<N1, N2>::MIN_BLOCKS)
fs_cols_kernel(const T* __restrict__ x, long long nsamp, int nsub,
               Starts starts, int nseg, const float* __restrict__ win,
               const float2* __restrict__ tw, float2* __restrict__ work) {
  using Pl = ColsPlan<N1, N2>;
  using L = typename Pl::L;
  constexpr int N = N1 * N2;
  constexpr int P = Pl::P;
  constexpr int C = Pl::C;
  using Pz = SubPass<N1, P, SubPlan<N1, P>::PASSES - 1>;
  extern __shared__ float2 sbuf[];  // BUFS * N1 * C complex

  constexpr int CHUNKS = N2 / C;
  const int chunk = blockIdx.x % CHUNKS;
  const int seg = (blockIdx.x / CHUNKS) % nseg;
  const int t = blockIdx.x / CHUNKS / nseg;
  const int s = blockIdx.y;
  const int b = L::sub(), lane = L::lane();
  const int n2 = chunk * C + b;  // this thread's column of the N1 x N2 matrix
  const long long st =
      clamp_start(starts(t), nsamp, static_cast<long long>(nseg) * N) +
      static_cast<long long>(seg) * N + n2;
  const T* re = x + (2LL * s) * nsamp + st;
  const T* im = x + (2LL * s + 1) * nsamp + st;
  const float2* tw1 = tw;                      // W_N1^m, m < N1/2
  const float2* twlo = tw + N1 / 2 + N2 / 2;   // W_N^l, l < N2
  float2* y = work +
              ((static_cast<long long>(t) * nsub + s) * nseg + seg) * N + n2;

  // the last pass: bin k1 times W_N^(n2*k1) into Y[k1][n2]
  auto last = [&](const float2 (&v)[P], int q, int d) {
#pragma unroll
    for (int r = 0; r < Pz::R; ++r) {
      const int k1 = d + r * (N1 / Pz::R);
      const int e = n2 * k1;  // < N
      const float2 w = cmul(tw_at<N1>(tw1, e >> ilog2(N2)),
                            __ldg(twlo + (e & (N2 - 1))));
      y[static_cast<long long>(k1) * N2] = cmul(v[q * Pz::R + r], w);
    }
  };
  float2 v[P];
  int xchg = 0;
#pragma unroll
  for (int q = 0; q < P / 16; ++q) {
    T raw_re[P], raw_im[P];
    reg_load<N1, P, N2>(re, im, raw_re, raw_im, q, lane);
    reg_window<N1, P, N2>(raw_re, raw_im, win + chunk * C + b, v, q, lane);
    dft_regs<16>(v, q * 16);  // pass 0: twiddles 1
    sub_write<N1, P, L, 0>(sbuf, v, q, b, lane);
  }
  sub_passes<N1, P, L, Pl::BUFS, 1>(v, sbuf, xchg, tw1, b, lane, last);
}

template <int N1, int N2>
__global__ void __launch_bounds__(RowsPlan<N1, N2>::THREADS,
                                  RowsPlan<N1, N2>::MIN_BLOCKS)
fs_rows_kernel(const float2* __restrict__ work, int nsub, int nseg,
               const float2* __restrict__ tw, float inv_scale,
               float* __restrict__ out) {
  using Pl = RowsPlan<N1, N2>;
  using L = typename Pl::L;
  constexpr int N = N1 * N2;
  constexpr int P = Pl::P;
  constexpr int G = Pl::G;
  constexpr int T = Pl::T;
  using Pz = SubPass<N2, P, SubPlan<N2, P>::PASSES - 1>;
  extern __shared__ float2 sbuf[];  // 2 * G * PADM complex

  constexpr int GROUPS = N1 / G;
  const int k10 = (blockIdx.x % GROUPS) * G;
  const int t = blockIdx.x / GROUPS;
  const int s = blockIdx.y;
  const int b = L::sub(), lane = L::lane();
  const float2* tw2 = tw + N1 / 2;  // W_N2^m, m < N2/2

  float acc[P];  // bins k2 = lane + q*T + r*N2/R of row k10 + b
#pragma unroll
  for (int i = 0; i < P; ++i) acc[i] = 0.f;
  auto last = [&](const float2 (&y)[P], int q, int d) {
#pragma unroll
    for (int r = 0; r < Pz::R; ++r) {
      const float2 v = y[q * Pz::R + r];
      acc[q * Pz::R + r] += v.x * v.x + v.y * v.y;
    }
  };
  int xchg = 0;
  for (int seg = 0; seg < nseg; ++seg) {
    const float2* y =
        work + ((static_cast<long long>(t) * nsub + s) * nseg + seg) * N +
        static_cast<long long>(k10 + b) * N2;
    float2 v[P];
    float2* wbuf = sbuf + (xchg & 1) * L::SIZE;
#pragma unroll
    for (int q = 0; q < P / 16; ++q) {
      const int d = lane + q * T;
#pragma unroll
      for (int r = 0; r < 16; ++r) v[q * 16 + r] = y[d + r * (N2 / 16)];
      dft_regs<16>(v, q * 16);  // pass 0: twiddles 1
      sub_write<N2, P, L, 0>(wbuf, v, q, b, lane);
    }
    sub_passes<N2, P, L, Pl::BUFS, 1>(v, sbuf, xchg, tw2, b, lane, last);
  }

  // the sums through shared memory, transposed, so that adjacent threads
  // store adjacent k1; fftshift: bin k lands at (k + N/2) mod N
  float* tb = reinterpret_cast<float*>(sbuf);
  __syncthreads();  // every pass has read the buffers
#pragma unroll
  for (int q = 0; q < Pz::Q; ++q)
#pragma unroll
    for (int r = 0; r < Pz::R; ++r)
      tb[b * Pl::TPAD + lane + q * T + r * (N2 / Pz::R)] =
          acc[q * Pz::R + r] * inv_scale;
  __syncthreads();
  float* o = out + (static_cast<long long>(t) * nsub + s) * N;
#pragma unroll
  for (int i = 0; i < P; ++i) {
    const int e = threadIdx.x + i * Pl::THREADS;
    const int k = k10 + e % G + N1 * (e / G);
    o[(k + N / 2) & (N - 1)] = tb[(e % G) * Pl::TPAD + e / G];
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

// Launch 1 of the split: work gets ntime * nsub * nseg * N1 * N2 complex
// values.
template <int N1, int N2, typename T, typename Starts>
cudaError_t launch_fs_cols(const T* x, long long nsamp, int nsub,
                           Starts starts, int ntime, int nseg,
                           const float* win, const float2* tw, float2* work,
                           cudaStream_t stream) {
  using Pl = ColsPlan<N1, N2>;
  const long long blocks =
      static_cast<long long>(ntime) * nseg * (N2 / Pl::C);
  if (work == nullptr || blocks > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
  auto cols = fs_cols_kernel<N1, N2, T, Starts>;
  cudaError_t e = allow_smem(cols, Pl::SMEM);
  if (e != cudaSuccess) return e;
  cols<<<dim3(static_cast<unsigned int>(blocks), nsub), Pl::THREADS,
         Pl::SMEM, stream>>>(x, nsamp, nsub, starts, nseg, win, tw, work);
  return cudaGetLastError();
}

// Launch 2 of the split: the ntime columns' power from launch 1's work.
template <int N1, int N2>
cudaError_t launch_fs_rows(const float2* work, int nsub, int ntime, int nseg,
                           const float2* tw, float inv_scale, float* out,
                           cudaStream_t stream) {
  using Pl = RowsPlan<N1, N2>;
  const long long blocks = static_cast<long long>(ntime) * (N1 / Pl::G);
  if (work == nullptr || blocks > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
  auto rows = fs_rows_kernel<N1, N2>;
  cudaError_t e = allow_smem(rows, Pl::SMEM);
  if (e != cudaSuccess) return e;
  rows<<<dim3(static_cast<unsigned int>(blocks), nsub), Pl::THREADS,
         Pl::SMEM, stream>>>(work, nsub, nseg, tw, inv_scale, out);
  return cudaGetLastError();
}

// Power-of-two 256 <= nfft <= 16384: one block per (column, subchannel),
// the register-pass kernel (136 KB of shared memory at 16384). 32768
// points (256 KB) exceed a block's 227 KB and run as the four-step split.
template <typename T, typename Starts>
cudaError_t dispatch_small(int nfft, const T* x, long long nsamp, int nsub,
                           Starts starts, int ntime, int nseg,
                           const float* win, const float2* tw,
                           float inv_scale, float* out, cudaStream_t stream) {
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
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
