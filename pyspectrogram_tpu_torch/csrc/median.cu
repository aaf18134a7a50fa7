// Kernel B2 on Hopper: exact median over the time axis of a (batch, n,
// cols) float32 array. A batch of 1 is one request's (n, cols) median; a
// merged multi-request launch (models/batch.py) passes its requests' cubes
// side by side, request b's rows starting at b * n * cols, so no
// transposed copy is made. The request index is a grid dimension in both
// regimes below.
//
// Replaces pyspectrogram_tpu/kernels/median_pallas.py::_make_median_kernel
// (the pallas_call at median_pallas.py:130, reached through
// median_over_time_pallas). The result is the k-th smallest (k = (n+1)/2)
// float in the total order of the float's bits (-0 below +0), and for even
// n the mean of the two middles as 0.5f * (v1 + v2), where v2 = v1 when
// more than k values are <= v1 as floats and else the least float above
// v1: bit-equal to ops.plain.median_bisect and equal to np.median.
//
// What bounds it: one read of the n * cols * 4 input bytes, 0.143 ms for
// the live engine's 480 MB window on an H100 at 3.35 TB/s. The first
// design (one thread per output bin, 33 bisection sweeps down its column)
// moved 33 times those bytes with one dependent load chain per thread and
// 8,192 threads at that window: latency-bound at ~0.39 TB/s. Two regimes
// replace it; the wrapper (kernels/median_cuda.py) picks one from n:
//
// - tile (n * TILE_STRIDE * 4 <= TILE_MAX_BYTES): a block loads an n x 32
//   tile once, coalesced, into shared memory as order keys, then bisects
//   with 8 threads per column whose counts meet by warp shuffles. Device
//   memory is read once; the 33 sweeps read shared memory, whose row stride
//   of 36 words keeps the 32 lanes of a warp on 32 banks.
// - radix (larger n): a radix select over 8-bit digits of the unsigned
//   order key, 4 passes. Each pass streams the cube once with 16-byte loads
//   (4-byte ones when cols % 4 != 0 or the buffer is not 16-byte aligned:
//   32-column tiles), split into (128-column tile) x (row
//   chunk) x (request) blocks, so ~8 blocks per SM are queued, not 1; a
//   block counts, for the keys that match the prefix chosen so far, each
//   column's next digit in a shared histogram laid out [column % 4][digit]
//   [lane] (a warp's atomics land on 32 banks), then adds its non-zero bins
//   into a per-column global histogram with integer atomics. Integer sums
//   do not depend on their order, so the result is deterministic. A select
//   kernel (one warp per column: a shuffle scan of the 256 bins) then fixes
//   the digit and the remaining rank and clears the bins for the next pass.
//   Even n: the last pass also keeps each column's least key above the
//   24-bit prefix (registers, then shared and global atomicMin), so the
//   (k+1)-th key is the k-th's own bin, the next non-empty bin, or that
//   least key, with no fifth pass. The floor: 4 x 480 MB at the card's
//   rate, ~0.6 ms, plus 8 launches.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int TILE_COLS = 32;
constexpr int TILE_STRIDE = TILE_COLS + 4;  // = 4 (mod 32): see tile reads
constexpr int TILE_THREADS = 256;           // 8 warps x 4 columns x 8 rows
constexpr int TILE_MAX_BYTES = 96 * 1024;
constexpr int TILE_LOADS = 8;               // rows in flight per thread
constexpr int RADIX_THREADS = 512;
constexpr int RADIX_UNROLL = 4;             // rows in flight per warp
constexpr int SELECT_THREADS = 256;         // 8 columns (warps) per block
constexpr unsigned FULL = 0xFFFFFFFFu;

// float -> int32 key with the same total order (as the first design and
// ops.plain._float_order_key); an involution
__device__ __forceinline__ int order_key(float v) {
  const int b = __float_as_int(v);
  return b ^ ((b >> 31) & 0x7FFFFFFF);
}

// float -> uint32 key with the same total order, for the radix digits
__device__ __forceinline__ unsigned radix_key(float v) {
  const unsigned b = __float_as_uint(v);
  return b ^ (static_cast<unsigned>(static_cast<int>(b) >> 31) | 0x80000000u);
}

__device__ __forceinline__ float radix_value(unsigned u) {
  return __uint_as_float(u & 0x80000000u ? u ^ 0x80000000u : ~u);
}

// ---- tile regime -----------------------------------------------------

__global__ void __launch_bounds__(TILE_THREADS)
median_tile_kernel(const float* __restrict__ x, int n, long long cols,
                   float* __restrict__ out) {
  extern __shared__ int tile[];  // n rows x TILE_STRIDE keys
  const long long c0 = static_cast<long long>(blockIdx.x) * TILE_COLS;
  const long long b = blockIdx.y;
  const float* xb = x + b * n * cols + c0;
  const int width = static_cast<int>(
      cols - c0 < TILE_COLS ? cols - c0 : TILE_COLS);
  // warp w loads rows w, w + 8, ...: each 32 neighbouring columns of one
  // row (128 coalesced bytes), TILE_LOADS rows in flight per thread
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int r0 = warp; r0 < n; r0 += 8 * TILE_LOADS) {
    float v[TILE_LOADS];
#pragma unroll
    for (int u = 0; u < TILE_LOADS; ++u) {
      const int r = r0 + 8 * u;
      v[u] = r < n && lane < width
                 ? __ldg(xb + static_cast<long long>(r) * cols + lane)
                 : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < TILE_LOADS; ++u)
      if (r0 + 8 * u < n)
        tile[(r0 + 8 * u) * TILE_STRIDE + lane] = order_key(v[u]);
  }
  __syncthreads();
  // lane = 4 * sub + q: column 4 * warp + q, rows sub, sub + 8, ...; with
  // the stride = 4 (mod 32) the bank is (4 * sub + q + 4 * warp) mod 32,
  // distinct over the warp
  const int sub = lane >> 2;
  const int c = warp * 4 + (lane & 3);
  const int* col = tile + c;
  const int k = (n + 1) / 2;
  int lo = -0x7F800001;
  int hi = 0x7F800000;
  for (int step = 0; step < 33; ++step) {
    // overflow-free floor((lo + hi) / 2): the bracket spans > int32 range
    const int mid = (lo & hi) + ((lo ^ hi) >> 1);
    int cnt = 0;
    for (int r = sub; r < n; r += 8) cnt += col[r * TILE_STRIDE] <= mid;
    cnt += __shfl_xor_sync(FULL, cnt, 4);
    cnt += __shfl_xor_sync(FULL, cnt, 8);
    cnt += __shfl_xor_sync(FULL, cnt, 16);
    if (cnt >= k)
      hi = mid;
    else
      lo = mid + 1;
  }
  const float v1 = __int_as_float(hi ^ ((hi >> 31) & 0x7FFFFFFF));
  float med = v1;
  if (!(n & 1)) {
    // if duplicates of v1 span the midpoint it IS the next value; else the
    // next value is the least one strictly above v1
    int cnt_le = 0;
    float bigger = __int_as_float(0x7F800000);  // +inf
    for (int r = sub; r < n; r += 8) {
      const int kb = col[r * TILE_STRIDE];
      const float v = __int_as_float(kb ^ ((kb >> 31) & 0x7FFFFFFF));
      cnt_le += v <= v1;
      if (v > v1) bigger = fminf(bigger, v);
    }
    for (int m = 4; m < 32; m <<= 1) {
      cnt_le += __shfl_xor_sync(FULL, cnt_le, m);
      bigger = fminf(bigger, __shfl_xor_sync(FULL, bigger, m));
    }
    const float v2 = cnt_le > k ? v1 : bigger;
    med = 0.5f * (v1 + v2);
  }
  if (sub == 0 && c < width) out[b * cols + c0 + c] = med;
}

// ---- radix regime ----------------------------------------------------

// One pass: the histogram of digit (key >> shift) & 255 over the keys whose
// bits above the digit equal the column's prefix (every key at shift 24),
// for a (32 * V)-column tile, rows [r0, r0 + rows), one request. With
// gmin (even n, shift 0) also the least key above the prefix's range.
template <int V>
__global__ void __launch_bounds__(RADIX_THREADS)
radix_hist_kernel(const float* __restrict__ x, int n, long long cols,
                  int rows, int shift, const unsigned* __restrict__ prefix,
                  unsigned* __restrict__ ghist, unsigned* __restrict__ gmin) {
  extern __shared__ unsigned sh[];  // [V][256][32] counts, [32 * V] mins
  constexpr int TC = 32 * V;
  constexpr int NBINS = V * 256 * 32;
  unsigned* smin = sh + NBINS;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  constexpr int NWARPS = RADIX_THREADS / 32;
  const long long c0 = static_cast<long long>(blockIdx.x) * TC;
  const long long b = blockIdx.z;
  const int r0 = blockIdx.y * rows;
  const int r1 = n - r0 < rows ? n : r0 + rows;
  for (int i = threadIdx.x; i < NBINS; i += RADIX_THREADS) sh[i] = 0;
  if (gmin)
    for (int i = threadIdx.x; i < TC; i += RADIX_THREADS) smin[i] = FULL;
  const unsigned hi_mask = shift >= 24 ? 0u : FULL << (shift + 8);
  const long long lc = c0 + lane * V;  // this lane's first column
  const bool valid = lc < cols;        // all V columns or none (wrapper)
  unsigned pre[V];
  unsigned mn[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    pre[j] = valid && shift < 24 ? prefix[b * cols + lc + j] : 0u;
    mn[j] = FULL;
  }
  __syncthreads();
  const float* xb = x + b * n * cols + lc;
  if (valid) {
    for (int r = r0 + warp; r < r1; r += NWARPS * RADIX_UNROLL) {
      float v[RADIX_UNROLL][V];
#pragma unroll
      for (int u = 0; u < RADIX_UNROLL; ++u) {
        const int rr = r + u * NWARPS;
        if (rr < r1) {
          const float* p = xb + static_cast<long long>(rr) * cols;
          if constexpr (V == 4) {
            const float4 q = __ldg(reinterpret_cast<const float4*>(p));
            v[u][0] = q.x;
            v[u][1] = q.y;
            v[u][2] = q.z;
            v[u][3] = q.w;
          } else {
            v[u][0] = __ldg(p);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < RADIX_UNROLL; ++u) {
        if (r + u * NWARPS >= r1) break;
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const unsigned key = radix_key(v[u][j]);
          if (((key ^ pre[j]) & hi_mask) == 0)
            atomicAdd(&sh[(j * 256 + ((key >> shift) & 255)) * 32 + lane], 1u);
          else if (gmin && (key & hi_mask) > pre[j])
            mn[j] = min(mn[j], key);
        }
      }
    }
  }
  if (gmin && valid) {
#pragma unroll
    for (int j = 0; j < V; ++j)
      if (mn[j] != FULL) atomicMin(&smin[lane * V + j], mn[j]);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < NBINS; i += RADIX_THREADS) {
    const unsigned cnt = sh[i];
    if (cnt) {
      const long long col = c0 + (i & 31) * V + i / (256 * 32);
      atomicAdd(&ghist[(b * cols + col) * 256 + ((i >> 5) & 255)], cnt);
    }
  }
  if (gmin)
    for (int i = threadIdx.x; i < TC; i += RADIX_THREADS)
      if (smin[i] != FULL) atomicMin(&gmin[b * cols + c0 + i], smin[i]);
}

// One warp per column: the bin holding rank `rank` (1-indexed, among the
// keys that matched), the new prefix and rank, the bins cleared for the
// next pass; at shift 0 the median itself.
__global__ void __launch_bounds__(SELECT_THREADS)
radix_select_kernel(unsigned* __restrict__ ghist,
                    unsigned* __restrict__ prefix, int* __restrict__ rank,
                    const unsigned* __restrict__ gmin, int n, int shift,
                    long long total, float* __restrict__ out) {
  const long long col =
      (static_cast<long long>(blockIdx.x) * SELECT_THREADS + threadIdx.x) >> 5;
  if (col >= total) return;  // whole warps: total is per warp
  const int lane = threadIdx.x & 31;
  uint4* h = reinterpret_cast<uint4*>(ghist + col * 256) + lane * 2;
  const uint4 a = h[0];
  const uint4 c = h[1];
  h[0] = make_uint4(0, 0, 0, 0);
  h[1] = make_uint4(0, 0, 0, 0);
  const unsigned cnt[8] = {a.x, a.y, a.z, a.w, c.x, c.y, c.z, c.w};
  unsigned sum = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) sum += cnt[i];
  unsigned incl = sum;  // inclusive scan over the lanes' bins 8l .. 8l+7
#pragma unroll
  for (int m = 1; m < 32; m <<= 1) {
    const unsigned t = __shfl_up_sync(FULL, incl, m);
    if (lane >= m) incl += t;
  }
  const unsigned r = shift >= 24 ? static_cast<unsigned>((n + 1) / 2)
                                 : static_cast<unsigned>(rank[col]);
  const unsigned pre = shift >= 24 ? 0u : prefix[col];
  const int owner = __ffs(__ballot_sync(FULL, incl >= r)) - 1;
  // in every lane: the first of its bins where the running count reaches r
  unsigned below = incl - sum;
  int d = 0;
  unsigned in_bin = 0;
  bool found = false;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    if (!found && below + cnt[i] >= r) {
      d = lane * 8 + i;
      in_bin = cnt[i];
      found = true;
    }
    if (!found) below += cnt[i];
  }
  d = __shfl_sync(FULL, d, owner);
  in_bin = __shfl_sync(FULL, in_bin, owner);
  const unsigned r_in = r - __shfl_sync(FULL, below, owner);
  const unsigned key = pre | (static_cast<unsigned>(d) << shift);
  if (shift > 0) {
    if (lane == 0) {
      prefix[col] = key;
      rank[col] = static_cast<int>(r_in);
    }
    return;
  }
  const float v1 = radix_value(key);
  float med = v1;
  if (!(n & 1)) {
    // the (k+1)-th key: in v1's own bin, in the next non-empty bin, or
    // the least key above the prefix
    int next = 256;
#pragma unroll
    for (int i = 7; i >= 0; --i)
      if (lane * 8 + i > d && cnt[i]) next = lane * 8 + i;
#pragma unroll
    for (int m = 16; m > 0; m >>= 1)
      next = min(next, __shfl_xor_sync(FULL, next, m));
    const unsigned key2 = in_bin > r_in ? key
                          : next < 256  ? (pre | static_cast<unsigned>(next))
                                        : gmin[col];
    float v2 = radix_value(key2);
    // v2 == v1 as floats (+0 after -0) is the "more than k values <= v1"
    // case, where the first design takes v1 itself
    if (v2 == v1) v2 = v1;
    med = 0.5f * (v1 + v2);
  }
  if (lane == 0) out[col] = med;
}

template <int V>
int radix_launch(const float* x, int batch, int n, long long cols, int rows,
                 unsigned* ghist, unsigned* prefix, int* rank, unsigned* gmin,
                 float* out, cudaStream_t stream) {
  const int smem = (V * 256 * 32 + 32 * V) * static_cast<int>(sizeof(unsigned));
  cudaError_t e = cudaFuncSetAttribute(
      radix_hist_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(static_cast<unsigned>((cols + 32 * V - 1) / (32 * V)),
                  static_cast<unsigned>((n + rows - 1) / rows),
                  static_cast<unsigned>(batch));
  const long long total = static_cast<long long>(batch) * cols;
  const unsigned sel_blocks = static_cast<unsigned>(
      (total * 32 + SELECT_THREADS - 1) / SELECT_THREADS);
  for (int shift = 24; shift >= 0; shift -= 8) {
    radix_hist_kernel<V><<<grid, RADIX_THREADS, smem, stream>>>(
        x, n, cols, rows, shift, prefix, ghist, shift == 0 ? gmin : nullptr);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    radix_select_kernel<<<sel_blocks, SELECT_THREADS, 0, stream>>>(
        ghist, prefix, rank, gmin, n, shift, total, out);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}

}  // namespace

// x: (batch, n, cols) contiguous float32; out: (batch, cols). The tile
// regime; n * (32 + 4) * 4 bytes must fit TILE_MAX_BYTES. Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int pst_median_tile(const void* x, int batch, int n, long long cols,
                               void* out, void* stream) {
  const long long smem = static_cast<long long>(n) * TILE_STRIDE * 4;
  if (batch <= 0 || batch > 65535 || n <= 0 || cols <= 0 ||
      smem > TILE_MAX_BYTES)
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        median_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(static_cast<unsigned>((cols + TILE_COLS - 1) / TILE_COLS),
                  static_cast<unsigned>(batch));
  median_tile_kernel<<<grid, TILE_THREADS, static_cast<size_t>(smem),
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), n, cols, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// The radix regime: 4 passes of (histogram, select), row chunks of `rows`.
// Workspace from the caller: ghist (batch * cols * 256) uint32 zeroed,
// prefix and rank (batch * cols), gmin (batch * cols) set to 0xFFFFFFFF
// for even n (unused for odd n). vec4 = 1 takes 16-byte loads and needs
// cols % 4 == 0 and a 16-byte aligned x. Returns the first launch error.
extern "C" int pst_median_radix(const void* x, int batch, int n,
                                long long cols, int rows, int vec4,
                                void* ghist, void* prefix, void* rank,
                                void* gmin, void* out, void* stream) {
  if (batch <= 0 || batch > 65535 || n <= 0 || cols <= 0 || rows <= 0 ||
      (n + rows - 1) / rows > 65535 ||
      (vec4 && (cols % 4 || reinterpret_cast<uintptr_t>(x) % 16)))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto fx = static_cast<const float*>(x);
  const auto h = static_cast<unsigned*>(ghist);
  const auto pre = static_cast<unsigned*>(prefix);
  const auto rk = static_cast<int*>(rank);
  const auto mn = static_cast<unsigned*>(gmin);
  const auto o = static_cast<float*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  return vec4 ? radix_launch<4>(fx, batch, n, cols, rows, h, pre, rk, mn, o, s)
              : radix_launch<1>(fx, batch, n, cols, rows, h, pre, rk, mn, o, s);
}
