// Kernel B4 on Hopper: B1's contract (window -> FFT -> |X|^2 summed over
// the segments -> scale -> fftshift, per column and subchannel) for
// power-of-two 65536 <= nfft <= 2^20, with gathered or contiguous frame
// starts, float32 or int16 planes, welch or parity. The same two entry
// points run B1 at 32768.
//
// Replaces pyspectrogram_tpu/kernels/sti_pallas.py::_make_big3_sti_psd
// (the pallas_call at sti_pallas.py:1110; with factors3, make_plan3 and
// _big3_vmem_bytes). That kernel factors the DFT into three small GEMMs
// A*B*C because the MXU is the TPU's only fast unit; that is not carried
// over. Here the transform is the four-step split N = N1 * N2 of
// fft_common.cuh (fs_cols_kernel, fs_rows_kernel), two launches through a
// workspace: 32768 = 128*256, 65536 = 256*256, 131072 = 512*256, 262144 =
// 512*512, 524288 = 1024*512, 1048576 = 1024*1024. Both launches run
// register-resident radix-16 passes over a batch of sub-FFTs (1 exchange
// through shared memory at 256 points, 2 at 512 and 1024, against 8-10
// radix-2 stages before), read and write global memory in whole sectors,
// and take their twiddles from three small tables (W_N1, W_N2 and W_N^l,
// l < N2: 5.6-16 KB, L1-resident) instead of one N/2-point table read at a
// stride; the inter-step factor W_N^(n2*k1) is the product of two entries.
// The wrapper (kernels/big_cuda.py) calls the two entry points in turn per
// chunk of columns, so each launch can be timed alone.
//
// What bounds it: one 2^20-point segment is ~5*N*log2(N) = 105 MFLOP
// against 8 MB of samples read (float32), 8 MB of workspace written and
// read back and 4 MB written: ~3-4 flop/B, under the card's float32 ridge
// (~20 flop/B), so the kernel is bound by memory traffic. On an H100 both
// launches move their bytes at 2.0-2.6 TB/s (PERF.md), so the workspace's
// round trip through HBM (16 of the 28-36 bytes a point moves) is what
// stands between the kernel and its bound. Chunks of columns small enough
// for the workspace to stay in the L2 were measured and were slower.

#include "fft_common.cuh"

namespace {

// The splits N1 x N2 of every four-step size: B1 (and B3) at 32768, B4
// above (kernels/_build.py FOUR_STEP builds their twiddle tables).
#define PST_FOUR_STEP(X) \
  X(128, 256) X(256, 256) X(512, 256) X(512, 512) X(1024, 512) X(1024, 1024)

template <typename T>
cudaError_t dispatch_cols(int nfft, const T* x, long long nsamp, int nsub,
                          StartsArray st, int ntime, int nseg,
                          const float* win, const float2* tw, float2* work,
                          cudaStream_t stream) {
  switch (nfft) {
#define PST_COLS(n1, n2)                                                    \
  case (n1) * (n2):                                                         \
    return launch_fs_cols<n1, n2>(x, nsamp, nsub, st, ntime, nseg, win, tw, \
                                  work, stream);
    PST_FOUR_STEP(PST_COLS)
#undef PST_COLS
    default:
      return cudaErrorInvalidValue;
  }
}

cudaError_t dispatch_rows(int nfft, const float2* work, int nsub, int ntime,
                          int nseg, const float2* tw, float inv_scale,
                          float* out, cudaStream_t stream) {
  switch (nfft) {
#define PST_ROWS(n1, n2)                                                    \
  case (n1) * (n2):                                                         \
    return launch_fs_rows<n1, n2>(work, nsub, ntime, nseg, tw, inv_scale,   \
                                  out, stream);
    PST_FOUR_STEP(PST_ROWS)
#undef PST_ROWS
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Launch 1 of the four-step split (32768 <= nfft <= 2^20) over ntime
// columns. dtype: 0 = float32 planes, 1 = int16 planes. work: a float2
// workspace of ntime * nsub * nseg * nfft elements. Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int pst_four_step_cols(const void* x, int dtype, long long nsamp,
                                  int nsub, const void* starts, int ntime,
                                  int nfft, int nseg, const void* win,
                                  const void* tw, void* work, void* stream) {
  if (ntime <= 0 || nsub <= 0 || nsub > 65535 || nseg <= 0 ||
      nsamp < static_cast<long long>(nseg) * nfft)
    return static_cast<int>(cudaErrorInvalidValue);
  const StartsArray st{static_cast<const int*>(starts)};
  const float* w = static_cast<const float*>(win);
  const float2* t = static_cast<const float2*>(tw);
  float2* wk = static_cast<float2*>(work);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e =
      dtype == 0
          ? dispatch_cols(nfft, static_cast<const float*>(x), nsamp, nsub, st,
                          ntime, nseg, w, t, wk, s)
      : dtype == 1
          ? dispatch_cols(nfft, static_cast<const int16_t*>(x), nsamp, nsub,
                          st, ntime, nseg, w, t, wk, s)
          : cudaErrorInvalidValue;
  return static_cast<int>(e);
}

// Launch 2: the ntime columns' fftshifted power (ntime, nsub, nfft) from
// launch 1's workspace.
extern "C" int pst_four_step_rows(const void* work, int nsub, int ntime,
                                  int nfft, int nseg, const void* tw,
                                  float inv_scale, void* out, void* stream) {
  if (ntime <= 0 || nsub <= 0 || nsub > 65535 || nseg <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(dispatch_rows(
      nfft, static_cast<const float2*>(work), nsub, ntime, nseg,
      static_cast<const float2*>(tw), inv_scale, static_cast<float*>(out),
      static_cast<cudaStream_t>(stream)));
}
