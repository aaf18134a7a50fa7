// Kernel B4 on Hopper: B1's contract (window -> FFT -> |X|^2 summed over
// the segments -> scale -> fftshift, per column and subchannel) for
// power-of-two 65536 <= nfft <= 2^20, with gathered or contiguous frame
// starts, float32 or int16 planes, welch or parity.
//
// Replaces pyspectrogram_tpu/kernels/sti_pallas.py::_make_big3_sti_psd
// (the pallas_call at sti_pallas.py:1110; with factors3, make_plan3 and
// _big3_vmem_bytes). That kernel factors the DFT into three small GEMMs
// A*B*C because the MXU is the TPU's only fast unit; that is not carried
// over. Here the transform is the four-step split N = N1 * N2 of
// fft_common.cuh, two launches through a workspace, with N1 >= N2 in
// {256, 512, 1024}: 65536 = 256*256, 131072 = 512*256, 262144 = 512*512,
// 524288 = 1024*512, 1048576 = 1024*1024. Each block transforms C = 8192/N1
// columns of N1 points (launch 1) or G = 8192/N2 rows of N2 points (launch
// 2) in 64-66 KB of dynamic shared memory, 512 threads, 8 butterflies and
// 16 elements per thread at every size: the per-thread shape of B1's
// spill-free 32768-point split. The twiddle table W_N^m, m < N/2, is
// computed in float64 on the host and cast to float32 (4 MB at 2^20).
//
// What bounds it: one 2^20-point segment is ~5*N*log2(N) = 105 MFLOP
// against 8 MB of samples read, 16 MB of workspace written and read back
// and 4 MB written: ~4 flop/B, under the card's float32 ridge (~20 flop/B),
// so the kernel is bound by memory traffic. Once the workspace outgrows the
// 50 MB L2 its round trip goes to HBM. The workspace (8 B per sample per
// segment) comes from the wrapper, which launches over column chunks to
// keep it within 1 GiB.

#include "fft_common.cuh"

namespace {

template <typename T>
cudaError_t dispatch_big(int nfft, const T* x, long long nsamp, int nsub,
                         StartsArray st, int ntime, int nseg,
                         const float* win, const float2* tw, float inv_scale,
                         float2* work, float* out, cudaStream_t stream) {
  constexpr int THREADS = 512;
  switch (nfft) {
#define PST_BIG(n1, n2)                                                     \
  case (n1) * (n2):                                                         \
    return launch_four_step<n1, n2, 8192 / (n1), 8192 / (n2), THREADS>(     \
        x, nsamp, nsub, st, ntime, nseg, win, tw, inv_scale, work, out,     \
        stream);
    PST_BIG(256, 256)
    PST_BIG(512, 256)
    PST_BIG(512, 512)
    PST_BIG(1024, 512)
    PST_BIG(1024, 1024)
#undef PST_BIG
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32 planes, 1 = int16 planes. work: a float2 workspace of
// ntime * nsub * nseg * nfft elements. Returns cudaGetLastError() after the
// two launches (0 on success).
extern "C" int pst_big_psd(const void* x, int dtype, long long nsamp,
                           int nsub, const void* starts, int ntime, int nfft,
                           int nseg, const void* win, const void* tw,
                           float inv_scale, void* work, void* out,
                           void* stream) {
  if (ntime <= 0 || nsub <= 0 || nsub > 65535 || nseg <= 0 ||
      nsamp < static_cast<long long>(nseg) * nfft)
    return static_cast<int>(cudaErrorInvalidValue);
  const StartsArray st{static_cast<const int*>(starts)};
  const float* w = static_cast<const float*>(win);
  const float2* t = static_cast<const float2*>(tw);
  float2* wk = static_cast<float2*>(work);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e =
      dtype == 0
          ? dispatch_big(nfft, static_cast<const float*>(x), nsamp, nsub, st,
                         ntime, nseg, w, t, inv_scale, wk, o, s)
      : dtype == 1
          ? dispatch_big(nfft, static_cast<const int16_t*>(x), nsamp, nsub,
                         st, ntime, nseg, w, t, inv_scale, wk, o, s)
          : cudaErrorInvalidValue;
  return static_cast<int>(e);
}
