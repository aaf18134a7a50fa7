// Kernel B1 on Hopper: windowed FFT periodogram -> Welch sum -> scale ->
// fftshift, one thread block per (STI column t, subchannel s).
//
// Replaces pyspectrogram_tpu/kernels/sti_pallas.py::make_pallas_sti_psd
// (the pallas_call at sti_pallas.py:555) over its whole range, power-of-two
// 256 <= nfft <= 32768. It computes what that kernel computes, not how: the
// TPU kernel factors the DFT into two MXU matmuls; here each segment runs a
// radix-2 Stockham FFT in shared memory. Up to 16384 points (128 KB) one
// block holds the whole segment; 32768 points (256 KB) exceed a block's
// 227 KB, so that size runs as a four-step split over two launches. The
// kernels live in fft_common.cuh, shared with B3 and B4; this file is B1's
// entry point, with frame starts read from a device array.
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
// starts (ntime,) int32 lives on the device, so contiguous (t*frame_len)
// and gathered frame starts are one code path.

#include "fft_common.cuh"

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
  const StartsArray st{static_cast<const int*>(starts)};
  const float* w = static_cast<const float*>(win);
  const float2* t = static_cast<const float2*>(tw);
  float2* wk = static_cast<float2*>(work);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e =
      dtype == 0
          ? dispatch_small(nfft, static_cast<const float*>(x), nsamp, nsub,
                           st, ntime, nseg, w, t, inv_scale, wk, o, s)
      : dtype == 1
          ? dispatch_small(nfft, static_cast<const int16_t*>(x), nsamp, nsub,
                           st, ntime, nseg, w, t, inv_scale, wk, o, s)
          : cudaErrorInvalidValue;
  return static_cast<int>(e);
}
