// Kernel B1 on Hopper: windowed FFT periodogram -> Welch sum -> scale ->
// fftshift, one thread block per (STI column t, subchannel s).
//
// Replaces pyspectrogram_tpu/kernels/sti_pallas.py::make_pallas_sti_psd
// (the pallas_call at sti_pallas.py:555) over its whole range, power-of-two
// 256 <= nfft <= 32768. It computes what that kernel computes, not how: the
// TPU kernel factors the DFT into two MXU matmuls; here each segment runs an
// FFT. Up to 16384 points one block per (column, subchannel) transforms the
// segment with register-resident radix-16 passes (reg_psd_kernel); 32768
// points (256 KB) exceed a block's 227 KB of shared memory, so that size
// runs as the four-step split over two launches, through big_psd.cu's
// entry points (kernels/big_cuda.py four_step_psd). The kernels live in
// fft_common.cuh, shared with B3 and B4; this file is B1's entry point up
// to 16384 points, with frame starts read from a device array.
//
// What bounds it: at nfft = 4096 one segment is ~5*N*log2(N) = 0.25 MFLOP
// against 32 KB of samples read, under the float32 ridge (~20 flop/B), so
// the kernel should be bound by the global read of the samples, with the
// segment's trips through shared memory next (a radix-2 FFT makes 12 at
// 4096, 704 KB with 24 barriers). The register-pass design moves the
// segment through shared memory once per pass boundary (2 exchanges,
// 128 KB, 2 barriers at 4096), reads pass 0 straight from global memory
// fused with the int16 widening and the window, with two blocks of 256
// threads per SM so that one block's reads overlap the other's passes,
// keeps each thread's |X|^2 sums in registers over the segments and
// writes each bin once, fftshifted. At 32768 the four-step split (the
// register passes over batches of sub-FFTs, big_psd.cu's entry points)
// adds one round trip of the segment through device memory (8 bytes per
// sample written and read back).
//
// starts (ntime,) int32 lives on the device, so contiguous (t*frame_len)
// and gathered frame starts are one code path.

#include "fft_common.cuh"

// 256 <= nfft <= 16384; 32768 runs the four-step split's entry points
// (big_psd.cu). dtype: 0 = float32 planes, 1 = int16 planes. Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int pst_sti_psd(const void* x, int dtype, long long nsamp,
                           int nsub, const void* starts, int ntime, int nfft,
                           int nseg, const void* win, const void* tw,
                           float inv_scale, void* out, void* stream) {
  if (ntime <= 0 || nsub <= 0 || nsub > 65535 || nseg <= 0 ||
      nsamp < static_cast<long long>(nseg) * nfft)
    return static_cast<int>(cudaErrorInvalidValue);
  const StartsArray st{static_cast<const int*>(starts)};
  const float* w = static_cast<const float*>(win);
  const float2* t = static_cast<const float2*>(tw);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e =
      dtype == 0
          ? dispatch_small(nfft, static_cast<const float*>(x), nsamp, nsub,
                           st, ntime, nseg, w, t, inv_scale, o, s)
      : dtype == 1
          ? dispatch_small(nfft, static_cast<const int16_t*>(x), nsamp, nsub,
                           st, ntime, nseg, w, t, inv_scale, o, s)
          : cudaErrorInvalidValue;
  return static_cast<int>(e);
}
