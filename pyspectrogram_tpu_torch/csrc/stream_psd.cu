// Kernel B3 on Hopper: the overlap-hop streaming push. Column t's frame
// starts at element offset t*hop of the push buffer (the carry followed by
// the new block), so consecutive columns overlap by frame_len - hop.
//
// Replaces pyspectrogram_tpu/kernels/sti_pallas.py::make_pallas_stream_psd
// (the pallas_call at sti_pallas.py:865). It computes what that kernel
// computes, for power-of-two 256 <= nfft <= 32768 and any 0 < hop <
// frame_len: the TPU kernel's gate (hop % 128 == 0 for lane-aligned
// slices, the buffer within a VMEM budget) has no counterpart here. It
// does not copy that kernel's VMEM-resident lane fold: it is B1's kernels
// (fft_common.cuh) with the start policy StartsHop, so the frame start t*hop
// is computed in the block and no starts tensor is built or copied; segment
// seg of column t starts at t*hop + seg*nfft, and parity mode reads segment
// 0 only. Up to 16384 points one block per (column, subchannel) runs the
// register-pass kernel (reg_psd_kernel); 32768 takes the four-step split
// through a workspace.
//
// What bounds it: overlapping frames read each sample frame_len/hop times.
// At the JAX bench's stream/4096/overlap2048 push (nfft 4096, nint 1, hop
// 2048, k 8, nsub 2) the buffer is 4 planes x 18,432 x 4 B = 295 KB, which
// stays in the 50 MB L2, so the repeated reads cost L2 bandwidth, not HBM
// (the card's analogue of the TPU keeping the buffer VMEM-resident). At
// that size the push is latency-bound: 16 blocks on 132 SMs, each one
// chain of dependent steps. The register passes shorten that chain from
// 12 shared-memory stages with 24 barriers to 3 passes with 2 exchanges.
// A shared-memory window shared by adjacent columns is left for later
// work.

#include "fft_common.cuh"

// x: float32 planes (2*nsub, nsamp), nsamp = frame_len - hop + k*hop with
// frame_len = nfft*nseg in welch mode. work: for nfft 32768, a float2
// workspace of k * nsub * nseg * nfft elements (ignored below). Returns
// cudaGetLastError() after the launches (0 on success).
extern "C" int pst_stream_psd(const void* x, long long nsamp, int nsub,
                              int hop, int k, int nfft, int nseg,
                              const void* win, const void* tw,
                              float inv_scale, void* work, void* out,
                              void* stream) {
  if (k <= 0 || hop <= 0 || nsub <= 0 || nsub > 65535 || nseg <= 0 ||
      nsamp > 0x7FFFFFFFLL ||
      static_cast<long long>(k - 1) * hop + static_cast<long long>(nseg) * nfft
          > nsamp)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* xf = static_cast<const float*>(x);
  const float* w = static_cast<const float*>(win);
  const float2* t = static_cast<const float2*>(tw);
  float2* wk = static_cast<float2*>(work);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nfft == 32768) {  // the four-step split 128 x 256, as B1's
    cudaError_t e = launch_fs_cols<128, 256>(xf, nsamp, nsub, StartsHop{hop},
                                             k, nseg, w, t, wk, s);
    if (e == cudaSuccess)
      e = launch_fs_rows<128, 256>(wk, nsub, k, nseg, t, inv_scale, o, s);
    return static_cast<int>(e);
  }
  return static_cast<int>(dispatch_small(nfft, xf, nsamp, nsub,
                                         StartsHop{hop}, k, nseg, w, t,
                                         inv_scale, o, s));
}
