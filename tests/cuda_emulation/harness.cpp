// Runs reg_psd_kernel (fft_common.cuh, emulated by mock_cuda.h) over one
// input file and writes its (ntime, nsub, nfft) float32 output.
//
//   harness NFFT DTYPE NSUB NSAMP NTIME NSEG POLICY HOP IN OUT
//
// DTYPE 0 = float32 planes, 1 = int16; POLICY 0 = StartsArray (starts read
// from IN), 1 = StartsHop (t*HOP). IN holds the (2*NSUB, NSAMP) planes,
// NTIME int32 starts, the NFFT float32 window, the NFFT/2 complex64
// twiddles and the float32 scale, in that order. Output bins the kernel
// does not write stay NaN.
#include "mock_cuda.h"
#include "fft_common_emu.cuh"

#include <cmath>
#include <fstream>
#include <string>
#include <thread>
#include <vector>

template <int N, typename T, typename S>
void run(const T* x, long long nsamp, int nsub, S st, int ntime, int nseg,
         const float* win, const float2* tw, float inv, float* out) {
  constexpr int TH = RegPlan<N>::THREADS;
  for (int t = 0; t < ntime; ++t)
    for (int s = 0; s < nsub; ++s) {
      std::barrier<> bar(TH);
      block_barrier = &bar;
      std::vector<std::thread> threads;
      for (int i = 0; i < TH; ++i)
        threads.emplace_back([=] {
          threadIdx = dim3(i);
          blockIdx = dim3(t, s);
          reg_psd_kernel<N, T, S>(x, nsamp, nsub, st, nseg, win, tw, inv,
                                  out);
        });
      for (auto& th : threads) th.join();
    }
}

template <typename T, typename S>
void dispatch(int n, const T* x, long long nsamp, int nsub, S st, int ntime,
              int nseg, const float* win, const float2* tw, float inv,
              float* out) {
  switch (n) {
#define PST_RUN(n)                                                 \
  case n:                                                          \
    run<n>(x, nsamp, nsub, st, ntime, nseg, win, tw, inv, out);    \
    break;
    PST_RUN(256) PST_RUN(512) PST_RUN(1024) PST_RUN(2048) PST_RUN(4096)
    PST_RUN(8192) PST_RUN(16384)
#undef PST_RUN
  }
}

template <typename T>
void by_policy(int n, const T* x, long long nsamp, int nsub, int policy,
               const int* starts, int hop, int ntime, int nseg,
               const float* win, const float2* tw, float inv, float* out) {
  if (policy == 0)
    dispatch(n, x, nsamp, nsub, StartsArray{starts}, ntime, nseg, win, tw,
             inv, out);
  else
    dispatch(n, x, nsamp, nsub, StartsHop{hop}, ntime, nseg, win, tw, inv,
             out);
}

int main(int argc, char** argv) {
  if (argc != 11) return 2;
  const int n = std::stoi(argv[1]), dtype = std::stoi(argv[2]);
  const int nsub = std::stoi(argv[3]);
  const long long nsamp = std::stoll(argv[4]);
  const int ntime = std::stoi(argv[5]), nseg = std::stoi(argv[6]);
  const int policy = std::stoi(argv[7]), hop = std::stoi(argv[8]);
  std::ifstream f(argv[9], std::ios::binary);
  std::vector<char> xs((dtype ? 2 : 4) * 2 * nsub * nsamp);
  f.read(xs.data(), xs.size());
  std::vector<int> starts(ntime);
  f.read(reinterpret_cast<char*>(starts.data()), 4 * ntime);
  std::vector<float> win(n);
  f.read(reinterpret_cast<char*>(win.data()), 4 * n);
  std::vector<float2> tw(n / 2);
  f.read(reinterpret_cast<char*>(tw.data()), 8 * (n / 2));
  float inv = 0.f;
  f.read(reinterpret_cast<char*>(&inv), 4);
  if (!f) return 3;
  std::vector<float> out(static_cast<size_t>(ntime) * nsub * n, NAN);
  if (dtype == 0)
    by_policy(n, reinterpret_cast<const float*>(xs.data()), nsamp, nsub,
              policy, starts.data(), hop, ntime, nseg, win.data(), tw.data(),
              inv, out.data());
  else
    by_policy(n, reinterpret_cast<const int16_t*>(xs.data()), nsamp, nsub,
              policy, starts.data(), hop, ntime, nseg, win.data(), tw.data(),
              inv, out.data());
  std::ofstream(argv[10], std::ios::binary)
      .write(reinterpret_cast<const char*>(out.data()), 4 * out.size());
  return 0;
}
