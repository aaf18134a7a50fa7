// Runs reg_psd_kernel up to 16384 points, or the four-step split's
// fs_cols_kernel then fs_rows_kernel through a workspace above
// (fft_common.cuh, emulated by mock_cuda.h), over one input file and
// writes the (ntime, nsub, nfft) float32 output.
//
//   harness NFFT DTYPE NSUB NSAMP NTIME NSEG POLICY HOP NTW IN OUT
//
// DTYPE 0 = float32 planes, 1 = int16; POLICY 0 = StartsArray (starts read
// from IN), 1 = StartsHop (t*HOP). IN holds the (2*NSUB, NSAMP) planes,
// NTIME int32 starts, the NFFT float32 window, the NTW complex64 twiddles
// and the float32 scale, in that order. Output bins the kernels do not
// write stay NaN.
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

// One launch: the grid's blocks one after another, each block's threads
// as std::threads meeting at one barrier.
template <class K>
void launch(int blocks_x, int blocks_y, int threads, K kernel) {
  for (int by = 0; by < blocks_y; ++by)
    for (int bx = 0; bx < blocks_x; ++bx) {
      std::barrier<> bar(threads);
      block_barrier = &bar;
      std::vector<std::thread> pool;
      for (int i = 0; i < threads; ++i)
        pool.emplace_back([=] {
          threadIdx = dim3(i);
          blockIdx = dim3(bx, by);
          kernel();
        });
      for (auto& th : pool) th.join();
    }
}

template <int N1, int N2, typename T, typename S>
void run_four_step(const T* x, long long nsamp, int nsub, S st, int ntime,
                   int nseg, const float* win, const float2* tw, float inv,
                   float* out) {
  using Pc = ColsPlan<N1, N2>;
  using Pr = RowsPlan<N1, N2>;
  std::vector<float2> work(static_cast<size_t>(ntime) * nsub * nseg * N1 *
                           N2);
  float2* wk = work.data();
  launch(ntime * nseg * (N2 / Pc::C), nsub, Pc::THREADS, [=] {
    fs_cols_kernel<N1, N2, T, S>(x, nsamp, nsub, st, nseg, win, tw, wk);
  });
  launch(ntime * (N1 / Pr::G), nsub, Pr::THREADS, [=] {
    fs_rows_kernel<N1, N2>(wk, nsub, nseg, tw, inv, out);
  });
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
#define PST_FS(n1, n2)                                                  \
  case (n1) * (n2):                                                     \
    run_four_step<n1, n2>(x, nsamp, nsub, st, ntime, nseg, win, tw, inv, \
                          out);                                         \
    break;
    PST_FS(128, 256) PST_FS(256, 256) PST_FS(512, 256)
#undef PST_FS
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
  if (argc != 12) return 2;
  const int n = std::stoi(argv[1]), dtype = std::stoi(argv[2]);
  const int nsub = std::stoi(argv[3]);
  const long long nsamp = std::stoll(argv[4]);
  const int ntime = std::stoi(argv[5]), nseg = std::stoi(argv[6]);
  const int policy = std::stoi(argv[7]), hop = std::stoi(argv[8]);
  const int ntw = std::stoi(argv[9]);
  std::ifstream f(argv[10], std::ios::binary);
  std::vector<char> xs((dtype ? 2 : 4) * 2 * nsub * nsamp);
  f.read(xs.data(), xs.size());
  std::vector<int> starts(ntime);
  f.read(reinterpret_cast<char*>(starts.data()), 4 * ntime);
  std::vector<float> win(n);
  f.read(reinterpret_cast<char*>(win.data()), 4 * n);
  std::vector<float2> tw(ntw);
  f.read(reinterpret_cast<char*>(tw.data()), 8 * ntw);
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
  std::ofstream(argv[11], std::ios::binary)
      .write(reinterpret_cast<const char*>(out.data()), 4 * out.size());
  return 0;
}
