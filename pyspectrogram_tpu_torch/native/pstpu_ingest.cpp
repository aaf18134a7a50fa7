// pstpu_ingest — native host-side ingest kernels.
//
// The reference delegates its IO hot path to the external libdigital_rf C
// library (reference: drfProc.py:52, drfProc.py:161-164: ntime sequential
// HDF5 reads per STI refresh). In this framework HDF5 decoding stays on
// h5py's C core; THIS file owns the step between the decoded sample span
// and the device transfer: slicing ntime strided frames out of the span
// and packing them into the plane-major / time-major layouts the TPU
// kernels consume. These are pure memory-movement loops that numpy can
// only express through temporaries; here they are single-pass, cache-
// blocked, and GIL-free (callers invoke via ctypes on raw buffers).
//
// Build: make -C csrc   (g++ -O3 -march=native -shared -fPIC)

#include <cstdint>
#include <cstring>

extern "C" {

// Interleaved complex64 span (span_len, nsub) [2 floats per sample] ->
// plane-major float32 out (nsub*2, ntime*frame_len):
//   out[2*sub + plane][t*frame_len + i] = span[starts[t] + i][sub].plane
void assemble_pm_c64(const float* span, int64_t span_len, int32_t nsub,
                     const int64_t* starts, int32_t ntime, int64_t frame_len,
                     float* out) {
    const int64_t row = (int64_t)ntime * frame_len;
    const int64_t sstride = 2 * (int64_t)nsub;  // floats per sample row
    for (int32_t sub = 0; sub < nsub; ++sub) {
        float* outr = out + (int64_t)(2 * sub) * row;
        float* outi = out + (int64_t)(2 * sub + 1) * row;
        for (int32_t t = 0; t < ntime; ++t) {
            const float* src = span + starts[t] * sstride + 2 * sub;
            float* dr = outr + (int64_t)t * frame_len;
            float* di = outi + (int64_t)t * frame_len;
            for (int64_t i = 0; i < frame_len; ++i) {
                dr[i] = src[i * sstride];
                di[i] = src[i * sstride + 1];
            }
        }
    }
}

// Same for int16 compound {r,i} spans -> int16 planes.
void assemble_pm_i16(const int16_t* span, int64_t span_len, int32_t nsub,
                     const int64_t* starts, int32_t ntime, int64_t frame_len,
                     int16_t* out) {
    const int64_t row = (int64_t)ntime * frame_len;
    const int64_t sstride = 2 * (int64_t)nsub;
    for (int32_t sub = 0; sub < nsub; ++sub) {
        int16_t* outr = out + (int64_t)(2 * sub) * row;
        int16_t* outi = out + (int64_t)(2 * sub + 1) * row;
        for (int32_t t = 0; t < ntime; ++t) {
            const int16_t* src = span + starts[t] * sstride + 2 * sub;
            int16_t* dr = outr + (int64_t)t * frame_len;
            int16_t* di = outi + (int64_t)t * frame_len;
            for (int64_t i = 0; i < frame_len; ++i) {
                dr[i] = src[i * sstride];
                di[i] = src[i * sstride + 1];
            }
        }
    }
}

// Deinterleave one complex64 buffer (n, nsub) into plane-major (nsub*2, n).
void deinterleave_c64(const float* src, int64_t n, int32_t nsub, float* out) {
    const int64_t sstride = 2 * (int64_t)nsub;
    for (int32_t sub = 0; sub < nsub; ++sub) {
        float* outr = out + (int64_t)(2 * sub) * n;
        float* outi = out + (int64_t)(2 * sub + 1) * n;
        const float* s = src + 2 * sub;
        for (int64_t i = 0; i < n; ++i) {
            outr[i] = s[i * sstride];
            outi[i] = s[i * sstride + 1];
        }
    }
}

int32_t pstpu_ingest_abi_version(void) { return 1; }

}  // extern "C"
