// Weight-streaming probe #14 for Hopper (sm_90a): int8 weights, convert only.
//
// Replaces script/probe_decode_budget.py:_w8p_kernel, the decode-budget
// probe that streams int8 weight bytes with no unpack beyond the convert:
//   out = (bf16(x) . bf16(w)) * scale[n]     w (K, N) int8 codes, any byte
// fp32 accumulation, out in x's dtype (bf16, or fp32 kept as is).
//
// Bound: at the probe's M = 1 decoder shapes the call moves its int8
// weights (16.8 MB for 4096 x 4096, 45.1 MB for 4096 x 11008, 46.1 MB for
// 11264 x 4096): 5.0 to 13.8 us at 3.35 TB/s, twice kernel #12's bytes. Two
// forms, picked by the wrapper by M (ops/kernels.py:probe_form): M <= 16
// runs kernel #12's one-launch decode form (w4a16_decode.cuh, mode kInt8:
// one half, 16 K rows of codes a step, each byte to bf16 through fp32 in
// registers), above that the tile loop (weight_stream_matmul.cuh) with one
// half. Beside #12 and #13 on the same design it measures int4 against int8
// streaming.

#include "w4a16_decode.cuh"
#include "weight_stream_matmul.cuh"

// The tile loop. x: contiguous (M, K) bf16; w: contiguous (>= K, N) int8;
// scale (N,) fp32; out: (M, N) bf16, or fp32 when out_f32; partial:
// (splits, M, N) fp32 when splits > 1. N and K multiples of 8. Returns the
// CUDA error of the launches.
extern "C" int stllm_w8p_matmul(const void* x, const void* w, const void* scale, void* out,
                                void* partial, int M, int N, int K, int splits, int out_f32,
                                void* stream) {
  return stllm::wsm::run<stllm::wsm::kInt8>(x, w, scale, out, partial, M, N, K, splits,
                                           out_f32, stream);
}

// The decode form: x contiguous (M, K) bf16, 16-byte aligned, M <= 16; w
// (>= K, N) int8; scale (N,) fp32; out (M, N) bf16, or fp32 when out_f32.
// N and K multiples of 8. One launch on ``stream``; returns its CUDA error
// (0 on success); never synchronises.
extern "C" int stllm_w8p_matmul_decode(const void* x, const void* w, const void* scale,
                                       void* out, int M, int N, int K, int out_f32,
                                       void* stream) {
  return stllm::w4d::run<stllm::wsm::kInt8>(x, w, scale, out, M, N, K, out_f32, stream);
}

// The decode form's blocks an SM (what 0) or registers a thread (what 1)
// at ``rows`` rows of x (up to 8, or up to 16); -1 on an error.
extern "C" int stllm_w8p_matmul_occupancy(int rows, int what) {
  return stllm::w4d::occupancy<stllm::wsm::kInt8>(rows > 8 ? 2 : 1, what);
}
