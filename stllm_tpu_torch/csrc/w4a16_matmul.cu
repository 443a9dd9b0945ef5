// W4A16 matmul for Hopper (sm_90a): bf16 x times int4 weights.
//
// Replaces stllm_tpu/ops/quant.py:_w4_pallas_kernel (through
// w4_matmul_pallas), which runs every decoder matmul of the W4A16 Vicuna-7B
// serving stack: four launches a layer (fused q|k|v, o, fused gate|up, down),
// 128 per LLaMA forward. It computes what that kernel computes:
//   x (M, K) cast to bf16; packed (>= K/2, N) int8 holding the codes of K
//   rows [0, K/2) in the low nibble and of rows [K/2, K) in the high nibble,
//   two's complement (top = (p << 28) >> 28, bottom = p >> 4)
//   out = (x[:, :K/2] . top + x[:, K/2:] . bottom) * scale[n]
//   with fp32 accumulation and an fp32 epilogue, cast to bf16 (or kept fp32
//   for an fp32 x). Packed rows at K/2 and beyond are zero padding (the
//   reference pads Vicuna's down projection from 5504 to 5632 rows at
//   conversion) and are never read.
//
// Bound on the H100: at decode (M = 4) the call moves the packed weights and
// little else, 8.4 MB (o) to 45.1 MB (gate|up): 2.5 to 13.5 us at 3.35 TB/s,
// about 0.97 ms of weight streaming per decode step over 32 layers. At
// prefill (M = 576) it does 19.3 to 103.9 GFLOP: 19.5 to 105 us at 989
// TFLOP/s bf16, about 7.5 ms per prompt.
//
// Two forms, picked by the wrapper by M (ops/kernels.py:w4a16_form):
// - decode (M <= 16; w4a16_decode.cuh): one launch; the swapped product on
//   mma.sync m16n8k16 with the weight unpacked in registers as the A
//   operand and x's rows in the n8 (no padding to 16 rows), the packed bytes
//   through cp.async rings, K split between the warps of a CTA and across
//   the CTAs of a thread-block cluster (up to 16), summed through
//   distributed shared memory in rank order.
// - prefill (M > 16; w4a16_prefill.cuh): wgmma on the swapped product, x
//   by TMA, each packed byte unpacked in registers once per block of 192
//   rows.
// The same library keeps the tile loop (weight_stream_matmul.cuh:
// stllm_w4a16_matmul, the 16-row instance with split-K and a reduce launch
// at M <= 16, the 64-row one above), the design both forms replaced, so it
// can be timed beside them. The probes #13 and #14 run the decode form at
// M <= 16 too (its kArith and kInt8 modes) and the tile loop above; #15
// runs on the tile loop.

#include "w4a16_decode.cuh"
#include "w4a16_prefill.cuh"
#include "weight_stream_matmul.cuh"

// Plain C entry point, loaded with ctypes. x: contiguous (M, 2 * k2t) bf16;
// packed: contiguous (>= k2t, N) int8; scale: (N,) fp32; out: (M, N) bf16,
// or fp32 when out_f32; partial: (splits, M, N) fp32 scratch when splits > 1.
// N and k2t multiples of 8. Launches on ``stream`` and returns the CUDA error
// of the launches (0 on success); never synchronises.
extern "C" int stllm_w4a16_matmul(const void* x, const void* packed, const void* scale,
                                  void* out, void* partial, int M, int N, int k2t,
                                  int splits, int out_f32, void* stream) {
  return stllm::wsm::run<stllm::wsm::kNibble>(x, packed, scale, out, partial, M, N, k2t,
                                             splits, out_f32, stream);
}

// The prefill form: x contiguous (M, 2 * k2t) bf16, 16-byte aligned; packed
// (>= k2t, N) int8; scale (N,) fp32; out (M, N) bf16, or fp32 when out_f32.
// N and k2t multiples of 8. One launch on
// ``stream``; returns its CUDA error (0 on success); never synchronises.
extern "C" int stllm_w4a16_matmul_prefill(const void* x, const void* packed, const void* scale,
                                          void* out, int M, int N, int k2t, int out_f32,
                                          void* stream) {
  return stllm::w4p::run(x, packed, scale, out, M, N, k2t, out_f32, stream);
}

// The decode form: x contiguous (M, 2 * k2t) bf16, 16-byte aligned, M <= 16;
// packed (>= k2t, N) int8; scale (N,) fp32; out (M, N) bf16, or fp32 when
// out_f32. N and k2t multiples of 8. One launch on ``stream``; returns its
// CUDA error (0 on success); never synchronises.
extern "C" int stllm_w4a16_matmul_decode(const void* x, const void* packed, const void* scale,
                                         void* out, int M, int N, int k2t, int out_f32,
                                         void* stream) {
  return stllm::w4d::run<stllm::wsm::kNibble>(x, packed, scale, out, M, N, k2t, out_f32, stream);
}

// Blocks one SM holds of the tile loop's bm instance (form 0; bm 16 or 64),
// the prefill form (form 1) or the decode form (form 2; bm the rows, up to
// 8 or up to 16), or the decode form's registers a thread (form 3); -1 on
// an error.
extern "C" int stllm_w4a16_matmul_occupancy(int form, int bm) {
  using namespace stllm::wsm;
  if (form == 1) return stllm::w4p::occupancy();
  if (form == 2 || form == 3) return stllm::w4d::occupancy<kNibble>(bm > 8 ? 2 : 1, form - 2);
  int n = -1;
  auto occ = [&](auto kernel, size_t smem) {
    if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem)) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads, smem) != cudaSuccess) {
      n = -1;
    }
  };
  if (bm == 16) {
    occ(weight_stream_kernel<kNibble, 16, 4>, smem_bytes<kNibble, 16, 4>());
  } else if (bm == 64) {
    occ(weight_stream_kernel<kNibble, 64, 2>, smem_bytes<kNibble, 64, 2>());
  }
  return n;
}
