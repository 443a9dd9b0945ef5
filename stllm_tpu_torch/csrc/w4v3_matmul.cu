// Weight-streaming probe #13 for Hopper (sm_90a): W4A16 on arithmetic packing.
//
// Replaces script/probe_decode_budget.py:_w4v3_kernel, a measurement probe of
// the decode budget: the int4 codes packed as p = 16 * bottom + top
// (|top|, |bottom| <= 7, so |p| <= 119), unpacked with arithmetic alone:
//   bottom = rint(p / 16)   (|top| / 16 < 0.5: never a tie, exact)
//   top    = p - 16 * bottom
//   out    = (x[:, :K/2] . top + x[:, K/2:] . bottom) * scale[n]
// fp32 accumulation, out in x's dtype (bf16, or fp32 kept as is).
//
// Bound: at the probe's M = 1 decoder shapes the call moves its packed
// weights (8.4 MB for a 4096 x 4096 matmul, 22.5 MB for 4096 x 11008, 23.1
// MB for 11264 x 4096): 2.5 to 6.9 us at 3.35 TB/s. It shares kernel #12's tile
// loop (weight_stream_matmul.cuh) and differs only in the unpack, which
// converts each byte to fp32 and back: a comparison of the two shows what
// the unpack arithmetic costs on this card.

#include "weight_stream_matmul.cuh"

// As stllm_w4a16_matmul (w4a16_matmul.cu), on arithmetic-packed bytes.
extern "C" int stllm_w4v3_matmul(const void* x, const void* packed, const void* scale,
                                 void* out, void* partial, int M, int N, int k2t, int splits,
                                 int out_f32, void* stream) {
  return stllm::wsm::run<stllm::wsm::kArith>(x, packed, scale, out, partial, M, N, k2t,
                                            splits, out_f32, stream);
}
