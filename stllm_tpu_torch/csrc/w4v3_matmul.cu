// Weight-streaming probe #13 for Hopper (sm_90a): W4A16 on arithmetic packing.
//
// Replaces script/probe_decode_budget.py:_w4v3_kernel, a measurement probe of
// the decode budget: the int4 codes packed as p = 16 * bottom + top, unpacked
// with arithmetic alone, on any byte as the reference rounds it:
//   bottom = rint(p / 16)   (half to even, as jnp.round)
//   top    = p - 16 * bottom
//   out    = (x[:, :K/2] . top + x[:, K/2:] . bottom) * scale[n]
// fp32 accumulation, out in x's dtype (bf16, or fp32 kept as is).
//
// Bound: at the probe's M = 1 decoder shapes the call moves its packed
// weights (8.4 MB for a 4096 x 4096 matmul, 22.5 MB for 4096 x 11008, 23.1
// MB for 11264 x 4096): 2.5 to 6.9 us at 3.35 TB/s. Two forms, picked by the
// wrapper by M (ops/kernels.py:probe_form): M <= 16 runs kernel #12's
// one-launch decode form (w4a16_decode.cuh, mode kArith: the bytes to bf16
// through fp32, then the split in bf16, in registers), above that the tile
// loop (weight_stream_matmul.cuh). On the same codes the decode form of #12
// and this one differ only in the unpack: their times show what the
// arithmetic unpack costs on this card.

#include "w4a16_decode.cuh"
#include "weight_stream_matmul.cuh"

// The tile loop, as stllm_w4a16_matmul (w4a16_matmul.cu), on
// arithmetic-packed bytes.
extern "C" int stllm_w4v3_matmul(const void* x, const void* packed, const void* scale,
                                 void* out, void* partial, int M, int N, int k2t, int splits,
                                 int out_f32, void* stream) {
  return stllm::wsm::run<stllm::wsm::kArith>(x, packed, scale, out, partial, M, N, k2t,
                                            splits, out_f32, stream);
}

// The decode form, as stllm_w4a16_matmul_decode, on arithmetic-packed bytes.
extern "C" int stllm_w4v3_matmul_decode(const void* x, const void* packed, const void* scale,
                                        void* out, int M, int N, int k2t, int out_f32,
                                        void* stream) {
  return stllm::w4d::run<stllm::wsm::kArith>(x, packed, scale, out, M, N, k2t, out_f32, stream);
}

// The decode form's blocks an SM (what 0) or registers a thread (what 1)
// at ``rows`` rows of x (up to 8, or up to 16); -1 on an error.
extern "C" int stllm_w4v3_matmul_occupancy(int rows, int what) {
  return stllm::w4d::occupancy<stllm::wsm::kArith>(rows > 8 ? 2 : 1, what);
}
