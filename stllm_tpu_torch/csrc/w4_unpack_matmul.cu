// Weight-streaming probe #15 for Hopper (sm_90a): five int4 unpack variants.
//
// Replaces script/probe_w4_unpack.py:kernel, the probe of unpack strategies
// at the Vicuna-7B gate/up decode shape (x (16, 4096) bf16, packed (2048,
// 11008)). Each variant computes x . unpack(p) with fp32 accumulation and no
// scale, out fp32, on the layout it takes:
//   int32, int16  nibble layout (top in the low nibble, two's complement),
//                 unpacked by shifts in 32- or 16-bit integers;
//   f32, bf16     biased layout p = 16 * b + (t + 8): b = floor(p / 16),
//                 t + 8 = p - 16 * b, in fp32 or in bf16 arithmetic;
//   and8          biased layout: t + 8 = p & 15, b = (p - (t + 8)) / 16 in bf16;
// the biased variants subtract 8 * sum(x[:, :K/2]) from every output of a row.
// On the TPU the int16 and bf16 variants did not lower; here all five build
// and give the same product.
//
// Bound: 22.5 MB of packed bytes at 3.35 TB/s, 6.7 us a call. The variants
// share kernel #12's tile loop (weight_stream_matmul.cuh) and differ only in
// the per-byte unpack, which here converts each code through int or float
// instructions; kernel #12's own unpack avoids the conversions.

#include "weight_stream_matmul.cuh"

// x: contiguous (M, 2 * k2t) bf16; packed: contiguous (>= k2t, N) int8;
// out: (M, N) fp32; partial: (splits, M, N) fp32 when splits > 1; variant:
// 0 int32, 1 int16, 2 f32, 3 bf16, 4 and8. Returns the CUDA error of the
// launches (cudaErrorInvalidValue for another variant).
extern "C" int stllm_w4_unpack_matmul(const void* x, const void* packed, const void* scale,
                                      void* out, void* partial, int M, int N, int k2t,
                                      int splits, int variant, void* stream) {
  using namespace stllm::wsm;
  (void)scale;
  switch (variant) {
    case 0: return run<kProbeInt32>(x, packed, nullptr, out, partial, M, N, k2t, splits, 1, stream);
    case 1: return run<kProbeInt16>(x, packed, nullptr, out, partial, M, N, k2t, splits, 1, stream);
    case 2: return run<kProbeF32>(x, packed, nullptr, out, partial, M, N, k2t, splits, 1, stream);
    case 3: return run<kProbeBf16>(x, packed, nullptr, out, partial, M, N, k2t, splits, 1, stream);
    case 4: return run<kProbeAnd8>(x, packed, nullptr, out, partial, M, N, k2t, splits, 1, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
