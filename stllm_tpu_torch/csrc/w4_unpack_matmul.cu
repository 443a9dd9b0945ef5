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
// Bound: 22.5 MB of packed bytes at 3.35 TB/s, 6.7 us a call. Two forms,
// picked by the wrapper by M (ops/kernels.py:unpack_form). M <= 8 runs
// kernel #12's one-launch decode form (w4a16_decode.cuh, modes kProbeInt32
// ... kProbeAnd8: each pair of packed rows gathered by one byte_perm as
// #12's nibbles are, each byte then unpacked in registers by the variant's
// own arithmetic, no scale, fp32 out; on the biased layout each K group
// sums the bf16 x_top columns of its steps from the x fragments it holds and
// folds -8 times that sum into its accumulators before the cluster's
// rank-order sum, so the correction adds no pass and no scratch). The
// decode form takes up to 16 rows, but at 9-16 (two n8 tiles of x rows, the
// probe's 16 among them) it was measured slower than the tile loop on the
// H100, so above 8 rows the variants run kernel #12's tile loop
// (weight_stream_matmul.cuh), which unpacks each weight tile into bf16
// tiles in shared memory. Each variant converts its codes through int or
// float instructions, where #12's own unpack avoids the conversions: their
// times beside #12's decode form show what each unpack costs on this card.

#include "w4a16_decode.cuh"
#include "weight_stream_matmul.cuh"

namespace {

// the variant's wsm::Mode, or -1
int probe_mode(int variant) {
  return variant >= 0 && variant < 5 ? stllm::wsm::kProbeInt32 + variant : -1;
}

}  // namespace

// The tile loop. x: contiguous (M, 2 * k2t) bf16; packed: contiguous
// (>= k2t, N) int8; out: (M, N) fp32; partial: (splits, M, N) fp32 when
// splits > 1; variant: 0 int32, 1 int16, 2 f32, 3 bf16, 4 and8. Returns the
// CUDA error of the launches (cudaErrorInvalidValue for another variant).
extern "C" int stllm_w4_unpack_matmul(const void* x, const void* packed, const void* scale,
                                      void* out, void* partial, int M, int N, int k2t,
                                      int splits, int variant, void* stream) {
  using namespace stllm::wsm;
  (void)scale;
  switch (probe_mode(variant)) {
    case kProbeInt32: return run<kProbeInt32>(x, packed, nullptr, out, partial, M, N, k2t, splits, 1, stream);
    case kProbeInt16: return run<kProbeInt16>(x, packed, nullptr, out, partial, M, N, k2t, splits, 1, stream);
    case kProbeF32: return run<kProbeF32>(x, packed, nullptr, out, partial, M, N, k2t, splits, 1, stream);
    case kProbeBf16: return run<kProbeBf16>(x, packed, nullptr, out, partial, M, N, k2t, splits, 1, stream);
    case kProbeAnd8: return run<kProbeAnd8>(x, packed, nullptr, out, partial, M, N, k2t, splits, 1, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The decode form: x contiguous (M, 2 * k2t) bf16, 16-byte aligned, M <=
// 16; packed (>= k2t, N) int8; scale unused; out (M, N) fp32; N and k2t
// multiples of 8. One launch on ``stream``; returns its CUDA error (0 on
// success, cudaErrorInvalidValue for another variant); never synchronises.
extern "C" int stllm_w4_unpack_matmul_decode(const void* x, const void* packed,
                                             const void* scale, void* out, int M, int N,
                                             int k2t, int variant, void* stream) {
  using namespace stllm::wsm;
  (void)scale;
  switch (probe_mode(variant)) {
    case kProbeInt32: return stllm::w4d::run<kProbeInt32>(x, packed, nullptr, out, M, N, k2t, 1, stream);
    case kProbeInt16: return stllm::w4d::run<kProbeInt16>(x, packed, nullptr, out, M, N, k2t, 1, stream);
    case kProbeF32: return stllm::w4d::run<kProbeF32>(x, packed, nullptr, out, M, N, k2t, 1, stream);
    case kProbeBf16: return stllm::w4d::run<kProbeBf16>(x, packed, nullptr, out, M, N, k2t, 1, stream);
    case kProbeAnd8: return stllm::w4d::run<kProbeAnd8>(x, packed, nullptr, out, M, N, k2t, 1, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The decode form's blocks an SM (what 0) or registers a thread (what 1)
// for ``variant`` at ``rows`` rows of x (up to 8, or up to 16); -1 on an
// error.
extern "C" int stllm_w4_unpack_matmul_occupancy(int variant, int rows, int what) {
  using namespace stllm::wsm;
  const int mt = rows > 8 ? 2 : 1;
  switch (probe_mode(variant)) {
    case kProbeInt32: return stllm::w4d::occupancy<kProbeInt32>(mt, what);
    case kProbeInt16: return stllm::w4d::occupancy<kProbeInt16>(mt, what);
    case kProbeF32: return stllm::w4d::occupancy<kProbeF32>(mt, what);
    case kProbeBf16: return stllm::w4d::occupancy<kProbeBf16>(mt, what);
    case kProbeAnd8: return stllm::w4d::occupancy<kProbeAnd8>(mt, what);
    default: return -1;
  }
}
