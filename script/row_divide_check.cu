// The divide of the register form of #9 and #10
// (stllm_tpu_torch/csrc/rowwise_quant.cuh: div_rn_by, the row's reciprocal
// with one fused correction) held to __fdiv_rn. Not part of the port:
// chip_smoke.py builds it (nvcc -I stllm_tpu_torch/csrc) for its kernels
// phase and for tests/test_torch_kernels.py, and runs it on the card.
//
// It counts, into count[0], the quotients that differ from __fdiv_rn's in
// any bit and, into count[1], the codes rint(y / s) that differ, where a
// code can change: every scale mantissa (s = 1 + m 2^-23, m < 2^23), every
// code boundary (k + 1/2) s for k = 0..127, the 2 * window + 1 fp32 values y
// around RN((k + 1/2) s), and their negatives; rowwise_quant.cuh says why
// that covers every row whose scale lies in [kDivMin, kDivMax].

#include "rowwise_quant.cuh"

namespace {

using stllm::div_rn_by;

__device__ __forceinline__ void compare(float y, float s, float r,
                                        unsigned long long (&differ)[2]) {
  const float want = __fdiv_rn(y, s), got = div_rn_by(y, s, r);
  differ[0] += __float_as_uint(got) != __float_as_uint(want);
  differ[1] += static_cast<int>(rintf(got)) != static_cast<int>(rintf(want));
}

constexpr int kMantissas = 1 << 23;

__global__ void ties_kernel(int window, unsigned long long* __restrict__ count) {
  unsigned long long differ[2] = {0, 0};
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m < kMantissas) {
    const float s = __uint_as_float(0x3f800000u | static_cast<unsigned>(m));
    const float r = __frcp_rn(s);
    for (int k = 0; k < 128; ++k) {
      const int mid = __float_as_int(__fmul_rn(static_cast<float>(k) + 0.5f, s));
      for (int d = -window; d <= window; ++d) {
        const float y = __int_as_float(mid + d);
        compare(y, s, r, differ);
        compare(-y, s, r, differ);
      }
    }
  }
  if (differ[0]) atomicAdd(count, differ[0]);
  if (differ[1]) atomicAdd(count + 1, differ[1]);
}

}  // namespace

// The check at ``window`` ulps (1..1000) either side of each boundary; count:
// two uint64 zeroed by the caller. Launches on ``stream``; returns the
// launch's error.
extern "C" int stllm_row_divide_ties(int window, void* count, void* stream) {
  if (window < 1 || window > 1000) return static_cast<int>(cudaErrorInvalidValue);
  ties_kernel<<<kMantissas / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      window, static_cast<unsigned long long*>(count));
  return static_cast<int>(cudaGetLastError());
}
