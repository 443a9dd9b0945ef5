// GELU -> per-row int8 (#10, replacing
// stllm_tpu/ops/quant.py:_gelu_quant_kernel) in the design that the register
// form of stllm_tpu_torch/csrc/gelu_quant.cu replaced. It is not part of the
// port: chip_smoke.py builds it (nvcc -I stllm_tpu_torch/csrc) only to time it
// beside the shipped kernel on the same bf16 inputs. Same C entry point and
// arguments as before the redesign: bf16 x, K a multiple of 8 up to kMaxRowK
// (12256: the design took 12288 on paper, but a row past 12256 did not fit
// its 48 KB of shared memory beside the reduction's 128 bytes).
//
// GELU fused with per-row int8 quantization, for Hopper (sm_90a): bf16 rows
// in, int8 rows plus an fp32 scale per row out.
//
// Replaces stllm_tpu/ops/quant.py:_gelu_quant_kernel, the activation between
// fc1 and fc2 of every trunk block of the dynamic-int8 EVA-ViT-g and of its
// calibration. It computes, in fp32, the GELU of torch.nn.functional.gelu
//   approx == 0:  y = (x * 0.5) * (1 + erf(x * sqrt(1/2)))     exact (erf)
//   approx != 0:  y = (x * 0.5) * (1 + tanh(sqrt(2/pi) * (x + 0.044715 x^3)))
// then the row quantization of rowwise_quant.cuh. On the TPU the erf form
// had no lowering and ran unfused through XLA (quant.py:320-336); the
// function is the same, and this kernel serves both forms.
//
// Bound on the H100 at the trunk shape (16 x 257 rows of 6144): each call
// reads 50.5 MB of bf16 and writes 25.3 MB of int8 and 16 KB of scales,
// 75.8 MB, about 22.6 us at 3.35 TB/s; some 25 fp32 operations an element
// (erff is a polynomial) take about 9 us at 67 TFLOP/s, so it is bound by
// memory. The design is that of layer_norm_quant.cu: one block of 256
// threads per row reads the row once with 16-byte loads, keeps the fp32 GELU
// row in shared memory (24 KB), and writes only int8 and the scale.

#include <cuda_bf16.h>

#include "rowwise_quant.cuh"

namespace {

using namespace stllm;

constexpr float kSqrtHalf = 0.70710678118654752440f;   // M_SQRT1_2
constexpr float kBeta = 0.79788456080286535588f;       // sqrt(2 / pi)
constexpr float kKappa = 0.044715f;

__device__ __forceinline__ float gelu(float x, bool approx) {
  float inner;
  if (approx) {
    const float cube = __fmul_rn(__fmul_rn(x, x), x);
    inner = tanhf(__fmul_rn(kBeta, __fadd_rn(x, __fmul_rn(kKappa, cube))));
  } else {
    inner = erff(__fmul_rn(x, kSqrtHalf));
  }
  return __fmul_rn(__fmul_rn(x, 0.5f), __fadd_rn(1.0f, inner));
}

__global__ void __launch_bounds__(kRowThreads)
gelu_quant_kernel(const __nv_bfloat16* __restrict__ x, int8_t* __restrict__ q,
                  float* __restrict__ scale, int K, int approx) {
  extern __shared__ __align__(16) float row[];
  __shared__ float red[32];
  const long long r = blockIdx.x;
  const uint4* src = reinterpret_cast<const uint4*>(x + r * K);
  for (int c = threadIdx.x; c < K / 8; c += kRowThreads) {
    const uint4 v = src[c];
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
    for (int j = 0; j < 8; ++j) row[c * 8 + j] = gelu(__bfloat162float(e[j]), approx != 0);
  }
  __syncthreads();
  quantize_row(row, K, q + r * K, scale + r, red);
}

}  // namespace

// Plain C entry point, loaded with ctypes. x: contiguous bf16 (rows, K),
// 16-byte aligned; q: int8 (rows, K); scale: fp32 (rows,). K is a multiple
// of 8 and at most kMaxRowK; approx != 0 selects the tanh form. Launches on
// ``stream`` and returns the CUDA error of the launch (0 on success).
extern "C" int stllm_gelu_quant_bf16(const void* x, void* q, void* scale, long long rows,
                                     int K, int approx, void* stream) {
  if (rows < 0 || K <= 0 || K % 8 != 0 || K > stllm::kMaxRowK || rows > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows == 0) return 0;
  gelu_quant_kernel<<<static_cast<unsigned>(rows), stllm::kRowThreads,
                      static_cast<size_t>(K) * sizeof(float),
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<int8_t*>(q),
      static_cast<float*>(scale), K, approx);
  return static_cast<int>(cudaGetLastError());
}
