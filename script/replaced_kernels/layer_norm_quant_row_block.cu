// LayerNorm -> per-row int8 (#9, replacing
// stllm_tpu/ops/quant.py:_ln_quant_kernel) in the design that the register
// form of stllm_tpu_torch/csrc/layer_norm_quant.cu replaced. It is not part
// of the port: chip_smoke.py builds it (nvcc -I stllm_tpu_torch/csrc) only to
// time it beside the shipped kernel on the same bf16 inputs. Same C entry
// point and arguments as before the redesign: bf16 x, gamma and beta, K a
// multiple of 8 up to kMaxRowK (12256: the design took 12288 on paper, but a
// row past 12256 did not fit its 48 KB of shared memory beside the
// reduction's 128 bytes).
//
// LayerNorm fused with per-row int8 quantization, for Hopper (sm_90a): bf16
// rows in, int8 rows plus an fp32 scale per row out.
//
// Replaces stllm_tpu/ops/quant.py:_ln_quant_kernel, the norm1 and norm2 of
// every trunk block of the dynamic-int8 EVA-ViT-g and of its calibration.
// It computes what that kernel computes, in its order, all in fp32:
//   mean = sum(x) / K;  var = sum((x - mean)^2) / K
//   y = ((x - mean) * (1 / sqrt(var + eps))) * gamma + beta
// then the row quantization of rowwise_quant.cuh. Products and sums are
// rounded one by one (__fmul_rn, __fadd_rn), so no fused multiply-add
// changes them.
//
// Bound on the H100 at the trunk shape (16 x 257 rows of 1408): each call
// reads 11.6 MB of bf16 and writes 5.8 MB of int8 and 16 KB of scales,
// 17.4 MB, about 5.2 us at 3.35 TB/s; its 8 operations an element are far
// below the fp32 rate, so it is bound by memory. The design reads each row
// from device memory once, with 16-byte loads, into an fp32 row in shared
// memory; the mean, the variance, the amax and the codes are passes over
// shared memory, and the only write is the int8 row and its scale. One block
// of 256 threads owns one row: 4,112 blocks at the trunk shape.

#include <cuda_bf16.h>

#include "rowwise_quant.cuh"

namespace {

using namespace stllm;

__global__ void __launch_bounds__(kRowThreads)
layer_norm_quant_kernel(const __nv_bfloat16* __restrict__ x,
                        const __nv_bfloat16* __restrict__ gamma,
                        const __nv_bfloat16* __restrict__ beta, int8_t* __restrict__ q,
                        float* __restrict__ scale, int K, float eps) {
  extern __shared__ __align__(16) float row[];
  __shared__ float red[32];
  const long long r = blockIdx.x;
  const uint4* src = reinterpret_cast<const uint4*>(x + r * K);
  float sum = 0.0f;
  for (int c = threadIdx.x; c < K / 8; c += kRowThreads) {
    const uint4 v = src[c];
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float f = __bfloat162float(e[j]);
      row[c * 8 + j] = f;
      sum += f;
    }
  }
  const float mean = __fdiv_rn(block_sum(sum, red), static_cast<float>(K));
  float sq = 0.0f;
  for (int i = threadIdx.x; i < K; i += kRowThreads) {
    const float d = __fsub_rn(row[i], mean);
    sq = __fadd_rn(sq, __fmul_rn(d, d));
  }
  const float var = __fdiv_rn(block_sum(sq, red), static_cast<float>(K));
  const float inv = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var, eps)));
  for (int i = threadIdx.x; i < K; i += kRowThreads) {
    const float y = __fmul_rn(__fmul_rn(__fsub_rn(row[i], mean), inv),
                              __bfloat162float(gamma[i]));
    row[i] = __fadd_rn(y, __bfloat162float(beta[i]));
  }
  __syncthreads();
  quantize_row(row, K, q + r * K, scale + r, red);
}

}  // namespace

// Plain C entry point, loaded with ctypes. x: contiguous bf16 (rows, K),
// 16-byte aligned; gamma, beta: bf16 (K,); q: int8 (rows, K); scale: fp32
// (rows,). K is a multiple of 8 and at most kMaxRowK. Launches on ``stream`` and
// returns the CUDA error of the launch (0 on success); never synchronises.
extern "C" int stllm_layer_norm_quant_bf16(const void* x, const void* gamma,
                                           const void* beta, void* q, void* scale,
                                           long long rows, int K, float eps,
                                           void* stream) {
  if (rows < 0 || K <= 0 || K % 8 != 0 || K > stllm::kMaxRowK || rows > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows == 0) return 0;
  layer_norm_quant_kernel<<<static_cast<unsigned>(rows), stllm::kRowThreads,
                            static_cast<size_t>(K) * sizeof(float),
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(gamma),
      static_cast<const __nv_bfloat16*>(beta), static_cast<int8_t*>(q),
      static_cast<float*>(scale), K, eps);
  return static_cast<int>(cudaGetLastError());
}
