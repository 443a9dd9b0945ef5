// Dynamic W8A8 matmul with per-(row, k-block) activation quantization (#8,
// replacing stllm_tpu/ops/quant.py:_quant_matmul_kernel) in the design that
// the TMA-fed wgmma GEMM of stllm_tpu_torch/csrc/quant_matmul.cu replaced.
// It is not part of the port: chip_smoke.py builds it (nvcc -I
// stllm_tpu_torch/csrc) only to time it beside the shipped kernel on the
// same inputs. Same C entry point and arguments as before the redesign: K a
// multiple of 16, N of 8, bk dividing K and, below K, a multiple of 64.
//
// Dynamic W8A8 matmul with per-(row, k-block) activation quantization, for
// Hopper (sm_90a): bf16 or fp32 x in, the same dtype out.
//
// Replaces stllm_tpu/ops/quant.py:_quant_matmul_kernel, the reference's fused
// dynamic-quant matmul. No model of the reference calls it; it is an op of the
// package's surface, ported as one. It computes what that kernel computes:
// for each k-block of bk columns of x (bk = K, or the 128-multiple tile the
// dispatch picks),
//   s = amax == 0 ? 1 : amax / 127;  q = rint(x / s)    (no clip: |q| <= 127)
//   acc += float(q . w_q[k-block]) * s                  (exact s32 product)
// and then out = acc * w_scale in x's dtype. Both divides are IEEE
// (__fdiv_rn): a reciprocal would move codes. The fp32 product and sum are
// rounded one by one, in the plain version's order; on the card the two
// outputs agree within one bf16 step.
//
// Bound on the H100 at the ViT-g fc1 shape ((16 x 257) x 1408 . 1408 x 6144):
// 71.1 G int8 operations, 36 us at 1,979 TOP/s, against 71 MB moved (x 11.6
// MB in bf16, the weight 8.7 MB, the output 50.5 MB: 21 us at 3.35 TB/s), so
// bound by the tensor cores.
//
// Design. A row's scale needs the amax of its whole k-block before any code
// of it exists, so the call is two launches. The first reads each (row,
// k-block) once and writes its scale (one block of 256 threads each, a few
// KB out). The second is the GEMM: a block owns a 64 x 128 output tile, 8
// warps of 16 rows x 64 columns (8 n8-tiles of s32 accumulators each), and
// walks K 64 bytes a step. The weight tile (128 columns, column-major as
// quantize_weights stores it) comes in by cp.async; the x tile is read with
// 16-byte loads, divided by its row's k-block scale and rounded into int8 in
// shared memory, so the codes never reach device memory. At each k-block's
// end the s32 sums fold into the fp32 accumulators with that block's scales.
// Rows of 64 bytes with no padding keep the 16-byte fragment reads of
// s8_matmul.cuh free of bank conflicts. Single-buffered; no wgmma or TMA yet.

#include <cuda_bf16.h>

#include "rowwise_quant.cuh"
#include "s8_matmul.cuh"

namespace {

using namespace stllm;
using namespace stllm::s8mm;

constexpr int kBM = 64;               // output rows of a block
constexpr int kBN = 128;              // output columns of a block
constexpr int kStep = 64;             // K bytes a step
constexpr int kThreads = 256;         // 8 warps: 4 row groups x 2 column groups

__global__ void __launch_bounds__(kRowThreads)
block_scales_kernel(const void* __restrict__ x, int x_f32, float* __restrict__ scales, int K,
                    int bk, int n_k) {
  __shared__ float red[32];
  const long long off = (long long)blockIdx.x * K + (long long)blockIdx.y * bk;
  float amax = 0.0f;
  if (x_f32) {
    const float4* src = reinterpret_cast<const float4*>(static_cast<const float*>(x) + off);
    for (int c = threadIdx.x; c < bk / 4; c += kRowThreads) {
      const float4 v = src[c];
      amax = fmaxf(fmaxf(amax, fabsf(v.x)), fmaxf(fabsf(v.y), fmaxf(fabsf(v.z), fabsf(v.w))));
    }
  } else {
    const uint4* src =
        reinterpret_cast<const uint4*>(static_cast<const __nv_bfloat16*>(x) + off);
    for (int c = threadIdx.x; c < bk / 8; c += kRowThreads) {
      const uint4 v = src[c];
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
      for (int j = 0; j < 8; ++j) amax = fmaxf(amax, fabsf(__bfloat162float(e[j])));
    }
  }
  amax = block_max(amax, red);
  if (threadIdx.x == 0) {
    scales[(long long)blockIdx.x * n_k + blockIdx.y] =
        amax == 0.0f ? 1.0f : __fdiv_rn(amax, 127.0f);
  }
}

__global__ void __launch_bounds__(kThreads)
quant_matmul_kernel(const void* __restrict__ x, int x_f32, const float* __restrict__ scales,
                    const int8_t* __restrict__ w, const float* __restrict__ ws,
                    void* __restrict__ out, int M, int K, int N, int bk, int n_k) {
  __shared__ __align__(16) int8_t sA[kBM * kStep];
  __shared__ __align__(16) int8_t sB[kBN * kStep];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int wr = (warp & 3) * 16;
  const int wc = (warp >> 2) * 64;
  const int ra = m0 + wr + g;
  const int rb = ra + 8;

  int iacc[8][4];
  float facc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      iacc[j][e] = 0;
      facc[j][e] = 0.0f;
    }
  }

  for (int k0 = 0; k0 < K; k0 += kStep) {
    const int kb = k0 / bk;
    for (int i = tid; i < kBN * (kStep / 16); i += kThreads) {
      const int c = i >> 2;
      const int q = i & 3;
      const int col = n0 + c;
      const int k = k0 + q * 16;
      const bool ok = col < N && k < K;
      cp_async16(&sB[c * kStep + q * 16], ok ? w + (long long)col * K + k : w, ok);
    }
    if (x_f32) {
      const float* xf = static_cast<const float*>(x);
      for (int i = tid; i < kBM * (kStep / 4); i += kThreads) {
        const int r = i >> 4;
        const int q = i & 15;
        const int row = m0 + r;
        const int k = k0 + q * 4;
        union { int8_t b[4]; uint32_t u; } pack;
        pack.u = 0u;
        if (row < M && k < K) {
          const float4 v = *reinterpret_cast<const float4*>(xf + (long long)row * K + k);
          const float s = scales[(long long)row * n_k + kb];
          pack.b[0] = quant_code(v.x, s);
          pack.b[1] = quant_code(v.y, s);
          pack.b[2] = quant_code(v.z, s);
          pack.b[3] = quant_code(v.w, s);
        }
        *reinterpret_cast<uint32_t*>(&sA[r * kStep + q * 4]) = pack.u;
      }
    } else {
      const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
      for (int i = tid; i < kBM * (kStep / 8); i += kThreads) {
        const int r = i >> 3;
        const int q = i & 7;
        const int row = m0 + r;
        const int k = k0 + q * 8;
        union { int8_t b[8]; uint2 u; } pack;
        pack.u = make_uint2(0u, 0u);
        if (row < M && k < K) {
          const uint4 v = *reinterpret_cast<const uint4*>(xb + (long long)row * K + k);
          const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
          const float s = scales[(long long)row * n_k + kb];
#pragma unroll
          for (int j = 0; j < 8; ++j) pack.b[j] = quant_code(__bfloat162float(e[j]), s);
        }
        *reinterpret_cast<uint2*>(&sA[r * kStep + q * 8]) = pack.u;
      }
    }
    cp_async_wait_all();
    __syncthreads();

    const uint4 lo = *reinterpret_cast<const uint4*>(&sA[(wr + g) * kStep + 16 * t]);
    const uint4 hi = *reinterpret_cast<const uint4*>(&sA[(wr + g + 8) * kStep + 16 * t]);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint4 b = *reinterpret_cast<const uint4*>(&sB[(wc + j * 8 + g) * kStep + 16 * t]);
      mma_step64(iacc[j], lo, hi, b);
    }
    __syncthreads();

    if (k0 + kStep >= K || (k0 + kStep) % bk == 0) {   // the end of a k-block
      const float sa = ra < M ? scales[(long long)ra * n_k + kb] : 0.0f;
      const float sb = rb < M ? scales[(long long)rb * n_k + kb] : 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          facc[j][e] = __fadd_rn(facc[j][e], __fmul_rn(__int2float_rn(iacc[j][e]),
                                                       e < 2 ? sa : sb));
          iacc[j][e] = 0;
        }
      }
    }
  }

#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = n0 + wc + j * 8 + 2 * t;
    if (c >= N) continue;                 // N % 8 == 0: c + 1 < N too
    const float w0 = ws[c], w1 = ws[c + 1];
    if (x_f32) {
      float* o = static_cast<float*>(out);
      if (ra < M) {
        *reinterpret_cast<float2*>(o + (long long)ra * N + c) =
            make_float2(__fmul_rn(facc[j][0], w0), __fmul_rn(facc[j][1], w1));
      }
      if (rb < M) {
        *reinterpret_cast<float2*>(o + (long long)rb * N + c) =
            make_float2(__fmul_rn(facc[j][2], w0), __fmul_rn(facc[j][3], w1));
      }
    } else {
      __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
      if (ra < M) {
        *reinterpret_cast<__nv_bfloat162*>(o + (long long)ra * N + c) =
            __floats2bfloat162_rn(__fmul_rn(facc[j][0], w0), __fmul_rn(facc[j][1], w1));
      }
      if (rb < M) {
        *reinterpret_cast<__nv_bfloat162*>(o + (long long)rb * N + c) =
            __floats2bfloat162_rn(__fmul_rn(facc[j][2], w0), __fmul_rn(facc[j][3], w1));
      }
    }
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes. x: (M, K) bf16 or, with x_f32,
// fp32; w: int8 (N, K) row-major, i.e. the (K, N) weight column-major; ws:
// fp32 (N,); scales: fp32 scratch (M, K / bk); out: (M, N) in x's dtype. Every
// tensor contiguous and 16-byte aligned; K a multiple of 16, N a multiple of
// 8; bk divides K and, when it is not K, is a multiple of 64. Launches on
// ``stream`` and returns the CUDA error of the launches (0 on success); never
// synchronises.
extern "C" int stllm_quant_matmul(const void* x, int x_f32, const void* w, const void* ws,
                                  void* scales, void* out, int M, int K, int N, int bk,
                                  void* stream) {
  if (M < 0 || K <= 0 || K % 16 != 0 || N <= 0 || N % 8 != 0 || bk <= 0 || K % bk != 0 ||
      bk % 8 != 0 || (bk != K && bk % kStep != 0) || (M + kBM - 1) / kBM > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (M == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_k = K / bk;
  float* sc = static_cast<float*>(scales);
  block_scales_kernel<<<dim3(M, n_k), kRowThreads, 0, st>>>(x, x_f32, sc, K, bk, n_k);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  quant_matmul_kernel<<<grid, kThreads, 0, st>>>(x, x_f32, sc, static_cast<const int8_t*>(w),
                                                 static_cast<const float*>(ws), out, M, K, N,
                                                 bk, n_k);
  return static_cast<int>(cudaGetLastError());
}
