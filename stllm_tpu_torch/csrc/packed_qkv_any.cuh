// The "any" form of the packed-qkv attention kernels (#1 bf16 or fp32, #2's
// and #3's fp32 rows before their row-quant pass): the math of the tile
// loops for every head_dim D >= 1 and every H*D, where the tile loops take D
// a multiple of 8 up to 128. The TPU kernels slice whole heads out of a
// whole (S, 3*H*D) block, so they take any head_dim the reference's
// feasibility rule admits (S < 1024 and the block's on-chip bytes); this
// form does too:
//   s   = q . k^T * scale * log2(e)        fp32 accumulation (#3: the exact
//         int32 dot, converted to fp32, times ((sq * sk) * scale) * log2(e))
//   p   = exp2(min(s, 50) - 50)
//   out = (io(p) . v) / sum(p)             io(p): p in the io dtype (bf16
//         for bf16 and int8 qkv, fp32 for fp32), fp32 accumulation; #3
//         multiplies by sv / sum(p) instead; sum(p) == 0 counts as 1
//
// Design: simple and right first. No model of the repository has such a
// head (every config has head_dim 64, 88 or 128), so no path runs this form
// and its time is not a target. A block owns kRows query rows of one
// (batch, head) pair. Pass 1: warp w scores query row w against all S keys
// (lane j takes keys j, j + 32, ...), each score a scalar dot product read
// straight from the packed rows (a head of D elements need not be aligned
// to more than its element), and keeps io(p) and the row's fp32 sum(p) in
// shared memory (S <= 1023: 4 KB a row). Pass 2: each thread owns output
// columns c, c + kThreads, ... of all kRows rows and sums io(p_k) * v[k][c]
// over the keys, so a warp's V loads are contiguous and every V element is
// read once a block.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace stllm {
namespace packed_any {

constexpr int kRows = 8;                // query rows of a block, one warp each in pass 1
constexpr int kThreads = kRows * 32;
constexpr int kMaxSeq = 1023;           // the reference's S < 1024
constexpr float kClamp = 50.0f;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }

__device__ __forceinline__ void store_out(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}
__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }

// q . k over D elements: fp32 products and sums, or (int8) the exact int32
// dot converted to fp32.
template <typename InT>
__device__ __forceinline__ float dot(const InT* q, const InT* k, int D) {
  float acc = 0.0f;
  for (int d = 0; d < D; ++d) acc = fmaf(to_f32(q[d]), to_f32(k[d]), acc);
  return acc;
}

template <>
__device__ __forceinline__ float dot<int8_t>(const int8_t* q, const int8_t* k, int D) {
  int acc = 0;
  for (int d = 0; d < D; ++d) acc += static_cast<int>(q[d]) * static_cast<int>(k[d]);
  return __int2float_rn(acc);
}

// InT: the qkv dtype; OutT: the output's (bf16 or fp32 for #1, fp32 rows for
// #2 and #3). ROUND_P: p rounded to bf16 before P.V (bf16 and int8 qkv).
// scales: #3's three fp32 scales (q, k, v) on the device, or null; then
// ``qk`` is scale * log2(e) and the rows are divided by sum(p).
template <typename InT, typename OutT, bool ROUND_P>
__global__ void __launch_bounds__(kThreads)
packed_any_kernel(const InT* __restrict__ qkv, const float* __restrict__ scales, float qk,
                  OutT* __restrict__ out, int S, int H, int D) {
  __shared__ float sp[kRows][kMaxSeq];  // io(p) of each row's keys
  __shared__ float sl[kRows];           // each row's fp32 sum(p)

  // a linear grid, row group fastest, then head, then batch
  const int groups = (S + kRows - 1) / kRows;
  const int r0 = static_cast<int>(blockIdx.x % groups) * kRows;
  const int h = static_cast<int>(blockIdx.x / groups % H);
  const int b = static_cast<int>(blockIdx.x / groups / H);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long hd = static_cast<long long>(H) * D;
  const long long row_stride = 3 * hd;
  const InT* base = qkv + b * S * row_stride + h * D;   // this pair's q, row 0
  float vs = 1.0f;
  if (scales != nullptr) {              // the TPU kernel's order: (sq * sk * scale), * log2(e)
    qk = __fmul_rn(__fmul_rn(__fmul_rn(scales[0], scales[1]), qk), kLog2e);
    vs = scales[2];
  }

  // pass 1: io(p) and sum(p) of query row r0 + warp
  const int row = r0 + warp;
  if (row < S) {
    const InT* q = base + row * row_stride;
    float l = 0.0f;
    for (int j = lane; j < S; j += 32) {
      const float s = __fmul_rn(dot(q, base + j * row_stride + hd, D), qk);
      const float p = exp2f(fminf(s, kClamp) - kClamp);
      l += p;
      sp[warp][j] = ROUND_P ? __bfloat162float(__float2bfloat16_rn(p)) : p;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
    if (lane == 0) sl[warp] = l;
  }
  __syncthreads();

  // pass 2: out[row][c] = sum_k io(p_k) v[k][c], then the row's factor
  const int rows = min(kRows, S - r0);
  const InT* v = base + 2 * hd;
  for (int c = threadIdx.x; c < D; c += kThreads) {
    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0.0f;
    for (int k = 0; k < S; ++k) {
      const float x = to_f32(v[k * row_stride + c]);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (r < rows) acc[r] = fmaf(sp[r][k], x, acc[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r < rows) {
        const float l = sl[r] == 0.0f ? 1.0f : sl[r];
        const float y = scales != nullptr ? acc[r] * __fdiv_rn(vs, l) : __fdiv_rn(acc[r], l);
        store_out(out + (static_cast<long long>(b) * S + r0 + r) * hd + h * D + c, y);
      }
    }
  }
}

// B, S, H, D > 0, S <= kMaxSeq, and a grid that fits.
inline bool shape_ok(int B, int S, int H, int D) {
  return B > 0 && S > 0 && S <= kMaxSeq && H > 0 && D > 0 &&
         static_cast<long long>((S + kRows - 1) / kRows) * H * B <= 0x7fffffffLL;
}

template <typename InT, typename OutT, bool ROUND_P>
cudaError_t launch(const InT* qkv, const float* scales, float qk, OutT* out, int B, int S,
                   int H, int D, cudaStream_t stream) {
  if (!shape_ok(B, S, H, D)) return cudaErrorInvalidValue;
  const long long blocks = static_cast<long long>((S + kRows - 1) / kRows) * H * B;
  packed_any_kernel<InT, OutT, ROUND_P><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      qkv, scales, qk, out, S, H, D);
  return cudaGetLastError();
}

}  // namespace packed_any
}  // namespace stllm
