// s8 x s8 -> s32 products on the tensor cores, shared by the two int8 GEMM
// kernels (qmm_res_ln.cu, quant_matmul.cu): mma.sync m16n8k32, A row-major
// (rows of the activation codes), B column-major (the weight codes of one
// output column contiguous over K, the layout quantize_weights stores).
//
// A 64-byte step of the contraction is two m16n8k32 products. Lane (g, t) of
// a warp (g = lane / 4, t = lane % 4) feeds both from 16 contiguous bytes:
// bytes [16t, 16t + 16) of the step, of A rows g and g + 8 and of B column
// g. The mma's own fragment layout has lane (g, t) hold bytes 4t.. and
// 16 + 4t.. of each 32-byte half; A and B here take the same permutation of
// the contraction index, so every output is the same exact integer sum, and
// each operand comes in with one 16-byte load.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace stllm {
namespace s8mm {

// c += a . b for one 16x8 tile, k = 32: a row-major 16x32 s8, b column-major
// 32x8 s8, c s32.
__device__ __forceinline__ void mma_s8(int c[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                       uint32_t a3, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// c += one 64-byte step: lo and hi the lane's 16 bytes of A rows g and g + 8,
// b its 16 bytes of B column g. c[0], c[1]: row g, columns 2t and 2t + 1 of
// the tile; c[2], c[3]: row g + 8.
__device__ __forceinline__ void mma_step64(int c[4], const uint4& lo, const uint4& hi,
                                           const uint4& b) {
  mma_s8(c, lo.x, hi.x, lo.y, hi.y, b.x, b.y);
  mma_s8(c, lo.z, hi.z, lo.w, hi.w, b.z, b.w);
}

// 16 bytes from global to shared memory without passing through registers;
// with ``pred`` false nothing is read and the 16 bytes are zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(addr), "l"(src),
               "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed copy groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ int8_t clip_code(float v) {
  return static_cast<int8_t>(static_cast<int>(fminf(fmaxf(rintf(v), -127.0f), 127.0f)));
}

}  // namespace s8mm
}  // namespace stllm
