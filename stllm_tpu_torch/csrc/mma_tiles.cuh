// Tile copies and tensor-core fragments shared by the attention loops for
// Hopper (sm_90a): the packed-qkv loop (packed_qkv_attention.cuh, and the
// static-int8 kernel's P.V) and the training loops (flash_attention.cuh).
//
// Tiles sit in shared memory as [row][dim] with a row stride of DP + kPad
// bf16 (DP the padded head_dim): the 16-byte padding puts the eight rows of
// an ldmatrix read in distinct banks. An int8 [row][dim] tile (16-byte row
// padding too) is read through the same helpers as a bf16 tile of half the
// width: an s8 m16n8k32 fragment holds, in each 32-bit register, the four
// bytes that ldmatrix gives a lane for one 16-byte row. They come in by cp.async, 16 bytes a
// copy, without passing through registers; commit groups let a loop keep the
// next tiles' copies in flight while it computes on the current one.
// ldmatrix reads the mma.sync m16n8k16 operand fragments from them, with
// .trans where a product contracts over the tile's rows (P . V), so no
// transposed copy is ever stored.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace stllm {

constexpr int kPad = 8;                 // bf16 row padding of a [row][dim] tile

__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// c += a . b for one 16x8 tile, k = 16: a row-major 16x16, b column-major 16x8.
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two neighbouring output columns of one row.
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(a, b);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// o (a warp's 16 x DP accumulators, fp32 mma layout) times f0 (row g) or
// f1 (row g + 8), stored to out rows qa and qa + 8 of width hd at column
// offset h * D; rows at or past S are not stored.
template <int DP, typename OutT>
__device__ __forceinline__ void store_rows(const float (&o)[DP / 8][4], float f0,
                                           float f1, OutT* out, int b, int S,
                                           int hd, int h, int D, int qa, int t) {
  const int qb = qa + 8;
  OutT* outa = out + (long long)b * S * hd + (long long)qa * hd + (long long)h * D;
  OutT* outb = outa + 8LL * hd;
#pragma unroll
  for (int nd = 0; nd < DP / 8; ++nd) {
    const int col = nd * 8 + 2 * t;
    if (col < D) {                           // D % 8 == 0: col + 1 < D too
      if (qa < S) store2(outa + col, o[nd][0] * f0, o[nd][1] * f0);
      if (qb < S) store2(outb + col, o[nd][2] * f1, o[nd][3] * f1);
    }
  }
}

__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory; with ``pred`` false nothing is read
// and the 16 bytes are zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  const int bytes = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(shared_addr(dst)),
               "l"(src), "r"(bytes));
}

// 8 bytes (.ca: .cg takes 16 only), zero-filled when ``pred`` is false: rows
// that are only 8-byte aligned, such as an int8 head of 88 bytes.
__device__ __forceinline__ void cp_async8(void* dst, const void* src, bool pred) {
  const int bytes = pred ? 8 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(shared_addr(dst)),
               "l"(src), "r"(bytes));
}

// 4 bytes, zero-filled when ``pred`` is false.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool pred) {
  const int bytes = pred ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(shared_addr(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed copy groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Start the copy of rows [r0, r0 + ROWS) of a strided (rows, D) slab into
// dst[ROWS][DP + kPad], spread over THREADS threads (``tid`` this thread's
// index among them); rows at or past ``limit`` and dims at or past D are
// zero-filled without a read.
template <int ROWS, int DP, int THREADS>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst, const __nv_bfloat16* base,
                                          long long row_stride, int r0, int limit, int D,
                                          int tid) {
  constexpr int LD = DP + kPad;
  constexpr int VECS = DP / 8;
#pragma unroll
  for (int i = tid; i < ROWS * VECS; i += THREADS) {
    const int r = i / VECS;
    const int c = i - r * VECS;
    const bool ok = r0 + r < limit && c * 8 < D;
    const __nv_bfloat16* src = ok ? base + (long long)(r0 + r) * row_stride + c * 8 : base;
    cp_async16(&dst[r * LD + c * 8], src, ok);
  }
}

// Four 8x8 bf16 matrices from shared memory: lane l gives the address of
// one 16-byte row (lanes 0-7 the first matrix, 8-15 the second, ...), and
// receives from matrix i, in r[i], the pair at (row l / 4, columns 2 * (l % 4)
// and + 1); with .trans the pair at (rows 2 * (l % 4) and + 1, column l / 4).
__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(shared_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(shared_addr(p)));
}

// Fragments of a [row][dim] tile with leading dimension LD, for one warp.
//
// frag_rows: the 16 x 16 block at (r0, c0) as the A operand (rows x depth):
//   a[0..3] of mma_bf16.
// frag_cols: the same lane addresses with .trans: the block's 16 rows are the
//   depth and its 16 columns two 8-wide output tiles: b[0], b[1] the B
//   operand of columns c0..c0+7, b[2], b[3] of columns c0+8..c0+15.
// frag_depth: the block at (r0, c0) as the B operand of a product that
//   contracts over the columns: rows r0..r0+7 are one 8-wide output tile
//   (b[0], b[1]), rows r0+8..r0+15 the next (b[2], b[3]).
template <int LD>
__device__ __forceinline__ void frag_rows(uint32_t a[4], const __nv_bfloat16* tile, int r0,
                                          int c0, int lane) {
  ldmatrix_x4(a, &tile[(r0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + c0 + (lane >> 4) * 8]);
}

template <int LD>
__device__ __forceinline__ void frag_cols(uint32_t b[4], const __nv_bfloat16* tile, int r0,
                                          int c0, int lane) {
  ldmatrix_x4_trans(
      b, &tile[(r0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + c0 + (lane >> 4) * 8]);
}

template <int LD>
__device__ __forceinline__ void frag_depth(uint32_t b[4], const __nv_bfloat16* tile, int r0,
                                           int c0, int lane) {
  ldmatrix_x4(b, &tile[(r0 + (lane & 7) + (lane >> 4) * 8) * LD + c0 + ((lane >> 3) & 1) * 8]);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

}  // namespace stllm
