// The decode form of the weight-streaming matmuls for Hopper (sm_90a): M <=
// 16 rows of x against a weight of int8 bytes, in one launch. MODE (the
// wsm::Mode of weight_stream_matmul.cuh) says what a byte means: kNibble,
// the int4 nibbles of the W4A16 matmul (#12, w4a16_matmul.cu's note);
// kArith, the probe #13's arithmetic packing p = 16 * bottom + top
// (w4v3_matmul.cu); kInt8, the probe #14's int8 codes (w8p_matmul.cu);
// kProbeInt32 ... kProbeAnd8, the probe #15's five unpack variants
// (w4_unpack_matmul.cu), each byte unpacked by its variant's own arithmetic
// (wsm::unpack_byte, as the tile loop does), fp32 out with no scale, and on
// the biased layout the row correction -8 * sum(x[:, :K/2]) (below).
//
// Bound on the H100: at decode (M = 4) a call moves the packed weight and
// little else, 8.4 MB (o) to 45.1 MB (gate|up), 2.5 to 13.5 us at 3.35 TB/s
// (0.97 ms over the 128 calls of a 32-layer step). The tile loop it replaces
// (weight_stream_matmul.cuh, 16-row instance) spent two launches on every
// Vicuna-7B shape (a split-K pass and a reduce over an fp32 partial buffer
// the wrapper allocated), unpacked each weight tile into bf16 tiles in
// shared memory and read them back by ldmatrix, and padded 4 rows of x to
// the mma's 16.
//
// Design: the swapped product of the prefill form (w4a16_prefill.cuh),
// out^T = W^T . x^T, on mma.sync m16n8k16: the weight is the A operand,
// unpacked in registers, and x the B operand, whose n8 holds 8 rows of x
// (M <= 8: one n8 tile; M <= 16: two), so no product is padded past 8 rows.
// The contraction index inside a 16-row step is permuted, alike for both
// operands: lane (g, t) takes packed rows 4t .. 4t + 3 as the mma's k slots
// 2t, 2t + 1, 2t + 8, 2t + 9, so its x fragment is 4 contiguous bf16 (one
// 8-byte read) and its weight is 4 rows of 16 contiguous bytes (columns
// 16g .. 16g + 15 of its slice). Byte 2j of a row is A row g of weight tile
// j, byte 2j + 1 its A row g + 8: one byte_perm of two rows yields the four
// fragments of two weight columns (low and high nibble, two rows each),
// unpacked with the exponent trick of weight_stream_matmul.cuh (no
// int-to-float conversion). The weight never crosses shared memory as bf16.
//
// A CTA owns kBN = 128 kSlices weight columns and a share of K, which its
// kKGroups groups of kSlices warps split step by step. Each group runs a
// ring of kStages cp.async stages (16 rows x kBN packed bytes, each copy
// instruction whole 128-byte row pieces, plus the step's x columns of both
// halves), one barrier a step. K is split further across the CTAs of a
// thread-block cluster along gridDim.x (up to 16, a non-portable size past
// 8), enough that a call has about kTargetCTAs CTAs: what the card took
// best at M = 4 (script/tune_hopper_gemms.py: many small CTAs, the weight's
// bytes in flight from every SM, the unpack of one warp under the loads of
// the others). At the end each CTA sums its groups' accumulators in shared
// memory, and, after a cluster barrier, each CTA sums one share of the
// outputs over the cluster's CTAs through distributed shared memory, in rank
// order, scales and stores it. One launch, no atomics, no scratch in device
// memory, the same sum on every run.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "weight_stream_matmul.cuh"

namespace stllm {
namespace w4d {
// internal linkage, as weight_stream_matmul.cuh explains
namespace {

using hopper::cluster_rank;
using hopper::cluster_sync;
using hopper::cp_async16;
using hopper::cp_async8;
using hopper::cp_async_wait_all;
using hopper::ld_cluster_f32;
using hopper::smem_u32;

constexpr int kSlices = 1;                // 128-column slices a CTA owns, a warp each
constexpr int kKGroups = 2;               // groups of kSlices warps splitting the CTA's share of K
constexpr int kWarps = kSlices * kKGroups;
constexpr int kThreads = kWarps * 32;
constexpr int kGroupThreads = kSlices * 32;
constexpr int kBN = 128 * kSlices;        // weight columns a CTA owns
constexpr int kStep = 16;                 // packed rows a step (the mma's k)
constexpr int kStages = 4;                // a K group's ring
constexpr int kMaxCluster = 16;           // CTAs along K (past 8: a non-portable cluster)
constexpr int kTargetCTAs = 512;          // CTAs a call aims at
constexpr int kMaxRows = 16;

// MT n8 tiles of x rows (M <= 8 * MT); kH halves of x (2 for the int4
// modes, 1 for kInt8)
template <int MODE, int MT>
struct Layout {
  static constexpr int kH = wsm::ModeTraits<MODE>::kHalves;
  static constexpr int kWBytes = kStep * kBN;                // [row][kBN] weight bytes
  static constexpr int kXBytes = kH * MT * 8 * kStep * 2;    // [half][row][16] bf16
  static constexpr int kStageBytes = kWBytes + kXBytes;
  static constexpr int kAcc = MT * 8 * 4;                    // accumulators a lane
  static constexpr int kRing = kKGroups * kStages * kStageBytes;
  static constexpr int kRed = kWarps * kAcc * 32 * 4;        // [warp][acc][lane] fp32
  static constexpr int kSmem = kRing > kRed ? kRing : kRed;
};

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ uint4 lds128(const unsigned char* p) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(smem_u32(p)));
  return v;
}

__device__ __forceinline__ uint2 lds64(const unsigned char* p) {
  uint2 v;
  asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];\n" : "=r"(v.x), "=r"(v.y) : "r"(smem_u32(p)));
  return v;
}

// byte offset in a stage of the 16-byte chunk c (of kBN / 16) of row r (of
// kStep): chunks permuted by 2 ((r / 4) % 4), so the lanes of a quarter warp
// (rows 4t + j, chunks 2q, 2q + 1 of one slice) read 8 distinct bank groups
__device__ __forceinline__ int chunk_at(int r, int c) {
  return r * kBN + ((c ^ (2 * ((r >> 2) & 3))) << 4);
}

__device__ __forceinline__ __nv_bfloat162 bf16x2_of(uint32_t bits) {
  return *reinterpret_cast<const __nv_bfloat162*>(&bits);
}

// the low bytes of the two 16-bit halves of w (rows a and b of one weight
// column), unpacked by the probe variant MODE's own arithmetic
// (wsm::unpack_byte on each sign-extended byte) to the bf16 pairs (top_a,
// top_b) and (bottom_a, bottom_b)
template <int MODE>
__device__ __forceinline__ void probe_pair(uint32_t w, uint32_t& top, uint32_t& bot) {
  __nv_bfloat16 ta, ba, tb, bb;
  wsm::unpack_byte<MODE>(static_cast<int>(w << 24) >> 24, ta, ba);
  wsm::unpack_byte<MODE>(static_cast<int>(w << 8) >> 24, tb, bb);
  top = wsm::pack2(ta, tb);
  bot = wsm::pack2(ba, bb);
}

// byte I of wa and byte I of wb, each u = p + 128, to the bf16 pair (p_a,
// p_b), exactly: the fp32 2^23 + u, minus 2^23 + 128, packed by cvt.rn
template <int I>
__device__ __forceinline__ uint32_t bytes_to_bf16x2(uint32_t wa, uint32_t wb) {
  const float fa = __uint_as_float(__byte_perm(wa, 0x4B000000u, 0x7440u | I)) - 8388736.0f;
  const float fb = __uint_as_float(__byte_perm(wb, 0x4B000000u, 0x7440u | I)) - 8388736.0f;
  return wsm::bits_of(__floats2bfloat162_rn(fa, fb));
}

// a bf16 pair of arithmetic-packed bytes p to its bottom = rint(p / 16)
// (half to even) and top = p - 16 * bottom, exactly
__device__ __forceinline__ void arith_split(uint32_t p, uint32_t& top, uint32_t& bot) {
  const __nv_bfloat162 pf = bf16x2_of(p);
  const __nv_bfloat162 q = __hfma2(pf, bf16x2_of(0x3D803D80u), bf16x2_of(0x43404340u));  // 1/16, 192
  const __nv_bfloat162 b = __hsub2(q, bf16x2_of(0x43404340u));
  bot = wsm::bits_of(b);
  top = wsm::bits_of(__hfma2(b, bf16x2_of(0xC180C180u), pf));                          // -16
}

template <int MODE, int MT>
__global__ void __launch_bounds__(kThreads, 16 / kWarps)
w4_decode_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ packed,
                 const float* __restrict__ scale, void* __restrict__ out, int M, int N, int kw,
                 int out_f32) {
  using L = Layout<MODE, MT>;
  constexpr int kH = L::kH;
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int slice = warp % kSlices;
  const int kgroup = warp / kSlices;
  const int gtid = threadIdx.x % kGroupThreads;     // thread within the K group
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int n0 = blockIdx.y * kBN;
  const int C = gridDim.x;                          // the cluster: CTAs along K
  const uint32_t rank = cluster_rank();
  const int ldx = kH * kw;

  // this CTA's 16-row steps [s0, s1); K group j takes every kKGroups-th
  const int steps = (kw + kStep - 1) / kStep;
  const int per = (steps + C - 1) / C;
  const int s0 = min(steps, static_cast<int>(rank) * per);
  const int s1 = min(steps, s0 + per);
  const int mine = s1 - s0 > kgroup ? (s1 - s0 - kgroup + kKGroups - 1) / kKGroups : 0;
  const int most = s1 - s0 > 0 ? (s1 - s0 + kKGroups - 1) / kKGroups : 0;
  const bool vec16 = N % 16 == 0 && reinterpret_cast<uintptr_t>(packed) % 16 == 0;

  unsigned char* ring = smem + kgroup * kStages * L::kStageBytes;

  // copies of the group's i-th step into ring stage ``st``: each copy
  // instruction takes whole 128-byte pieces of rows, 16 bytes a lane; then
  // the step's x columns
  auto issue = [&](int i, int st) {
    const int k0 = (s0 + kgroup + i * kKGroups) * kStep;
    unsigned char* sw = ring + st * L::kStageBytes;
#pragma unroll
    for (int c = gtid; c < kStep * (kBN / 16); c += kGroupThreads) {
      const int r = c / (kBN / 16);
      const int chunk = c % (kBN / 16);
      const int k = k0 + r;
      const int col = n0 + 16 * chunk;
      unsigned char* dst = sw + chunk_at(r, chunk);
      const int8_t* src = packed + static_cast<long long>(k) * N + col;
      if (vec16) {
        const bool ok = k < kw && col < N;
        cp_async16(dst, ok ? src : packed, ok ? 16 : 0);
      } else {
        const bool ok0 = k < kw && col < N, ok1 = k < kw && col + 8 < N;
        cp_async8(dst, ok0 ? src : packed, ok0 ? 8 : 0);
        cp_async8(dst + 8, ok1 ? src + 8 : packed, ok1 ? 8 : 0);
      }
    }
    // x: [half][row][16 columns]; piece i: row i / (2 kH), half (i / 2) %
    // kH, 8 columns (i % 2)
#pragma unroll
    for (int i = gtid; i < 16 * kH * MT; i += kGroupThreads) {
      const int m = kH == 2 ? i >> 2 : i >> 1;
      const int half = kH == 2 ? (i >> 1) & 1 : 0;
      const int piece = i & 1;
      const bool ok = m < M && k0 + 8 * piece < kw;   // kw % 8 == 0: whole pieces
      const __nv_bfloat16* src = x + static_cast<long long>(m) * ldx + half * kw + k0 + 8 * piece;
      cp_async16(sw + L::kWBytes + ((half * MT * 8) + m) * 32 + piece * 16, ok ? src : x,
                 ok ? 16 : 0);
    }
  };

  float acc[MT][8][4];
#pragma unroll
  for (int h = 0; h < MT; ++h)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[h][j][0] = acc[h][j][1] = acc[h][j][2] = acc[h][j][3] = 0.0f;
  // biased modes: this lane's share of sum(x_top) of row 8 h + g over the
  // group's steps, from the x fragments it already holds
  float xsum[MT];
#pragma unroll
  for (int h = 0; h < MT; ++h) xsum[h] = 0.0f;

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < mine) issue(i, i);
    cp_async_commit();
  }
  for (int i = 0; i < most; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();                // step i landed for every thread; step i - 1 is consumed
    if (i + kStages - 1 < mine) issue(i + kStages - 1, (i + kStages - 1) % kStages);
    cp_async_commit();
    if (i >= mine) continue;

    // lane (g, t): rows 4t .. 4t + 3 of the step, columns 16g .. 16g + 15 of
    // the warp's slice
    const unsigned char* sw = ring + (i % kStages) * L::kStageBytes;
    const int chunk = 8 * slice + g;
    const uint4 w0 = lds128(sw + chunk_at(4 * t + 0, chunk));
    const uint4 w1 = lds128(sw + chunk_at(4 * t + 1, chunk));
    const uint4 w2 = lds128(sw + chunk_at(4 * t + 2, chunk));
    const uint4 w3 = lds128(sw + chunk_at(4 * t + 3, chunk));
    uint2 xt[MT], xb[MT];
#pragma unroll
    for (int h = 0; h < MT; ++h) {
      xt[h] = lds64(sw + L::kWBytes + (h * 8 + g) * 32 + 8 * t);
      if constexpr (kH == 2) xb[h] = lds64(sw + L::kWBytes + ((MT * 8) + h * 8 + g) * 32 + 8 * t);
    }
    const uint32_t r0[4] = {w0.x, w0.y, w0.z, w0.w}, r1[4] = {w1.x, w1.y, w1.z, w1.w};
    const uint32_t r2[4] = {w2.x, w2.y, w2.z, w2.w}, r3[4] = {w3.x, w3.y, w3.z, w3.w};
    if constexpr (wsm::ModeTraits<MODE>::kBiased) {
#pragma unroll
      for (int h = 0; h < MT; ++h) {
        xsum[h] += (__uint_as_float(xt[h].x << 16) + __uint_as_float(xt[h].x & 0xFFFF0000u)) +
                   (__uint_as_float(xt[h].y << 16) + __uint_as_float(xt[h].y & 0xFFFF0000u));
      }
    }
    if constexpr (MODE >= wsm::kProbeInt32) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        // the pair words of kNibble: bytes 2j (low) and 2j + 1 (high) of rows
        // 4t, 4t + 1 (and 4t + 2, 4t + 3), row 4t (4t + 2) in the low half
        const uint32_t sel = (j & 1) ? 0x7632u : 0x5410u;
        const uint32_t p01 = __byte_perm(r0[j >> 1], r1[j >> 1], sel);
        const uint32_t p23 = __byte_perm(r2[j >> 1], r3[j >> 1], sel);
        uint32_t top[4], bot[4];
        probe_pair<MODE>(p01, top[0], bot[0]);
        probe_pair<MODE>(p01 >> 8, top[1], bot[1]);
        probe_pair<MODE>(p23, top[2], bot[2]);
        probe_pair<MODE>(p23 >> 8, top[3], bot[3]);
#pragma unroll
        for (int h = 0; h < MT; ++h) {
          wsm::mma_bf16(acc[h][j], top, xt[h].x, xt[h].y);
          wsm::mma_bf16(acc[h][j], bot, xb[h].x, xb[h].y);
        }
      }
    } else if constexpr (MODE == wsm::kNibble) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        // bytes 2j, 2j + 1 of rows 4t, 4t + 1 (and 4t + 2, 4t + 3) as the two
        // 16-bit halves of a word: row 4t (4t + 2) low
        const uint32_t sel = (j & 1) ? 0x7632u : 0x5410u;
        const uint32_t p01 = __byte_perm(r0[j >> 1], r1[j >> 1], sel);
        const uint32_t p23 = __byte_perm(r2[j >> 1], r3[j >> 1], sel);
        const uint32_t top[4] = {wsm::nibbles_to_bf16x2(p01), wsm::nibbles_to_bf16x2(p01 >> 8),
                                 wsm::nibbles_to_bf16x2(p23), wsm::nibbles_to_bf16x2(p23 >> 8)};
        const uint32_t bot[4] = {wsm::nibbles_to_bf16x2(p01 >> 4), wsm::nibbles_to_bf16x2(p01 >> 12),
                                 wsm::nibbles_to_bf16x2(p23 >> 4), wsm::nibbles_to_bf16x2(p23 >> 12)};
#pragma unroll
        for (int h = 0; h < MT; ++h) {
          wsm::mma_bf16(acc[h][j], top, xt[h].x, xt[h].y);
          wsm::mma_bf16(acc[h][j], bot, xb[h].x, xb[h].y);
        }
      }
    } else {
      uint32_t u0[4], u1[4], u2[4], u3[4];        // u = p + 128 in every byte
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        u0[q] = r0[q] ^ 0x80808080u;
        u1[q] = r1[q] ^ 0x80808080u;
        u2[q] = r2[q] ^ 0x80808080u;
        u3[q] = r3[q] ^ 0x80808080u;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        // fragment q of weight tile j: byte 2j (A row g) or 2j + 1 (A row
        // g + 8) of rows 4t, 4t + 1 (q 0, 1) or 4t + 2, 4t + 3 (q 2, 3)
        const int w = j >> 1;
        uint32_t a[4];
        if (j & 1) {
          a[0] = bytes_to_bf16x2<2>(u0[w], u1[w]);
          a[1] = bytes_to_bf16x2<3>(u0[w], u1[w]);
          a[2] = bytes_to_bf16x2<2>(u2[w], u3[w]);
          a[3] = bytes_to_bf16x2<3>(u2[w], u3[w]);
        } else {
          a[0] = bytes_to_bf16x2<0>(u0[w], u1[w]);
          a[1] = bytes_to_bf16x2<1>(u0[w], u1[w]);
          a[2] = bytes_to_bf16x2<0>(u2[w], u3[w]);
          a[3] = bytes_to_bf16x2<1>(u2[w], u3[w]);
        }
        if constexpr (MODE == wsm::kInt8) {
#pragma unroll
          for (int h = 0; h < MT; ++h) wsm::mma_bf16(acc[h][j], a, xt[h].x, xt[h].y);
        } else {
          uint32_t top[4], bot[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) arith_split(a[q], top[q], bot[q]);
#pragma unroll
          for (int h = 0; h < MT; ++h) {
            wsm::mma_bf16(acc[h][j], top, xt[h].x, xt[h].y);
            wsm::mma_bf16(acc[h][j], bot, xb[h].x, xb[h].y);
          }
        }
      }
    }
  }
  cp_async_wait_all();
  if constexpr (wsm::ModeTraits<MODE>::kBiased) {
    // -8 * sum(x_top) of the group's steps off each of its outputs, before
    // the sums over groups and CTAs: lanes (g, 0..3) hold row 8 h + g's
    // shares; lane (g, t)'s outputs are of rows 8 h + 2t and 8 h + 2t + 1
    // (entries 0, 2 and 1, 3), whose sums lanes 8t and 8t + 4 hold
#pragma unroll
    for (int h = 0; h < MT; ++h) {
      float s = xsum[h];
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      const float s0 = -8.0f * __shfl_sync(0xffffffffu, s, 8 * t);
      const float s1 = -8.0f * __shfl_sync(0xffffffffu, s, 8 * t + 4);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        acc[h][j][0] += s0;
        acc[h][j][1] += s1;
        acc[h][j][2] += s0;
        acc[h][j][3] += s1;
      }
    }
  }
  __syncthreads();                  // every warp is done with the ring: it becomes red

  // each slice's sum over the K groups, in group order, into group 0's slot
  // of red: [warp][acc][lane]
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int h = 0; h < MT; ++h)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        red[(warp * L::kAcc + (h * 8 + j) * 4 + c) * 32 + lane] = acc[h][j][c];
      }
  if (kKGroups > 1) {
    __syncthreads();
    for (int i = threadIdx.x; i < kSlices * L::kAcc * 32; i += kThreads) {
      float v = red[i];
#pragma unroll
      for (int q = 1; q < kKGroups; ++q) v += red[q * kSlices * L::kAcc * 32 + i];
      red[i] = v;
    }
  }
  cluster_sync();                   // every CTA's sums are in red

  // output (m, n0 + c), c < kBN, of this CTA's share: summed over the
  // cluster's CTAs in rank order, scaled, stored
  const int outputs = M * kBN;
  const int share = (outputs + C - 1) / C;
  const int o1 = min(outputs, (static_cast<int>(rank) + 1) * share);
  for (int o = static_cast<int>(rank) * share + threadIdx.x; o < o1; o += kThreads) {
    const int m = o / kBN;
    const int c = o - m * kBN;
    const int n = n0 + c;
    if (n >= N) continue;
    // slice c / 128's lane ((c % 128) / 16, (m % 8) / 2) holds it in tile
    // (m / 8, (c % 16) / 2), entry 2 (c % 2) + m % 2
    const int src = (c >> 7) * L::kAcc * 32 +
                    ((((m >> 3) * 8 + ((c & 15) >> 1)) * 4 + (c & 1) * 2 + (m & 1)) * 32) +
                    ((c & 127) >> 4) * 4 + ((m & 7) >> 1);
    float v = 0.0f;
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q) {
      if (q < C) v += ld_cluster_f32(red + src, static_cast<uint32_t>(q));
    }
    if constexpr (wsm::ModeTraits<MODE>::kScaled) v *= scale[n];
    const long long e = static_cast<long long>(m) * N + n;
    if (out_f32) {
      static_cast<float*>(out)[e] = v;
    } else {
      static_cast<__nv_bfloat16*>(out)[e] = __float2bfloat16_rn(v);
    }
  }
  cluster_sync();                   // no CTA leaves while another reads its red
}

template <int MODE, int MT>
cudaError_t prepare() {
  cudaError_t err = cudaFuncSetAttribute(w4_decode_kernel<MODE, MT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Layout<MODE, MT>::kSmem);
  if (err == cudaSuccess && kMaxCluster > 8) {
    err = cudaFuncSetAttribute(w4_decode_kernel<MODE, MT>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  return err;
}

// the mode's kernels' shared-memory and cluster attributes, set once per
// device
template <int MODE>
cudaError_t device_ready() {
  static bool ready[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (!ready[dev]) {
    err = prepare<MODE, 1>();
    if (err == cudaSuccess) err = prepare<MODE, 2>();
    if (err != cudaSuccess) return err;
    ready[dev] = true;
  }
  return cudaSuccess;
}

// CTAs a cluster splits K over: doubling until the call has kTargetCTAs
// CTAs, at most kMaxCluster and the steps.
int cluster_size(int col_tiles, int steps) {
  int c = 1;
  while (c < kMaxCluster && c * col_tiles < kTargetCTAs) c *= 2;
  return c < steps ? c : steps;
}

template <int MODE, int MT>
cudaError_t launch(const void* x, const void* packed, const void* scale, void* out, int M, int N,
                   int kw, int out_f32, cudaStream_t stream) {
  const int cluster = cluster_size((N + kBN - 1) / kBN, (kw + kStep - 1) / kStep);
  cudaLaunchConfig_t cfg{};
  cfg.gridDim = dim3(cluster, (N + kBN - 1) / kBN);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = Layout<MODE, MT>::kSmem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, w4_decode_kernel<MODE, MT>,
                                       static_cast<const __nv_bfloat16*>(x),
                                       static_cast<const int8_t*>(packed),
                                       static_cast<const float*>(scale), out, M, N, kw, out_f32);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Shape checks, then the launch. x: contiguous (M, kH kw) bf16, 16-byte
// aligned, M <= 16; w (>= kw, N) int8, 8-byte aligned; scale (N,) fp32
// (the scaled modes; the probe #15's take none); out (M, N) bf16, or fp32
// when out_f32. N and kw (the weight rows in use: K / 2 for the int4 modes,
// K for kInt8) multiples of 8.
template <int MODE>
int run(const void* x, const void* w, const void* scale, void* out, int M, int N, int kw,
        int out_f32, void* stream) {
  if (M <= 0 || M > kMaxRows || N <= 0 || N % 8 || kw <= 0 || kw % 8 ||
      (wsm::ModeTraits<MODE>::kScaled && scale == nullptr) ||
      (N + kBN - 1) / kBN > 65535 || reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(w) % 8) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = device_ready<MODE>();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = M > 8 ? launch<MODE, 2>(x, w, scale, out, M, N, kw, out_f32, st)
              : launch<MODE, 1>(x, w, scale, out, M, N, kw, out_f32, st);
  return static_cast<int>(err);
}

// Of the mode's kernel at mt n8 tiles of rows (M <= 8: 1; M <= 16: 2):
// the blocks one SM holds at once (what 0) or its registers a thread (what
// 1); -1 on an error.
template <int MODE>
int occupancy(int mt, int what) {
  if (device_ready<MODE>() != cudaSuccess || (mt != 1 && mt != 2) || what < 0 || what > 1) {
    return -1;
  }
  auto query = [&](auto kernel, int smem) {
    int n = -1;
    cudaFuncAttributes attr{};
    const cudaError_t err =
        what == 0 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads, smem)
                  : cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return -1;
    return what == 0 ? n : attr.numRegs;
  };
  return mt == 1 ? query(w4_decode_kernel<MODE, 1>, Layout<MODE, 1>::kSmem)
                 : query(w4_decode_kernel<MODE, 2>, Layout<MODE, 2>::kSmem);
}

}  // namespace
}  // namespace w4d
}  // namespace stllm
