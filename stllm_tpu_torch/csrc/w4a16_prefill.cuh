// The prefill form of the W4A16 matmul (#12) for Hopper (sm_90a): M > 16
// rows of x against the int4-packed weight, the function of
// w4a16_matmul.cu's note.
//
// Bound on the H100: at prefill (M = 576) the four Vicuna-7B shapes do 19.3
// to 103.9 GFLOP, 19.5 to 105 us at 989 TFLOP/s bf16 (about 7.5 ms over 32
// layers), so the tensor cores bound it and the int4 weight (8.4 to 45.1
// MB) is the small operand. The decode form (weight_stream_matmul.cuh, 64-row
// prefill tiles) unpacked each weight tile into shared memory again for each
// of the 9 row tiles of M = 576 and ran mma.sync: 5.4x its bound.
//
// Design: the swapped product of the public Hopper mixed-input GEMMs
// (CUTLASS's mixed-input collective, vLLM's Machete), out^T = W^T . x^T, so
// the int4 weight is wgmma's A operand, unpacked in registers, and x is the
// K-major B operand straight from its row-major rows. It was picked over a
// producer-consumer unpack into a shared-memory bf16 tile because the
// unpacked weight then never crosses shared memory (no store, no second
// read, no proxy fence) and both halves of a byte feed one accumulator: the
// low nibble against x[:, k] and the high nibble against x[:, K/2 + k].
//
// A block owns 128 weight columns (two consumer warpgroups of 64, the m64 of
// wgmma) and 192 rows of x (the n of wgmma; 576 = 3 x 192), and walks the
// K/2 packed rows 64 at a time. One producer warp fills a ring of 3 stages:
// the two x tiles of the stage (columns [k0, k0 + 64) and [K/2 + k0,
// K/2 + k0 + 64), 192 rows, 128 bytes a row) by TMA in the 128-byte swizzle,
// and the 64 x 128 packed bytes by cp.async into a padded tile; both report to the stage's
// full mbarrier (the TMA bytes as a transaction count, the cp.async as 32
// lane arrivals). Each consumer thread reads the 32 packed bytes its A
// fragments need from the stage (rows 2t, 2t + 1, 2t + 8, 2t + 9 of each
// 16-row step, columns g and g + 8 of its warp's 16), unpacks them in
// registers with the exponent trick of weight_stream_matmul.cuh (no
// int-to-float conversion), and issues eight m64n192k16 wgmmas (four steps,
// top and bottom), register A and descriptor B. Each packed byte is thus
// unpacked once per block of 192 rows. The warpgroup waits for its
// wgmmas, frees the stage to the producer, and the other warpgroup's
// products cover its unpacking. The epilogue scales each accumulator row
// (a weight column) by its channel scale and writes the transposed tile.
// Rows past M and x columns past K/2 arrive as zeros from TMA, packed rows
// past K/2 and columns past N as zeros from cp.async, so a ragged M, N
// (a multiple of 8) or K/2 (a multiple of 8) needs no other code.
//
// Grid: (row tiles, column tiles), row tiles fastest, so the blocks that
// read one weight tile run together and find it in L2; clusters of two
// blocks neighbouring along N share each x tile: each block loads half of
// its rows by TMA multicast to both, so x crosses L2 once per 256 weight
// columns, and a stage is free once the consumers of both blocks have
// released it.
//
// Measured on the H100 (script/tune_hopper_gemms.py, PERF.md): 192-row
// tiles beat 128 and 256 at M = 576 and at M = 640 (4 x 192 rows against
// 5 x 128 or 3 x 256), and a loop that unpacked the next stage into a
// second register set while the current wgmmas ran (wait_group 1) lost to
// this one (wait_group 0).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "weight_stream_matmul.cuh"

namespace stllm {
namespace w4p {
// internal linkage, as weight_stream_matmul.cuh explains
namespace {

using namespace stllm::hopper;

constexpr int kBN = 128;                  // weight columns a block owns
constexpr int kBK = 64;                   // packed rows a stage (128 bytes of an x half row)
constexpr int kLdP = kBN + 16;            // packed tile row stride, bytes: conflict-free reads
constexpr int kConsumers = 2;             // warpgroups, 64 weight columns each
constexpr int kProducerWarp = 4 * kConsumers;
constexpr int kThreads = kConsumers * 128 + 32;

constexpr int kBM = 192;                  // x rows a block owns
constexpr int kClusterN = 2;              // blocks of a cluster, neighbours along N
constexpr int kXPiece = kBM / kClusterN;  // x rows each block loads for the cluster
constexpr int kStages = 3;
constexpr int kXBytes = kBM * kBK * 2;    // one x half tile, a 1024-byte multiple
constexpr int kStageX = 2 * kXBytes;
constexpr int kPBytes = kBK * kLdP;
// 1024 bytes of slack to align the swizzled tiles, the ring, the barriers
constexpr size_t kSmem =
    1024 + static_cast<size_t>(kStages) * (kStageX + kPBytes) + 2 * kStages * sizeof(uint64_t);

// packed bytes of rows r, r + 1 at column c of the staged tile as the two
// 16-bit halves of a word (row r low)
__device__ __forceinline__ uint32_t byte_pair(const uint8_t* p, int r, int c) {
  return static_cast<uint32_t>(p[r * kLdP + c]) | (static_cast<uint32_t>(p[(r + 1) * kLdP + c]) << 16);
}

__device__ __forceinline__ void store_out(void* out, long long i, float v, int out_f32) {
  if (out_f32) {
    static_cast<float*>(out)[i] = v;
  } else {
    static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(v);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
w4_prefill_kernel(const __grid_constant__ CUtensorMap x_top,
                  const __grid_constant__ CUtensorMap x_bot, const int8_t* __restrict__ packed,
                  const float* __restrict__ scale, void* __restrict__ out, int M, int N, int kw,
                  int out_f32) {
  constexpr int ST = kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* sx = base;                         // [ST][2][kBM][64] bf16, swizzled
  uint8_t* sp = base + ST * kStageX;                 // [ST][kBK][kLdP] packed bytes
  uint64_t* full = reinterpret_cast<uint64_t*>(sp + ST * kPBytes);
  uint64_t* empty = full + ST;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int steps = (kw + kBK - 1) / kBK;
  const uint32_t rank = cluster_rank();

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 33);            // 32 producer lanes' cp.async + the TMA's expect_tx
      mbar_init(&empty[s], kConsumers * kClusterN);   // every consumer warpgroup of the cluster
    }
    mbar_init_fence();
  }
  cluster_sync();                         // all barriers of the cluster initialised

  if (warp == kProducerWarp) {
    const bool vec16 = N % 16 == 0;
    int stage = 0;
    uint32_t phase = 0;
    for (int s = 0; s < steps; ++s) {
      mbar_wait(&empty[stage], phase ^ 1);           // a fresh barrier passes at once
      const int k0 = s * kBK;
      if (lane == 0) {
        // this block's rows of both x tiles, to every block of the cluster
        constexpr uint16_t kAll = (1u << kClusterN) - 1;
        const int piece = static_cast<int>(rank) * kXPiece;
        unsigned char* dx = sx + stage * kStageX + piece * 128;
        mbar_arrive_expect_tx(&full[stage], kStageX);
        tma_load_2d_multicast(dx, &x_top, &full[stage], kAll, k0, m0 + piece);
        tma_load_2d_multicast(dx + kXBytes, &x_bot, &full[stage], kAll, k0, m0 + piece);
      }
      __syncwarp();
      uint8_t* dp = sp + stage * kPBytes;
      if (vec16) {
        for (int i = lane; i < kBK * kBN / 16; i += 32) {
          const int r = i / (kBN / 16);
          const int c = (i % (kBN / 16)) * 16;
          const bool ok = k0 + r < kw && n0 + c < N;
          cp_async16(dp + r * kLdP + c, ok ? packed + static_cast<long long>(k0 + r) * N + n0 + c
                                           : packed, ok ? 16 : 0);
        }
      } else {
        for (int i = lane; i < kBK * kBN / 8; i += 32) {
          const int r = i / (kBN / 8);
          const int c = (i % (kBN / 8)) * 8;
          const bool ok = k0 + r < kw && n0 + c < N;
          cp_async8(dp + r * kLdP + c, ok ? packed + static_cast<long long>(k0 + r) * N + n0 + c
                                          : packed, ok ? 8 : 0);
        }
      }
      cp_async_arrive(&full[stage]);
      if (++stage == ST) {
        stage = 0;
        phase ^= 1;
      }
    }
    cp_async_wait_all();
  } else {

    // consumers: warpgroup wg owns weight columns [64 wg, 64 wg + 64) of the
    // block; lane (g, t) of warp w feeds A rows 16 w + g and + 8
    const int wg = warp >> 2;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int col = wg * 64 + (warp & 3) * 16 + g;
    float acc[kBM / 2];
#pragma unroll
    for (int i = 0; i < kBM / 2; ++i) acc[i] = 0.0f;

    int stage = 0;
    uint32_t phase = 0;
    for (int s = 0; s < steps; ++s) {
      mbar_wait(&full[stage], phase);
      const uint8_t* p = sp + stage * kPBytes + col;
      uint32_t top[4][4], bot[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = 16 * j + 2 * t;
        // A fragment: a0 (row g, k r..r+1), a1 (row g + 8), a2 (row g, k r + 8..r + 9), a3
        const uint32_t w[4] = {byte_pair(p, r, 0), byte_pair(p, r, 8), byte_pair(p, r + 8, 0),
                               byte_pair(p, r + 8, 8)};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          top[j][q] = wsm::nibbles_to_bf16x2(w[q]);
          bot[j][q] = wsm::nibbles_to_bf16x2(w[q] >> 4);
        }
      }
      const unsigned char* xs = sx + stage * kStageX;
      const uint64_t d_top = desc_k_sw128(xs);
      const uint64_t d_bot = desc_k_sw128(xs + kXBytes);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wgmma_m64n192k16_rs(acc, top[j], d_top + 2 * j);   // 32 bytes a 16-row step
        wgmma_m64n192k16_rs(acc, bot[j], d_bot + 2 * j);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      if ((threadIdx.x & 127) == 0) {
        for (int r = 0; r < kClusterN; ++r) mbar_arrive_cluster(&empty[stage], r);
      }
      __syncwarp();
      if (++stage == ST) {
        stage = 0;
        phase ^= 1;
      }
    }

    // epilogue: acc[4c + e] is out^T[col][8c + 2t + e], acc[4c + 2 + e] the
    // same x row at weight column col + 8
    const int na = n0 + col;
    const int nb = na + 8;
    const float sa = na < N ? scale[na] : 0.0f;
    const float sb = nb < N ? scale[nb] : 0.0f;
#pragma unroll
    for (int c = 0; c < kBM / 8; ++c) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int m = m0 + 8 * c + 2 * t + e;
        if (m >= M) continue;
        const long long o = static_cast<long long>(m) * N;
        if (na < N) store_out(out, o + na, acc[4 * c + e] * sa, out_f32);
        if (nb < N) store_out(out, o + nb, acc[4 * c + 2 + e] * sb, out_f32);
      }
    }
  }
  cluster_sync();                         // no block leaves while its neighbour may signal it
}

cudaError_t configure(cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr, int M, int N,
                      cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      w4_prefill_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kSmem));
  if (err != cudaSuccess) return err;
  // column tiles rounded up to whole clusters; a tile past N reads zeros
  // and writes nothing
  const int col_tiles = ((N + kBN - 1) / kBN + kClusterN - 1) / kClusterN * kClusterN;
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3((M + kBM - 1) / kBM, col_tiles);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmem;
  cfg.stream = stream;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 1;
  attr.val.clusterDim.y = kClusterN;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaSuccess;
}

cudaError_t launch(const void* x, const void* packed, const void* scale, void* out, int M, int N,
                   int kw, int out_f32, cudaStream_t stream) {
  if ((N + kBN - 1) / kBN > 65535 - kClusterN) return cudaErrorInvalidValue;
  // the two halves of x (M, 2 kw) bf16: columns [0, kw) and [kw, 2 kw), in
  // boxes of the rows one block of a cluster loads
  CUtensorMap top, bot;
  const uint64_t row_bytes = 4ull * kw;
  cudaError_t err = tensor_map_2d(&top, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, kw, M, row_bytes,
                                  kBK, kXPiece);
  if (err != cudaSuccess) return err;
  err = tensor_map_2d(&bot, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                      static_cast<const __nv_bfloat16*>(x) + kw, kw, M, row_bytes, kBK, kXPiece);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  err = configure(cfg, attr, M, N, stream);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(&cfg, w4_prefill_kernel, top, bot, static_cast<const int8_t*>(packed),
                           static_cast<const float*>(scale), out, M, N, kw, out_f32);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Blocks one SM holds at once.
int occupancy() {
  if (cudaFuncSetAttribute(w4_prefill_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(kSmem)) != cudaSuccess) {
    return -1;
  }
  int n = -1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, w4_prefill_kernel, kThreads, kSmem) !=
      cudaSuccess) {
    return -1;
  }
  return n;
}

// Shape checks, then the launch. x: contiguous (M, 2 kw) bf16, 16-byte
// aligned; packed (>= kw, N) int8; scale (N,) fp32; out (M, N) bf16, or fp32
// when out_f32. N and kw multiples of 8.
int run(const void* x, const void* packed, const void* scale, void* out, int M, int N, int kw,
        int out_f32, void* stream) {
  if (M <= 0 || N <= 0 || N % 8 || kw <= 0 || kw % 8 || scale == nullptr ||
      reinterpret_cast<uintptr_t>(x) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(
      launch(x, packed, scale, out, M, N, kw, out_f32, static_cast<cudaStream_t>(stream)));
}

}  // namespace
}  // namespace w4p
}  // namespace stllm
