// The packed-qkv attention tile loop, shared by the bf16 kernel
// (packed_qkv_attention.cu) and the int8-epilogue kernel
// (packed_qkv_attention_quant.cu); the static-int8 kernel
// (packed_qkv_attention_s8.cu) runs the same geometry, ring and shape rule
// on int8 tiles.
//
//   qkv (B, S, 3*H*D), q|k|v by thirds, heads contiguous within a third
//   s   = q . k^T * scale * log2(e)                    (fp32 accumulation)
//   p   = exp2(min(s, 50) - 50)        clamped softmax numerator, no row max
//   out = (bf16(p) . v) / sum(p)       fp32 accumulation, 0 where sum(p) == 0
// Keys past S contribute p = 0; query rows past S are not stored. The output
// row (H*D) is stored as bf16 or, for a later row-quant pass, as fp32.
// Because the softmax subtracts a fixed 50 and not the row maximum, one pass
// over the keys accumulates sum(p) and sum(p . v) with no online rescale.
//
// Design for Hopper. A sequence is one (batch, head) pair. A warp owns 16
// query rows of one pair; products run on the tensor cores (mma.sync
// m16n8k16, bf16 in, fp32 accumulate), with D padded to DP (a multiple of
// 32) by zero-filled copies. Q, and K and V tiles as [key][dim], come in by
// cp.async; K and V through a ring of stages, so the next tile's copies are
// in flight while this tile's products run (one barrier a tile: it both
// publishes tile i and frees tile i - 1's stage). ldmatrix reads the Q and K
// fragments and, with .trans, the V fragments of P . V; no transposed V is
// stored. Q's fragments are read from shared memory again for every key
// tile rather than held: that keeps a thread under 113 registers, so two
// blocks of 9 warps share an SM. Two forms:
// - long (S > 16): a block holds W warps on one pair, W chosen so that the
//   ceil(S / 16) row units split evenly over ceil(units / kMaxWarps) blocks
//   (S = 257: 17 units in two blocks of 9 and 8 warps, where 64-row blocks
//   spent a fifth of the blocks on the last row). Every block reads its
//   pair's K and V once, in 32-key stages, and skips the 16-key blocks that
//   lie past S (S = 257: the ninth tile computes one 16-key block);
// - short (S <= 16, the BTAdapter's temporal attention over T frames): a
//   block of 4 warps takes 4 pairs, one each, with one 16-key tile a pair.

#pragma once

#include "mma_tiles.cuh"

namespace stllm {

constexpr float kClamp = 50.0f;

__device__ __forceinline__ float clamped_exp2(float s, float scale_log2e) {
  return exp2f(fminf(s * scale_log2e, kClamp) - kClamp);
}

namespace packed {

constexpr int kMaxWarps = 9;            // warps of a long-form block
constexpr int kStages = 2;              // stages of the long-form ring
constexpr int kShortKeys = 16;          // the short form's one key tile
constexpr int kShortPairs = 4;          // pairs (and warps) of a short-form block
constexpr int kMaxThreads = (kMaxWarps > kShortPairs ? kMaxWarps : kShortPairs) * 32;
constexpr int kMaxHeadDim = 128;

constexpr int kLongKeys = 32;           // keys a long-form ring stage holds

// pairs: (batch, head) pairs a block takes; warps: warps on each pair;
// q_blocks: blocks that split one pair's query rows.
struct Geometry {
  int pairs, warps, q_blocks;
};

inline Geometry geometry(int S) {
  if (S <= 16) return {kShortPairs, 1, 1};
  const int units = (S + 15) / 16;
  const int q_blocks = (units + kMaxWarps - 1) / kMaxWarps;
  return {1, (units + q_blocks - 1) / q_blocks, q_blocks};
}

// B, S, H > 0, D a multiple of 8 and at most 128, and a grid that fits.
inline bool shape_ok(int B, int S, int H, int D) {
  if (B <= 0 || S <= 0 || H <= 0 || D <= 0 || D % 8 || D > kMaxHeadDim) return false;
  const Geometry g = geometry(S);
  const long long blocks = ((long long)B * H + g.pairs - 1) / g.pairs * g.q_blocks;
  return blocks <= 0x7fffffffLL;
}

// Start the copies of ``nrows`` rows from r0 of one pair's (S, D) slab into
// dst[nrows][DP + kPad] over the block's ``nthreads`` threads; rows at or past
// ``limit`` and dims past D are zero-filled.
template <int DP>
__device__ __forceinline__ void copy_rows(__nv_bfloat16* dst, const __nv_bfloat16* base,
                                          long long row_stride, int r0, int nrows, int limit,
                                          int D, int tid, int nthreads) {
  constexpr int LD = DP + kPad;
  constexpr int VECS = DP / 8;
  for (int i = tid; i < nrows * VECS; i += nthreads) {
    const int r = i / VECS;
    const int c = i - r * VECS;
    const bool ok = r0 + r < limit && c * 8 < D;
    const __nv_bfloat16* src = ok ? base + (long long)(r0 + r) * row_stride + c * 8 : base;
    cp_async16(&dst[r * LD + c * 8], src, ok);
  }
}

// BK keys a ring stage, STAGES stages. The block takes ``pairs`` pairs from
// (blockIdx.x / q_blocks) * pairs on and query rows [qb * 16W, (qb + 1) * 16W)
// of each, qb = blockIdx.x % q_blocks; warp w works on pair w / W, rows
// 16 (w % W) of that range.
template <int DP, int BK, int STAGES, typename OutT>
__global__ void __launch_bounds__(kMaxThreads, 2)
packed_kernel(const __nv_bfloat16* __restrict__ qkv, OutT* __restrict__ out, int B, int S,
              int H, int D, float scale_log2e, int pairs, int W, int q_blocks) {
  constexpr int LD = DP + kPad;
  extern __shared__ __align__(16) unsigned char smem[];
  const int rows = 16 * W;                  // query rows of a pair in this block
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);   // [pairs][rows][LD]
  __nv_bfloat16* sRing = sQ + pairs * rows * LD;  // [STAGES][K, V][pairs][BK][LD]

  const int nthreads = blockDim.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;          // row group of the mma fragments
  const int t = lane & 3;           // thread within the group
  const int first_pair = blockIdx.x / q_blocks * pairs;
  const int q0 = blockIdx.x % q_blocks * rows;
  const int hd = H * D;
  const long long row_stride = 3LL * hd;
  const int nbh = B * H;

  const int wp = warp / W;                       // this warp's pair in the block
  const int wr = (warp - wp * W) * 16;           // its first row in the pair's range
  const int pair = first_pair + wp;
  const bool active = pair < nbh && q0 + wr < S;  // warp-uniform

  auto pair_base = [&](int p) {
    const int bh = min(first_pair + p, nbh - 1);
    return qkv + (long long)(bh / H) * S * row_stride + (long long)(bh % H) * D;
  };
  auto pair_rows = [&](int p) { return first_pair + p < nbh ? S : 0; };
  auto stage_k = [&](int st, int p) { return sRing + ((st * 2) * pairs + p) * BK * LD; };
  auto stage_v = [&](int st, int p) { return sRing + ((st * 2 + 1) * pairs + p) * BK * LD; };
  const int n_tiles = (S + BK - 1) / BK;
  // copies of key tile i into its stage: only the 16-key blocks that hold a
  // key are copied (the rest are never read)
  auto issue_tile = [&](int i) {
    const int k0 = i * BK;
    const int nrows = min(BK, (S - k0 + 15) / 16 * 16);
    const int st = i % STAGES;
    for (int p = 0; p < pairs; ++p) {
      const __nv_bfloat16* base = pair_base(p);
      copy_rows<DP>(stage_k(st, p), base + hd, row_stride, k0, nrows, pair_rows(p), D, tid,
                    nthreads);
      copy_rows<DP>(stage_v(st, p), base + 2 * hd, row_stride, k0, nrows, pair_rows(p), D,
                    tid, nthreads);
    }
  };

  // prologue: Q, then the ring's first STAGES - 1 tiles, one commit group each
  for (int p = 0; p < pairs; ++p) {
    copy_rows<DP>(sQ + p * rows * LD, pair_base(p), row_stride, q0, rows, pair_rows(p), D, tid,
                  nthreads);
  }
  cp_async_commit();
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < n_tiles) issue_tile(i);
    cp_async_commit();
  }
  cp_async_wait<STAGES - 1>();                   // Q has landed
  __syncthreads();

  const __nv_bfloat16* sQw = sQ + wp * rows * LD;  // this warp's pair's Q rows
  float o[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
  float l0 = 0.0f, l1 = 0.0f;                    // partial sum(p) of rows g, g + 8

  for (int i = 0; i < n_tiles; ++i) {
    if (STAGES == 1) {                           // one stage: load, then compute
      issue_tile(i);
      cp_async_commit();
    }
    // tile i has landed (this thread's copies, then every thread's), and
    // every warp is done with tile i - 1, whose stage the next issue refills
    cp_async_wait<(STAGES > 1 ? STAGES - 2 : 0)>();
    __syncthreads();
    if (STAGES > 1) {
      if (i + STAGES - 1 < n_tiles) issue_tile(i + STAGES - 1);
      cp_async_commit();
    }
    if (active) {
      const int k0 = i * BK;
      const int blocks = min(BK / 16, (S - k0 + 15) / 16);   // 16-key blocks holding a key
      const __nv_bfloat16* sK = stage_k(i % STAGES, wp);
      const __nv_bfloat16* sV = stage_v(i % STAGES, wp);
      // s = q . k^T for this warp's 16 rows and the tile's keys
      float s[BK / 8][4];
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        uint32_t q[4];
        frag_rows<LD>(q, sQw, wr, kk * 16, lane);
#pragma unroll
        for (int n2 = 0; n2 < BK / 16; ++n2) {
          if (n2 < blocks) {
            uint32_t kf[4];
            frag_depth<LD>(kf, sK, n2 * 16, kk * 16, lane);
            mma_bf16(s[2 * n2], q, kf[0], kf[1]);
            mma_bf16(s[2 * n2 + 1], q, kf[2], kf[3]);
          }
        }
      }
      // p, its fp32 row sums, and p in bf16 laid out as the A operand of
      // P . V: score tiles 2j and 2j + 1 form k-step j
      uint32_t pf[BK / 16][4];
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
        const int key = k0 + n * 8 + 2 * t;
        const float p0 = key < S ? clamped_exp2(s[n][0], scale_log2e) : 0.0f;
        const float p1 = key + 1 < S ? clamped_exp2(s[n][1], scale_log2e) : 0.0f;
        const float p2 = key < S ? clamped_exp2(s[n][2], scale_log2e) : 0.0f;
        const float p3 = key + 1 < S ? clamped_exp2(s[n][3], scale_log2e) : 0.0f;
        l0 += p0 + p1;
        l1 += p2 + p3;
        pf[n / 2][(n % 2) * 2 + 0] = pack_bf16(p0, p1);
        pf[n / 2][(n % 2) * 2 + 1] = pack_bf16(p2, p3);
      }
      // o += p . v
#pragma unroll
      for (int j = 0; j < BK / 16; ++j) {
        if (j < blocks) {
#pragma unroll
          for (int nd2 = 0; nd2 < DP / 16; ++nd2) {
            uint32_t vf[4];
            frag_cols<LD>(vf, sV, j * 16, nd2 * 16, lane);
            mma_bf16(o[2 * nd2], pf[j], vf[0], vf[1]);
            mma_bf16(o[2 * nd2 + 1], pf[j], vf[2], vf[3]);
          }
        }
      }
    }
    if (STAGES == 1) __syncthreads();            // the stage is consumed before its refill
  }
  cp_async_wait_all();
  if (!active) return;

  // Full row sums: the four threads of a group hold disjoint key columns.
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const float d0 = l0 == 0.0f ? 1.0f : l0;
  const float d1 = l1 == 0.0f ? 1.0f : l1;
#pragma unroll
  for (int nd = 0; nd < DP / 8; ++nd) {
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nd][e] = __fdiv_rn(o[nd][e], e < 2 ? d0 : d1);
  }
  store_rows<DP, OutT>(o, 1.0f, 1.0f, out, pair / H, S, hd, pair % H, D, q0 + wr + g, t);
}

// The kernel, its block size and shared memory for one launch shape.
template <int DP, typename OutT>
struct Launch {
  void (*kernel)(const __nv_bfloat16*, OutT*, int, int, int, int, float, int, int, int);
  Geometry geo;
  int threads;
  size_t smem;
};

template <int DP>
inline size_t smem_bytes(int keys, int stages, const Geometry& g) {
  const size_t rows = (size_t)g.pairs * (16 * g.warps + (size_t)stages * 2 * keys);
  return rows * (DP + kPad) * sizeof(__nv_bfloat16);
}

template <int DP, typename OutT>
Launch<DP, OutT> plan(int S) {
  const Geometry geo = geometry(S);
  if (geo.pairs > 1) {
    return {packed_kernel<DP, kShortKeys, 1, OutT>, geo, geo.pairs * geo.warps * 32,
            smem_bytes<DP>(kShortKeys, 1, geo)};
  }
  return {packed_kernel<DP, kLongKeys, kStages, OutT>, geo, geo.warps * 32,
          smem_bytes<DP>(kLongKeys, kStages, geo)};
}

template <int DP, typename OutT>
cudaError_t launch_dp(const void* qkv, OutT* out, int B, int S, int H, int D,
                      float scale_log2e, cudaStream_t stream) {
  const Launch<DP, OutT> l = plan<DP, OutT>(S);
  cudaError_t err = cudaFuncSetAttribute(l.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(l.smem));
  if (err != cudaSuccess) return err;
  const long long blocks = ((long long)B * H + l.geo.pairs - 1) / l.geo.pairs * l.geo.q_blocks;
  l.kernel<<<static_cast<unsigned>(blocks), l.threads, l.smem, stream>>>(
      static_cast<const __nv_bfloat16*>(qkv), out, B, S, H, D, scale_log2e, l.geo.pairs,
      l.geo.warps, l.geo.q_blocks);
  return cudaGetLastError();
}

// Resident blocks a streaming multiprocessor holds for this launch shape.
template <int DP, typename OutT>
int occupancy_dp(int S) {
  const Launch<DP, OutT> l = plan<DP, OutT>(S);
  int blocks = 0;
  if (cudaFuncSetAttribute(l.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(l.smem)) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, l.kernel, l.threads, l.smem) !=
          cudaSuccess) {
    return -1;
  }
  return blocks;
}

template <typename OutT>
cudaError_t launch(const void* qkv, OutT* out, int B, int S, int H, int D, float scale_log2e,
                   cudaStream_t st) {
  if (!shape_ok(B, S, H, D)) return cudaErrorInvalidValue;
  switch ((D + 31) / 32 * 32) {
    case 32: return launch_dp<32, OutT>(qkv, out, B, S, H, D, scale_log2e, st);
    case 64: return launch_dp<64, OutT>(qkv, out, B, S, H, D, scale_log2e, st);
    case 96: return launch_dp<96, OutT>(qkv, out, B, S, H, D, scale_log2e, st);
    default: return launch_dp<128, OutT>(qkv, out, B, S, H, D, scale_log2e, st);
  }
}

template <typename OutT>
int occupancy(int S, int D) {
  switch ((D + 31) / 32 * 32) {
    case 32: return occupancy_dp<32, OutT>(S);
    case 64: return occupancy_dp<64, OutT>(S);
    case 96: return occupancy_dp<96, OutT>(S);
    default: return occupancy_dp<128, OutT>(S);
  }
}

}  // namespace packed
}  // namespace stllm
