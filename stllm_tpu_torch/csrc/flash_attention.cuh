// Tile loops of the training-path attention kernels for Hopper (sm_90a):
// the forward shared by fused_short_attention.cu and flash_attention_fwd.cu,
// and the two backward kernels of flash_attention_bwd_dq.cu and
// flash_attention_bwd_dkv.cu.
//
// q, k, v and dO are bf16 (B, S, H, D) tensors read in place through their
// batch, sequence and head strides (elements; the head dimension is
// contiguous), so a q|k|v projection viewed as heads feeds the kernels with
// no transpose or split copy. D is a run-time multiple of 8 up to 128, padded
// with zeros to DP (a multiple of 32) in shared memory. kv_mask is int32
// (B, Sk), > 0 where the key is a real token, or null. A key is visible to
// query row i when it is in range, unmasked and, if causal, key <= i + offset.
// Outputs are bf16 (B, S, H, D) contiguous; lse and delta are fp32 (B, H, Sq).
//
// All products run on the tensor cores (bf16 in, fp32 accumulate): P and dS
// are rounded to bf16 for their second product, scores scale in fp32 after
// the q.k^T product, and the softmax works in base 2. Each block owns a run
// of rows (forward, dQ: 64 queries; dK, dV: 128 keys) and walks the other
// axis in tiles inside the block, so nothing carries across blocks and no
// atomics are needed. Causal tiles outside the visible range are skipped,
// and causal blocks launch heaviest first (one linear block index, the row
// tile slowest). Every loop keeps the next walked tile's cp.async copies in
// flight in a two-stage ring behind one barrier a tile (the copy and fragment
// helpers are mma_tiles.cuh's). The forward and dQ run mma.sync m16n8k16
// with 4 warps of 16 rows: tiles sit in shared memory once, as [row][dim],
// and ldmatrix reads the operand fragments, with .trans where a product
// contracts over the tile's rows (P . V, dS . K), so no transposed copy is
// ever stored. dK, dV run wgmma (hopper.cuh) with two warpgroups of 64 keys
// on tiles in the no-swizzle core-matrix layout, which serves both the
// K-major and the MN-major reads of a tile. Shared memory is dynamic (every
// loop passes 48 KB at D = 128).

#pragma once

#include "hopper.cuh"
#include "mma_tiles.cuh"

namespace stllm {
namespace flash {

constexpr int kRows = 64;               // rows a forward block owns
constexpr int kFwdTile = 64;            // keys per forward tile
constexpr int kThreads = 128;           // its 4 warps of 16 rows
constexpr float kNeg = -1e30f;          // a masked score
constexpr float kLseMasked = 1e30f;     // lse of a row with no visible key
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kLog2e = 1.4426950408889634f;

struct Strides {
  long long b, s, h;
};

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const __nv_bfloat16* d_out;           // backward only
  Strides qs, ks, vs, gs;               // gs: strides of d_out
  const int* kv_mask;                   // (B, Sk) or null
  const float* lse_in;                  // backward: (B, H, Sq)
  const float* delta;                   // backward: (B, H, Sq)
  __nv_bfloat16* out;                   // forward out, or dq
  __nv_bfloat16* out2;                  // dk
  __nv_bfloat16* out3;                  // dv
  float* lse_out;                       // forward: (B, H, Sq) or null
  int B, Sq, Sk, H, D;
  int causal, offset;
  float scale;                          // softmax scale
};

// ---------------------------------------------------------------------------
// Forward: out = softmax(q . k^T * scale, over the visible keys) . v by the
// online-softmax recurrence over key tiles, and optionally the per-row
// logsumexp.
//
// UNIFORM selects what a row with no visible key gives. false (the flash
// forward): output 0 and lse = kLseMasked, so the backward's exp(s - lse) is
// 0 there. true (the fused short kernel): masked scores take part as -1e30,
// exactly as a max-subtracted softmax over the full score row treats them, so
// such a row averages v over every key; the loop then goes on past the causal
// range while any row of the block has seen no visible key.
//
// Design. A block of 4 warps owns 64 query rows of one (batch, head); each
// warp keeps its 16 rows' q fragments in registers. K, V and the tile's
// kv_mask words come through a two-stage cp.async ring: the copies of key
// tile i + 1 are issued before the products of tile i, right after the one
// barrier a tile (which both publishes tile i and frees tile i - 1's stage).
// Q lands in stage 1's K slot before the loop and is read into registers
// before that stage's first tile is issued, so the ring holds the block's
// only tiles (70 KB at D = 128), and the registers are held to 168 a
// thread: three blocks an SM at D = 128 (two before). Each thread turns the
// mask words of its 16 keys into bits once per tile; the causal test runs
// only on the tiles that cross its warp's diagonal. Causal blocks run heaviest first: the linear
// block index walks the query tiles from the last one down.
// ---------------------------------------------------------------------------
template <int DP>
constexpr int fwd_smem_bytes() {
  return 2 * 2 * kFwdTile * (DP + kPad) * 2 + 2 * kFwdTile * 4;
}

template <int DP, bool UNIFORM>
__global__ void __launch_bounds__(kThreads, 3) flash_fwd_kernel(const Params p) {
  constexpr int LD = DP + kPad;
  constexpr int TILE = kFwdTile * LD;
  extern __shared__ __align__(16) unsigned char smem[];
  // [stage][K, V][key][dim]; Q first sits in stage 1's K slot
  __nv_bfloat16* sKV = reinterpret_cast<__nv_bfloat16*>(smem);
  int* sMask = reinterpret_cast<int*>(sKV + 4 * TILE);              // [stage][key]

  // the query tile, heaviest first when causal, then the (head, batch) pair
  const int n_q = (p.Sq + kRows - 1) / kRows;
  const int bh_count = p.H * p.B;
  const int qt = blockIdx.x / bh_count;
  const int q0 = (p.causal ? n_q - 1 - qt : qt) * kRows;
  const int h = blockIdx.x % bh_count % p.H;
  const int b = blockIdx.x % bh_count / p.H;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wr = warp * 16;
  const bool active = q0 + wr < p.Sq;      // warp-uniform

  const __nv_bfloat16* qb = p.q + (long long)b * p.qs.b + (long long)h * p.qs.h;
  const __nv_bfloat16* kb = p.k + (long long)b * p.ks.b + (long long)h * p.ks.h;
  const __nv_bfloat16* vb = p.v + (long long)b * p.vs.b + (long long)h * p.vs.h;
  const int* maskb = p.kv_mask ? p.kv_mask + (long long)b * p.Sk : nullptr;
  // keys at or past k_end are hidden from every row of the block
  int k_end = p.Sk;
  if (p.causal) k_end = max(0, min(p.Sk, q0 + kRows + p.offset));

  // copies of key tile i into stage i & 1: K, V, and the mask words (1 where
  // there is no mask; keys past Sk read as 0, and the in-range test is kept
  // apart below)
  auto issue_tile = [&](int i) {
    const int k0 = i * kFwdTile;
    __nv_bfloat16* sk = sKV + (i & 1) * 2 * TILE;
    load_rows<kFwdTile, DP, kThreads>(sk, kb, p.ks.s, k0, p.Sk, p.D, tid);
    load_rows<kFwdTile, DP, kThreads>(sk + TILE, vb, p.vs.s, k0, p.Sk, p.D, tid);
    if (tid < kFwdTile) {
      int* dst = sMask + (i & 1) * kFwdTile + tid;
      if (maskb) {
        const bool ok = k0 + tid < p.Sk;
        cp_async4(dst, ok ? maskb + k0 + tid : maskb, ok);
      } else {
        *dst = 1;
      }
    }
  };

  __nv_bfloat16* sQ = sKV + 2 * TILE + 0;  // stage 1's K slot
  load_rows<kRows, DP, kThreads>(sQ, qb, p.qs.s, q0, p.Sq, p.D, tid);
  cp_async_commit();
  issue_tile(0);
  cp_async_commit();
  cp_async_wait<1>();                      // Q has landed
  __syncthreads();
  uint32_t qf[DP / 16][4];
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) frag_rows<LD>(qf[kk], sQ, wr, kk * 16, lane);

  float o[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
  float m0 = kNeg, m1 = kNeg;              // running row maxima (base-2 scores), rows g, g + 8
  float l0 = 0.0f, l1 = 0.0f;              // this thread's share of the running sum(p)
  const int qa = q0 + wr + g;
  const int qb_row = qa + 8;
  const float c = p.scale * kLog2e;

  for (int i = 0; i * kFwdTile < p.Sk; ++i) {
    const int k0 = i * kFwdTile;
    if (k0 >= k_end) {
      if (!UNIFORM) break;
      const bool unseen = active && ((qa < p.Sq && m0 == kNeg) || (qb_row < p.Sq && m1 == kNeg));
      if (!__syncthreads_or(unseen)) break;
      if (i > 0) {                         // past the causal range: not prefetched
        issue_tile(i);
        cp_async_commit();
      }
    }
    // tile i has landed (this thread's copies, then every thread's), and
    // every warp is done with tile i - 1 (or with Q, at i = 0), whose stage
    // the next issue refills
    cp_async_wait<0>();
    __syncthreads();
    if ((i + 1) * kFwdTile < k_end) issue_tile(i + 1);
    cp_async_commit();
    if (active) {
      const __nv_bfloat16* sK = sKV + (i & 1) * 2 * TILE;
      const __nv_bfloat16* sV = sK + TILE;
      const int* mk = sMask + (i & 1) * kFwdTile;
      // this thread's 16 keys: bit 2n + e is key n * 8 + 2t + e of the tile
      uint32_t in_range = 0, visible = 0;
#pragma unroll
      for (int n = 0; n < kFwdTile / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kl = n * 8 + 2 * t + e;
          if (k0 + kl < p.Sk) {
            in_range |= 1u << (2 * n + e);
            if (mk[kl] > 0) visible |= 1u << (2 * n + e);
          }
        }
      }
      // the causal test only where the tile crosses this warp's diagonal
      const bool diagonal = p.causal && k0 + kFwdTile - 1 > q0 + wr + p.offset;

      float s[kFwdTile / 8][4];
#pragma unroll
      for (int n = 0; n < kFwdTile / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
#pragma unroll
      for (int n2 = 0; n2 < kFwdTile / 16; ++n2) {
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk) {
          uint32_t kf[4];
          frag_depth<LD>(kf, sK, n2 * 16, kk * 16, lane);
          mma_bf16(s[2 * n2], qf[kk], kf[0], kf[1]);
          mma_bf16(s[2 * n2 + 1], qf[kk], kf[2], kf[3]);
        }
      }
      // base-2 scores with hidden keys at kNeg, and the tile's row maxima
      float mx0 = kNeg, mx1 = kNeg;
      uint32_t vis0 = visible, vis1 = visible;   // rows g and g + 8
      if (diagonal) {
#pragma unroll
        for (int n = 0; n < kFwdTile / 8; ++n) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int key = k0 + n * 8 + 2 * t + e;
            if (key > qa + p.offset) vis0 &= ~(1u << (2 * n + e));
            if (key > qb_row + p.offset) vis1 &= ~(1u << (2 * n + e));
          }
        }
      }
#pragma unroll
      for (int n = 0; n < kFwdTile / 8; ++n) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t bit = 1u << (2 * n + (j & 1));
          s[n][j] = ((j < 2 ? vis0 : vis1) & bit) ? s[n][j] * c : kNeg;
        }
        mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
        mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
      }
      const float mn0 = fmaxf(m0, quad_max(mx0));
      const float mn1 = fmaxf(m1, quad_max(mx1));
      const float a0 = exp2f(m0 - mn0);
      const float a1 = exp2f(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      l0 *= a0;
      l1 *= a1;
#pragma unroll
      for (int nd = 0; nd < DP / 8; ++nd) {
        o[nd][0] *= a0;
        o[nd][1] *= a0;
        o[nd][2] *= a1;
        o[nd][3] *= a1;
      }
      // keys past Sk never count; under !UNIFORM neither do hidden ones
      const uint32_t keep0 = UNIFORM ? in_range : vis0;
      const uint32_t keep1 = UNIFORM ? in_range : vis1;
      uint32_t pf[kFwdTile / 16][4];
#pragma unroll
      for (int n = 0; n < kFwdTile / 8; ++n) {
        float pv[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t bit = 1u << (2 * n + (j & 1));
          const float e = exp2f(s[n][j] - (j < 2 ? m0 : m1));
          pv[j] = ((j < 2 ? keep0 : keep1) & bit) ? e : 0.0f;
        }
        l0 += pv[0] + pv[1];
        l1 += pv[2] + pv[3];
        pf[n / 2][(n % 2) * 2 + 0] = pack_bf16(pv[0], pv[1]);
        pf[n / 2][(n % 2) * 2 + 1] = pack_bf16(pv[2], pv[3]);
      }
#pragma unroll
      for (int j = 0; j < kFwdTile / 16; ++j) {
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
  cp_async_wait_all();
  if (!active) return;

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const float d0 = l0 == 0.0f ? 1.0f : l0;
  const float d1 = l1 == 0.0f ? 1.0f : l1;
#pragma unroll
  for (int nd = 0; nd < DP / 8; ++nd) {
#pragma unroll
    for (int j = 0; j < 4; ++j) o[nd][j] = __fdiv_rn(o[nd][j], j < 2 ? d0 : d1);
  }
  store_rows<DP, __nv_bfloat16>(o, 1.0f, 1.0f, p.out, b, p.Sq, p.H * p.D, h, p.D, qa, t);
  if (p.lse_out && t == 0) {
    float* lse = p.lse_out + ((long long)b * p.H + h) * p.Sq;
    if (qa < p.Sq) lse[qa] = l0 == 0.0f ? kLseMasked : (m0 + log2f(l0)) * kLn2;
    if (qb_row < p.Sq) lse[qb_row] = l1 == 0.0f ? kLseMasked : (m1 + log2f(l1)) * kLn2;
  }
}

// ---------------------------------------------------------------------------
// Backward, shared definitions: with s = q . k^T * scale,
//   p  = exp(s - lse) on visible keys, 0 elsewhere
//   dp = dO . v^T
//   ds = p * (dp - delta) * scale           delta = sum(dO * O) per row
//   dq = ds . k     dk = ds^T . q     dv = p^T . dO
//
// Design shared by both kernels. A block owns a run of rows (dQ: 64 queries;
// dK, dV: 128 keys) of one (batch, head) and walks the other axis in tiles of
// 64 through a two-stage cp.async ring: the walked tile's two row blocks and
// its 4-byte words (dQ: the kv_mask words; dK, dV: lse and delta) come in by
// cp.async, and tile i + 1's copies are issued right after the one barrier a
// tile (which publishes tile i and frees tile i - 1's stage), before tile
// i's products. The block's own rows load once, before the loop. Blocks take
// one linear index with the row tile slowest: under causal, dQ walks its
// query tiles from the last one down and dK, dV their key tiles from the
// first one up, so the blocks with the most walked tiles launch first.
// Causal tiles that no row of the block sees are skipped, and the causal
// test runs only where a tile crosses a warp's diagonal.
//
// dQ (mma.sync, 4 warps of 16 rows): each warp keeps its Q and dO fragments
// in registers (Q and dO land in the ring's last stage before the loop, as
// the forward's Q does) and runs the products on sub-tiles of 32 keys, which
// bounds the score registers (237 a thread at D = 128, two blocks an SM).
// ---------------------------------------------------------------------------
// ---------------------------------------------------------------------------
constexpr int kDqTile = 64;             // keys per dQ walked tile
constexpr int kDqStages = 2;
constexpr int kDqSub = 32;              // keys per dQ score sub-tile
constexpr int kDqRows = 64;             // query rows a dQ block owns (2 threads a row)
constexpr int kDkvTile = 64;            // queries per dK, dV walked tile
constexpr int kDkvRows = 128;           // keys a dK, dV block owns: one warpgroup per 64

// dQ: [stage][K, V][key][dim] rows, Q and dO landing past the first
// kDqStages - 1 stages, then the [stage][key] mask words
template <int ROWS>
constexpr int kDqRingRows = kDqStages * 2 * kDqTile > (kDqStages - 1) * 2 * kDqTile + 2 * ROWS
                                ? kDqStages * 2 * kDqTile
                                : (kDqStages - 1) * 2 * kDqTile + 2 * ROWS;

template <int DP, int ROWS>
constexpr int dq_smem_bytes() {
  return kDqRingRows<ROWS> * (DP + kPad) * 2 + kDqStages * kDqTile * 4;
}

template <int DP, int ROWS>
__global__ void __launch_bounds__(2 * ROWS, 128 / ROWS) flash_bwd_dq_kernel(const Params p) {
  constexpr int THREADS = 2 * ROWS;
  constexpr int LD = DP + kPad;
  constexpr int T = kDqTile;
  constexpr int TILE = T * LD;
  constexpr int NS = kDqSub / 8;           // 8-key score tiles of a sub-tile
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sKV = reinterpret_cast<__nv_bfloat16*>(smem);
  int* sMask = reinterpret_cast<int*>(sKV + kDqRingRows<ROWS> * LD);

  // the query tile, heaviest first when causal, then the (head, batch) pair
  const int n_q = (p.Sq + ROWS - 1) / ROWS;
  const int bh_count = p.H * p.B;
  const int tile = blockIdx.x / bh_count;
  const int bh = blockIdx.x % bh_count;
  const int q0 = (p.causal ? n_q - 1 - tile : tile) * ROWS;
  const int h = bh % p.H;
  const int b = bh / p.H;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wr = warp * 16;
  const bool active = q0 + wr < p.Sq;     // warp-uniform

  const __nv_bfloat16* qb = p.q + (long long)b * p.qs.b + (long long)h * p.qs.h;
  const __nv_bfloat16* kb = p.k + (long long)b * p.ks.b + (long long)h * p.ks.h;
  const __nv_bfloat16* vb = p.v + (long long)b * p.vs.b + (long long)h * p.vs.h;
  const __nv_bfloat16* gb = p.d_out + (long long)b * p.gs.b + (long long)h * p.gs.h;
  const int* maskb = p.kv_mask ? p.kv_mask + (long long)b * p.Sk : nullptr;
  const long long row0 = ((long long)b * p.H + h) * p.Sq;
  // keys at or past k_end are hidden from every row of the block
  int k_end = p.Sk;
  if (p.causal) k_end = max(0, min(p.Sk, q0 + ROWS + p.offset));
  const int n_tiles = (k_end + T - 1) / T;

  // copies of key tile i into stage i % kDqStages: K, V and one word a key,
  // > 0 where the key is in range and unmasked
  auto issue_tile = [&](int i) {
    const int k0 = i * T;
    __nv_bfloat16* sk = sKV + (i % kDqStages) * 2 * TILE;
    load_rows<T, DP, THREADS>(sk, kb, p.ks.s, k0, p.Sk, p.D, tid);
    load_rows<T, DP, THREADS>(sk + TILE, vb, p.vs.s, k0, p.Sk, p.D, tid);
    for (int r = tid; r < T; r += THREADS) {
      int* dst = sMask + (i % kDqStages) * T + r;
      const bool ok = k0 + r < p.Sk;
      if (maskb) {
        cp_async4(dst, ok ? maskb + k0 + r : maskb, ok);
      } else {
        *dst = ok ? 1 : 0;
      }
    }
  };

  // Q and dO past the stages the prologue fills; the first issue into that
  // stage comes after the loop's first barrier, when every warp holds its
  // fragments
  __nv_bfloat16* sQ = sKV + (kDqStages - 1) * 2 * TILE;
  __nv_bfloat16* sG = sQ + ROWS * LD;
  load_rows<ROWS, DP, THREADS>(sQ, qb, p.qs.s, q0, p.Sq, p.D, tid);
  load_rows<ROWS, DP, THREADS>(sG, gb, p.gs.s, q0, p.Sq, p.D, tid);
  cp_async_commit();
#pragma unroll
  for (int i = 0; i < kDqStages - 1; ++i) {
    if (i < n_tiles) issue_tile(i);
    cp_async_commit();
  }
  cp_async_wait<kDqStages - 1>();          // Q and dO have landed
  __syncthreads();
  uint32_t qf[DP / 16][4], gf[DP / 16][4];
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    frag_rows<LD>(qf[kk], sQ, wr, kk * 16, lane);
    frag_rows<LD>(gf[kk], sG, wr, kk * 16, lane);
  }

  const int qa = q0 + wr + g;
  const int qb_row = qa + 8;
  const float c = p.scale * kLog2e;
  // rows past Sq get lse = kLseMasked: p = 0 there
  const float lse0 = (qa < p.Sq ? p.lse_in[row0 + qa] : kLseMasked) * kLog2e;
  const float lse1 = (qb_row < p.Sq ? p.lse_in[row0 + qb_row] : kLseMasked) * kLog2e;
  const float dl0 = qa < p.Sq ? p.delta[row0 + qa] : 0.0f;
  const float dl1 = qb_row < p.Sq ? p.delta[row0 + qb_row] : 0.0f;

  float acc[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;

  for (int i = 0; i < n_tiles; ++i) {
    // tile i has landed (this thread's copies, then every thread's), and
    // every warp is done with tile i - 1, whose stage the next issue refills
    cp_async_wait<kDqStages - 2>();
    __syncthreads();
    if (i + kDqStages - 1 < n_tiles) issue_tile(i + kDqStages - 1);
    cp_async_commit();
    if (!active) continue;
    const int k0 = i * T;
    const __nv_bfloat16* sK = sKV + (i % kDqStages) * 2 * TILE;
    const __nv_bfloat16* sV = sK + TILE;
    const int* mk = sMask + (i % kDqStages) * T;
    // the causal test only where the tile crosses this warp's diagonal
    const bool diagonal = p.causal && k0 + T - 1 > q0 + wr + p.offset;
#pragma unroll
    for (int sub = 0; sub < T / kDqSub; ++sub) {
      const int ks = sub * kDqSub;
      // keys past this warp's last row are hidden from all of its rows
      if (p.causal && k0 + ks > q0 + wr + 15 + p.offset) break;
      float s[NS][4], dp[NS][4];
#pragma unroll
      for (int n = 0; n < NS; ++n) {
#pragma unroll
        for (int j = 0; j < 4; ++j) s[n][j] = dp[n][j] = 0.0f;
      }
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
#pragma unroll
        for (int n2 = 0; n2 < NS / 2; ++n2) {
          uint32_t kf[4], vf[4];
          frag_depth<LD>(kf, sK, ks + n2 * 16, kk * 16, lane);
          frag_depth<LD>(vf, sV, ks + n2 * 16, kk * 16, lane);
          mma_bf16(s[2 * n2], qf[kk], kf[0], kf[1]);
          mma_bf16(s[2 * n2 + 1], qf[kk], kf[2], kf[3]);
          mma_bf16(dp[2 * n2], gf[kk], vf[0], vf[1]);
          mma_bf16(dp[2 * n2 + 1], gf[kk], vf[2], vf[3]);
        }
      }
      uint32_t dsf[NS / 2][4];
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        const int kl = ks + n * 8 + 2 * t;
        const int2 words = *reinterpret_cast<const int2*>(mk + kl);
        float ds[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int key = k0 + kl + (j & 1);
          const int row = j < 2 ? qa : qb_row;
          const bool v = ((j & 1) ? words.y : words.x) > 0 &&
                         (!diagonal || key <= row + p.offset);
          const float pr = v ? exp2f(s[n][j] * c - (j < 2 ? lse0 : lse1)) : 0.0f;
          ds[j] = pr * (dp[n][j] - (j < 2 ? dl0 : dl1)) * p.scale;
        }
        dsf[n / 2][(n % 2) * 2 + 0] = pack_bf16(ds[0], ds[1]);
        dsf[n / 2][(n % 2) * 2 + 1] = pack_bf16(ds[2], ds[3]);
      }
#pragma unroll
      for (int j = 0; j < NS / 2; ++j) {
#pragma unroll
        for (int nd2 = 0; nd2 < DP / 16; ++nd2) {
          uint32_t kf[4];
          frag_cols<LD>(kf, sK, ks + j * 16, nd2 * 16, lane);
          mma_bf16(acc[2 * nd2], dsf[j], kf[0], kf[1]);
          mma_bf16(acc[2 * nd2 + 1], dsf[j], kf[2], kf[3]);
        }
      }
    }
  }
  cp_async_wait_all();
  if (!active) return;
  store_rows<DP, __nv_bfloat16>(acc, 1.0f, 1.0f, p.out, b, p.Sq, p.H * p.D, h, p.D, qa, t);
}

// ---------------------------------------------------------------------------
// dK, dV (wgmma): each warpgroup of the block owns 64 of its keys, wgmma's M,
// and both share the walked tiles, so a 128-key block reads each Q and dO
// tile once for two warpgroups. Tiles sit in shared memory in the no-swizzle
// core-matrix layout (hopper::desc_core), which serves a tile as a K-major
// operand (contraction over the head dimension) and as an MN-major one
// (contraction over its rows) alike. Per tile, on the transposed scores: S^T
// = K.Q^T and dP^T = V.dO^T from shared memory (m64n64k16), then dV += P^T.dO
// and dK += dS^T.Q with P^T and dS^T in registers as the A operand and dO, Q
// MN-major (m64nDk16). The dP^T product is in flight while the threads turn
// S^T into P^T. dK and dV stay in 128 fp32 registers a thread (246 in all at
// D = 128, one block of two warpgroups an SM).
// ---------------------------------------------------------------------------
// rows [r0, r0 + ROWS) of a strided (rows, D) slab into the core-matrix
// layout, dims past D and rows past ``limit`` zero-filled without a read:
// four threads copy 64 neighbouring bytes of one row, so a warp reads whole
// 32-byte sectors and writes eight rows of four chunks with no bank conflict
template <int ROWS, int DP, int THREADS>
__device__ __forceinline__ void load_core(__nv_bfloat16* dst, const __nv_bfloat16* base,
                                          long long row_stride, int r0, int limit, int D,
                                          int tid) {
  static_assert(DP % 32 == 0, "four chunks a row per pass");
#pragma unroll
  for (int i = tid; i < ROWS * DP / 8; i += THREADS) {
    const int c = i / (4 * ROWS) * 4 + (i & 3);
    const int r = (i >> 2) % ROWS;
    const bool ok = r0 + r < limit && c * 8 < D;
    const __nv_bfloat16* src = ok ? base + (long long)(r0 + r) * row_stride + c * 8 : base;
    cp_async16(dst + (c * ROWS + r) * 8, src, ok);
  }
}

// d (64 x N) = (scale_d ? d : 0) + a . b, both K-major descriptors
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a, uint64_t b,
                                         int scale_d) {
  static_assert(N == 32 || N == 64, "score tile");
  if constexpr (N == 32) hopper::wgmma_m64n32k16_ss(d, a, b, scale_d);
  else hopper::wgmma_m64n64k16_ss(d, a, b, scale_d);
}

// d (64 x N) += a (registers) . b (MN-major descriptor)
template <int N>
__device__ __forceinline__ void wgmma_rs_mn(float (&d)[N / 2], const uint32_t (&a)[4],
                                            uint64_t b) {
  if constexpr (N == 32) hopper::wgmma_m64n32k16_rs_mn(d, a, b);
  else if constexpr (N == 64) hopper::wgmma_m64n64k16_rs_mn(d, a, b);
  else if constexpr (N == 96) hopper::wgmma_m64n96k16_rs_mn(d, a, b);
  else hopper::wgmma_m64n128k16_rs_mn(d, a, b);
}

// K, V (ROWS rows), the [stage][Q, dO] ring (kDkvTile rows each), then
// [stage][lse, delta]
template <int DP, int ROWS>
constexpr int dkv_smem_bytes() {
  return (2 * ROWS + 2 * 2 * kDkvTile) * DP * 2 + 2 * 2 * kDkvTile * 4;
}


template <int DP, int ROWS>
__global__ void __launch_bounds__(2 * ROWS, 128 / ROWS) flash_bwd_dkv_kernel(const Params p) {
  constexpr int THREADS = 2 * ROWS;
  constexpr int T = kDkvTile;
  constexpr int TILE = T * DP;
  constexpr int NT = T / 8;                // 8-query column tiles of a score tile
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem);   // core layout, ROWS rows
  __nv_bfloat16* sV = sK + ROWS * DP;
  __nv_bfloat16* sQG = sV + ROWS * DP;                          // [stage][Q, dO], T rows
  float* sRows = reinterpret_cast<float*>(sQG + 2 * 2 * TILE);

  // the key tile, first one first, then the (head, batch) pair
  const int bh_count = p.H * p.B;
  const int tile = blockIdx.x / bh_count;
  const int bh = blockIdx.x % bh_count;
  const int kbase = tile * ROWS;
  const int h = bh % p.H;
  const int b = bh / p.H;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wr = warp * 16;

  const __nv_bfloat16* qb = p.q + (long long)b * p.qs.b + (long long)h * p.qs.h;
  const __nv_bfloat16* kb = p.k + (long long)b * p.ks.b + (long long)h * p.ks.h;
  const __nv_bfloat16* vb = p.v + (long long)b * p.vs.b + (long long)h * p.vs.h;
  const __nv_bfloat16* gb = p.d_out + (long long)b * p.gs.b + (long long)h * p.gs.h;
  const int* maskb = p.kv_mask ? p.kv_mask + (long long)b * p.Sk : nullptr;
  const long long row0 = ((long long)b * p.H + h) * p.Sq;
  int q_begin = 0;
  if (p.causal) q_begin = max(0, kbase - p.offset) / T * T;
  const int n_tiles = max(0, (p.Sq - q_begin + T - 1) / T);

  auto issue_tile = [&](int i) {
    const int q0 = q_begin + i * T;
    __nv_bfloat16* sq = sQG + (i & 1) * 2 * TILE;
    load_core<T, DP, THREADS>(sq, qb, p.qs.s, q0, p.Sq, p.D, tid);
    load_core<T, DP, THREADS>(sq + TILE, gb, p.gs.s, q0, p.Sq, p.D, tid);
    float* dst = sRows + (i & 1) * 2 * T;
    for (int r = tid; r < 2 * T; r += THREADS) {
      const int ql = r < T ? r : r - T;
      const bool ok = q0 + ql < p.Sq;
      const float* src = (r < T ? p.lse_in : p.delta) + row0 + q0 + ql;
      cp_async4(dst + r, ok ? src : p.lse_in, ok);
    }
  };

  load_core<ROWS, DP, THREADS>(sK, kb, p.ks.s, kbase, p.Sk, p.D, tid);
  load_core<ROWS, DP, THREADS>(sV, vb, p.vs.s, kbase, p.Sk, p.D, tid);
  cp_async_commit();
  if (n_tiles > 0) issue_tile(0);
  cp_async_commit();

  const int ka = kbase + wr + g;
  const int kb_row = ka + 8;
  const bool kv0 = ka < p.Sk && (!maskb || maskb[ka] > 0);
  const bool kv1 = kb_row < p.Sk && (!maskb || maskb[kb_row] > 0);
  const float c = p.scale * kLog2e;
  // this warpgroup's 64 rows of K and V
  const int wg_row = tid / 128 * 64;
  const uint64_t k_desc = hopper::desc_core(sK + wg_row * 8, ROWS * 16, 128);
  const uint64_t v_desc = hopper::desc_core(sV + wg_row * 8, ROWS * 16, 128);

  float dk[DP / 2], dv[DP / 2];
#pragma unroll
  for (int n = 0; n < DP / 2; ++n) dk[n] = dv[n] = 0.0f;

  for (int i = 0; i < n_tiles; ++i) {
    // tile i (and, at i = 0, K and V) has landed and is visible to the async
    // proxy; every thread (and every product) is done with tile i - 1, whose
    // stage the next issue refills
    cp_async_wait<0>();
    hopper::fence_proxy_async();
    __syncthreads();
    if (i + 1 < n_tiles) issue_tile(i + 1);
    cp_async_commit();
    const int q0 = q_begin + i * T;
    const __nv_bfloat16* sQ = sQG + (i & 1) * 2 * TILE;
    const __nv_bfloat16* sG = sQ + TILE;
    const float* sLse = sRows + (i & 1) * 2 * T;
    const float* sDelta = sLse + T;
    // s^T and dp^T: rows are the block's keys, columns the tile's queries
    const uint64_t q_desc = hopper::desc_core(sQ, T * 16, 128);
    const uint64_t g_desc = hopper::desc_core(sG, T * 16, 128);
    float s[T / 2], dp[T / 2];
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      wgmma_ss<T>(s, k_desc + kk * 2 * ROWS, q_desc + kk * 2 * T, kk);
    hopper::wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      wgmma_ss<T>(dp, v_desc + kk * 2 * ROWS, g_desc + kk * 2 * T, kk);
    hopper::wgmma_commit();
    // p in place of s^T while dP^T is in flight
    hopper::wgmma_wait<1>();
    hopper::fence_regs(s);
    const bool diagonal = p.causal && kbase + wr + 15 > q0 + p.offset;
    uint32_t pf[T / 16][4], dsf[T / 16][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int ql = n * 8 + 2 * t;
      const float2 lse2 = *reinterpret_cast<const float2*>(sLse + ql);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int q = q0 + ql + (j & 1);
        const int key = j < 2 ? ka : kb_row;
        const bool v = (j < 2 ? kv0 : kv1) && q < p.Sq && (!diagonal || key <= q + p.offset);
        const float lse = (j & 1) ? lse2.y : lse2.x;
        s[4 * n + j] = v ? exp2f(s[4 * n + j] * c - lse * kLog2e) : 0.0f;
      }
      pf[n / 2][(n % 2) * 2 + 0] = pack_bf16(s[4 * n], s[4 * n + 1]);
      pf[n / 2][(n % 2) * 2 + 1] = pack_bf16(s[4 * n + 2], s[4 * n + 3]);
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs(dp);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const float2 dl2 = *reinterpret_cast<const float2*>(sDelta + n * 8 + 2 * t);
      float ds[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ds[j] = s[4 * n + j] * (dp[4 * n + j] - ((j & 1) ? dl2.y : dl2.x)) * p.scale;
      dsf[n / 2][(n % 2) * 2 + 0] = pack_bf16(ds[0], ds[1]);
      dsf[n / 2][(n % 2) * 2 + 1] = pack_bf16(ds[2], ds[3]);
    }
    // dV += P^T . dO and dK += dS^T . Q, dO and Q MN-major, 16 queries a
    // step
    const uint64_t g_mn = hopper::desc_core(sG, 128, T * 16);
    const uint64_t q_mn = hopper::desc_core(sQ, 128, T * 16);
    hopper::wgmma_fence();
#pragma unroll
    for (int j = 0; j < T / 16; ++j) wgmma_rs_mn<DP>(dv, pf[j], g_mn + j * 16);
#pragma unroll
    for (int j = 0; j < T / 16; ++j) wgmma_rs_mn<DP>(dk, dsf[j], q_mn + j * 16);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(dk);
    hopper::fence_regs(dv);
  }
  cp_async_wait_all();                     // the K and V copies, had the loop no tile
  store_rows<DP, __nv_bfloat16>(reinterpret_cast<const float(&)[DP / 8][4]>(dk), 1.0f, 1.0f,
                                p.out2, b, p.Sk, p.H * p.D, h, p.D, ka, t);
  store_rows<DP, __nv_bfloat16>(reinterpret_cast<const float(&)[DP / 8][4]>(dv), 1.0f, 1.0f,
                                p.out3, b, p.Sk, p.H * p.D, h, p.D, ka, t);
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

// B, H > 0 within the grid's limits, Sq, Sk > 0, D a multiple of 8 up to 128,
// every stride a multiple of 8 elements (16-byte vector loads).
inline bool shape_ok(const Params& p) {
  const Strides* all[4] = {&p.qs, &p.ks, &p.vs, &p.gs};
  for (const Strides* s : all) {
    if (s->b % 8 || s->s % 8 || s->h % 8) return false;
  }
  return p.B > 0 && p.H > 0 && p.Sq > 0 && p.Sk > 0 && p.D > 0 && p.D % 8 == 0 &&
         p.D <= 128 && p.H <= 65535 && p.B <= 65535;
}

// grid: one linear index over (row tile, head, batch), the row tile slowest
// (query tiles for the forward and dQ, key tiles for dK, dV)
// (blocks of ``block_rows`` rows, two threads a row)
template <typename Kernel>
cudaError_t launch(Kernel kernel, int smem_bytes, int rows, const Params& p,
                   cudaStream_t stream, int block_rows = kRows) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem_bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(
      static_cast<unsigned>((long long)(rows + block_rows - 1) / block_rows * p.H * p.B));
  kernel<<<grid, 2 * block_rows, smem_bytes, stream>>>(p);
  return cudaGetLastError();
}

template <bool UNIFORM>
cudaError_t launch_fwd(const Params& p, cudaStream_t st) {
  if (!shape_ok(p)) return cudaErrorInvalidValue;
  switch ((p.D + 31) / 32 * 32) {
    case 32: return launch(flash_fwd_kernel<32, UNIFORM>, fwd_smem_bytes<32>(), p.Sq, p, st);
    case 64: return launch(flash_fwd_kernel<64, UNIFORM>, fwd_smem_bytes<64>(), p.Sq, p, st);
    case 96: return launch(flash_fwd_kernel<96, UNIFORM>, fwd_smem_bytes<96>(), p.Sq, p, st);
    default: return launch(flash_fwd_kernel<128, UNIFORM>, fwd_smem_bytes<128>(), p.Sq, p, st);
  }
}

// Resident blocks of a kernel a streaming multiprocessor holds, or -1.
template <typename Kernel>
int occupancy(Kernel kernel, int smem_bytes, int block_rows = kRows) {
  int blocks = 0;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, 2 * block_rows,
                                                    smem_bytes) != cudaSuccess) {
    return -1;
  }
  return blocks;
}

// the bf16 forward's at head_dim D
template <bool UNIFORM>
int fwd_occupancy(int D) {
  switch ((D + 31) / 32 * 32) {
    case 32: return occupancy(flash_fwd_kernel<32, UNIFORM>, fwd_smem_bytes<32>());
    case 64: return occupancy(flash_fwd_kernel<64, UNIFORM>, fwd_smem_bytes<64>());
    case 96: return occupancy(flash_fwd_kernel<96, UNIFORM>, fwd_smem_bytes<96>());
    default: return occupancy(flash_fwd_kernel<128, UNIFORM>, fwd_smem_bytes<128>());
  }
}

// (templates, so that a library holds only the kernels its entry point launches)
template <typename = void>
cudaError_t launch_dq(const Params& p, cudaStream_t st) {
  if (!shape_ok(p)) return cudaErrorInvalidValue;
  constexpr int R = kDqRows;
  switch ((p.D + 31) / 32 * 32) {
    case 32: return launch(flash_bwd_dq_kernel<32, R>, dq_smem_bytes<32, R>(), p.Sq, p, st, R);
    case 64: return launch(flash_bwd_dq_kernel<64, R>, dq_smem_bytes<64, R>(), p.Sq, p, st, R);
    case 96: return launch(flash_bwd_dq_kernel<96, R>, dq_smem_bytes<96, R>(), p.Sq, p, st, R);
    default: return launch(flash_bwd_dq_kernel<128, R>, dq_smem_bytes<128, R>(), p.Sq, p, st, R);
  }
}

template <typename = void>
int dq_occupancy(int D) {
  constexpr int R = kDqRows;
  switch ((D + 31) / 32 * 32) {
    case 32: return occupancy(flash_bwd_dq_kernel<32, R>, dq_smem_bytes<32, R>(), R);
    case 64: return occupancy(flash_bwd_dq_kernel<64, R>, dq_smem_bytes<64, R>(), R);
    case 96: return occupancy(flash_bwd_dq_kernel<96, R>, dq_smem_bytes<96, R>(), R);
    default: return occupancy(flash_bwd_dq_kernel<128, R>, dq_smem_bytes<128, R>(), R);
  }
}

template <typename = void>
cudaError_t launch_dkv(const Params& p, cudaStream_t st) {
  if (!shape_ok(p)) return cudaErrorInvalidValue;
  constexpr int R = kDkvRows;
  switch ((p.D + 31) / 32 * 32) {
    case 32: return launch(flash_bwd_dkv_kernel<32, R>, dkv_smem_bytes<32, R>(), p.Sk, p, st, R);
    case 64: return launch(flash_bwd_dkv_kernel<64, R>, dkv_smem_bytes<64, R>(), p.Sk, p, st, R);
    case 96: return launch(flash_bwd_dkv_kernel<96, R>, dkv_smem_bytes<96, R>(), p.Sk, p, st, R);
    default: return launch(flash_bwd_dkv_kernel<128, R>, dkv_smem_bytes<128, R>(), p.Sk, p, st, R);
  }
}

template <typename = void>
int dkv_occupancy(int D) {
  constexpr int R = kDkvRows;
  switch ((D + 31) / 32 * 32) {
    case 32: return occupancy(flash_bwd_dkv_kernel<32, R>, dkv_smem_bytes<32, R>(), R);
    case 64: return occupancy(flash_bwd_dkv_kernel<64, R>, dkv_smem_bytes<64, R>(), R);
    case 96: return occupancy(flash_bwd_dkv_kernel<96, R>, dkv_smem_bytes<96, R>(), R);
    default: return occupancy(flash_bwd_dkv_kernel<128, R>, dkv_smem_bytes<128, R>(), R);
  }
}

// The flat argument list of the C entry points: each tensor is a pointer and
// three strides (batch, sequence, head) as one long long array of 12:
// q, k, v, dO in that order (dO's three are ignored by the forward).
inline Params make_params(const void* q, const void* k, const void* v, const void* d_out,
                          const long long* strides, const void* kv_mask, int B, int Sq, int Sk,
                          int H, int D, int causal, int offset, float scale) {
  Params p{};
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.d_out = static_cast<const __nv_bfloat16*>(d_out);
  p.qs = {strides[0], strides[1], strides[2]};
  p.ks = {strides[3], strides[4], strides[5]};
  p.vs = {strides[6], strides[7], strides[8]};
  p.gs = {strides[9], strides[10], strides[11]};
  p.kv_mask = static_cast<const int*>(kv_mask);
  p.B = B;
  p.Sq = Sq;
  p.Sk = Sk;
  p.H = H;
  p.D = D;
  p.causal = causal;
  p.offset = offset;
  p.scale = scale;
  return p;
}

}  // namespace flash
}  // namespace stllm
