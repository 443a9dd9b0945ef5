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
// All products run on the tensor cores (mma.sync m16n8k16, bf16 in, fp32
// accumulate): P and dS are rounded to bf16 for their second product, scores
// scale in fp32 after the q.k^T product, and the softmax works in base 2.
// A block has 4 warps of 16 rows each: 64 query rows (forward, dQ) or 64 keys
// (dK, dV). Each block walks the other axis in tiles inside the block, so
// nothing carries across blocks and no atomics are needed. Causal tiles
// outside the visible range are skipped. Every tile sits in shared memory
// once, as [row][dim]; ldmatrix reads the operand fragments from it, with
// .trans where a product contracts over the tile's rows (P . V, dS . K,
// P^T . dO, dS^T . Q), so no transposed copy is ever stored. Tiles come in by
// cp.async (the copy and fragment helpers are mma_tiles.cuh's): the forward
// keeps the next key tile's copies in flight in a two-stage ring; the
// backward loops wait for a tile before they compute on it. Shared memory is
// dynamic (the forward ring and the backward tiles pass 48 KB at D = 128).

#pragma once

#include "mma_tiles.cuh"

namespace stllm {
namespace flash {

constexpr int kRows = 64;               // rows a block owns
constexpr int kFwdTile = 64;            // keys per forward tile
constexpr int kBwdTile = 32;            // keys (dQ) or queries (dK, dV) per backward tile
constexpr int kThreads = 128;           // 4 warps of 16 rows
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
// ---------------------------------------------------------------------------

// dQ: a block owns 64 query rows and walks the keys 32 at a time.
template <int DP>
constexpr int dq_smem_bytes() {
  return 2 * (kRows + kBwdTile) * (DP + kPad) * 2 + kBwdTile * 4;
}

template <int DP>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(const Params p) {
  constexpr int LD = DP + kPad;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);   // [query][dim]
  __nv_bfloat16* sG = sQ + kRows * LD;                           // dO, [query][dim]
  __nv_bfloat16* sK = sG + kRows * LD;                           // [key][dim]
  __nv_bfloat16* sV = sK + kBwdTile * LD;                        // [key][dim]
  int* sMask = reinterpret_cast<int*>(sV + kBwdTile * LD);

  const int q0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wr = warp * 16;
  const bool active = q0 + wr < p.Sq;

  const __nv_bfloat16* qb = p.q + (long long)b * p.qs.b + (long long)h * p.qs.h;
  const __nv_bfloat16* kb = p.k + (long long)b * p.ks.b + (long long)h * p.ks.h;
  const __nv_bfloat16* vb = p.v + (long long)b * p.vs.b + (long long)h * p.vs.h;
  const __nv_bfloat16* gb = p.d_out + (long long)b * p.gs.b + (long long)h * p.gs.h;
  const int* maskb = p.kv_mask ? p.kv_mask + (long long)b * p.Sk : nullptr;
  const long long row0 = ((long long)b * p.H + h) * p.Sq;

  load_rows<kRows, DP, kThreads>(sQ, qb, p.qs.s, q0, p.Sq, p.D, tid);
  load_rows<kRows, DP, kThreads>(sG, gb, p.gs.s, q0, p.Sq, p.D, tid);

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
  int k_end = p.Sk;
  if (p.causal) k_end = max(0, min(p.Sk, q0 + kRows + p.offset));

  for (int k0 = 0; k0 < k_end; k0 += kBwdTile) {
    __syncthreads();
    load_rows<kBwdTile, DP, kThreads>(sK, kb, p.ks.s, k0, p.Sk, p.D, tid);
    load_rows<kBwdTile, DP, kThreads>(sV, vb, p.vs.s, k0, p.Sk, p.D, tid);
    if (tid < kBwdTile) {
      const int key = k0 + tid;
      sMask[tid] = key < p.Sk && (!maskb || maskb[key] > 0) ? 1 : 0;
    }
    cp_async_wait_all();
    __syncthreads();
    if (!active) continue;

    float s[kBwdTile / 8][4], dp[kBwdTile / 8][4];
#pragma unroll
    for (int n = 0; n < kBwdTile / 8; ++n) {
#pragma unroll
      for (int j = 0; j < 4; ++j) s[n][j] = dp[n][j] = 0.0f;
    }
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      uint32_t a[4], ga[4];
      frag_rows<LD>(a, sQ, wr, kk * 16, lane);
      frag_rows<LD>(ga, sG, wr, kk * 16, lane);
#pragma unroll
      for (int n2 = 0; n2 < kBwdTile / 16; ++n2) {
        uint32_t kf[4], vf[4];
        frag_depth<LD>(kf, sK, n2 * 16, kk * 16, lane);
        frag_depth<LD>(vf, sV, n2 * 16, kk * 16, lane);
        mma_bf16(s[2 * n2], a, kf[0], kf[1]);
        mma_bf16(s[2 * n2 + 1], a, kf[2], kf[3]);
        mma_bf16(dp[2 * n2], ga, vf[0], vf[1]);
        mma_bf16(dp[2 * n2 + 1], ga, vf[2], vf[3]);
      }
    }
    uint32_t dsf[kBwdTile / 16][4];
#pragma unroll
    for (int n = 0; n < kBwdTile / 8; ++n) {
      float ds[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kl = n * 8 + 2 * t + (j & 1);
        const int row = j < 2 ? qa : qb_row;
        const bool v = sMask[kl] > 0 && (!p.causal || k0 + kl <= row + p.offset);
        const float pr = v ? exp2f(s[n][j] * c - (j < 2 ? lse0 : lse1)) : 0.0f;
        ds[j] = pr * (dp[n][j] - (j < 2 ? dl0 : dl1)) * p.scale;
      }
      dsf[n / 2][(n % 2) * 2 + 0] = pack_bf16(ds[0], ds[1]);
      dsf[n / 2][(n % 2) * 2 + 1] = pack_bf16(ds[2], ds[3]);
    }
#pragma unroll
    for (int j = 0; j < kBwdTile / 16; ++j) {
#pragma unroll
      for (int nd2 = 0; nd2 < DP / 16; ++nd2) {
        uint32_t kf[4];
        frag_cols<LD>(kf, sK, j * 16, nd2 * 16, lane);
        mma_bf16(acc[2 * nd2], dsf[j], kf[0], kf[1]);
        mma_bf16(acc[2 * nd2 + 1], dsf[j], kf[2], kf[3]);
      }
    }
  }
  cp_async_wait_all();                     // the Q and dO copies, had the loop no tile
  if (!active) return;
  store_rows<DP, __nv_bfloat16>(acc, 1.0f, 1.0f, p.out, b, p.Sq, p.H * p.D, h, p.D, qa, t);
}

// dK and dV: a block owns 64 keys and walks the queries 32 at a time, on the
// transposed scores s^T = k . q^T so that its keys are the rows of every
// accumulator.
template <int DP>
constexpr int dkv_smem_bytes() {
  return 2 * (kRows + kBwdTile) * (DP + kPad) * 2 + 2 * kBwdTile * 4;
}

template <int DP>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(const Params p) {
  constexpr int LD = DP + kPad;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem);   // [key][dim]
  __nv_bfloat16* sV = sK + kRows * LD;                           // [key][dim]
  __nv_bfloat16* sQ = sV + kRows * LD;                           // [query][dim]
  __nv_bfloat16* sG = sQ + kBwdTile * LD;                        // dO, [query][dim]
  float* sLse = reinterpret_cast<float*>(sG + kBwdTile * LD);    // [query], times log2(e)
  float* sDelta = sLse + kBwdTile;                               // [query]

  const int kbase = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wr = warp * 16;
  const bool active = kbase + wr < p.Sk;

  const __nv_bfloat16* qb = p.q + (long long)b * p.qs.b + (long long)h * p.qs.h;
  const __nv_bfloat16* kb = p.k + (long long)b * p.ks.b + (long long)h * p.ks.h;
  const __nv_bfloat16* vb = p.v + (long long)b * p.vs.b + (long long)h * p.vs.h;
  const __nv_bfloat16* gb = p.d_out + (long long)b * p.gs.b + (long long)h * p.gs.h;
  const int* maskb = p.kv_mask ? p.kv_mask + (long long)b * p.Sk : nullptr;
  const long long row0 = ((long long)b * p.H + h) * p.Sq;

  load_rows<kRows, DP, kThreads>(sK, kb, p.ks.s, kbase, p.Sk, p.D, tid);
  load_rows<kRows, DP, kThreads>(sV, vb, p.vs.s, kbase, p.Sk, p.D, tid);

  const int ka = kbase + wr + g;
  const int kb_row = ka + 8;
  const bool kv0 = ka < p.Sk && (!maskb || maskb[ka] > 0);
  const bool kv1 = kb_row < p.Sk && (!maskb || maskb[kb_row] > 0);
  const float c = p.scale * kLog2e;

  float dk[DP / 8][4], dv[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
#pragma unroll
    for (int j = 0; j < 4; ++j) dk[n][j] = dv[n][j] = 0.0f;
  }
  // the first query row that sees this block's first key
  int q_begin = 0;
  if (p.causal) q_begin = max(0, kbase - p.offset) / kBwdTile * kBwdTile;

  for (int q0 = q_begin; q0 < p.Sq; q0 += kBwdTile) {
    __syncthreads();
    load_rows<kBwdTile, DP, kThreads>(sQ, qb, p.qs.s, q0, p.Sq, p.D, tid);
    load_rows<kBwdTile, DP, kThreads>(sG, gb, p.gs.s, q0, p.Sq, p.D, tid);
    if (tid < kBwdTile) {
      const int q = q0 + tid;
      sLse[tid] = (q < p.Sq ? p.lse_in[row0 + q] : kLseMasked) * kLog2e;
      sDelta[tid] = q < p.Sq ? p.delta[row0 + q] : 0.0f;
    }
    cp_async_wait_all();
    __syncthreads();
    if (!active) continue;

    // s^T and dp^T: rows are this warp's keys, columns the tile's queries
    float s[kBwdTile / 8][4], dp[kBwdTile / 8][4];
#pragma unroll
    for (int n = 0; n < kBwdTile / 8; ++n) {
#pragma unroll
      for (int j = 0; j < 4; ++j) s[n][j] = dp[n][j] = 0.0f;
    }
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      uint32_t a[4], va[4];
      frag_rows<LD>(a, sK, wr, kk * 16, lane);
      frag_rows<LD>(va, sV, wr, kk * 16, lane);
#pragma unroll
      for (int n2 = 0; n2 < kBwdTile / 16; ++n2) {
        uint32_t qf[4], gf[4];
        frag_depth<LD>(qf, sQ, n2 * 16, kk * 16, lane);
        frag_depth<LD>(gf, sG, n2 * 16, kk * 16, lane);
        mma_bf16(s[2 * n2], a, qf[0], qf[1]);
        mma_bf16(s[2 * n2 + 1], a, qf[2], qf[3]);
        mma_bf16(dp[2 * n2], va, gf[0], gf[1]);
        mma_bf16(dp[2 * n2 + 1], va, gf[2], gf[3]);
      }
    }
    uint32_t pf[kBwdTile / 16][4], dsf[kBwdTile / 16][4];
#pragma unroll
    for (int n = 0; n < kBwdTile / 8; ++n) {
      float pr[4], ds[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int ql = n * 8 + 2 * t + (j & 1);
        const int q = q0 + ql;
        const int key = j < 2 ? ka : kb_row;
        const bool v = (j < 2 ? kv0 : kv1) && q < p.Sq && (!p.causal || key <= q + p.offset);
        pr[j] = v ? exp2f(s[n][j] * c - sLse[ql]) : 0.0f;
        ds[j] = pr[j] * (dp[n][j] - sDelta[ql]) * p.scale;
      }
      pf[n / 2][(n % 2) * 2 + 0] = pack_bf16(pr[0], pr[1]);
      pf[n / 2][(n % 2) * 2 + 1] = pack_bf16(pr[2], pr[3]);
      dsf[n / 2][(n % 2) * 2 + 0] = pack_bf16(ds[0], ds[1]);
      dsf[n / 2][(n % 2) * 2 + 1] = pack_bf16(ds[2], ds[3]);
    }
#pragma unroll
    for (int j = 0; j < kBwdTile / 16; ++j) {
#pragma unroll
      for (int nd2 = 0; nd2 < DP / 16; ++nd2) {
        uint32_t gf[4], qf[4];
        frag_cols<LD>(gf, sG, j * 16, nd2 * 16, lane);
        frag_cols<LD>(qf, sQ, j * 16, nd2 * 16, lane);
        mma_bf16(dv[2 * nd2], pf[j], gf[0], gf[1]);
        mma_bf16(dv[2 * nd2 + 1], pf[j], gf[2], gf[3]);
        mma_bf16(dk[2 * nd2], dsf[j], qf[0], qf[1]);
        mma_bf16(dk[2 * nd2 + 1], dsf[j], qf[2], qf[3]);
      }
    }
  }
  cp_async_wait_all();                     // the K and V copies, had the loop no tile
  if (!active) return;
  store_rows<DP, __nv_bfloat16>(dk, 1.0f, 1.0f, p.out2, b, p.Sk, p.H * p.D, h, p.D, ka, t);
  store_rows<DP, __nv_bfloat16>(dv, 1.0f, 1.0f, p.out3, b, p.Sk, p.H * p.D, h, p.D, ka, t);
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

// grid: (query or key tiles, H, B), or for the forward one linear index over
// (query tile, head, batch), query tile slowest
template <typename Kernel>
cudaError_t launch(Kernel kernel, int smem_bytes, dim3 grid, const Params& p,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem_bytes);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem_bytes, stream>>>(p);
  return cudaGetLastError();
}

inline dim3 tile_grid(int rows, const Params& p) {
  return dim3((rows + kRows - 1) / kRows, p.H, p.B);
}

inline dim3 fwd_grid(const Params& p) {
  return dim3(static_cast<unsigned>((long long)(p.Sq + kRows - 1) / kRows * p.H * p.B));
}

template <bool UNIFORM>
cudaError_t launch_fwd(const Params& p, cudaStream_t st) {
  if (!shape_ok(p)) return cudaErrorInvalidValue;
  const dim3 grid = fwd_grid(p);
  switch ((p.D + 31) / 32 * 32) {
    case 32: return launch(flash_fwd_kernel<32, UNIFORM>, fwd_smem_bytes<32>(), grid, p, st);
    case 64: return launch(flash_fwd_kernel<64, UNIFORM>, fwd_smem_bytes<64>(), grid, p, st);
    case 96: return launch(flash_fwd_kernel<96, UNIFORM>, fwd_smem_bytes<96>(), grid, p, st);
    default: return launch(flash_fwd_kernel<128, UNIFORM>, fwd_smem_bytes<128>(), grid, p, st);
  }
}

// Resident blocks of the forward kernel a streaming multiprocessor holds at
// head_dim D, or -1.
template <typename Kernel>
int occupancy(Kernel kernel, int smem_bytes) {
  int blocks = 0;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads, smem_bytes) !=
          cudaSuccess) {
    return -1;
  }
  return blocks;
}

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
  switch ((p.D + 31) / 32 * 32) {
    case 32: return launch(flash_bwd_dq_kernel<32>, dq_smem_bytes<32>(), tile_grid(p.Sq, p), p, st);
    case 64: return launch(flash_bwd_dq_kernel<64>, dq_smem_bytes<64>(), tile_grid(p.Sq, p), p, st);
    case 96: return launch(flash_bwd_dq_kernel<96>, dq_smem_bytes<96>(), tile_grid(p.Sq, p), p, st);
    default: return launch(flash_bwd_dq_kernel<128>, dq_smem_bytes<128>(), tile_grid(p.Sq, p), p, st);
  }
}

template <typename = void>
cudaError_t launch_dkv(const Params& p, cudaStream_t st) {
  if (!shape_ok(p)) return cudaErrorInvalidValue;
  switch ((p.D + 31) / 32 * 32) {
    case 32: return launch(flash_bwd_dkv_kernel<32>, dkv_smem_bytes<32>(), tile_grid(p.Sk, p), p, st);
    case 64: return launch(flash_bwd_dkv_kernel<64>, dkv_smem_bytes<64>(), tile_grid(p.Sk, p), p, st);
    case 96: return launch(flash_bwd_dkv_kernel<96>, dkv_smem_bytes<96>(), tile_grid(p.Sk, p), p, st);
    default: return launch(flash_bwd_dkv_kernel<128>, dkv_smem_bytes<128>(), tile_grid(p.Sk, p), p, st);
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
