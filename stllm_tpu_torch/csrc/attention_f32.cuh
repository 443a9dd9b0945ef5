// The fp32-io instantiations of the attention kernels for Hopper (sm_90a):
// the packed-qkv forward (#1, and #2's rows before their quantization), the
// flash forward (#4), the fused short forward (#7) and the two backward
// kernels (#5 dQ, #6 dK and dV). Each computes the function of its bf16
// kernel with fp32 inputs, products and outputs, as the TPU kernels keep the
// io dtype: scores, P and dS stay fp32 (no bf16 rounding), and the products
// run on the CUDA cores as fp32 fused multiply-adds, never in TF32. The fp32
// models are the test and small-check configurations, so the design is
// simple and right first: a block of 4 warps owns 16 rows and walks the
// other axis in tiles held in shared memory (row stride 129 floats: the
// column reads of a warp miss bank conflicts); a warp forms the scores of a
// row against 32 keys (forward, one lane a key, so the row's maximum and sum
// reduce over the warp) or 2 rows against 16 (backward), and each thread
// then accumulates 2 x 8 ... 16 output columns of one row.
//
// q, k, v and dO are read through (batch, sequence, head) strides in
// elements, the head dimension contiguous; D is at most 128. The packed
// forward takes q, k, v as the three thirds of a (B, S, 3*H*D) tensor.

#pragma once

#include <cuda_runtime.h>

namespace stllm {
namespace f32attn {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;               // query rows (forward, dQ) or keys (dK, dV) a block owns
constexpr int kFwdKeys = 32;            // keys a forward tile holds: one a lane
constexpr int kBwdTile = 16;            // keys (dQ) or queries (dK, dV) a backward tile holds
constexpr int kMaxD = 128;
constexpr int kLd = kMaxD + 1;          // row stride of a shared tile, in floats
constexpr int kCols = kMaxD / 8;        // output columns a thread holds
constexpr float kNeg = -1e30f;
constexpr float kLseMasked = 1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kClamp = 50.0f;

// kPacked: the packed kernel's clamped exp2(min(s, 50) - 50) with no row
// maximum over every key in range (``scale`` is then scale * log2(e));
// kFlash: the online softmax over the visible keys, a row with none giving
// 0 and lse = 1e30; kUniform: the fused short kernel's max-subtracted
// softmax over the full row with hidden keys at -1e30.
enum Mode { kPacked = 0, kFlash = 1, kUniform = 2 };

struct Strides {
  long long b, s, h;
};

struct Params {
  const float* q;
  const float* k;
  const float* v;
  const float* d_out;                   // backward only
  Strides qs, ks, vs, gs;
  const int* kv_mask;                   // (B, Sk) or null
  const float* lse_in;                  // backward: (B, H, Sq)
  const float* delta;                   // backward: (B, H, Sq)
  float* out;                           // forward out, or dq: (B, Sq, H, D) contiguous
  float* out2;                          // dk
  float* out3;                          // dv
  float* lse_out;                       // forward: (B, H, Sq) or null
  int B, Sq, Sk, H, D;
  int causal, offset;
  float scale;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Rows [r0, r0 + n) of a strided (rows, D) slab into dst[n][kLd]; rows at or
// past ``limit`` are zeros.
__device__ __forceinline__ void load_tile(float* dst, const float* base, long long stride,
                                          int r0, int n, int limit, int D) {
  for (int i = threadIdx.x; i < n * D; i += kThreads) {
    const int r = i / D;
    const int c = i - r * D;
    dst[r * kLd + c] = r0 + r < limit ? base[(long long)(r0 + r) * stride + c] : 0.0f;
  }
}

__device__ __forceinline__ float dot(const float* a, const float* b, int D) {
  float s = 0.0f;
  for (int d = 0; d < D; ++d) s = fmaf(a[d], b[d], s);
  return s;
}

__device__ __forceinline__ const float* head_base(const float* t, const Strides& st, int b,
                                                  int h) {
  return t + (long long)b * st.b + (long long)h * st.h;
}

__device__ __forceinline__ bool key_unmasked(const int* maskb, int key, int Sk) {
  return key < Sk && (!maskb || maskb[key] > 0);
}

// Row ``row`` of a (B, S, H, D) contiguous output: columns col0 + 8 j of
// head h.
__device__ __forceinline__ void store_row(float* out, const float (&o)[kCols], float f, int b,
                                          int row, int S, int H, int h, int D, int col0) {
  float* dst = out + (((long long)b * S + row) * H + h) * D;
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    const int col = col0 + 8 * j;
    if (col < D) dst[col] = __fdiv_rn(o[j], f);
  }
}

template <int MODE>
__global__ void __launch_bounds__(kThreads) fwd_kernel(const Params p) {
  __shared__ float sQ[kRows * kLd];
  __shared__ float sK[kFwdKeys * kLd];
  __shared__ float sV[kFwdKeys * kLd];
  __shared__ float sP[kRows][kFwdKeys + 1];
  __shared__ float sM[kRows], sL[kRows], sA[kRows];   // running max, sum, this tile's rescale

  const int q0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int orow = tid >> 3;               // the output row this thread accumulates
  const int ocol = tid & 7;                // and its first column
  const float* kb = head_base(p.k, p.ks, b, h);
  const float* vb = head_base(p.v, p.vs, b, h);
  const int* maskb = p.kv_mask ? p.kv_mask + (long long)b * p.Sk : nullptr;
  const float c = MODE == kPacked ? p.scale : p.scale * kLog2e;

  load_tile(sQ, head_base(p.q, p.qs, b, h), p.qs.s, q0, kRows, p.Sq, p.D);
  if (tid < kRows) {
    sM[tid] = kNeg;
    sL[tid] = 0.0f;
  }
  float o[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) o[j] = 0.0f;
  int k_end = p.Sk;
  if (p.causal) k_end = max(0, min(p.Sk, q0 + kRows + p.offset));

  for (int k0 = 0; k0 < p.Sk; k0 += kFwdKeys) {
    __syncthreads();                       // the previous tile is consumed; sM is current
    if (k0 >= k_end) {
      if (MODE != kUniform) break;
      const bool unseen = tid < kRows && q0 + tid < p.Sq && sM[tid] == kNeg;
      if (!__syncthreads_or(unseen)) break;
    }
    load_tile(sK, kb, p.ks.s, k0, kFwdKeys, p.Sk, p.D);
    load_tile(sV, vb, p.vs.s, k0, kFwdKeys, p.Sk, p.D);
    __syncthreads();
    const int key = k0 + lane;
    const bool in_range = key < p.Sk;
    const bool unmasked = key_unmasked(maskb, key, p.Sk);
    for (int rr = warp; rr < kRows; rr += kWarps) {
      const float s = dot(&sQ[rr * kLd], &sK[lane * kLd], p.D);
      float pr;
      if (MODE == kPacked) {
        pr = in_range ? exp2f(fminf(s * c, kClamp) - kClamp) : 0.0f;
        const float lsum = warp_sum(pr);
        if (lane == 0) sL[rr] += lsum;
      } else {
        const bool vis = unmasked && (!p.causal || key <= q0 + rr + p.offset);
        const float s2 = vis ? s * c : kNeg;
        const float m_old = sM[rr];
        const float m_new = fmaxf(m_old, warp_max(s2));
        const float e = exp2f(s2 - m_new);
        pr = (MODE == kUniform ? in_range : vis) ? e : 0.0f;
        const float lsum = warp_sum(pr);
        __syncwarp();                      // every lane has read sM[rr]
        if (lane == 0) {
          const float a = exp2f(m_old - m_new);
          sA[rr] = a;
          sM[rr] = m_new;
          sL[rr] = sL[rr] * a + lsum;
        }
      }
      sP[rr][lane] = pr;
    }
    __syncthreads();
    const float a = MODE == kPacked ? 1.0f : sA[orow];
    const int n = min(kFwdKeys, p.Sk - k0);
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int col = ocol + 8 * j;
      if (col < p.D) {
        float acc = o[j] * a;
        for (int kk = 0; kk < n; ++kk) acc = fmaf(sP[orow][kk], sV[kk * kLd + col], acc);
        o[j] = acc;
      }
    }
  }
  __syncthreads();
  const int row = q0 + orow;
  if (row >= p.Sq) return;
  const float l = sL[orow];
  store_row(p.out, o, l == 0.0f ? 1.0f : l, b, row, p.Sq, p.H, h, p.D, ocol);
  if (MODE == kFlash && p.lse_out && ocol == 0) {
    p.lse_out[((long long)b * p.H + h) * p.Sq + row] =
        l == 0.0f ? kLseMasked : (sM[orow] + log2f(l)) * kLn2;
  }
}

// dQ: a block owns 16 query rows and walks the keys 16 at a time; with
// s = q . k^T * scale, p = exp(s - lse) on the visible keys,
// ds = p * (dO . v^T - delta) * scale, dq = ds . k. (Templates, so that a
// library holds only the kernels its entry point launches.)
template <typename = void>
__global__ void __launch_bounds__(kThreads) dq_kernel(const Params p) {
  __shared__ float sQ[kRows * kLd];
  __shared__ float sG[kRows * kLd];
  __shared__ float sK[kBwdTile * kLd];
  __shared__ float sV[kBwdTile * kLd];
  __shared__ float sDS[kRows][kBwdTile + 1];

  const int q0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int orow = tid >> 3;
  const int ocol = tid & 7;
  const float* kb = head_base(p.k, p.ks, b, h);
  const float* vb = head_base(p.v, p.vs, b, h);
  const int* maskb = p.kv_mask ? p.kv_mask + (long long)b * p.Sk : nullptr;
  const long long row0 = ((long long)b * p.H + h) * p.Sq;

  load_tile(sQ, head_base(p.q, p.qs, b, h), p.qs.s, q0, kRows, p.Sq, p.D);
  load_tile(sG, head_base(p.d_out, p.gs, b, h), p.gs.s, q0, kRows, p.Sq, p.D);
  float acc[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) acc[j] = 0.0f;
  int k_end = p.Sk;
  if (p.causal) k_end = max(0, min(p.Sk, q0 + kRows + p.offset));

  for (int k0 = 0; k0 < k_end; k0 += kBwdTile) {
    __syncthreads();
    load_tile(sK, kb, p.ks.s, k0, kBwdTile, p.Sk, p.D);
    load_tile(sV, vb, p.vs.s, k0, kBwdTile, p.Sk, p.D);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kRows * kBwdTile / kThreads; ++i) {
      const int e = tid + kThreads * i;
      const int rr = e / kBwdTile;
      const int kl = e % kBwdTile;
      const int row = q0 + rr;
      const int key = k0 + kl;
      const bool vis = row < p.Sq && key_unmasked(maskb, key, p.Sk) &&
                       (!p.causal || key <= row + p.offset);
      float ds = 0.0f;
      if (vis) {
        const float s = dot(&sQ[rr * kLd], &sK[kl * kLd], p.D);
        const float dp = dot(&sG[rr * kLd], &sV[kl * kLd], p.D);
        const float pr = expf(s * p.scale - p.lse_in[row0 + row]);
        ds = pr * (dp - p.delta[row0 + row]) * p.scale;
      }
      sDS[rr][kl] = ds;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int col = ocol + 8 * j;
      if (col < p.D) {
        float a = acc[j];
        for (int kl = 0; kl < kBwdTile; ++kl) a = fmaf(sDS[orow][kl], sK[kl * kLd + col], a);
        acc[j] = a;
      }
    }
  }
  const int row = q0 + orow;
  if (row < p.Sq) store_row(p.out, acc, 1.0f, b, row, p.Sq, p.H, h, p.D, ocol);
}

// dK and dV: a block owns 16 keys and walks the queries 16 at a time:
// dv = p^T . dO, dk = ds^T . q.
template <typename = void>
__global__ void __launch_bounds__(kThreads) dkv_kernel(const Params p) {
  __shared__ float sK[kRows * kLd];
  __shared__ float sV[kRows * kLd];
  __shared__ float sQ[kBwdTile * kLd];
  __shared__ float sG[kBwdTile * kLd];
  __shared__ float sP[kRows][kBwdTile + 1];
  __shared__ float sDS[kRows][kBwdTile + 1];
  __shared__ float sLse[kBwdTile], sDelta[kBwdTile];

  const int kbase = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int orow = tid >> 3;
  const int ocol = tid & 7;
  const float* qb = head_base(p.q, p.qs, b, h);
  const float* gb = head_base(p.d_out, p.gs, b, h);
  const int* maskb = p.kv_mask ? p.kv_mask + (long long)b * p.Sk : nullptr;
  const long long row0 = ((long long)b * p.H + h) * p.Sq;

  load_tile(sK, head_base(p.k, p.ks, b, h), p.ks.s, kbase, kRows, p.Sk, p.D);
  load_tile(sV, head_base(p.v, p.vs, b, h), p.vs.s, kbase, kRows, p.Sk, p.D);
  float dk[kCols], dv[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) dk[j] = dv[j] = 0.0f;
  int q_begin = 0;
  if (p.causal) q_begin = max(0, kbase - p.offset) / kBwdTile * kBwdTile;

  for (int qt = q_begin; qt < p.Sq; qt += kBwdTile) {
    __syncthreads();
    load_tile(sQ, qb, p.qs.s, qt, kBwdTile, p.Sq, p.D);
    load_tile(sG, gb, p.gs.s, qt, kBwdTile, p.Sq, p.D);
    if (tid < kBwdTile) {
      const int q = qt + tid;
      sLse[tid] = q < p.Sq ? p.lse_in[row0 + q] : kLseMasked;
      sDelta[tid] = q < p.Sq ? p.delta[row0 + q] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kRows * kBwdTile / kThreads; ++i) {
      const int e = tid + kThreads * i;
      const int kr = e / kBwdTile;
      const int qc = e % kBwdTile;
      const int key = kbase + kr;
      const int q = qt + qc;
      const bool vis = q < p.Sq && key_unmasked(maskb, key, p.Sk) &&
                       (!p.causal || key <= q + p.offset);
      float pr = 0.0f, ds = 0.0f;
      if (vis) {
        const float s = dot(&sK[kr * kLd], &sQ[qc * kLd], p.D);
        const float dp = dot(&sV[kr * kLd], &sG[qc * kLd], p.D);
        pr = expf(s * p.scale - sLse[qc]);
        ds = pr * (dp - sDelta[qc]) * p.scale;
      }
      sP[kr][qc] = pr;
      sDS[kr][qc] = ds;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int col = ocol + 8 * j;
      if (col < p.D) {
        float a = dv[j], d = dk[j];
        for (int qc = 0; qc < kBwdTile; ++qc) {
          a = fmaf(sP[orow][qc], sG[qc * kLd + col], a);
          d = fmaf(sDS[orow][qc], sQ[qc * kLd + col], d);
        }
        dv[j] = a;
        dk[j] = d;
      }
    }
  }
  const int key = kbase + orow;
  if (key < p.Sk) {
    store_row(p.out2, dk, 1.0f, b, key, p.Sk, p.H, h, p.D, ocol);
    store_row(p.out3, dv, 1.0f, b, key, p.Sk, p.H, h, p.D, ocol);
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

inline bool shape_ok(const Params& p) {
  return p.B > 0 && p.H > 0 && p.Sq > 0 && p.Sk > 0 && p.D > 0 && p.D <= kMaxD &&
         p.H <= 65535 && p.B <= 65535 && (p.Sq + kRows - 1) / kRows <= 0x7fffffff &&
         (p.Sk + kRows - 1) / kRows <= 0x7fffffff;
}

// (templates, so that a library holds only the kernels its entry point launches)
template <int MODE>
cudaError_t launch_fwd(const Params& p, cudaStream_t st) {
  if (!shape_ok(p)) return cudaErrorInvalidValue;
  fwd_kernel<MODE><<<dim3((p.Sq + kRows - 1) / kRows, p.H, p.B), kThreads, 0, st>>>(p);
  return cudaGetLastError();
}

template <typename = void>
cudaError_t launch_dq(const Params& p, cudaStream_t st) {
  if (!shape_ok(p)) return cudaErrorInvalidValue;
  dq_kernel<><<<dim3((p.Sq + kRows - 1) / kRows, p.H, p.B), kThreads, 0, st>>>(p);
  return cudaGetLastError();
}

template <typename = void>
cudaError_t launch_dkv(const Params& p, cudaStream_t st) {
  if (!shape_ok(p)) return cudaErrorInvalidValue;
  dkv_kernel<><<<dim3((p.Sk + kRows - 1) / kRows, p.H, p.B), kThreads, 0, st>>>(p);
  return cudaGetLastError();
}

// The training kernels' flat argument list, as flash::make_params: strides
// is 12 long longs (batch, sequence, head of q, k, v, dO).
inline Params make_params(const void* q, const void* k, const void* v, const void* d_out,
                          const long long* strides, const void* kv_mask, int B, int Sq, int Sk,
                          int H, int D, int causal, int offset, float scale) {
  Params p{};
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.d_out = static_cast<const float*>(d_out);
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

// The packed forward on a contiguous (B, S, 3*H*D) qkv: q, k, v are its
// thirds, out (B, S, H*D) contiguous; scale_log2e = scale * log2(e).
template <typename = void>
cudaError_t launch_packed(const void* qkv, float* out, int B, int S, int H, int D,
                          float scale_log2e, cudaStream_t st) {
  const float* base = static_cast<const float*>(qkv);
  const long long hd = (long long)H * D;
  const long long strides[12] = {S * 3 * hd, 3 * hd, D, S * 3 * hd, 3 * hd, D,
                                 S * 3 * hd, 3 * hd, D, 0, 0, 0};
  Params p = make_params(base, base + hd, base + 2 * hd, nullptr, strides, nullptr, B, S, S, H,
                         D, 0, 0, scale_log2e);
  p.out = out;
  return launch_fwd<kPacked>(p, st);
}

}  // namespace f32attn
}  // namespace stllm
