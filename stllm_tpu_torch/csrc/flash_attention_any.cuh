// The "any" form of the training-path attention kernels (#7 fused short
// forward, #4 flash forward, #5 dQ, #6 dK and dV), bf16 or fp32 in and out:
// the math of the tile loops (flash_attention.cuh, attention_f32.cuh) for
// every head_dim D >= 1, where the tile loops take D up to 128 (the wrapper
// zero-pads a D that is no multiple of 8 for them). The TPU kernels pad any
// head_dim to their 128-lane width and slice the padding back off, so they
// take every D; this form does too. Per kernel:
//   #7  s = q . k^T * scale over every key, hidden keys (kv_mask, and key >
//       query + Sk - Sq when causal) at -1e30, the max-subtracted softmax
//       over the full row (so a row with no visible key averages v over
//       every key), P = exp(s - max) / sum normalised and rounded to v's
//       dtype, out = P . V;
//   #4  the same over the visible keys only (causal: key <= query), by the
//       online recurrence; fp32 lse, and a row with no visible key gives
//       output 0 and lse = 1e30;
//   #5  p = exp(s - lse) on the visible keys, ds = p * (dO . v^T - delta) *
//       scale, dq = ds . k;
//   #6  dv = p^T . dO, dk = ds^T . q, walking the queries of each key.
// Everything else runs in fp32 on the CUDA cores (#4's P and #5/#6's P and
// dS are not rounded, as in their plain versions), so the plain versions
// (ops/kernels.py) are matched up to summation order.
//
// Design: simple and right first. No model of the repository has such a
// head (every config has head_dim 64, 88 or 128), so no path runs this form
// and its time is not a target. A block of kWarps warps owns kWarps rows of
// one (batch, head) pair, a warp a row (forward and dQ: query rows; dK, dV:
// key rows), and kCols output columns of them: D is a run-time value with no
// bound, so a wider head takes more blocks along a column-chunk axis of the
// grid, each recomputing the row's scores, and every lane keeps its
// kCols / 32 accumulators of each output in registers. The warp walks the
// other axis 32 at a time, lane j scoring element j (each score a scalar dot
// product over all D, read in place through the tensors' strides, with no
// alignment asked), so the row's statistics reduce over the warp; then it
// walks those 32 again, each weight broadcast by a shuffle, and every lane
// adds weight x row[c] for its columns c = lane + 32 i, so the warp's reads
// of a v, k, q or dO row are contiguous. Warps share nothing: no shared
// memory and no barrier, and a warp whose row is past the end returns.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace stllm {
namespace attn_any {

constexpr int kWarps = 4;               // rows a block owns, a warp each
constexpr int kThreads = kWarps * 32;
constexpr int kCols = 256;              // output columns of a block: a chunk of D
constexpr int kPerLane = kCols / 32;
constexpr float kNeg = -1e30f;          // a hidden score of the fused short kernel
constexpr float kLseMasked = 1e30f;     // lse of a flash row with no visible key

// kFlash: #4's forward; kUniform: #7's
enum Mode { kFlash = 0, kUniform = 1 };

struct Strides {
  long long b, s, h;
};

template <typename T>
struct Params {
  const T* q;
  const T* k;
  const T* v;
  const T* d_out;                       // backward only
  Strides qs, ks, vs, gs;
  const int* kv_mask;                   // (B, Sk) or null
  const float* lse_in;                  // backward: (B, H, Sq)
  const float* delta;                   // backward: (B, H, Sq)
  T* out;                               // forward out, or dq: (B, Sq, H, D) contiguous
  T* out2;                              // dk: (B, Sk, H, D) contiguous
  T* out3;                              // dv
  float* lse_out;                       // forward: (B, H, Sq) or null
  int B, Sq, Sk, H, D;
  int causal, offset;                   // visible: key <= query + offset when causal
  float scale;
};

__device__ __forceinline__ float f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float f32(float x) { return x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }
__device__ __forceinline__ void put(float* p, float x) { *p = x; }

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

// a . b over D elements, fp32 products and sums
template <typename T>
__device__ __forceinline__ float dot(const T* a, const T* b, int D) {
  float s = 0.0f;
  for (int d = 0; d < D; ++d) s = fmaf(f32(a[d]), f32(b[d]), s);
  return s;
}

// acc[i] += w * row[lane + 32 i] for the columns of the chunk inside D
template <typename T>
__device__ __forceinline__ void add_row(float (&acc)[kPerLane], float w, const T* row, int lane,
                                        int cols) {
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const int c = lane + 32 * i;
    if (c < cols) acc[i] = fmaf(w, f32(row[c]), acc[i]);
  }
}

// dst[lane + 32 i] = acc[i] / f for the columns of the chunk inside D
template <typename T>
__device__ __forceinline__ void store(T* dst, const float (&acc)[kPerLane], float f, int lane,
                                      int cols) {
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const int c = lane + 32 * i;
    if (c < cols) put(dst + c, __fdiv_rn(acc[i], f));
  }
}

// The block's place: a linear grid, the row group fastest, then the column
// chunk, the head and the batch. ``row`` is this warp's row (at or past the
// caller's row count: the warp has none).
struct Place {
  int row, c0, cols, h, b;
};

__device__ __forceinline__ Place place(int rows, int D, int H) {
  const long long groups = (rows + kWarps - 1) / kWarps;
  const long long chunks = (D + kCols - 1) / kCols;
  long long i = blockIdx.x;
  Place pl;
  pl.row = static_cast<int>(i % groups) * kWarps + (threadIdx.x >> 5);
  i /= groups;
  pl.c0 = static_cast<int>(i % chunks) * kCols;
  i /= chunks;
  pl.h = static_cast<int>(i % H);
  pl.b = static_cast<int>(i / H);
  pl.cols = min(kCols, D - pl.c0);
  return pl;
}

template <typename T>
__device__ __forceinline__ const T* at(const T* base, const Strides& st, int b, int row, int h) {
  return base + b * st.b + static_cast<long long>(row) * st.s + h * st.h;
}

__device__ __forceinline__ bool unmasked(const int* maskb, int key) {
  return maskb == nullptr || maskb[key] > 0;
}

// ---------------------------------------------------------------------------
// Forward (#4, #7): query row ``row`` against the keys. #4: the online
// softmax in one pass. #7: a pass for the row's max and sum, then a pass that
// rounds each normalised weight to T before P . V, as its plain version does.
// ---------------------------------------------------------------------------

// the weight as T holds it
__device__ __forceinline__ float as_stored(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
__device__ __forceinline__ float as_stored(float x, const float*) { return x; }

template <typename T, int MODE>
__global__ void __launch_bounds__(kThreads) fwd_kernel(const Params<T> p) {
  const Place pl = place(p.Sq, p.D, p.H);
  if (pl.row >= p.Sq) return;
  const int lane = threadIdx.x & 31;
  const T* q = at(p.q, p.qs, pl.b, pl.row, pl.h);
  const int* maskb = p.kv_mask ? p.kv_mask + static_cast<long long>(pl.b) * p.Sk : nullptr;
  const int last = pl.row + p.offset;   // the last key a causal row sees
  // #4 walks the visible range only; #7 every key, hidden ones at -1e30
  const int end = MODE == kFlash && p.causal ? max(0, min(p.Sk, last + 1)) : p.Sk;
  // this lane's score of key k0 + lane: -inf past the row's keys
  auto score = [&](int k0) {
    const int key = k0 + lane;
    if (key >= end) return -INFINITY;
    if (unmasked(maskb, key) && (!p.causal || key <= last)) {
      return dot(q, at(p.k, p.ks, pl.b, key, pl.h), p.D) * p.scale;
    }
    return MODE == kUniform ? kNeg : -INFINITY;
  };
  float acc[kPerLane];
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) acc[i] = 0.0f;
  float m = -INFINITY, l = 0.0f;
  for (int k0 = 0; k0 < end; k0 += 32) {
    const float s = score(k0);
    const float tile_max = warp_max(s);
    if (tile_max == -INFINITY) continue;   // #4: no visible key in this tile
    const float m_new = fmaxf(m, tile_max);
    const float alpha = m == -INFINITY ? 0.0f : expf(m - m_new);
    const float pr = s == -INFINITY ? 0.0f : expf(s - m_new);
    l = l * alpha + warp_sum(pr);
    m = m_new;
    if (MODE == kUniform) continue;        // the weights wait for the row's sum
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) acc[i] *= alpha;
    const int n = min(32, end - k0);
    for (int j = 0; j < n; ++j) {
      const float w = __shfl_sync(0xffffffffu, pr, j);
      if (w != 0.0f) add_row(acc, w, at(p.v, p.vs, pl.b, k0 + j, pl.h) + pl.c0, lane, pl.cols);
    }
  }
  const bool empty = l == 0.0f;         // #4: no visible key; #7 never (zero-sum guard)
  if (MODE == kUniform) {
    const float sum = empty ? 1.0f : l;
    for (int k0 = 0; k0 < end; k0 += 32) {
      const float s = score(k0);
      const float pr = s == -INFINITY ? 0.0f : as_stored(__fdiv_rn(expf(s - m), sum), p.v);
      const int n = min(32, end - k0);
      for (int j = 0; j < n; ++j) {
        const float w = __shfl_sync(0xffffffffu, pr, j);
        if (w != 0.0f) add_row(acc, w, at(p.v, p.vs, pl.b, k0 + j, pl.h) + pl.c0, lane, pl.cols);
      }
    }
  }
  const long long orow = (static_cast<long long>(pl.b) * p.Sq + pl.row) * p.H + pl.h;
  store(p.out + orow * p.D + pl.c0, acc, MODE == kUniform || empty ? 1.0f : l, lane, pl.cols);
  if (p.lse_out != nullptr && pl.c0 == 0 && lane == 0) {
    p.lse_out[(static_cast<long long>(pl.b) * p.H + pl.h) * p.Sq + pl.row] =
        empty ? kLseMasked : m + logf(l);
  }
}

// ---------------------------------------------------------------------------
// dQ (#5): query row ``row`` against its visible keys
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads) dq_kernel(const Params<T> p) {
  const Place pl = place(p.Sq, p.D, p.H);
  if (pl.row >= p.Sq) return;
  const int lane = threadIdx.x & 31;
  const T* q = at(p.q, p.qs, pl.b, pl.row, pl.h);
  const T* g = at(p.d_out, p.gs, pl.b, pl.row, pl.h);
  const int* maskb = p.kv_mask ? p.kv_mask + static_cast<long long>(pl.b) * p.Sk : nullptr;
  const long long r = (static_cast<long long>(pl.b) * p.H + pl.h) * p.Sq + pl.row;
  const float lse = p.lse_in[r], delta = p.delta[r];
  const int end = p.causal ? max(0, min(p.Sk, pl.row + p.offset + 1)) : p.Sk;
  float acc[kPerLane];
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) acc[i] = 0.0f;
  for (int k0 = 0; k0 < end; k0 += 32) {
    const int key = k0 + lane;
    float ds = 0.0f;
    if (key < end && unmasked(maskb, key)) {
      const float pr = expf(dot(q, at(p.k, p.ks, pl.b, key, pl.h), p.D) * p.scale - lse);
      const float dp = dot(g, at(p.v, p.vs, pl.b, key, pl.h), p.D);
      ds = pr * (dp - delta) * p.scale;
    }
    const int n = min(32, end - k0);
    for (int j = 0; j < n; ++j) {
      const float w = __shfl_sync(0xffffffffu, ds, j);
      if (w != 0.0f) add_row(acc, w, at(p.k, p.ks, pl.b, k0 + j, pl.h) + pl.c0, lane, pl.cols);
    }
  }
  const long long orow = (static_cast<long long>(pl.b) * p.Sq + pl.row) * p.H + pl.h;
  store(p.out + orow * p.D + pl.c0, acc, 1.0f, lane, pl.cols);
}

// ---------------------------------------------------------------------------
// dK, dV (#6): key row ``row`` against the queries that see it
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads) dkv_kernel(const Params<T> p) {
  const Place pl = place(p.Sk, p.D, p.H);
  const int key = pl.row;
  if (key >= p.Sk) return;
  const int lane = threadIdx.x & 31;
  const T* kr = at(p.k, p.ks, pl.b, key, pl.h);
  const T* vr = at(p.v, p.vs, pl.b, key, pl.h);
  const float* lse = p.lse_in + (static_cast<long long>(pl.b) * p.H + pl.h) * p.Sq;
  const float* delta = p.delta + (static_cast<long long>(pl.b) * p.H + pl.h) * p.Sq;
  const bool seen = p.kv_mask == nullptr || p.kv_mask[static_cast<long long>(pl.b) * p.Sk + key] > 0;
  // causal: the queries i with key <= i + offset
  const int start = p.causal ? max(0, key - p.offset) : 0;
  float dk[kPerLane], dv[kPerLane];
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) dk[i] = dv[i] = 0.0f;
  for (int i0 = seen ? start : p.Sq; i0 < p.Sq; i0 += 32) {
    const int i = i0 + lane;
    float pr = 0.0f, ds = 0.0f;
    if (i < p.Sq) {
      pr = expf(dot(at(p.q, p.qs, pl.b, i, pl.h), kr, p.D) * p.scale - lse[i]);
      const float dp = dot(at(p.d_out, p.gs, pl.b, i, pl.h), vr, p.D);
      ds = pr * (dp - delta[i]) * p.scale;
    }
    const int n = min(32, p.Sq - i0);
    for (int j = 0; j < n; ++j) {
      const float wp = __shfl_sync(0xffffffffu, pr, j);
      const float wd = __shfl_sync(0xffffffffu, ds, j);
      if (wp != 0.0f) add_row(dv, wp, at(p.d_out, p.gs, pl.b, i0 + j, pl.h) + pl.c0, lane, pl.cols);
      if (wd != 0.0f) add_row(dk, wd, at(p.q, p.qs, pl.b, i0 + j, pl.h) + pl.c0, lane, pl.cols);
    }
  }
  const long long orow = (static_cast<long long>(pl.b) * p.Sk + key) * p.H + pl.h;
  store(p.out2 + orow * p.D + pl.c0, dk, 1.0f, lane, pl.cols);
  store(p.out3 + orow * p.D + pl.c0, dv, 1.0f, lane, pl.cols);
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

// Blocks of a launch over ``rows`` rows, or 0 where the shape is empty or
// the linear grid does not hold them.
inline unsigned blocks(int rows, int D, int H, int B) {
  if (rows <= 0 || D <= 0 || H <= 0 || B <= 0) return 0;
  const long long n = static_cast<long long>((rows + kWarps - 1) / kWarps) *
                      ((D + kCols - 1) / kCols) * H * B;
  return n <= 0x7fffffffLL ? static_cast<unsigned>(n) : 0u;
}

// The training kernels' flat argument list, as flash::make_params: strides
// is 12 long longs (batch, sequence, head of q, k, v, dO).
template <typename T>
Params<T> make_params(const void* q, const void* k, const void* v, const void* d_out,
                      const long long* strides, const void* kv_mask, int B, int Sq, int Sk,
                      int H, int D, int causal, int offset, float scale) {
  Params<T> p{};
  p.q = static_cast<const T*>(q);
  p.k = static_cast<const T*>(k);
  p.v = static_cast<const T*>(v);
  p.d_out = static_cast<const T*>(d_out);
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

// The forward: out (B, Sq, H, D) and, for #4, lse (B, H, Sq) or null.
template <typename T, int MODE>
cudaError_t launch_fwd(const Params<T>& p, cudaStream_t st) {
  const unsigned n = p.Sk > 0 ? blocks(p.Sq, p.D, p.H, p.B) : 0u;
  if (n == 0) return cudaErrorInvalidValue;
  fwd_kernel<T, MODE><<<n, kThreads, 0, st>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dq(const Params<T>& p, cudaStream_t st) {
  const unsigned n = p.Sk > 0 ? blocks(p.Sq, p.D, p.H, p.B) : 0u;
  if (n == 0) return cudaErrorInvalidValue;
  dq_kernel<T><<<n, kThreads, 0, st>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dkv(const Params<T>& p, cudaStream_t st) {
  const unsigned n = p.Sq > 0 ? blocks(p.Sk, p.D, p.H, p.B) : 0u;
  if (n == 0) return cudaErrorInvalidValue;
  dkv_kernel<T><<<n, kThreads, 0, st>>>(p);
  return cudaGetLastError();
}

}  // namespace attn_any
}  // namespace stllm
