// Packed-qkv attention on static-int8 qkv with a per-row int8 epilogue, for
// Hopper (sm_90a): int8 qkv and its three calibrated scales in, int8 out plus
// an fp32 scale per row.
//
// Replaces stllm_tpu/ops/attention.py:_packed_qkv_s8_kernel, the attention of
// every trunk block and every BTAdapter spatial layer of the static-int8
// EVA-ViT-g. It computes what that kernel computes:
//   qkv_q (B, S, 3*H*D) int8, q|k|v by thirds, with scales sq, sk, sv
//   s   = int(q . k^T) * ((sq * sk * scale) * log2(e))  (exact s32 products)
//   p   = exp2(min(s, 50) - 50)                         clamped, no row max
//   out = (bf16(p) . bf16(v)) * (sv / sum(p))           fp32 accumulation
// and then quantizes each full output row over all H*D columns
// (rowwise_quant.cuh). int8 -> bf16 is exact, and so are the s32 products:
// 127^2 * D < 2^24 for every D the loop takes, so an fp32 dot of the same
// codes gives the same scores (the TPU kernel's int8_dot=False form).
//
// Bound on the H100 at the ViT-g shape (16, 257, 3*16*88): each call reads
// 17.4 MB of int8 qkv and writes 5.8 MB of int8 and 16 KB of scales, 23.2 MB,
// about 6.9 us at 3.35 TB/s, against 2.97 G int8 operations (1.5 us at
// 1,979 TOP/s) plus 2.97 GFLOP of bf16 P.V (3.0 us at 989 TFLOP/s), so it is
// bound by memory. The row amax spans the heads, so the epilogue takes the
// two-launch route of packed_qkv_attention_quant.cu: fp32 rows to a scratch
// buffer, then the row-quant pass. That route moves the scratch too (23.2 MB
// written, 23.2 MB read), about 21 us of its own at 3.35 TB/s where the
// scratch misses the 50 MB L2.
//
// Design: the bf16 kernel's loop (packed_qkv_attention.cuh) on int8 tiles.
// The same geometry: blocks of up to 9 warps that split a (batch, head)
// pair's query rows evenly (S = 257: two blocks of 9 and 8 warps), 16 rows a
// warp, and a short form for S <= 16 (a block of 4 warps on 4 pairs). Q and
// K sit in shared memory as int8 [row][dim], D padded to a multiple of 32
// (the s8 mma depth) with zero-filled copies, rows padded by 16 bytes; they
// come in by cp.async (16 bytes a copy where D % 16 == 0, else 8: a head of
// 88 bytes is only 8-byte aligned), K through a ring of 32-key tiles whose
// copies run two tiles ahead (three stages: 0.0729 ms at the trunk against
// 0.0756 with two and 0.0753 with four on an H100 SXM at 700 W,
// script/tune_attention_loops.py).
// q . k^T runs on mma.sync m16n8k32 s8 -> s32, its fragments read by
// ldmatrix: an s8 fragment of a [row][dim] tile is what ldmatrix gives for
// 16-byte rows. P.V runs on m16n8k16 bf16 as in the bf16 kernel, so V has to
// become bf16: V codes come in by cp.async to int8 staging buffers with K,
// and once tile i + 1's have landed (after tile i's products) each thread
// converts the chunks it copied itself into the next bf16 stage as
// [key][dim] (16-byte stores), ahead of the one barrier a tile; P.V reads
// them with ldmatrix.trans. No register holds a tile in flight, so a thread
// stays under 113 registers and two blocks of 9 warps share an SM. A
// head_dim the loop does not take (not a multiple of 8, or above 128) takes
// the "any" form (packed_qkv_any.cuh).

#include "packed_qkv_any.cuh"
#include "packed_qkv_attention.cuh"
#include "rowwise_quant.cuh"

namespace stllm {
namespace packed {

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kS8Stages = 3;            // K stages of the long-form ring

// V-code staging buffers and bf16 V stages of a ring of STAGES K stages: the
// codes of the tiles in flight, and the tile computing plus the next one
template <int STAGES>
constexpr int kCodeBufs = STAGES > 1 ? STAGES - 1 : 1;
template <int STAGES>
constexpr int kVStages = STAGES > 1 ? 2 : 1;

// c += a . b for one 16x8 tile, k = 32: a row-major 16x32 s8, b column-major
// 32x8 s8, c s32.
__device__ __forceinline__ void mma_s8(int c[4], const uint32_t a[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// int8 row stride (bytes) of the Q, K and V-staging tiles: the 16 extra bytes
// put the eight 16-byte rows of an ldmatrix read in distinct banks.
template <int DP>
constexpr int kS8Ld = DP + 16;

// Start the copies of ``nrows`` rows from r0 of one pair's int8 (S, D) slab
// into dst[nrows][DP + 16], VEC bytes a copy; rows at or past ``limit`` and
// bytes past D are zero-filled.
template <int DP, int VEC>
__device__ __forceinline__ void copy_rows_s8(int8_t* dst, const int8_t* base,
                                             long long row_stride, int r0, int nrows, int limit,
                                             int D, int tid, int nthreads) {
  constexpr int LD = kS8Ld<DP>;
  constexpr int VECS = DP / VEC;
  for (int i = tid; i < nrows * VECS; i += nthreads) {
    const int r = i / VECS;
    const int c = i - r * VECS;
    const bool ok = r0 + r < limit && c * VEC < D;
    const int8_t* src = ok ? base + (long long)(r0 + r) * row_stride + c * VEC : base;
    if (VEC == 16) {
      cp_async16(&dst[r * LD + c * VEC], src, ok);
    } else {
      cp_async8(&dst[r * LD + c * VEC], src, ok);
    }
  }
}

// Byte k of w as a signed code, in fp32 (exact).
__device__ __forceinline__ float code(uint32_t w, int k) {
  return static_cast<float>(static_cast<int8_t>(w >> (8 * k)));
}

// The chunks this thread copied with copy_rows_s8 (same rows, same thread
// split), as bf16 into dst[nrows][DP + kPad]: 8 codes, one 16-byte store.
template <int DP, int VEC>
__device__ __forceinline__ void convert_rows_s8(__nv_bfloat16* dst, const int8_t* src,
                                                int nrows, int tid, int nthreads) {
  constexpr int LDS = kS8Ld<DP>;
  constexpr int LDV = DP + kPad;
  constexpr int VECS = DP / VEC;
  for (int i = tid; i < nrows * VECS; i += nthreads) {
    const int r = i / VECS;
    const int c = i - r * VECS;
#pragma unroll
    for (int h = 0; h < VEC / 8; ++h) {
      const uint2 w = *reinterpret_cast<const uint2*>(&src[r * LDS + c * VEC + h * 8]);
      uint4 o;
      o.x = pack_bf16(code(w.x, 0), code(w.x, 1));
      o.y = pack_bf16(code(w.x, 2), code(w.x, 3));
      o.z = pack_bf16(code(w.y, 0), code(w.y, 1));
      o.w = pack_bf16(code(w.y, 2), code(w.y, 3));
      *reinterpret_cast<uint4*>(&dst[r * LDV + c * VEC + h * 8]) = o;
    }
  }
}

// BK keys a ring stage, STAGES stages (copies run STAGES - 1 tiles ahead),
// VEC bytes a copy. The block takes ``pairs`` pairs and query rows as
// packed_kernel does.
template <int DP, int BK, int STAGES, int VEC>
__global__ void __launch_bounds__(kMaxThreads, 2)
packed_s8_kernel(const int8_t* __restrict__ qkv, const float* __restrict__ scales, float scale,
                 float* __restrict__ out, int B, int S, int H, int D, int pairs, int W,
                 int q_blocks) {
  constexpr int LDK = kS8Ld<DP>;
  constexpr int LDV = DP + kPad;
  extern __shared__ __align__(16) unsigned char smem[];
  const int rows = 16 * W;
  constexpr int CODES = kCodeBufs<STAGES>;
  constexpr int VST = kVStages<STAGES>;
  int8_t* sQ = reinterpret_cast<int8_t*>(smem);         // [pairs][rows][LDK]
  int8_t* sK = sQ + pairs * rows * LDK;                  // [STAGES][pairs][BK][LDK]
  int8_t* sVc = sK + STAGES * pairs * BK * LDK;          // [CODES][pairs][BK][LDK]: V codes
  __nv_bfloat16* sV = reinterpret_cast<__nv_bfloat16*>(sVc + CODES * pairs * BK * LDK);
                                                         // [VST][pairs][BK][LDV]

  const int nthreads = blockDim.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int first_pair = blockIdx.x / q_blocks * pairs;
  const int q0 = blockIdx.x % q_blocks * rows;
  const int hd = H * D;
  const long long row_stride = 3LL * hd;
  const int nbh = B * H;

  const int wp = warp / W;
  const int wr = (warp - wp * W) * 16;
  const int pair = first_pair + wp;
  const bool active = pair < nbh && q0 + wr < S;   // warp-uniform
  // the TPU kernel's qk scale: (sq * sk * scale) in fp32, then * log2(e)
  const float qk_log2 = __fmul_rn(__fmul_rn(__fmul_rn(scales[0], scales[1]), scale), kLog2e);
  const float v_scale = scales[2];

  auto pair_base = [&](int p) {
    const int bh = min(first_pair + p, nbh - 1);
    return qkv + (long long)(bh / H) * S * row_stride + (long long)(bh % H) * D;
  };
  auto pair_rows = [&](int p) { return first_pair + p < nbh ? S : 0; };
  auto tile_rows = [&](int i) { return min(BK, (S - i * BK + 15) / 16 * 16); };
  const int n_tiles = (S + BK - 1) / BK;
  // K of key tile i into its stage and V's codes into its staging buffer:
  // only the 16-key blocks that hold a key; one commit group a tile (empty
  // past the last)
  auto issue_tile = [&](int i) {
    if (i < n_tiles) {
      for (int p = 0; p < pairs; ++p) {
        const int8_t* base = pair_base(p);
        copy_rows_s8<DP, VEC>(sK + ((i % STAGES) * pairs + p) * BK * LDK, base + hd,
                              row_stride, i * BK, tile_rows(i), pair_rows(p), D, tid, nthreads);
        copy_rows_s8<DP, VEC>(sVc + ((i % CODES) * pairs + p) * BK * LDK, base + 2 * hd,
                              row_stride, i * BK, tile_rows(i), pair_rows(p), D, tid, nthreads);
      }
    }
    cp_async_commit();
  };
  // once this thread's copies of tile i have landed (the CODES - 1 later
  // tiles' groups may be in flight): its V codes as bf16
  auto convert_tile = [&](int i) {
    cp_async_wait<CODES - 1>();
    for (int p = 0; p < pairs; ++p) {
      convert_rows_s8<DP, VEC>(sV + ((i % VST) * pairs + p) * BK * LDV,
                               sVc + ((i % CODES) * pairs + p) * BK * LDK, tile_rows(i), tid,
                               nthreads);
    }
  };

  // prologue: Q, then tiles 0 .. CODES - 1
  for (int p = 0; p < pairs; ++p) {
    copy_rows_s8<DP, VEC>(sQ + p * rows * LDK, pair_base(p), row_stride, q0, rows,
                          pair_rows(p), D, tid, nthreads);
  }
  for (int j = 0; j < CODES; ++j) issue_tile(j);
  convert_tile(0);
  __syncthreads();

  // the int8 tiles as bf16 tiles of half the width, for the fragment helpers
  const __nv_bfloat16* sQw = reinterpret_cast<const __nv_bfloat16*>(sQ + wp * rows * LDK);
  float o[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
  float l0 = 0.0f, l1 = 0.0f;

  for (int i = 0; i < n_tiles; ++i) {
    // tile i + CODES's copies run while tile i computes: its K stage, V
    // staging buffer and (below) bf16 V stage were last read before the
    // barrier that ended tile i - 1
    if (STAGES > 1) issue_tile(i + CODES);
    if (active) {
      const int k0 = i * BK;
      const int blocks = min(BK / 16, (S - k0 + 15) / 16);
      const __nv_bfloat16* sKw =
          reinterpret_cast<const __nv_bfloat16*>(sK + ((i % STAGES) * pairs + wp) * BK * LDK);
      const __nv_bfloat16* sVw = sV + ((i % VST) * pairs + wp) * BK * LDV;
      int acc[BK / 8][4];
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0;
#pragma unroll
      for (int kk = 0; kk < DP / 32; ++kk) {
        uint32_t q[4];
        frag_rows<LDK / 2>(q, sQw, wr, kk * 16, lane);
#pragma unroll
        for (int n2 = 0; n2 < BK / 16; ++n2) {
          if (n2 < blocks) {
            uint32_t kf[4];
            frag_depth<LDK / 2>(kf, sKw, n2 * 16, kk * 16, lane);
            mma_s8(acc[2 * n2], q, kf[0], kf[1]);
            mma_s8(acc[2 * n2 + 1], q, kf[2], kf[3]);
          }
        }
      }
      uint32_t pf[BK / 16][4];
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
        const int key = k0 + n * 8 + 2 * t;
        const float p0 = key < S ? clamped_exp2(__int2float_rn(acc[n][0]), qk_log2) : 0.0f;
        const float p1 = key + 1 < S ? clamped_exp2(__int2float_rn(acc[n][1]), qk_log2) : 0.0f;
        const float p2 = key < S ? clamped_exp2(__int2float_rn(acc[n][2]), qk_log2) : 0.0f;
        const float p3 = key + 1 < S ? clamped_exp2(__int2float_rn(acc[n][3]), qk_log2) : 0.0f;
        l0 += p0 + p1;
        l1 += p2 + p3;
        pf[n / 2][(n % 2) * 2 + 0] = pack_bf16(p0, p1);
        pf[n / 2][(n % 2) * 2 + 1] = pack_bf16(p2, p3);
      }
#pragma unroll
      for (int j = 0; j < BK / 16; ++j) {
        if (j < blocks) {
#pragma unroll
          for (int nd2 = 0; nd2 < DP / 16; ++nd2) {
            uint32_t vf[4];
            frag_cols<LDV>(vf, sVw, j * 16, nd2 * 16, lane);
            mma_bf16(o[2 * nd2], pf[j], vf[0], vf[1]);
            mma_bf16(o[2 * nd2 + 1], pf[j], vf[2], vf[3]);
          }
        }
      }
    }
    if (i + 1 < n_tiles) convert_tile(i + 1);
    // publishes tile i + 1 (K by every thread's copies, V by every thread's
    // conversions) and ends every warp's reads of tile i
    __syncthreads();
  }
  if (!active) return;

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  // the TPU kernel's order: o * (v_scale / sum(p))
  const float f0 = __fdiv_rn(v_scale, l0 == 0.0f ? 1.0f : l0);
  const float f1 = __fdiv_rn(v_scale, l1 == 0.0f ? 1.0f : l1);
  store_rows<DP, float>(o, f0, f1, out, pair / H, S, hd, pair % H, D, q0 + wr + g, t);
}

using S8Kernel = void (*)(const int8_t*, const float*, float, float*, int, int, int, int, int,
                          int, int);

struct S8Launch {
  S8Kernel kernel;
  Geometry geo;
  int threads;
  size_t smem;
};

template <int DP, int STAGES>
inline size_t s8_smem_bytes(int keys, const Geometry& g) {
  const size_t int8_rows =
      (size_t)g.pairs * (16 * g.warps + (size_t)(STAGES + kCodeBufs<STAGES>) * keys);
  const size_t bf16_rows = (size_t)g.pairs * kVStages<STAGES> * keys;
  return int8_rows * kS8Ld<DP> + bf16_rows * (DP + kPad) * sizeof(__nv_bfloat16);
}

template <int DP, int VEC>
S8Launch s8_plan_vec(int S) {
  const Geometry geo = geometry(S);
  if (geo.pairs > 1) {
    return {packed_s8_kernel<DP, kShortKeys, 1, VEC>, geo, geo.pairs * geo.warps * 32,
            s8_smem_bytes<DP, 1>(kShortKeys, geo)};
  }
  return {packed_s8_kernel<DP, kLongKeys, kS8Stages, VEC>, geo, geo.warps * 32,
          s8_smem_bytes<DP, kS8Stages>(kLongKeys, geo)};
}

template <int DP>
S8Launch s8_plan_dp(int S, int D) {
  return D % 16 == 0 ? s8_plan_vec<DP, 16>(S) : s8_plan_vec<DP, 8>(S);
}

// The kernel, block size and shared memory of the ring loop at (S, D).
inline S8Launch s8_plan(int S, int D) {
  switch ((D + 31) / 32 * 32) {
    case 32: return s8_plan_dp<32>(S, D);
    case 64: return s8_plan_dp<64>(S, D);
    case 96: return s8_plan_dp<96>(S, D);
    default: return s8_plan_dp<128>(S, D);
  }
}

inline cudaError_t launch_s8(const void* qkv, const float* scales, float scale, float* out,
                             int B, int S, int H, int D, cudaStream_t stream) {
  const S8Launch l = s8_plan(S, D);
  cudaError_t err = cudaFuncSetAttribute(l.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(l.smem));
  if (err != cudaSuccess) return err;
  const long long blocks = ((long long)B * H + l.geo.pairs - 1) / l.geo.pairs * l.geo.q_blocks;
  l.kernel<<<static_cast<unsigned>(blocks), l.threads, l.smem, stream>>>(
      static_cast<const int8_t*>(qkv), scales, scale, out, B, S, H, D, l.geo.pairs,
      l.geo.warps, l.geo.q_blocks);
  return cudaGetLastError();
}

}  // namespace packed
}  // namespace stllm

namespace {

cudaError_t quantize(const float* rows, void* out_q, void* out_scale, int B, int S, int H,
                     int D, cudaStream_t st) {
  return stllm::launch_rowwise_quant(rows, static_cast<int8_t*>(out_q),
                                     static_cast<float*>(out_scale),
                                     static_cast<long long>(B) * S, H * D, st);
}

}  // namespace

// Plain C entry points, loaded with ctypes. qkv: contiguous int8 (B, S, 3*H*D),
// 16-byte aligned; scales: 3 fp32 (q, k, v) on the device; scratch: fp32
// (B, S, H*D); out_q: int8 (B, S, H*D); out_scale: fp32 (B, S). The ring
// loop takes D a multiple of 8 and at most 128; the _any entry any D >= 1 and
// S <= 1023. Both take any H*D. Each launches on ``stream`` and returns the
// CUDA error of the launches (0 on success); never synchronises.
extern "C" int stllm_packed_qkv_attention_s8(const void* qkv, const void* scales,
                                             float scale, void* scratch, void* out_q,
                                             void* out_scale, int B, int S, int H,
                                             int D, void* stream) {
  if (!stllm::packed::shape_ok(B, S, H, D)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* rows = static_cast<float*>(scratch);
  cudaError_t err = stllm::packed::launch_s8(qkv, static_cast<const float*>(scales), scale,
                                             rows, B, S, H, D, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(quantize(rows, out_q, out_scale, B, S, H, D, st));
}

extern "C" int stllm_packed_qkv_attention_s8_any(const void* qkv, const void* scales,
                                                 float scale, void* scratch, void* out_q,
                                                 void* out_scale, int B, int S, int H, int D,
                                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* rows = static_cast<float*>(scratch);
  cudaError_t err = stllm::packed_any::launch<int8_t, float, true>(
      static_cast<const int8_t*>(qkv), static_cast<const float*>(scales), scale, rows, B, S,
      H, D, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(quantize(rows, out_q, out_scale, B, S, H, D, st));
}

// The row-quant pass alone on fp32 (rows, K) (the second launch of the
// entries above, and of #2's), so that a timing can split the route.
extern "C" int stllm_rowwise_quant(const void* y, void* q, void* scale, long long rows, int K,
                                   void* stream) {
  return static_cast<int>(stllm::launch_rowwise_quant(
      static_cast<const float*>(y), static_cast<int8_t*>(q), static_cast<float*>(scale), rows,
      K, static_cast<cudaStream_t>(stream)));
}

// Resident blocks a streaming multiprocessor holds for the ring loop at
// sequence length S and head_dim D (-1 on an error).
extern "C" int stllm_packed_qkv_attention_s8_occupancy(int S, int D) {
  const stllm::packed::S8Launch l = stllm::packed::s8_plan(S, D);
  int blocks = 0;
  if (cudaFuncSetAttribute(l.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(l.smem)) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, l.kernel, l.threads, l.smem) !=
          cudaSuccess) {
    return -1;
  }
  return blocks;
}
