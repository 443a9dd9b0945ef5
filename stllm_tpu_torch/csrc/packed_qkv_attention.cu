// Packed-qkv attention for Hopper (sm_90a), bf16 in and out.
//
// Replaces stllm_tpu/ops/attention.py:_packed_qkv_kernel, the attention of
// every EVA-ViT-g trunk block and every BTAdapter temporal and spatial layer.
// It computes what that kernel computes:
//   qkv (B, S, 3*H*D), q|k|v by thirds, heads contiguous within a third
//   s   = q . k^T * scale * log2(e)                    (fp32 accumulation)
//   p   = exp2(min(s, 50) - 50)        clamped softmax numerator, no row max
//   out = (bf16(p) . v) / sum(p)       fp32 accumulation, 0 where sum(p) == 0
// Keys past S contribute p = 0; query rows past S are not stored.
//
// Bound on the H100 at the ViT-g shape (16, 257, 3*16*88): each call reads
// 34.7 MB and writes 11.6 MB, about 13.8 us at 3.35 TB/s, against 5.95 GFLOP,
// about 6 us at 989 TFLOP/s, so it is bound by memory. The design reads q, k
// and v straight from the packed rows (row stride 3*H*D) with 16-byte loads,
// so the qkv projection feeds it with no split copies; products run on the
// tensor cores (mma.sync m16n8k16, bf16 in, fp32 accumulate) with D padded
// to a multiple of 16 in shared memory. Because the softmax subtracts a fixed
// 50 and not the row maximum, one pass over the keys accumulates sum(p) and
// sum(p . v) with no online rescale.
//
// Grid (ceil(S/64), H, B); a block of 4 warps owns 64 query rows of one
// head, each warp 16 rows, and walks the keys 64 at a time. K and V tiles
// are not double-buffered, each K/V tile is read once per query tile, and the
// S = 16 temporal shape leaves three of the four warps idle; wgmma, TMA and
// a tiling for short sequences are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;                 // query rows per block
constexpr int kBK = 64;                 // keys per tile
constexpr int kWarps = 4;               // 16 query rows per warp
constexpr int kThreads = kWarps * 32;
constexpr float kClamp = 50.0f;

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

__device__ __forceinline__ float clamped_exp2(float s, float scale_log2e) {
  return exp2f(fminf(s * scale_log2e, kClamp) - kClamp);
}

// DP: head_dim padded to a multiple of 16 (the mma depth).
template <int DP>
__global__ void __launch_bounds__(kThreads)
packed_qkv_attention_kernel(const __nv_bfloat16* __restrict__ qkv,
                            __nv_bfloat16* __restrict__ out, int S, int H,
                            int D, float scale_log2e) {
  // Row strides padded by 8 bf16 so the fragment reads of the 8 row groups
  // of a warp fall in distinct shared-memory banks.
  constexpr int LDS = DP + 8;       // sQ, sK: [row][dim]
  constexpr int LDV = kBK + 8;      // sVt: [dim][key], V transposed
  __shared__ __align__(16) __nv_bfloat16 sQ[kBQ * LDS];
  __shared__ __align__(16) __nv_bfloat16 sK[kBK * LDS];
  __shared__ __align__(16) __nv_bfloat16 sVt[DP * LDV];

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;          // row group of the mma fragments
  const int t = lane & 3;           // thread within the group
  const int hd = H * D;
  const long long row_stride = 3LL * hd;
  const __nv_bfloat16* base = qkv + (long long)b * S * row_stride + (long long)h * D;
  const int vecs = D / 8;           // 16-byte vectors per head row
  const __nv_bfloat16 zero = __float2bfloat16(0.0f);
  const uint4 zero4 = make_uint4(0u, 0u, 0u, 0u);

  // Zero the padding dims once; the tile loads below never write them.
  for (int i = tid; i < kBQ * (DP - D); i += kThreads) {
    const int r = i / (DP - D);
    const int c = D + i % (DP - D);
    sQ[r * LDS + c] = zero;
    sK[r * LDS + c] = zero;
  }
  for (int i = tid; i < (DP - D) * kBK; i += kThreads) {
    sVt[(D + i / kBK) * LDV + i % kBK] = zero;
  }
  // Q tile; rows past S load as zeros and are never stored.
  for (int i = tid; i < kBQ * vecs; i += kThreads) {
    const int r = i / vecs;
    const int c = i - r * vecs;
    const int q = q0 + r;
    uint4 v = zero4;
    if (q < S) v = *reinterpret_cast<const uint4*>(base + (long long)q * row_stride + c * 8);
    *reinterpret_cast<uint4*>(&sQ[r * LDS + c * 8]) = v;
  }
  __syncthreads();

  const int wr = warp * 16;                  // this warp's first row in the tile
  const bool active = q0 + wr < S;           // warp-uniform
  uint32_t qf[DP / 16][4];
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const int col = kk * 16 + 2 * t;
    qf[kk][0] = ld_pair(&sQ[(wr + g) * LDS + col]);
    qf[kk][1] = ld_pair(&sQ[(wr + g + 8) * LDS + col]);
    qf[kk][2] = ld_pair(&sQ[(wr + g) * LDS + col + 8]);
    qf[kk][3] = ld_pair(&sQ[(wr + g + 8) * LDS + col + 8]);
  }

  float o[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
  float l0 = 0.0f, l1 = 0.0f;                // partial sum(p) of rows g, g + 8

  for (int k0 = 0; k0 < S; k0 += kBK) {
    __syncthreads();                         // the previous tile is consumed
    for (int i = tid; i < kBK * vecs; i += kThreads) {
      const int r = i / vecs;
      const int c = i - r * vecs;
      const int key = k0 + r;
      uint4 kv = zero4, vv = zero4;
      if (key < S) {
        const __nv_bfloat16* src = base + (long long)key * row_stride + c * 8;
        kv = *reinterpret_cast<const uint4*>(src + hd);
        vv = *reinterpret_cast<const uint4*>(src + 2 * hd);
      }
      *reinterpret_cast<uint4*>(&sK[r * LDS + c * 8]) = kv;
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
      for (int j = 0; j < 8; ++j) sVt[(c * 8 + j) * LDV + r] = ve[j];
    }
    __syncthreads();
    if (!active) continue;

    // s = q . k^T for this warp's 16 rows and the tile's 64 keys.
    float s[kBK / 8][4];
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
      const __nv_bfloat16* krow = &sK[(n * 8 + g) * LDS + 2 * t];
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        mma_bf16(s[n], qf[kk], ld_pair(krow + kk * 16), ld_pair(krow + kk * 16 + 8));
      }
    }
    // p, its fp32 row sums, and p in bf16 laid out as the A operand of P.V:
    // score tiles 2j and 2j+1 form k-step j.
    uint32_t pf[kBK / 16][4];
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n) {
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
    for (int nd = 0; nd < DP / 8; ++nd) {
      const __nv_bfloat16* vrow = &sVt[(nd * 8 + g) * LDV + 2 * t];
#pragma unroll
      for (int j = 0; j < kBK / 16; ++j) {
        mma_bf16(o[nd], pf[j], ld_pair(vrow + j * 16), ld_pair(vrow + j * 16 + 8));
      }
    }
  }
  if (!active) return;

  // Full row sums: the four threads of a group hold disjoint key columns.
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float d0 = l0 == 0.0f ? 1.0f : l0;
  const float d1 = l1 == 0.0f ? 1.0f : l1;
  const int qa = q0 + wr + g;
  const int qb = qa + 8;
  __nv_bfloat16* outa = out + (long long)b * S * hd + (long long)qa * hd + (long long)h * D;
  __nv_bfloat16* outb = outa + 8LL * hd;
#pragma unroll
  for (int nd = 0; nd < DP / 8; ++nd) {
    const int col = nd * 8 + 2 * t;
    if (col < D) {                           // D % 8 == 0: col + 1 < D too
      if (qa < S) {
        *reinterpret_cast<uint32_t*>(outa + col) = pack_bf16(o[nd][0] / d0, o[nd][1] / d0);
      }
      if (qb < S) {
        *reinterpret_cast<uint32_t*>(outb + col) = pack_bf16(o[nd][2] / d1, o[nd][3] / d1);
      }
    }
  }
}

template <int DP>
void launch(const void* qkv, void* out, int B, int S, int H, int D,
            float scale_log2e, cudaStream_t stream) {
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  packed_qkv_attention_kernel<DP><<<grid, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(qkv), static_cast<__nv_bfloat16*>(out),
      S, H, D, scale_log2e);
}

}  // namespace

// Plain C entry point, loaded with ctypes. qkv and out are contiguous bf16
// device buffers of (B, S, 3*H*D) and (B, S, H*D), 16-byte aligned; D is a
// multiple of 8 and at most 112 (the three tiles fit the 48 KB of static
// shared memory up to a padded head_dim of 112). Launches on ``stream`` and
// returns the CUDA error of the launch (0 on success); never synchronises.
extern "C" int stllm_packed_qkv_attention_bf16(const void* qkv, void* out, int B,
                                               int S, int H, int D,
                                               float scale_log2e, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || D <= 0 || D % 8 != 0 || D > 112 ||
      H > 65535 || B > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((D + 15) / 16 * 16) {
    case 16: launch<16>(qkv, out, B, S, H, D, scale_log2e, st); break;
    case 32: launch<32>(qkv, out, B, S, H, D, scale_log2e, st); break;
    case 48: launch<48>(qkv, out, B, S, H, D, scale_log2e, st); break;
    case 64: launch<64>(qkv, out, B, S, H, D, scale_log2e, st); break;
    case 80: launch<80>(qkv, out, B, S, H, D, scale_log2e, st); break;
    case 96: launch<96>(qkv, out, B, S, H, D, scale_log2e, st); break;
    default: launch<112>(qkv, out, B, S, H, D, scale_log2e, st); break;
  }
  return static_cast<int>(cudaGetLastError());
}
