// The static-int8 packed-qkv attention (#3, replacing
// stllm_tpu/ops/attention.py:_packed_qkv_s8_kernel) in the design that the
// ring loop of stllm_tpu_torch/csrc/packed_qkv_attention_s8.cu replaced. It
// is not part of the port: chip_smoke.py and script/tune_attention_loops.py
// build it (nvcc -I stllm_tpu_torch/csrc) only to time it beside the shipped
// kernel on the same inputs. Same C entry point and arguments.
//
// Design: a linear grid of 64-query-row blocks of 4 warps per (batch, head)
// pair; K and V come in through registers with 8-byte loads, one buffer,
// load -> barrier -> compute -> barrier; V is converted to bf16 and stored
// transposed one element at a time; the s8 fragments are read by scalar
// 4-byte shared loads; q . k^T on mma.sync m16n8k32 s8, P.V on m16n8k16
// bf16; fp32 rows to a scratch buffer, then the row-quant pass.

#include "mma_tiles.cuh"
#include "rowwise_quant.cuh"

namespace {

using namespace stllm;

constexpr int kBQ = 64;                 // query rows per block
constexpr int kBK = 64;                 // keys per tile
constexpr int kWarps = 4;               // 16 query rows per warp
constexpr int kThreads = kWarps * 32;
constexpr float kClamp = 50.0f;

__device__ __forceinline__ float clamped_exp2(float s, float scale_log2e) {
  return exp2f(fminf(s * scale_log2e, kClamp) - kClamp);
}

// B, S, H > 0; D a multiple of 8 and at most 128; a linear grid of
// ceil(S / 64) * H * B blocks.
inline bool shape_ok(int B, int S, int H, int D) {
  return B > 0 && S > 0 && H > 0 && D > 0 && D % 8 == 0 && D <= 128 &&
         (long long)((S + kBQ - 1) / kBQ) * H * B <= 0x7fffffffLL;
}

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t ld_word(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

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

// DP: head_dim padded to a multiple of 32 (the s8 mma depth). scales: the
// three fp32 scales (q, k, v) on the device.
template <int DP>
__global__ void __launch_bounds__(kThreads)
packed_qkv_s8_kernel(const int8_t* __restrict__ qkv, const float* __restrict__ scales,
                     float scale, float* __restrict__ out, int S, int H, int D) {
  // Row stride of 16 extra bytes: the 8 row groups of a fragment read start
  // 28 words apart, so the 32 words of one read fall in 32 banks.
  constexpr int LDQ = DP + 16;      // sQ, sK: [row][dim], int8
  constexpr int LDV = kBK + 8;      // sVt: [dim][key], bf16, V transposed
  __shared__ __align__(16) int8_t sQ[kBQ * LDQ];
  __shared__ __align__(16) int8_t sK[kBK * LDQ];
  __shared__ __align__(16) __nv_bfloat16 sVt[DP * LDV];

  // a linear grid, query tile fastest, then head, then batch
  const int q_tiles = (S + kBQ - 1) / kBQ;
  const int q0 = static_cast<int>(blockIdx.x % q_tiles) * kBQ;
  const int h = static_cast<int>(blockIdx.x / q_tiles % H);
  const int b = static_cast<int>(blockIdx.x / q_tiles / H);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int hd = H * D;
  const long long row_stride = 3LL * hd;
  const int8_t* base = qkv + (long long)b * S * row_stride + (long long)h * D;
  const int vecs = D / 8;           // 8-byte vectors per head row
  const __nv_bfloat16 zero = __float2bfloat16(0.0f);
  const uint2 zero2 = make_uint2(0u, 0u);
  // the TPU kernel's qk scale: (sq * sk * scale) in fp32, then * log2(e)
  const float qk_log2 = __fmul_rn(__fmul_rn(__fmul_rn(scales[0], scales[1]), scale), kLog2e);
  const float v_scale = scales[2];

  for (int i = tid; i < kBQ * (DP - D); i += kThreads) {
    const int r = i / (DP - D);
    const int c = D + i % (DP - D);
    sQ[r * LDQ + c] = 0;
    sK[r * LDQ + c] = 0;
  }
  for (int i = tid; i < (DP - D) * kBK; i += kThreads) {
    sVt[(D + i / kBK) * LDV + i % kBK] = zero;
  }
  for (int i = tid; i < kBQ * vecs; i += kThreads) {
    const int r = i / vecs;
    const int c = i - r * vecs;
    const int q = q0 + r;
    uint2 v = zero2;
    if (q < S) v = *reinterpret_cast<const uint2*>(base + (long long)q * row_stride + c * 8);
    *reinterpret_cast<uint2*>(&sQ[r * LDQ + c * 8]) = v;
  }
  __syncthreads();

  const int wr = warp * 16;
  const bool active = q0 + wr < S;
  uint32_t qf[DP / 32][4];
#pragma unroll
  for (int kk = 0; kk < DP / 32; ++kk) {
    const int col = kk * 32 + 4 * t;
    qf[kk][0] = ld_word(&sQ[(wr + g) * LDQ + col]);
    qf[kk][1] = ld_word(&sQ[(wr + g + 8) * LDQ + col]);
    qf[kk][2] = ld_word(&sQ[(wr + g) * LDQ + col + 16]);
    qf[kk][3] = ld_word(&sQ[(wr + g + 8) * LDQ + col + 16]);
  }

  float o[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
  float l0 = 0.0f, l1 = 0.0f;

  for (int k0 = 0; k0 < S; k0 += kBK) {
    __syncthreads();
    for (int i = tid; i < kBK * vecs; i += kThreads) {
      const int r = i / vecs;
      const int c = i - r * vecs;
      const int key = k0 + r;
      uint2 kv = zero2, vv = zero2;
      if (key < S) {
        const int8_t* src = base + (long long)key * row_stride + c * 8;
        kv = *reinterpret_cast<const uint2*>(src + hd);
        vv = *reinterpret_cast<const uint2*>(src + 2 * hd);
      }
      *reinterpret_cast<uint2*>(&sK[r * LDQ + c * 8]) = kv;
      const int8_t* ve = reinterpret_cast<const int8_t*>(&vv);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        sVt[(c * 8 + j) * LDV + r] = __int2bfloat16_rn(static_cast<int>(ve[j]));
      }
    }
    __syncthreads();
    if (!active) continue;

    uint32_t pf[kBK / 16][4];
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n) {
      int acc[4] = {0, 0, 0, 0};
      const int8_t* krow = &sK[(n * 8 + g) * LDQ + 4 * t];
#pragma unroll
      for (int kk = 0; kk < DP / 32; ++kk) {
        mma_s8(acc, qf[kk], ld_word(krow + kk * 32), ld_word(krow + kk * 32 + 16));
      }
      const int key = k0 + n * 8 + 2 * t;
      const float p0 = key < S ? clamped_exp2(__int2float_rn(acc[0]), qk_log2) : 0.0f;
      const float p1 = key + 1 < S ? clamped_exp2(__int2float_rn(acc[1]), qk_log2) : 0.0f;
      const float p2 = key < S ? clamped_exp2(__int2float_rn(acc[2]), qk_log2) : 0.0f;
      const float p3 = key + 1 < S ? clamped_exp2(__int2float_rn(acc[3]), qk_log2) : 0.0f;
      l0 += p0 + p1;
      l1 += p2 + p3;
      pf[n / 2][(n % 2) * 2 + 0] = pack_bf16(p0, p1);
      pf[n / 2][(n % 2) * 2 + 1] = pack_bf16(p2, p3);
    }
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

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  // the TPU kernel's order: o * (v_scale / sum(p))
  const float f0 = __fdiv_rn(v_scale, l0 == 0.0f ? 1.0f : l0);
  const float f1 = __fdiv_rn(v_scale, l1 == 0.0f ? 1.0f : l1);
  store_rows<DP, float>(o, f0, f1, out, b, S, hd, h, D, q0 + wr + g, t);
}

template <int DP>
void launch_s8(const void* qkv, const float* scales, float scale, float* out, int B,
               int S, int H, int D, cudaStream_t stream) {
  const long long blocks = static_cast<long long>((S + kBQ - 1) / kBQ) * H * B;
  packed_qkv_s8_kernel<DP><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const int8_t*>(qkv), scales, scale, out, S, H, D);
}

}  // namespace

// Plain C entry point, loaded with ctypes. qkv: contiguous int8 (B, S, 3*H*D),
// 16-byte aligned; scales: 3 fp32 (q, k, v) on the device; scratch: fp32
// (B, S, H*D); out_q: int8 (B, S, H*D); out_scale: fp32 (B, S). D is a
// multiple of 8 and at most 128; any H*D. Launches on ``stream`` and
// returns the CUDA error of the launches (0 on success); never
// synchronises.
extern "C" int stllm_packed_qkv_attention_s8(const void* qkv, const void* scales,
                                             float scale, void* scratch, void* out_q,
                                             void* out_scale, int B, int S, int H,
                                             int D, void* stream) {
  if (!shape_ok(B, S, H, D)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scales);
  float* rows = static_cast<float*>(scratch);
  switch ((D + 31) / 32 * 32) {
    case 32: launch_s8<32>(qkv, sc, scale, rows, B, S, H, D, st); break;
    case 64: launch_s8<64>(qkv, sc, scale, rows, B, S, H, D, st); break;
    case 96: launch_s8<96>(qkv, sc, scale, rows, B, S, H, D, st); break;
    default: launch_s8<128>(qkv, sc, scale, rows, B, S, H, D, st); break;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(stllm::launch_rowwise_quant(
      rows, static_cast<int8_t*>(out_q), static_cast<float*>(out_scale),
      static_cast<long long>(B) * S, H * D, st));
}
