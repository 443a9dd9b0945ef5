// LayerNorm fused with per-row int8 quantization, for Hopper (sm_90a): rows
// of bf16 or fp32 in (gamma and beta each bf16 or fp32), int8 rows plus an
// fp32 scale per row out.
//
// Replaces stllm_tpu/ops/quant.py:_ln_quant_kernel, the norm1 and norm2 of
// every trunk block of the dynamic-int8 EVA-ViT-g and of its calibration.
// It computes what that kernel computes, in its order, all in fp32:
//   mean = sum(x) / K;  var = sum((x - mean)^2) / K   (two passes over the
//   values held, no E[x^2] - mean^2)
//   y = ((x - mean) * (1 / sqrt(var + eps))) * gamma + beta
// then the row quantization of rowwise_quant.cuh (amax, s = amax / 127 or 1,
// rint(y / s) by IEEE divide, round half to even). Products and sums are
// rounded one by one (__fmul_rn, __fadd_rn), so no fused multiply-add
// changes them; build without --use_fast_math.
//
// Bound on the H100 at the trunk shape (16 x 257 rows of 1408, bf16): each
// call reads 11.6 MB of bf16 and writes 5.8 MB of int8 and 16 KB of scales,
// 17.4 MB, about 5.2 us at 3.35 TB/s. The register form runs about 28
// instructions an element, 15 of them fp32 (script/row_quant_sass.py counts
// them in the built kernel): issued in about 4.8 us at 1.98 GHz, just under
// that, so it is bound by memory. Two forms:
//
// - the register form (K a multiple of 8 for bf16 x, of 4 for fp32, up to
//   12288): a group of threads owns a row and holds it in registers
//   (rowwise_quant.cuh: one warp a row up to K = 1536, so at the trunk 8
//   rows a 256-thread block and no barrier at all; 2, 4 or 8 warps up to
//   12288, each of the three reductions then one barrier). Each thread
//   issues all its 16-byte loads of the row before any arithmetic, the
//   mean, the variance and the amax reduce by warp shuffles, gamma and beta
//   are read once per thread and row through the read-only path (they stay
//   in L1), the codes are divided by the row's scale through its
//   reciprocal (one fused correction, __fdiv_rn's codes) and go out
//   from registers, 8 an 8-byte store (4 a 4-byte store for fp32 rows).
// - the "any" form (every other K): one 256-thread block a row, the fp32
//   row staged in shared memory (the design the register form replaced, as
//   script/replaced_kernels/layer_norm_quant_row_block.cu keeps it) and read
//   element by element; a row wider than 12256 (kMaxRowK: its fp32 row
//   and the reduction's 128 bytes past 48 KB) is read from device memory
//   again in each of the four passes (mean, variance, amax, codes).

#include "rowwise_quant.cuh"

namespace {

using namespace stllm;

template <typename TX, typename TG, typename TB, int TPR, int G>
__global__ void __launch_bounds__(kRegThreads)
layer_norm_quant_regs(const TX* __restrict__ x, const TG* __restrict__ gamma,
                      const TB* __restrict__ beta, int8_t* __restrict__ q,
                      float* __restrict__ scale, long long rows, int K, float eps) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(TX)), kLoads = G * 8 / kVec;
  __shared__ float red[TPR > 32 ? 3 : 1][kRegThreads / 32];
  const int t = threadIdx.x % TPR;
  const long long r = static_cast<long long>(blockIdx.x) * (kRegThreads / TPR) + threadIdx.x / TPR;
  const bool live = r < rows;
  const int chunks = live ? K / kVec : 0;
  const long long base = (live ? r : 0) * K;
  float v[G * 8];
  load_row_regs<TX, TPR, G>(x + base, chunks, t, v);

  float sum = 0.0f;
#pragma unroll
  for (int i = 0; i < G * 8; ++i) sum += v[i];
  const float mean = __fdiv_rn(row_reduce<TPR, false>(sum, red[0]), static_cast<float>(K));
  float sq = 0.0f;
#pragma unroll
  for (int l = 0; l < kLoads; ++l) {
    const bool in = l * TPR + t < chunks;
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const float d = in ? __fsub_rn(v[l * kVec + j], mean) : 0.0f;
      v[l * kVec + j] = d;
      sq = __fadd_rn(sq, __fmul_rn(d, d));
    }
  }
  const float var = __fdiv_rn(row_reduce<TPR, false>(sq, red[TPR > 32 ? 1 : 0]),
                              static_cast<float>(K));
  const float inv = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var, eps)));
  float amax = 0.0f;
#pragma unroll
  for (int l = 0; l < kLoads; ++l) {
    const int c = l * TPR + t;
    if (c < chunks) {
      float g[kVec], b[kVec];
      load_f32<kVec>(gamma + c * kVec, g);
      load_f32<kVec>(beta + c * kVec, b);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const float y = __fadd_rn(__fmul_rn(__fmul_rn(v[l * kVec + j], inv), g[j]), b[j]);
        v[l * kVec + j] = y;
        amax = fmaxf(amax, fabsf(y));
      }
    }
  }
  quantize_regs<TX, TPR, G>(v, amax, chunks, t, q + base, scale + (live ? r : 0),
                            red[TPR > 32 ? 2 : 0]);
}

template <typename TX, typename TG, typename TB>
__global__ void __launch_bounds__(kRowThreads)
layer_norm_quant_any(const TX* __restrict__ x, const TG* __restrict__ gamma,
                     const TB* __restrict__ beta, int8_t* __restrict__ q,
                     float* __restrict__ scale, int K, float eps) {
  extern __shared__ __align__(16) float row[];     // K floats when staged
  __shared__ float red[32];
  const long long r = blockIdx.x;
  const bool staged = K <= kMaxRowK;
  const TX* src = x + r * K;
  auto xv = [&](int i) { return staged ? row[i] : to_f32(src[i]); };
  float sum = 0.0f;
  for (int i = threadIdx.x; i < K; i += kRowThreads) {
    const float f = to_f32(src[i]);
    if (staged) row[i] = f;
    sum += f;
  }
  const float mean = __fdiv_rn(block_sum(sum, red), static_cast<float>(K));
  float sq = 0.0f;
  for (int i = threadIdx.x; i < K; i += kRowThreads) {
    const float d = __fsub_rn(xv(i), mean);
    sq = __fadd_rn(sq, __fmul_rn(d, d));
  }
  const float var = __fdiv_rn(block_sum(sq, red), static_cast<float>(K));
  const float inv = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var, eps)));
  auto y = [&](int i) {
    return __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(xv(i), mean), inv), to_f32(gamma[i])),
                     to_f32(beta[i]));
  };
  if (staged) {
    for (int i = threadIdx.x; i < K; i += kRowThreads) row[i] = y(i);
    __syncthreads();
    quantize_row(row, K, q + r * K, scale + r, red);
  } else {
    quantize_row_fn(y, K, q + r * K, scale + r, red);
  }
}

// The register form's kernel for these element types at K's geometry.
template <typename TX, typename TG, typename TB>
const void* regs_kernel(int K) {
  const void* fn = nullptr;
  with_reg_geometry(K, [&](auto geo) {
    fn = reinterpret_cast<const void*>(
        layer_norm_quant_regs<TX, TG, TB, decltype(geo)::TPR, decltype(geo)::G>);
    return 0;
  });
  return fn;
}

template <typename TX, typename TG, typename TB>
int launch(const void* x, const void* gamma, const void* beta, void* q, void* scale,
           long long rows, int K, float eps, bool any, cudaStream_t stream) {
  const auto* xp = static_cast<const TX*>(x);
  const auto* gp = static_cast<const TG*>(gamma);
  const auto* bp = static_cast<const TB*>(beta);
  auto* qp = static_cast<int8_t*>(q);
  auto* sp = static_cast<float*>(scale);
  if (any) {
    const size_t smem = K <= kMaxRowK ? static_cast<size_t>(K) * sizeof(float) : 0;
    layer_norm_quant_any<TX, TG, TB><<<static_cast<unsigned>(rows), kRowThreads, smem, stream>>>(
        xp, gp, bp, qp, sp, K, eps);
    return static_cast<int>(cudaGetLastError());
  }
  return with_reg_geometry(K, [&](auto geo) {
    constexpr int kRows = kRegThreads / decltype(geo)::TPR;
    const auto blocks = static_cast<unsigned>((rows + kRows - 1) / kRows);
    layer_norm_quant_regs<TX, TG, TB, decltype(geo)::TPR, decltype(geo)::G>
        <<<blocks, kRegThreads, 0, stream>>>(xp, gp, bp, qp, sp, rows, K, eps);
    return static_cast<int>(cudaGetLastError());
  });
}

int dispatch(const void* x, const void* gamma, const void* beta, void* q, void* scale,
             long long rows, int K, float eps, int x_f32, int g_f32, int b_f32, bool any,
             void* stream) {
  const int vec = x_f32 ? 4 : 8;
  const bool regs_ok = K % vec == 0 && K <= kRegMaxK;
  if (rows < 0 || K <= 0 || rows > 2147483647LL || (!any && !regs_ok)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows == 0) return 0;
  return with_type(x_f32, [&](auto xt) {
    return with_type(g_f32, [&](auto gt) {
      return with_type(b_f32, [&](auto bt) {
        return launch<decltype(xt), decltype(gt), decltype(bt)>(
            x, gamma, beta, q, scale, rows, K, eps, any, static_cast<cudaStream_t>(stream));
      });
    });
  });
}

}  // namespace

// Plain C entry points, loaded with ctypes. x: contiguous (rows, K), bf16
// (x_f32 == 0) or fp32; gamma, beta: (K,), each bf16 or fp32 (g_f32, b_f32);
// every pointer 16-byte aligned; q: int8 (rows, K); scale: fp32 (rows,).
// Launch on ``stream`` and return the CUDA error of the launch (0 on
// success); never synchronise.
// The register form: K a multiple of 8 (bf16 x) or 4 (fp32 x), at most 12288.
extern "C" int stllm_layer_norm_quant(const void* x, const void* gamma, const void* beta,
                                      void* q, void* scale, long long rows, int K, float eps,
                                      int x_f32, int g_f32, int b_f32, void* stream) {
  return dispatch(x, gamma, beta, q, scale, rows, K, eps, x_f32, g_f32, b_f32, false, stream);
}

// The "any" form: every K >= 1.
extern "C" int stllm_layer_norm_quant_any(const void* x, const void* gamma, const void* beta,
                                          void* q, void* scale, long long rows, int K,
                                          float eps, int x_f32, int g_f32, int b_f32,
                                          void* stream) {
  return dispatch(x, gamma, beta, q, scale, rows, K, eps, x_f32, g_f32, b_f32, true, stream);
}

// The register form's instance at K (x, gamma and beta all bf16, or all
// fp32): what 0 -> blocks an SM holds at once, 1 -> registers a thread.
extern "C" int stllm_layer_norm_quant_occupancy(int K, int x_f32, int what) {
  const void* fn = x_f32 ? regs_kernel<float, float, float>(K)
                         : regs_kernel<__nv_bfloat16, __nv_bfloat16, __nv_bfloat16>(K);
  if (what == 1) {
    cudaFuncAttributes attr;
    return cudaFuncGetAttributes(&attr, fn) == cudaSuccess ? attr.numRegs : -1;
  }
  int n = -1;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fn, kRegThreads, 0);
  return n;
}
