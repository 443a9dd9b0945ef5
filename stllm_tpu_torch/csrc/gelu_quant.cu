// GELU fused with per-row int8 quantization, for Hopper (sm_90a): rows of
// bf16 or fp32 in, int8 rows plus an fp32 scale per row out.
//
// Replaces stllm_tpu/ops/quant.py:_gelu_quant_kernel, the activation between
// fc1 and fc2 of every trunk block of the dynamic-int8 EVA-ViT-g and of its
// calibration. It computes, in fp32, the GELU of torch.nn.functional.gelu
//   approx == 0:  y = (x * 0.5) * (1 + erf(x * sqrt(1/2)))     exact (erf)
//   approx != 0:  y = (x * 0.5) * (1 + tanh(sqrt(2/pi) * (x + 0.044715 x^3)))
// then the row quantization of rowwise_quant.cuh (amax, s = amax / 127 or 1,
// rint(y / s) by IEEE divide, round half to even). On the TPU the erf form
// had no lowering and ran unfused through XLA (quant.py:320-336); the
// function is the same, and this kernel serves both forms.
//
// Bound on the H100 at the trunk shape (16 x 257 rows of 6144, bf16): each
// call reads 50.5 MB of bf16 and writes 25.3 MB of int8 and 16 KB of scales,
// 75.8 MB, about 22.6 us at 3.35 TB/s. erff (tanhf) is most of the
// arithmetic: the register form runs about 37 (35) instructions an
// element, 28 (25) of them fp32 (script/row_quant_sass.py counts them in
// the built kernel), issued in about 28 (26) us at 1.98 GHz, so the
// instruction issue, not the bytes, bounds it. Two forms:
//
// - the register form (K a multiple of 8 for bf16 x, of 4 for fp32, up to
//   12288): a group of threads owns a row and holds its GELU in registers
//   (rowwise_quant.cuh: four warps a row at the trunk's K = 6144, 6 16-byte
//   loads a thread, two rows a 256-thread block; one warp a row up to K =
//   1536). Each thread issues all its loads of the row before any
//   arithmetic; the amax reduces by warp shuffles and, past one warp, one
//   exchange of a float a warp in shared memory behind one barrier; the
//   codes are divided by the row's scale through its reciprocal (one fused
//   correction, __fdiv_rn's codes) and go out from registers, 8 an
//   8-byte store (4 a 4-byte store for fp32 rows).
// - the "any" form (every other K): one 256-thread block a row, the fp32
//   GELU row staged in shared memory (the design the register form
//   replaced, as script/replaced_kernels/gelu_quant_row_block.cu keeps it)
//   and read element by element; a row wider than 12256 (kMaxRowK) is read
//   from device memory twice, once for the amax and once for the codes.

#include "rowwise_quant.cuh"

namespace {

using namespace stllm;

constexpr float kSqrtHalf = 0.70710678118654752440f;   // M_SQRT1_2
constexpr float kBeta = 0.79788456080286535588f;       // sqrt(2 / pi)
constexpr float kKappa = 0.044715f;

__device__ __forceinline__ float gelu(float x, bool approx) {
  float inner;
  if (approx) {
    const float cube = __fmul_rn(__fmul_rn(x, x), x);
    inner = tanhf(__fmul_rn(kBeta, __fadd_rn(x, __fmul_rn(kKappa, cube))));
  } else {
    inner = erff(__fmul_rn(x, kSqrtHalf));
  }
  return __fmul_rn(__fmul_rn(x, 0.5f), __fadd_rn(1.0f, inner));
}

template <typename TX, int TPR, int G, bool kApprox>
__global__ void __launch_bounds__(kRegThreads)
gelu_quant_regs(const TX* __restrict__ x, int8_t* __restrict__ q, float* __restrict__ scale,
                long long rows, int K) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(TX)), kLoads = G * 8 / kVec;
  __shared__ float red[kRegThreads / 32];
  const int t = threadIdx.x % TPR;
  const long long r = static_cast<long long>(blockIdx.x) * (kRegThreads / TPR) + threadIdx.x / TPR;
  const bool live = r < rows;
  const int chunks = live ? K / kVec : 0;
  const long long base = (live ? r : 0) * K;
  float v[G * 8];
  load_row_regs<TX, TPR, G>(x + base, chunks, t, v);
  float amax = 0.0f;
#pragma unroll
  for (int l = 0; l < kLoads; ++l) {
    if (l * TPR + t < chunks) {
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const float y = gelu(v[l * kVec + j], kApprox);
        v[l * kVec + j] = y;
        amax = fmaxf(amax, fabsf(y));
      }
    }
  }
  quantize_regs<TX, TPR, G>(v, amax, chunks, t, q + base, scale + (live ? r : 0), red);
}

template <typename TX>
__global__ void __launch_bounds__(kRowThreads)
gelu_quant_any(const TX* __restrict__ x, int8_t* __restrict__ q, float* __restrict__ scale,
               int K, int approx) {
  extern __shared__ __align__(16) float row[];     // K floats when staged
  __shared__ float red[32];
  const long long r = blockIdx.x;
  const TX* src = x + r * K;
  auto y = [&](int i) { return gelu(to_f32(src[i]), approx != 0); };
  if (K <= kMaxRowK) {
    for (int i = threadIdx.x; i < K; i += kRowThreads) row[i] = y(i);
    __syncthreads();
    quantize_row(row, K, q + r * K, scale + r, red);
  } else {
    quantize_row_fn(y, K, q + r * K, scale + r, red);
  }
}

template <typename TX, bool kApprox>
const void* regs_kernel(int K) {
  const void* fn = nullptr;
  with_reg_geometry(K, [&](auto geo) {
    fn = reinterpret_cast<const void*>(
        gelu_quant_regs<TX, decltype(geo)::TPR, decltype(geo)::G, kApprox>);
    return 0;
  });
  return fn;
}

template <typename TX, bool kApprox>
int launch_regs(const TX* x, int8_t* q, float* scale, long long rows, int K,
                cudaStream_t stream) {
  return with_reg_geometry(K, [&](auto geo) {
    constexpr int kRows = kRegThreads / decltype(geo)::TPR;
    const auto blocks = static_cast<unsigned>((rows + kRows - 1) / kRows);
    gelu_quant_regs<TX, decltype(geo)::TPR, decltype(geo)::G, kApprox>
        <<<blocks, kRegThreads, 0, stream>>>(x, q, scale, rows, K);
    return static_cast<int>(cudaGetLastError());
  });
}

int dispatch(const void* x, void* q, void* scale, long long rows, int K, int approx,
             int x_f32, bool any, void* stream) {
  const int vec = x_f32 ? 4 : 8;
  if (rows < 0 || K <= 0 || rows > 2147483647LL || (!any && (K % vec || K > kRegMaxK))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows == 0) return 0;
  auto* qp = static_cast<int8_t*>(q);
  auto* sp = static_cast<float*>(scale);
  const auto st = static_cast<cudaStream_t>(stream);
  return with_type(x_f32, [&](auto xt) {
    using TX = decltype(xt);
    const auto* xp = static_cast<const TX*>(x);
    if (any) {
      const size_t smem = K <= kMaxRowK ? static_cast<size_t>(K) * sizeof(float) : 0;
      gelu_quant_any<TX><<<static_cast<unsigned>(rows), kRowThreads, smem, st>>>(
          xp, qp, sp, K, approx);
      return static_cast<int>(cudaGetLastError());
    }
    return approx ? launch_regs<TX, true>(xp, qp, sp, rows, K, st)
                  : launch_regs<TX, false>(xp, qp, sp, rows, K, st);
  });
}

}  // namespace

// Plain C entry points, loaded with ctypes. x: contiguous (rows, K), bf16
// (x_f32 == 0) or fp32, 16-byte aligned; q: int8 (rows, K); scale: fp32
// (rows,); approx != 0 selects the tanh form. Launch on ``stream`` and
// return the CUDA error of the launch (0 on success); never synchronise.
// The register form: K a multiple of 8 (bf16 x) or 4 (fp32 x), at most 12288.
extern "C" int stllm_gelu_quant(const void* x, void* q, void* scale, long long rows, int K,
                                int approx, int x_f32, void* stream) {
  return dispatch(x, q, scale, rows, K, approx, x_f32, false, stream);
}

// The "any" form: every K >= 1.
extern "C" int stllm_gelu_quant_any(const void* x, void* q, void* scale, long long rows, int K,
                                    int approx, int x_f32, void* stream) {
  return dispatch(x, q, scale, rows, K, approx, x_f32, true, stream);
}

// The register form's erf instance at K: what 0 -> blocks an SM holds at
// once, 1 -> registers a thread.
extern "C" int stllm_gelu_quant_occupancy(int K, int x_f32, int what) {
  const void* fn = x_f32 ? regs_kernel<float, false>(K) : regs_kernel<__nv_bfloat16, false>(K);
  if (what == 1) {
    cudaFuncAttributes attr;
    return cudaFuncGetAttributes(&attr, fn) == cudaSuccess ? attr.numRegs : -1;
  }
  int n = -1;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fn, kRegThreads, 0);
  return n;
}
