// The weight-streaming matmul tile loop, shared by the W4A16 kernel
// (w4a16_matmul.cu) and the three weight-streaming probe kernels
// (w4v3_matmul.cu, w8p_matmul.cu, w4_unpack_matmul.cu): the form #13 and #14
// run above 16 rows, the only one of #15, and the design #12's two forms
// replaced. They differ only in how a stored weight byte becomes bf16
// weights (the MODE template argument; w4a16_decode.cuh takes the first
// three modes in registers):
//
//   out[m, n] = sum_k bf16(x[m, k]) * W[k, n]          fp32 accumulation
//
// Two-half modes (every int4 layout) hold W as a (K/2, N) byte array whose
// byte p[k, n] carries W[k, n] (the "top" code) and W[k2 + k, n] (the
// "bottom" code), k2 = K / 2 the true half-K taken from x: rows of the byte
// array at k2 and beyond are zero padding and are never read. The int8 mode
// (one half) holds W as (K, N) codes. Scaled modes multiply by a per-column
// fp32 scale in the epilogue; biased modes (the probe's p = 16 * b + (t + 8)
// layout) subtract 8 * sum_{k < k2} x[m, k] from every output of row m.
//
// Tiling: a block of 4 warps owns BM output rows and 128 output columns, each
// warp 32 columns of all BM rows, and walks its share of the weight rows 32
// at a time. Each step stages the raw weight tile (16- or 8-byte cp.async)
// and the matching x columns of both halves (16-byte cp.async) in a ring of
// ST shared-memory stages, unpacks the weight tile into one bf16 tile per
// half in shared memory, and runs the products on the tensor cores
// (mma.sync m16n8k16, bf16 in, fp32 accumulate; ldmatrix, transposed for the
// row-major weight tile). Rows past M and weight rows past k2 are zero-filled
// by cp.async and never read from device memory. BM is 16 when M <= 16
// (decode: 4 slots fill 4 of the mma's 16 rows; 4 stages, 46 KB of shared
// memory, 4 blocks an SM) and 64 otherwise (prefill: 2 stages, 47 KB).
// On the H100 the blocks an SM holds mattered more than the pipeline depth:
// deeper rings at 1-2 blocks an SM, and 128-row prefill tiles whose unpack
// 8 warps share, both measured slower.
//
// Split-K: when the output tiles alone give too few blocks for the card, the
// wrapper picks `splits` > 1; blockIdx.z walks an even share of the weight
// rows and stores raw fp32 partial sums to a (splits, M, N) buffer the
// wrapper allocates, and a second launch sums them, scales and casts.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace stllm {
namespace wsm {
// Internal linkage: every library that includes this header gets its own
// kernels, host stubs and per-device flags, even where two instantiate the
// same template.
namespace {

constexpr int kBN = 128;            // output columns per block
constexpr int kBK = 32;             // weight rows per pipeline step
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kWN = kBN / kWarps;   // output columns per warp
constexpr int kLdP = kBN + 16;      // raw weight tile row stride, bytes
constexpr int kLdX = kBK + 8;       // x tile row stride, bf16
constexpr int kLdW = kBN + 8;       // unpacked weight tile row stride, bf16
constexpr int kMaxGridY = 65535;

enum Mode : int {
  kNibble = 0,      // #12: low nibble top, high nibble bottom, two's complement
  kArith = 1,       // #13: p = 16 * bottom + top; bottom = rint(p / 16), top = p - 16 * bottom
  kInt8 = 2,        // #14: int8 (K, N) codes, converted only
  kProbeInt32 = 3,  // #15 "int32": nibble layout, int32 shifts
  kProbeInt16 = 4,  // #15 "int16": nibble layout, int16 shifts
  kProbeF32 = 5,    // #15 "f32": biased layout, fp32 floor
  kProbeBf16 = 6,   // #15 "bf16": biased layout, bf16 floor
  kProbeAnd8 = 7,   // #15 "and8": biased layout, byte and
};

template <int MODE>
struct ModeTraits {
  static constexpr int kHalves = MODE == kInt8 ? 1 : 2;
  static constexpr bool kBiased = MODE == kProbeF32 || MODE == kProbeBf16 || MODE == kProbeAnd8;
  static constexpr bool kScaled = MODE == kNibble || MODE == kArith || MODE == kInt8;
};

struct Args {
  const __nv_bfloat16* x;   // (M, ldx) bf16, the bottom half at column kw
  const int8_t* w;          // (>= kw, N) bytes
  const float* scale;       // (N,) fp32, scaled modes only
  void* out;                // (M, N) bf16, or fp32 when out_f32
  float* partial;           // (splits, M, N) fp32 when splits > 1
  int M, N, kw, ldx, splits, out_f32;
};

// --------------------------------------------------------------------------
// PTX helpers
// --------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 or 8 bytes from global to shared; src_bytes = 0 zero-fills and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a . b for one 16x8 tile, k = 16: a row-major 16x16, b column-major 16x8.
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits_of(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return bits_of(__halves2bfloat162(lo, hi));
}

// --------------------------------------------------------------------------
// unpacking one weight byte, or four
// --------------------------------------------------------------------------

// Two nibbles, in bits 0-3 of each 16-bit half, to two bf16 codes. u =
// nibble ^ 8 is code + 8 in [0, 15]; the bf16 with bits 0x4300 | u is 128 + u
// exactly (exponent 2^7, so the 7 mantissa bits count units), and subtracting
// 136 leaves the two's-complement code exactly. No int-to-float conversion.
__device__ __forceinline__ uint32_t nibbles_to_bf16x2(uint32_t pair) {
  uint32_t bits = (pair & 0x000F000Fu) ^ 0x43084308u;
  const __nv_bfloat162 v = *reinterpret_cast<__nv_bfloat162*>(&bits);
  return bits_of(__hsub2(v, __floats2bfloat162_rn(136.0f, 136.0f)));
}

// One byte p (sign-extended) to its top and bottom weights, as each probe
// variant computes them.
template <int MODE>
__device__ __forceinline__ void unpack_byte(int p, __nv_bfloat16& top, __nv_bfloat16& bot) {
  if constexpr (MODE == kArith) {
    const float pf = static_cast<float>(p);
    const float b = rintf(pf * 0.0625f);        // half to even, as the reference on any byte
    top = __float2bfloat16_rn(pf - 16.0f * b);
    bot = __float2bfloat16_rn(b);
  } else if constexpr (MODE == kInt8) {
    top = __int2bfloat16_rn(p);
    bot = top;
  } else if constexpr (MODE == kProbeInt32) {
    top = __int2bfloat16_rn(static_cast<int>(static_cast<uint32_t>(p) << 28) >> 28);
    bot = __int2bfloat16_rn(p >> 4);
  } else if constexpr (MODE == kProbeInt16) {
    const int16_t p16 = static_cast<int16_t>(p);
    top = __int2bfloat16_rn(static_cast<int16_t>(static_cast<uint16_t>(p16) << 12) >> 12);
    bot = __int2bfloat16_rn(static_cast<int16_t>(p16 >> 4));
  } else if constexpr (MODE == kProbeF32) {
    const float v = static_cast<float>(p);
    const float b = floorf(v * 0.0625f);
    top = __float2bfloat16_rn(v - 16.0f * b);   // t + 8
    bot = __float2bfloat16_rn(b);
  } else if constexpr (MODE == kProbeBf16) {
    const __nv_bfloat16 v = __int2bfloat16_rn(p);
    const __nv_bfloat16 b = hfloor(__hmul(v, __float2bfloat16_rn(0.0625f)));
    top = __hsub(v, __hmul(__float2bfloat16_rn(16.0f), b));
    bot = b;
  } else {  // kProbeAnd8
    const __nv_bfloat16 t = __int2bfloat16_rn(p & 15);
    const __nv_bfloat16 v = __int2bfloat16_rn(p);
    top = t;
    bot = __hmul(__hsub(v, t), __float2bfloat16_rn(0.0625f));
  }
}

// Four bytes (four neighbouring columns of one row) to four top and four
// bottom weights, as bf16 pairs (columns n, n + 1 and n + 2, n + 3).
template <int MODE>
__device__ __forceinline__ void unpack_word(uint32_t w, uint32_t top[2], uint32_t bot[2]) {
  if constexpr (MODE == kNibble) {
    const uint32_t lo = __byte_perm(w, 0u, 0x4140);   // bytes 0, 1 -> 16-bit halves
    const uint32_t hi = __byte_perm(w, 0u, 0x4342);   // bytes 2, 3
    top[0] = nibbles_to_bf16x2(lo);
    top[1] = nibbles_to_bf16x2(hi);
    bot[0] = nibbles_to_bf16x2(lo >> 4);
    bot[1] = nibbles_to_bf16x2(hi >> 4);
  } else {
    __nv_bfloat16 t[4], b[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      unpack_byte<MODE>(static_cast<int>(static_cast<int8_t>((w >> (8 * j)) & 0xFFu)), t[j], b[j]);
    }
    top[0] = pack2(t[0], t[1]);
    top[1] = pack2(t[2], t[3]);
    bot[0] = pack2(b[0], b[1]);
    bot[1] = pack2(b[2], b[3]);
  }
}

// The staged raw tile (kBK x kBN bytes) to one bf16 tile per half.
template <int MODE>
__device__ __forceinline__ void unpack_tile(const int8_t* sp, __nv_bfloat16* sw, int tid) {
  constexpr int kHalves = ModeTraits<MODE>::kHalves;
#pragma unroll
  for (int i = tid; i < kBK * kBN / 16; i += kThreads) {
    const int r = i / (kBN / 16);
    const int c = (i % (kBN / 16)) * 16;
    const uint4 raw = *reinterpret_cast<const uint4*>(sp + r * kLdP + c);
    const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
    uint32_t t[8], b[8];
#pragma unroll
    for (int j = 0; j < 4; ++j) unpack_word<MODE>(words[j], &t[2 * j], &b[2 * j]);
    uint4* dt = reinterpret_cast<uint4*>(sw + r * kLdW + c);
    dt[0] = make_uint4(t[0], t[1], t[2], t[3]);
    dt[1] = make_uint4(t[4], t[5], t[6], t[7]);
    if constexpr (kHalves == 2) {
      uint4* db = reinterpret_cast<uint4*>(sw + (kBK + r) * kLdW + c);
      db[0] = make_uint4(b[0], b[1], b[2], b[3]);
      db[1] = make_uint4(b[4], b[5], b[6], b[7]);
    }
  }
}

template <int MODE, int BM, int ST>
constexpr size_t smem_bytes() {
  return static_cast<size_t>(ST) * kBK * kLdP +
         sizeof(__nv_bfloat16) * (static_cast<size_t>(ST) * ModeTraits<MODE>::kHalves * BM * kLdX +
                                  static_cast<size_t>(ModeTraits<MODE>::kHalves) * kBK * kLdW) +
         sizeof(float) * BM;
}

// --------------------------------------------------------------------------
// the tile loop
// --------------------------------------------------------------------------

template <int MODE, int BM, int ST>
__global__ void __launch_bounds__(kThreads) weight_stream_kernel(const Args a) {
  using T = ModeTraits<MODE>;
  constexpr int H = T::kHalves;
  constexpr int MT = BM / 16;               // mma row tiles per warp
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* sP = reinterpret_cast<int8_t*>(smem);                                  // [ST][kBK][kLdP]
  __nv_bfloat16* sX = reinterpret_cast<__nv_bfloat16*>(smem + ST * kBK * kLdP);  // [ST][H][BM][kLdX]
  __nv_bfloat16* sW = sX + ST * H * BM * kLdX;                                   // [H][kBK][kLdW]
  float* sRow = reinterpret_cast<float*>(sW + H * kBK * kLdW);                   // [BM]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * BM;
  const int steps = (a.kw + kBK - 1) / kBK;
  const int per = (steps + a.splits - 1) / a.splits;
  const int s0 = blockIdx.z * per;
  const int nsteps = max(0, min(steps, s0 + per) - s0);
  const bool vec16 = a.N % 16 == 0;

  // Stage `step` (global index) of the weight rows and x columns into `stage`.
  auto load = [&](int step, int stage) {
    const int k0 = step * kBK;
    int8_t* dp = sP + stage * kBK * kLdP;
    if (vec16) {
      for (int i = tid; i < kBK * kBN / 16; i += kThreads) {
        const int r = i / (kBN / 16);
        const int c = (i % (kBN / 16)) * 16;
        const bool ok = k0 + r < a.kw && n0 + c < a.N;
        const int8_t* src = ok ? a.w + static_cast<long long>(k0 + r) * a.N + n0 + c : a.w;
        cp_async16(dp + r * kLdP + c, src, ok ? 16 : 0);
      }
    } else {
      for (int i = tid; i < kBK * kBN / 8; i += kThreads) {
        const int r = i / (kBN / 8);
        const int c = (i % (kBN / 8)) * 8;
        const bool ok = k0 + r < a.kw && n0 + c < a.N;
        const int8_t* src = ok ? a.w + static_cast<long long>(k0 + r) * a.N + n0 + c : a.w;
        cp_async8(dp + r * kLdP + c, src, ok ? 8 : 0);
      }
    }
    __nv_bfloat16* dx = sX + stage * H * BM * kLdX;
    for (int i = tid; i < H * BM * (kBK / 8); i += kThreads) {
      const int h = i / (BM * (kBK / 8));
      const int rem = i - h * (BM * (kBK / 8));
      const int r = rem / (kBK / 8);
      const int c = (rem % (kBK / 8)) * 8;
      const bool ok = m0 + r < a.M && k0 + c < a.kw;   // kw % 8 == 0: whole chunks
      const __nv_bfloat16* src =
          ok ? a.x + static_cast<long long>(m0 + r) * a.ldx + h * a.kw + k0 + c : a.x;
      cp_async16(dx + (h * BM + r) * kLdX + c, src, ok ? 16 : 0);
    }
  };

  float acc[MT][4][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.0f;
  float rsum = 0.0f;                        // biased modes: this thread's share of sum(x_top)
  constexpr int kTpr = kThreads / BM;       // threads per x row for that sum

#pragma unroll
  for (int s = 0; s < ST - 1; ++s) {
    if (s < nsteps) load(s0 + s, s);
    cp_async_commit();
  }
  for (int s = 0; s < nsteps; ++s) {
    cp_async_wait<ST - 2>();
    __syncthreads();                        // stage s landed; the last step's tiles are consumed
    const int stage = s % ST;
    unpack_tile<MODE>(sP + stage * kBK * kLdP, sW, tid);
    if (s + ST - 1 < nsteps) load(s0 + s + ST - 1, (s + ST - 1) % ST);
    cp_async_commit();
    __syncthreads();                        // the bf16 weight tiles are ready

    const __nv_bfloat16* xs = sX + stage * H * BM * kLdX;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
#pragma unroll
      for (int h = 0; h < H; ++h) {
        uint32_t bf[2][4];
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          ldmatrix_x4_trans(bf[np], sW + (h * kBK + kk + (lane & 15)) * kLdW + warp * kWN +
                                        np * 16 + (lane >> 4) * 8);
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          uint32_t af[4];
          ldmatrix_x4(af, xs + (h * BM + mt * 16 + (lane & 15)) * kLdX + kk + (lane >> 4) * 8);
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            mma_bf16(acc[mt][nt], af, bf[nt >> 1][(nt & 1) * 2], bf[nt >> 1][(nt & 1) * 2 + 1]);
          }
        }
      }
    }
    if constexpr (T::kBiased) {
      constexpr int kCpt = kBK / kTpr;
      const __nv_bfloat16* xr = xs + (tid / kTpr) * kLdX + (tid % kTpr) * kCpt;
#pragma unroll
      for (int c = 0; c < kCpt; ++c) rsum += __bfloat162float(xr[c]);
    }
  }
  cp_async_wait<0>();

  if constexpr (T::kBiased) {
#pragma unroll
    for (int o = kTpr / 2; o > 0; o >>= 1) rsum += __shfl_xor_sync(0xffffffffu, rsum, o);
    if (tid % kTpr == 0) sRow[tid / kTpr] = rsum;
    __syncthreads();
  }

  // Epilogue: rows m0 + mt * 16 + g (+ 8), columns n0 + warp * 32 + nt * 8 + 2t (+ 1).
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int col = n0 + warp * kWN + nt * 8 + 2 * t;
      if (col >= a.N) continue;             // N % 8 == 0: col + 1 < N too
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int rl = mt * 16 + g + 8 * hr;
        const int row = m0 + rl;
        if (row >= a.M) continue;
        float v0 = acc[mt][nt][2 * hr];
        float v1 = acc[mt][nt][2 * hr + 1];
        if constexpr (T::kBiased) {
          v0 -= 8.0f * sRow[rl];
          v1 -= 8.0f * sRow[rl];
        }
        const long long e = static_cast<long long>(row) * a.N + col;
        if (a.splits > 1) {
          *reinterpret_cast<float2*>(a.partial + static_cast<long long>(blockIdx.z) * a.M * a.N + e) =
              make_float2(v0, v1);
          continue;
        }
        if constexpr (T::kScaled) {
          v0 *= a.scale[col];
          v1 *= a.scale[col + 1];
        }
        if (a.out_f32) {
          *reinterpret_cast<float2*>(static_cast<float*>(a.out) + e) = make_float2(v0, v1);
        } else {
          *reinterpret_cast<uint32_t*>(static_cast<__nv_bfloat16*>(a.out) + e) =
              bits_of(__floats2bfloat162_rn(v0, v1));
        }
      }
    }
  }
}

// Sum the split-K partials of two neighbouring outputs, scale, cast.
template <bool SCALED>
__global__ void splitk_reduce_kernel(const Args a) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long mn = static_cast<long long>(a.M) * a.N;
  if (2 * i >= mn) return;
  const long long e = 2 * i;
  const int col = static_cast<int>(e % a.N);
  float v0 = 0.0f, v1 = 0.0f;
  for (int s = 0; s < a.splits; ++s) {
    const float2 p = *reinterpret_cast<const float2*>(a.partial + s * mn + e);
    v0 += p.x;
    v1 += p.y;
  }
  if (SCALED) {
    v0 *= a.scale[col];
    v1 *= a.scale[col + 1];
  }
  if (a.out_f32) {
    *reinterpret_cast<float2*>(static_cast<float*>(a.out) + e) = make_float2(v0, v1);
  } else {
    *reinterpret_cast<uint32_t*>(static_cast<__nv_bfloat16*>(a.out) + e) =
        bits_of(__floats2bfloat162_rn(v0, v1));
  }
}

template <int MODE, int BM, int ST>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<MODE, BM, ST>();
  static bool ready[64] = {};               // dynamic shared memory allowed, per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (!ready[dev]) {
    err = cudaFuncSetAttribute(weight_stream_kernel<MODE, BM, ST>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    ready[dev] = true;
  }
  if ((a.M + BM - 1) / BM > kMaxGridY) return cudaErrorInvalidValue;
  const dim3 grid((a.N + kBN - 1) / kBN, (a.M + BM - 1) / BM, a.splits);
  weight_stream_kernel<MODE, BM, ST><<<grid, kThreads, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.splits == 1) return err;
  const long long pairs = static_cast<long long>(a.M) * a.N / 2;
  const int threads = 256;
  splitk_reduce_kernel<ModeTraits<MODE>::kScaled>
      <<<static_cast<unsigned>((pairs + threads - 1) / threads), threads, 0, stream>>>(a);
  return cudaGetLastError();
}

// Shape checks, then the decode (BM 16, 4 stages) or prefill (BM 64, 2
// stages) instance. kw: weight rows in use (K/2 for the int4 modes, K for
// int8); the x row stride is 2 * kw or kw.
template <int MODE>
int run(const void* x, const void* w, const void* scale, void* out, void* partial, int M, int N,
        int kw, int splits, int out_f32, void* stream) {
  Args a{static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w),
         static_cast<const float*>(scale), out, static_cast<float*>(partial),
         M, N, kw, ModeTraits<MODE>::kHalves * kw, splits, out_f32};
  const int steps = (kw + kBK - 1) / kBK;
  if (M <= 0 || N <= 0 || N % 8 || kw <= 0 || kw % 8 || splits < 1 || splits > steps ||
      (splits > 1 && partial == nullptr) || (ModeTraits<MODE>::kScaled && scale == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = M <= 16 ? launch<MODE, 16, 4>(a, st) : launch<MODE, 64, 2>(a, st);
  return static_cast<int>(err);
}

}  // namespace
}  // namespace wsm
}  // namespace stllm
