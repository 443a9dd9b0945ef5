// Dynamic W8A8 matmul with per-(row, k-block) activation quantization, for
// Hopper (sm_90a): bf16 or fp32 x in, the same dtype out.
//
// Replaces stllm_tpu/ops/quant.py:_quant_matmul_kernel, the reference's fused
// dynamic-quant matmul. No model of the reference calls it; it is an op of the
// package's surface, ported as one. It computes what that kernel computes:
// for each k-block of bk columns of x (bk = K, or the 128-multiple tile the
// dispatch picks),
//   s = amax == 0 ? 1 : amax / 127;  q = rint(x / s)    (no clip: |q| <= 127)
//   acc += float(q . w_q[k-block]) * s                  (exact s32 product)
// and then out = acc * w_scale in x's dtype. The codes are __fdiv_rn's (a
// reciprocal alone would move some); the fp32 product and sum are rounded
// one by one, in the plain version's order.
//
// Bound on the H100 at the ViT-g fc1 shape ((16 x 257) x 1408 . 1408 x 6144):
// 71.1 G int8 operations, 36 us at 1,979 TOP/s, against 71 MB moved (x 11.6
// MB in bf16, the weight 8.7 MB, the output 50.5 MB: 21 us at 3.35 TB/s), so
// bound by the tensor cores; at fc2 (6144 -> 1408, three k-blocks of 2048)
// 37 us of operations against 25 us of bytes. The two-launch route below
// also writes the codes once and reads them again: its own floor adds those
// bytes (5.8 MB twice at fc1, 25.3 MB twice at fc2) to the bound's.
//
// Design: quantize once, then a TMA-fed wgmma GEMM (two launches).
// 1. The quant pass writes each (row, k-block)'s fp32 scale and its int8
//    codes to device memory: codes (M, Kp), Kp = K rounded up to 16, the
//    tail past K zero (a zero code adds nothing to the s32 sums). x is read
//    as (M n_k, bk) rows, each k-block a row of the register form of
//    rowwise_quant.cuh (a group of threads holds the row in registers, the
//    divide through the row's reciprocal with one correction, __fdiv_rn's
//    codes) where bk is whole 16-byte chunks up to 12288 (every model: 1408
//    and 2048); every other width takes one block a row, element by element.
// 2. The GEMM: both operands K-major, the codes (M, Kp) and the weight
//    stored column-major as quantize_weights leaves it, i.e. (N, Kp)
//    row-major. A CTA of two consumer warpgroups (64 rows each) and a
//    producer warpgroup (one warp of it issues the copies; setmaxnreg moves
//    its registers to the consumers) owns a 128 x BN output tile; the
//    producer feeds a ring of 128-byte K steps (the codes' 128 rows and the
//    weight's BN rows, TMA boxes in the 128-byte swizzle) under full/empty
//    mbarriers, the consumers run m64nBNk32 s8 wgmmas from shared memory
//    into s32 accumulators, one stage in flight behind the one issued; the
//    first product of each k-block overwrites the accumulators. At each
//    k-block's end the s32 sums fold into fp32
//    accumulators with that block's row scales (__int2float_rn, __fmul_rn,
//    __fadd_rn: the plain version's order; the next block's scales are
//    loaded then, under its products); with one k-block the fold is the
//    epilogue, which multiplies by w_scale (the tile's slice in shared
//    memory), casts, and, for bf16 rows of whole 16-byte multiples and
//    tiles of whole 64-column boxes, writes the tile into shared memory in
//    the 128-byte swizzle and stores it by TMA while the next tile's
//    products run (stores from registers took fc1 from 0.072 to 0.104 ms);
//    other outputs are stored from registers, masked at ragged M and N. The
//    CTAs are persistent (one an SM, walking the tiles row tile fastest), so
//    the producer loads the next tile's first stages during a tile's
//    epilogue. BN (256 or 128; 128 with more than one
//    k-block, whose fp32 accumulators double the registers) is picked per
//    call to minimise the rounds of tiles times their width.
//    Rows past M, K past Kp and weight rows past N arrive as zeros from TMA.

#include <cuda_bf16.h>

#include "hopper.cuh"
#include "rowwise_quant.cuh"

namespace {

using namespace stllm;

// ---------------------------------------------------------------------------
// 1. the quant pass
// ---------------------------------------------------------------------------

// k-block r of x (row r / n_k, block r % n_k), held by a group of TPR threads
template <typename TX, int TPR, int G>
__global__ void __launch_bounds__(kRegThreads)
block_quant_regs(const TX* __restrict__ x, int8_t* __restrict__ q, float* __restrict__ scale,
                 long long rows, int bk, int n_k, int K, int Kp) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(TX));
  __shared__ float red[kRegThreads / 32];
  const int t = threadIdx.x % TPR;
  const long long r = static_cast<long long>(blockIdx.x) * (kRegThreads / TPR) + threadIdx.x / TPR;
  const bool live = r < rows;
  const long long rr = live ? r : 0;
  const int chunks = live ? bk / kVec : 0;
  float v[G * 8];
  load_row_regs<TX, TPR, G>(x + rr * bk, chunks, t, v);
  float amax = 0.0f;                       // chunks past the row hold zeros
#pragma unroll
  for (int i = 0; i < G * 8; ++i) amax = fmaxf(amax, fabsf(v[i]));
  int8_t* qrow = q + rr / n_k * Kp + rr % n_k * bk;
  quantize_regs<TX, TPR, G>(v, amax, chunks, t, qrow, scale + rr, red);
  if (live && rr % n_k == n_k - 1 && t < Kp - K) qrow[bk + t] = 0;   // the zero tail
}

// every other width: one block a k-block, read element by element (twice)
template <typename TX>
__global__ void __launch_bounds__(kRowThreads)
block_quant_any(const TX* __restrict__ x, int8_t* __restrict__ q, float* __restrict__ scale,
                int bk, int n_k, int K, int Kp) {
  __shared__ float red[32];
  const long long r = blockIdx.x;
  const TX* src = x + r * bk;
  int8_t* qrow = q + r / n_k * Kp + r % n_k * bk;
  quantize_row_fn([&](int i) { return to_f32(src[i]); }, bk, qrow, scale + r, red);
  if (r % n_k == n_k - 1 && static_cast<int>(threadIdx.x) < Kp - K) qrow[bk + threadIdx.x] = 0;
}

bool quant_regs(int bk, int x_f32) { return bk % (x_f32 ? 4 : 8) == 0 && bk <= kRegMaxK; }

template <typename TX>
const void* quant_regs_kernel(int bk) {
  const void* fn = nullptr;
  with_reg_geometry(bk, [&](auto geo) {
    fn = reinterpret_cast<const void*>(
        block_quant_regs<TX, decltype(geo)::TPR, decltype(geo)::G>);
    return 0;
  });
  return fn;
}

int launch_quant(const void* x, int x_f32, int8_t* q, float* scale, int M, int K, int Kp,
                 int bk, cudaStream_t st) {
  const int n_k = K / bk;
  const long long rows = static_cast<long long>(M) * n_k;
  if (rows > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  return with_type(x_f32, [&](auto xt) {
    using TX = decltype(xt);
    const auto* xp = static_cast<const TX*>(x);
    if (!quant_regs(bk, x_f32)) {
      block_quant_any<TX><<<static_cast<unsigned>(rows), kRowThreads, 0, st>>>(
          xp, q, scale, bk, n_k, K, Kp);
      return static_cast<int>(cudaGetLastError());
    }
    return with_reg_geometry(bk, [&](auto geo) {
      constexpr int kRows = kRegThreads / decltype(geo)::TPR;
      block_quant_regs<TX, decltype(geo)::TPR, decltype(geo)::G>
          <<<static_cast<unsigned>((rows + kRows - 1) / kRows), kRegThreads, 0, st>>>(
              xp, q, scale, rows, bk, n_k, K, Kp);
      return static_cast<int>(cudaGetLastError());
    });
  });
}

// ---------------------------------------------------------------------------
// 2. the GEMM
// ---------------------------------------------------------------------------

// named, as qmm_res_ln.cu's cluster form: a using-directive for hopper.cuh's
// unnamed namespace at this file's unnamed scope makes nvcc's host stubs
// ambiguous
namespace gemm {

using namespace stllm::hopper;

constexpr int kBM = 128;                  // rows of a tile: two consumer warpgroups of 64
constexpr int kBK = 128;                  // K bytes a stage: one 128-byte swizzle span
constexpr int kConsumers = kBM / 64;
constexpr int kProducerWarp = 4 * kConsumers;   // the first warp of the producer warpgroup
constexpr int kThreads = (kConsumers + 1) * 128;
// registers a thread after setmaxnreg: the producer warpgroup gives its
// registers to the consumers (2 x 128 x 232 + 128 x 40 <= 65536)
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kSmemBudget = 220 * 1024;   // the ring, the staged output, the w_scale slices
constexpr int kMaxStages = 8;
constexpr int kOutBox = 64;               // output columns of a TMA store box: 128 bf16 bytes
// the tile widths, widest first: one k-block, more than one (there the
// fp32 fold accumulators double the registers). 176 columns, whose tiles
// are no whole TMA store boxes, lost to 128 at every ViT-g shape
// (script/tune_hopper_gemms.py)
constexpr int kWidths1[] = {256, 128};
constexpr int kWidthsN[] = {128};

template <int BN>
struct Layout {
  static constexpr int kABytes = kBM * kBK;                // the codes' tile
  static constexpr int kStage = kABytes + BN * kBK;        // a 1024-byte multiple
  // a bf16 output tile staged for TMA stores: kOutBox-column boxes of each
  // warpgroup's 64 rows in the 128-byte swizzle (tile widths that are whole
  // boxes)
  static constexpr bool kStaged = BN % kOutBox == 0;
  static constexpr int kBoxBytes = 64 * kOutBox * 2;
  static constexpr int kStaging = kStaged ? kBM * BN * 2 : 0;
  static constexpr int kWs = kConsumers * BN * 4;          // each warpgroup's w_scale slice
  static constexpr int kStages = (kSmemBudget - kStaging - kWs) / kStage < kMaxStages
                                     ? (kSmemBudget - kStaging - kWs) / kStage
                                     : kMaxStages;
  static constexpr size_t kSmem = 1024 + static_cast<size_t>(kStages) * kStage + kStaging +
                                  kWs + 2 * kStages * sizeof(uint64_t);
};

// The s8 wgmma shapes with hopper.cuh's operands and a scale-d operand: the
// first product of a k-block overwrites the accumulators (scale_d = 0), so no
// instruction outside wgmma writes them between two products (ptxas would
// serialise the wgmmas: its warning C7515), both descriptors K-major.
// d (64 x 128, s32) = (scale_d ? d : 0) + a (64 x 32 s8) . b (32 x 128 s8)
__device__ __forceinline__ void wgmma_m64n128k32_s8_d(int (&d)[64], uint64_t desc_a,
                                                   uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d (64 x 256, s32) = (scale_d ? d : 0) + a (64 x 32 s8) . b (32 x 256 s8)
__device__ __forceinline__ void wgmma_m64n256k32_s8_d(int (&d)[128], uint64_t desc_a,
                                                   uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

template <int BN>
__device__ __forceinline__ void wgmma_s8(int (&acc)[BN / 2], uint64_t da, uint64_t db,
                                         int scale_d) {
  if constexpr (BN == 128) {
    wgmma_m64n128k32_s8_d(acc, da, db, scale_d);
  } else {
    wgmma_m64n256k32_s8_d(acc, da, db, scale_d);
  }
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// a consumer warpgroup's release of a stage
__device__ __forceinline__ void release(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// the last k-block's sum a of an output in the plain version's order: a * s,
// added to the earlier blocks' f (kMulti)
template <bool kMulti>
__device__ __forceinline__ float fold(int a, float f, float s) {
  const float part = __fmul_rn(__int2float_rn(a), s);
  if constexpr (kMulti) {
    return __fadd_rn(f, part);
  } else {
    return part;
  }
}

// the 128 threads of consumer warpgroup wg (barrier 0 is __syncthreads)
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(wg + 1) : "memory");
}

// a 2-D TMA store of a shared-memory box; reads past the tensor's edge are
// not written
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, const void* src, int c0,
                                             int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// until this thread's TMA stores have read their shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void store_out(void* out, long long i, float a, float b, bool two,
                                          bool pairs, int out_f32) {
  if (out_f32) {
    float* o = static_cast<float*>(out) + i;
    if (two && pairs) {
      *reinterpret_cast<float2*>(o) = make_float2(a, b);
    } else {
      o[0] = a;
      if (two) o[1] = b;
    }
  } else {
    __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out) + i;
    if (two && pairs) {
      *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(a, b);
    } else {
      o[0] = __float2bfloat16_rn(a);
      if (two) o[1] = __float2bfloat16_rn(b);
    }
  }
}

// steps: 128-byte K steps of the codes' rows; spb: steps a k-block (all of
// them with one k-block)
template <int BN, bool kMulti>
__global__ void __launch_bounds__(kThreads, 1)
gemm_kernel(const __grid_constant__ CUtensorMap a_map, const __grid_constant__ CUtensorMap b_map,
            const __grid_constant__ CUtensorMap out_map, const float* __restrict__ scales,
            const float* __restrict__ ws, void* __restrict__ out, int M, int N, int steps,
            int spb, int n_k, int m_tiles, int tiles, int out_f32, int tma_out) {
  using L = Layout<BN>;
  constexpr int ST = L::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* staging = base + ST * L::kStage;
  float* ws_tile = reinterpret_cast<float*>(staging + L::kStaging);
  uint64_t* full = reinterpret_cast<uint64_t*>(ws_tile + kConsumers * BN);
  uint64_t* empty = full + ST;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  // the CTAs walk the tiles row tile fastest: tile i is row tile i % m_tiles
  // of column tile i / m_tiles
  const int first = static_cast<int>(blockIdx.x);
  const int ctas = static_cast<int>(gridDim.x);
  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);                   // the producer's expect_tx
      mbar_init(&empty[s], kConsumers);         // every consumer warpgroup
    }
    mbar_init_fence();
  }
  __syncthreads();

  int stage = 0;
  uint32_t phase = 0;
  if (warp >= kProducerWarp) {
    setmaxnreg_dec<kProducerRegs>();
    // one warp of the group issues the copies
    for (int tile = first; warp == kProducerWarp && tile < tiles; tile += ctas) {
      const int m0 = tile % m_tiles * kBM;
      const int n0 = tile / m_tiles * BN;
      for (int s = 0; s < steps; ++s) {
        mbar_wait(&empty[stage], phase ^ 1);    // a fresh barrier passes at once
        if (lane == 0) {
          unsigned char* dst = base + stage * L::kStage;
          mbar_arrive_expect_tx(&full[stage], L::kStage);
          tma_load_2d(dst, &a_map, &full[stage], s * kBK, m0);
          tma_load_2d(dst + L::kABytes, &b_map, &full[stage], s * kBK, n0);
        }
        __syncwarp();
        if (++stage == ST) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    setmaxnreg_inc<kConsumerRegs>();

    // consumer warpgroup wg owns rows [64 wg, 64 wg + 64) of the tile; lane
    // (g, t) of warp w holds rows 16 w + g and + 8, columns 8 j + 2 t and + 1
    const int wg = warp >> 2;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int ll = (warp & 3) * 16 + g;         // row of the warpgroup's 64
    const int la = wg * 64 + ll;
    const bool leader = (threadIdx.x & 127) == 0;
    const bool pairs = (N & 1) == 0;
    float* wsw = ws_tile + wg * BN;
    auto row_scale = [&](int r, int kb) {
      return r < M ? scales[static_cast<long long>(r) * n_k + kb] : 0.0f;
    };
    for (int tile = first; tile < tiles; tile += ctas) {
      const int m0 = tile % m_tiles * kBM;
      const int n0 = tile / m_tiles * BN;
      const int ra = m0 + la;
      const int rb = ra + 8;
      // the tile's w_scale slice (after every thread of the warpgroup has
      // read the last tile's) and the first k-block's row scales, ahead of
      // the products
      wg_sync(wg);
      for (int i = threadIdx.x & 127; i < BN; i += 128) wsw[i] = n0 + i < N ? ws[n0 + i] : 0.0f;
      wg_sync(wg);
      float sa = row_scale(ra, 0);
      float sb = row_scale(rb, 0);
      int acc[BN / 2];                            // each k-block's first wgmma sets them
      float facc[BN / 2];                         // kMulti only
      if constexpr (kMulti) {
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) facc[i] = 0.0f;
      }
      int prev = -1;
      for (int s = 0; s < steps; ++s) {
        mbar_wait(&full[stage], phase);
        const unsigned char* src = base + stage * L::kStage;
        const uint64_t da = desc_k_sw128(src + wg * 64 * kBK);
        const uint64_t db = desc_k_sw128(src + L::kABytes);
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < kBK / 32; ++j) wgmma_s8<BN>(acc, da + 2 * j, db + 2 * j, s % spb | j);
        wgmma_commit();
        // the end of a k-block before the last: fold its sums (kMulti)
        const bool fold = kMulti && s + 1 < steps && (s + 1) % spb == 0;
        if (fold) {
          wgmma_wait<0>();
        } else {
          wgmma_wait<1>();                        // the previous stage's products are done
        }
        if (leader) {
          if (prev >= 0) release(&empty[prev]);
          if (fold) release(&empty[stage]);
        }
        prev = fold ? -1 : stage;
        if constexpr (kMulti) {
          if (fold) {
            fence_regs(acc);
#pragma unroll
            for (int i = 0; i < BN / 2; ++i) {
              facc[i] = __fadd_rn(facc[i], __fmul_rn(__int2float_rn(acc[i]), (i & 2) ? sb : sa));
            }
            const int kb = (s + 1) / spb;         // the next k-block's row scales
            sa = row_scale(ra, kb);
            sb = row_scale(rb, kb);
          }
        }
        if (++stage == ST) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_regs(acc);
      if (leader && prev >= 0) release(&empty[prev]);

      // epilogue: the last k-block's fold, times w_scale, cast; staged and
      // stored by TMA (bf16, N a multiple of 8), else stored from registers
      if (L::kStaged && tma_out) {
        unsigned char* st = staging + wg * (L::kStaging / kConsumers);
        if (leader) bulk_wait_read();             // the last tile's stores have read it
        wg_sync(wg);
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const float2 w = *reinterpret_cast<const float2*>(wsw + 8 * j + 2 * t);
          const int i = 4 * j;
          // box j / 8, 16-byte chunk j % 8 of a 128-byte row, swizzled by the row
          unsigned char* box = st + (j / 8) * L::kBoxBytes + 4 * t;
          const int chunk = (j % 8) ^ (ll & 7);   // rows ll and ll + 8 share it
          *reinterpret_cast<__nv_bfloat162*>(box + ll * 128 + chunk * 16) = __floats2bfloat162_rn(
              __fmul_rn(fold<kMulti>(acc[i], facc[i], sa), w.x),
              __fmul_rn(fold<kMulti>(acc[i + 1], facc[i + 1], sa), w.y));
          *reinterpret_cast<__nv_bfloat162*>(box + (ll + 8) * 128 + chunk * 16) =
              __floats2bfloat162_rn(__fmul_rn(fold<kMulti>(acc[i + 2], facc[i + 2], sb), w.x),
                                    __fmul_rn(fold<kMulti>(acc[i + 3], facc[i + 3], sb), w.y));
        }
        fence_proxy_async();                      // visible to the TMA unit
        wg_sync(wg);
        if (leader) {
          for (int b = 0; b < BN / kOutBox; ++b) {
            tma_store_2d(&out_map, st + b * L::kBoxBytes, n0 + b * kOutBox, m0 + wg * 64);
          }
          bulk_commit();
        }
      } else {
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int c = n0 + 8 * j + 2 * t;
          const bool two = c + 1 < N;
          const float w0 = wsw[8 * j + 2 * t];
          const float w1 = wsw[8 * j + 2 * t + 1];
          if (c < N && ra < M) {
            store_out(out, static_cast<long long>(ra) * N + c,
                      __fmul_rn(fold<kMulti>(acc[4 * j], facc[4 * j], sa), w0),
                      __fmul_rn(fold<kMulti>(acc[4 * j + 1], facc[4 * j + 1], sa), w1), two, pairs,
                      out_f32);
          }
          if (c < N && rb < M) {
            store_out(out, static_cast<long long>(rb) * N + c,
                      __fmul_rn(fold<kMulti>(acc[4 * j + 2], facc[4 * j + 2], sb), w0),
                      __fmul_rn(fold<kMulti>(acc[4 * j + 3], facc[4 * j + 3], sb), w1), two, pairs,
                      out_f32);
          }
        }
      }
    }
    if (leader) bulk_wait();                      // the stores are done before the CTA exits
  }
}

int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
    return 0;
  }
  return n;
}

// The tile width of a call: the one whose rounds of tiles over the SMs
// times its width (the columns one SM walks) is least, the widest on a tie.
int pick_width(int M, int N, bool multi, int sms) {
  const long long m_tiles = (M + kBM - 1) / kBM;
  int best = 0;
  long long best_cost = 0;
  auto consider = [&](int bn) {
    const long long tiles = m_tiles * ((N + bn - 1) / bn);
    const long long cost = (tiles + sms - 1) / sms * bn;
    if (best == 0 || cost < best_cost) {
      best = bn;
      best_cost = cost;
    }
  };
  if (multi) {
    for (int bn : kWidthsN) consider(bn);
  } else {
    for (int bn : kWidths1) consider(bn);
  }
  return best;
}

// Calls f(Tile<BN, kMulti>{}) for the instance of tile width bn; returns
// what f returns.
template <int BN_, bool kMulti_>
struct Tile {
  static constexpr int BN = BN_;
  static constexpr bool kMulti = kMulti_;
};

template <typename F>
int with_tile(int bn, bool multi, F&& f) {
  if (multi) return f(Tile<128, true>{});
  return bn == 256 ? f(Tile<256, false>{}) : f(Tile<128, false>{});
}

template <int BN, bool kMulti>
cudaError_t set_smem() {
  return cudaFuncSetAttribute(gemm_kernel<BN, kMulti>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(Layout<BN>::kSmem));
}

int launch_gemm(const int8_t* codes, const float* scales, const int8_t* w, const float* ws,
                void* out, int M, int K, int N, int bk, int out_f32, cudaStream_t st) {
  const int Kp = (K + 15) / 16 * 16;
  const int n_k = K / bk;
  const int sms = sm_count();
  if (sms <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  CUtensorMap a_map;
  cudaError_t err = tensor_map_2d(&a_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, codes, Kp, M, Kp, kBK,
                                  kBM);
  if (err != cudaSuccess) return static_cast<int>(err);
  return with_tile(pick_width(M, N, n_k > 1, sms), n_k > 1, [&](auto tile) {
    constexpr int BN = decltype(tile)::BN;
    constexpr bool kMulti = decltype(tile)::kMulti;
    CUtensorMap b_map, out_map = {};
    cudaError_t e = tensor_map_2d(&b_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, w, Kp, N, Kp, kBK, BN);
    if (e != cudaSuccess) return static_cast<int>(e);
    // TMA stores take rows of whole 16-byte multiples
    const int tma_out = Layout<BN>::kStaged && !out_f32 && N % 8 == 0;
    if (tma_out) {
      e = tensor_map_2d(&out_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, out, N, M, 2ull * N, kOutBox,
                        64);
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    e = set_smem<BN, kMulti>();
    if (e != cudaSuccess) return static_cast<int>(e);
    const int m_tiles = (M + kBM - 1) / kBM;
    const long long tiles = static_cast<long long>(m_tiles) * ((N + BN - 1) / BN);
    if (tiles > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
    const int ctas = tiles < sms ? static_cast<int>(tiles) : sms;   // one an SM, persistent
    const int steps = (Kp + kBK - 1) / kBK;
    gemm_kernel<BN, kMulti><<<ctas, kThreads, Layout<BN>::kSmem, st>>>(
        a_map, b_map, out_map, scales, ws, out, M, N, steps, n_k > 1 ? bk / kBK : steps, n_k,
        m_tiles, static_cast<int>(tiles), out_f32, tma_out);
    return static_cast<int>(cudaGetLastError());
  });
}

bool shapes_ok(int M, int K, int bk) {
  return M >= 0 && K > 0 && bk > 0 && K % bk == 0 && (bk == K || bk % kBK == 0);
}

bool aligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace gemm

}  // namespace

// Plain C entry points, loaded with ctypes. x: (M, K) bf16 or, with x_f32,
// fp32, contiguous; codes: int8 scratch (M, Kp), Kp = K rounded up to 16;
// scales: fp32 (M, K / bk); bk divides K and, below K, is a multiple of 128.
// Every pointer 16-byte aligned. Launch on ``stream`` and return the CUDA
// error of the launches (0 on success); never synchronise.
//
// The quant pass alone: codes and scales of every (row, k-block).
extern "C" int stllm_blockwise_quant(const void* x, int x_f32, void* codes, void* scales, int M,
                                     int K, int bk, void* stream) {
  if (!gemm::shapes_ok(M, K, bk) || !gemm::aligned(x) || !gemm::aligned(codes)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (M == 0) return 0;
  return launch_quant(x, x_f32, static_cast<int8_t*>(codes), static_cast<float*>(scales), M, K,
                      (K + 15) / 16 * 16, bk, static_cast<cudaStream_t>(stream));
}

// The whole op, two launches: w int8 (N, Kp) row-major, i.e. the (K, N)
// weight column-major with its K padded by zeros to Kp; ws fp32 (N,); out
// (M, N) in x's dtype.
extern "C" int stllm_quant_matmul(const void* x, int x_f32, const void* w, const void* ws,
                                  void* codes, void* scales, void* out, int M, int K, int N,
                                  int bk, void* stream) {
  if (!gemm::shapes_ok(M, K, bk) || N <= 0 || !gemm::aligned(x) || !gemm::aligned(w) ||
      !gemm::aligned(codes) || !gemm::aligned(out)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (M == 0) return 0;
  const auto st = static_cast<cudaStream_t>(stream);
  auto* q = static_cast<int8_t*>(codes);
  auto* sc = static_cast<float*>(scales);
  const int err = launch_quant(x, x_f32, q, sc, M, K, (K + 15) / 16 * 16, bk, st);
  if (err) return err;
  return gemm::launch_gemm(q, sc, static_cast<const int8_t*>(w), static_cast<const float*>(ws),
                           out, M, K, N, bk, x_f32, st);
}

// what = 0: blocks an SM holds of the GEMM instance a call at (M, K, N, bk)
// runs; 1: its registers a thread; 2: its tile width; 3: blocks an SM of the
// quant pass's register form at bk (x_f32), 4: its registers (-1 where bk
// takes the element form). -1 on an error.
extern "C" int stllm_quant_matmul_occupancy(int M, int K, int N, int bk, int x_f32, int what) {
  if (!gemm::shapes_ok(M, K, bk) || N <= 0) return -1;
  const int sms = gemm::sm_count();
  if (sms <= 0) return -1;
  if (what == 3 || what == 4) {
    if (!quant_regs(bk, x_f32)) return -1;
    const void* fn = x_f32 ? quant_regs_kernel<float>(bk) : quant_regs_kernel<__nv_bfloat16>(bk);
    if (what == 4) {
      cudaFuncAttributes attr;
      return cudaFuncGetAttributes(&attr, fn) == cudaSuccess ? attr.numRegs : -1;
    }
    int n = -1;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fn, kRegThreads, 0) == cudaSuccess
               ? n : -1;
  }
  const bool multi = K / bk > 1;
  const int bn = gemm::pick_width(M, N, multi, sms);
  if (what == 2) return bn;
  return gemm::with_tile(bn, multi, [&](auto tile) {
    constexpr int BN = decltype(tile)::BN;
    constexpr bool kMulti = decltype(tile)::kMulti;
    if (what == 1) {
      cudaFuncAttributes attr;
      return cudaFuncGetAttributes(&attr, gemm::gemm_kernel<BN, kMulti>) == cudaSuccess
                 ? attr.numRegs : -1;
    }
    int n = -1;
    if (gemm::set_smem<BN, kMulti>() != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, gemm::gemm_kernel<BN, kMulti>,
                                                      gemm::kThreads, gemm::Layout<BN>::kSmem) !=
            cudaSuccess) {
      return -1;
    }
    return n;
  });
}
