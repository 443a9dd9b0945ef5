// s8 matmul with the residual add, LayerNorm and static int8 carried in its
// epilogue, for Hopper (sm_90a).
//
// Replaces stllm_tpu/ops/quant.py:_qmm_res_ln_kernel, the proj and fc2
// matmuls of the static-int8 EVA-ViT-g under STLLM_FUSED_LN (proj -> norm2,
// fc2 -> the next block's norm1). It computes what that kernel computes, in
// its order, all in fp32 after the exact s32 product:
//   y   = (acc * hs) * ws + b            acc = hq . w_q over K (s32)
//   xn  = x_prev + y;  x_new = xn in the io dtype
//   mean = sum(xn) / N;  var = sum((xn - mean)^2) / N      (two passes)
//   z   = ((xn - mean) * (1 / sqrt(var + eps))) * gamma + beta
//   yq  = clip(rint(z * (1 / out_scale)), -127, 127)
// hs is per row or one scalar (stride 0). 1 / out_scale is one IEEE divide
// of the device scalar, so no launch waits for the host. Products and sums
// are rounded one by one (__fmul_rn, __fadd_rn): no fused multiply-add
// changes them.
//
// Bound on the H100 at the ViT-g proj site ((16 x 257) x 1408 . 1408 x 1408):
// 16.3 G int8 operations (8.2 us at 1,979 TOP/s) against 36.7 MB moved (hq
// 5.8 MB, the weight 2 MB, x_prev and x_new 11.6 MB each, yq 5.8 MB: 11 us at
// 3.35 TB/s), so bound by memory; at the fc2 site (K = 6144) 71.1 G
// operations (36 us) against 63 MB (19 us), bound by the tensor cores.
//
// Design. The LayerNorm needs whole output rows, so a block of 8 warps owns
// 16 rows and all N columns: warp w holds columns [w N/8, (w + 1) N/8) as
// N/64 n8-tiles of s32 accumulators in registers (22 tiles, 88 registers, at
// N = 1408), and 4,112 rows make 257 blocks. Each lane feeds its products
// with its own 16 bytes of A rows g, g + 8 and of each tile's weight column
// per 64 bytes of K (s8_matmul.cuh). Those bytes come in by cp.async into a
// two-stage ring in shared memory that is private to the lane (it reads back
// only what it copied, so no barrier guards the ring): the next step's
// 24 chunks a lane, 196 KB a block at N = 1408, are in flight while the
// current step multiplies. (The first design loaded them into registers: 22
// loads in flight a lane, 2.16 ms at the fc2 site.) The weight is read
// column-major, (N, K) in memory, as quantize_weights stores it; every block
// reads all of it, from L2 after the first. At the k-exit each thread turns
// its accumulators into xn, writes x_new, and the row statistics reduce over
// the quad, then over the 8 warps through shared memory, the mean first and
// then the centred sum of squares. No wgmma or TMA yet: that is later work.
//
// Rows wider than 1536 columns (the registers and the ring of one pass) take
// qmm_res_ln_wide_kernel, still one launch: the block walks N in equal
// chunks of at most 1536 columns, stages xn in an fp32 scratch row the
// wrapper allocates (M x N, at most 4 MiB a sample by the dispatch rule),
// and takes the mean, the centred variance and the codes from it afterwards.
// The 1408-wide ViT-g sites never take it.
//
// The cluster form (qmm_res_ln_cluster_kernel), which the ViT-g sites take
// (ops/kernels.py:qmm_res_ln_form: N = 8 x 128, 8 x 176 or 8 x 256). The
// 16-row blocks above each read the whole weight, from L2 after the first,
// about 2.2 GB of L2 traffic at fc2 over 257 blocks, and run mma.sync. Here
// a cluster of 8 CTAs owns 128 rows and each CTA a 1/8 slice of N (176
// columns at N = 1408), so a CTA reads only its slice of the weight and
// each weight byte crosses L2 once per 128 rows. Per 128-byte step of K a
// producer warp loads the CTA's (slice, 128) weight tile by TMA and 16 of
// the 128 hq rows by TMA multicast to all 8 CTAs, so each hq tile crosses
// L2 once per cluster; both operands are K-major as the s8 wgmma requires
// (hq (M, K) row-major, the weight (N, K) row-major, the layout
// quantize_weights stores), in the 128-byte swizzle, through a 4-stage ring
// whose full mbarriers count the bytes and whose empty mbarriers count the
// 16 consumer warpgroups of the cluster (remote arrives). Two consumer
// warpgroups each run m64nSk32 s8 wgmmas (S = the slice) into s32
// accumulators: 64 rows by S columns. At the k-exit each thread makes
// y, xn and x_new for its columns as the kernel above does; the row sums of
// each CTA's slice reduce over the quad and land in shared memory, every
// CTA reads the 8 partials of its rows through distributed shared memory
// (mapa, in rank order, so all 8 get the same mean) after a cluster
// barrier, then the same for the centred sum of squares, then the codes.
// One launch (cudaLaunchKernelEx with the cluster dimension).

#include <cuda_bf16.h>

#include "hopper.cuh"
#include "s8_matmul.cuh"

namespace {

using namespace stllm::s8mm;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 16;             // rows a block owns
constexpr int kStages = 2;            // steps of the cp.async ring
constexpr int kChunk = 1536;          // widest row one pass holds (24 n8-tiles a warp)

// Columns of each chunk of a wide row: the fewest chunks of at most kChunk
// columns, equal widths in multiples of 128 (the last may be narrower).
__host__ __device__ inline int chunk_width(int N) {
  const int chunks = (N + kChunk - 1) / kChunk;
  return (N / 128 + chunks - 1) / chunks * 128;
}

// Bytes of dynamic shared memory for a launch with nt n8-tiles a warp: per
// stage, per warp, nt weight chunks and 2 activation chunks of 32 lanes x 16.
inline size_t ring_bytes(int nt) {
  return static_cast<size_t>(kStages) * kWarps * (nt + 2) * 32 * sizeof(uint4);
}

__device__ __forceinline__ float2 load_pair(const void* base, long long i, int f32) {
  if (f32) return *reinterpret_cast<const float2*>(static_cast<const float*>(base) + i);
  return __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(static_cast<const __nv_bfloat16*>(base) + i));
}

__device__ __forceinline__ void store_pair(void* base, long long i, float a, float b,
                                           int f32) {
  if (f32) {
    *reinterpret_cast<float2*>(static_cast<float*>(base) + i) = make_float2(a, b);
  } else {
    *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(base) + i) =
        __floats2bfloat162_rn(a, b);
  }
}

// The 16-row sum of a per-thread partial (rows g and g + 8), over the quad's
// 4 lanes and then the 8 warps; every thread gets its two rows' totals, summed
// in one order.
__device__ __forceinline__ void row_sums(float& a, float& b, float (*red)[kRows], int warp,
                                         int g, int t) {
  a += __shfl_xor_sync(0xffffffffu, a, 1);
  a += __shfl_xor_sync(0xffffffffu, a, 2);
  b += __shfl_xor_sync(0xffffffffu, b, 1);
  b += __shfl_xor_sync(0xffffffffu, b, 2);
  if (t == 0) {
    red[warp][g] = a;
    red[warp][g + 8] = b;
  }
  __syncthreads();
  a = 0.0f;
  b = 0.0f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    a += red[w][g];
    b += red[w][g + 8];
  }
}

// xn = x_prev + ((acc * hs) * ws + bias) of rows a, b (elements oa, ob on)
// at columns c and c + 1, each product and sum rounded on its own.
__device__ __forceinline__ void residual(float (&v)[4], const int (&acc)[4], float ha, float hb,
                                         int c, const float* ws, const float* bias,
                                         const void* x_prev, long long oa, long long ob, bool va,
                                         bool vb, int io_f32) {
  const float w0 = ws[c], w1 = ws[c + 1];
  const float b0 = bias ? bias[c] : 0.0f;
  const float b1 = bias ? bias[c + 1] : 0.0f;
  const float2 xa = va ? load_pair(x_prev, oa + c, io_f32) : make_float2(0.0f, 0.0f);
  const float2 xb = vb ? load_pair(x_prev, ob + c, io_f32) : make_float2(0.0f, 0.0f);
  v[0] = __fadd_rn(xa.x, __fadd_rn(__fmul_rn(__fmul_rn(__int2float_rn(acc[0]), ha), w0), b0));
  v[1] = __fadd_rn(xa.y, __fadd_rn(__fmul_rn(__fmul_rn(__int2float_rn(acc[1]), ha), w1), b1));
  v[2] = __fadd_rn(xb.x, __fadd_rn(__fmul_rn(__fmul_rn(__int2float_rn(acc[2]), hb), w0), b0));
  v[3] = __fadd_rn(xb.y, __fadd_rn(__fmul_rn(__fmul_rn(__int2float_rn(acc[3]), hb), w1), b1));
}

// The row's code of z = ((xn - mean) * inv) * gamma + beta, times 1 / out_scale.
__device__ __forceinline__ int8_t ln_code(float xn, float mean, float inv, float gamma,
                                          float beta, float inv_os) {
  return clip_code(__fmul_rn(__fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(xn, mean), inv), gamma),
                                       beta), inv_os));
}

// The K loop of one block: acc (this lane's NT n8-tiles, nt in use) += the
// product of A rows ra, rb (pa, pb: their bytes 16t on) and the weight
// columns of the warp's tiles (pw: column col0 + g, byte 16t), through the
// lane's two-stage cp.async ring.
template <int NT>
__device__ __forceinline__ void k_loop(int (&acc)[NT][4], uint4* ring, const int8_t* pa,
                                       const int8_t* pb, const int8_t* pw, bool va, bool vb,
                                       int K, int nt, int warp, int lane, int t) {
  const long long tile = 8LL * K;      // from one n8-tile's column g to the next's
  // the lane's slots of the ring: chunk c of stage s at mine[s * stage + c * 32]
  const int stage = kWarps * (nt + 2) * 32;
  uint4* mine = ring + warp * (nt + 2) * 32 + lane;

  // start the copies of the step at k0 into stage s; chunks past K or of rows
  // past M are zero-filled (K % 16 == 0: a 16-byte chunk is all in or out)
  auto fetch = [&](int k0, int s) {
    uint4* dst = mine + s * stage;
    const bool in = k0 + 16 * t < K;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j < nt) cp_async16(dst + j * 32, in ? pw + j * tile + k0 : pw, in);
    }
    cp_async16(dst + nt * 32, va && in ? pa + k0 : pa, va && in);
    cp_async16(dst + (nt + 1) * 32, vb && in ? pb + k0 : pb, vb && in);
    cp_async_commit();
  };

#pragma unroll
  for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0;

  const int steps = (K + 63) / 64;
  fetch(0, 0);
  for (int i = 0; i < steps; ++i) {
    if (i + 1 < steps) {
      __syncwarp();                    // the stage refilled now was read in step i - 1
      fetch((i + 1) * 64, (i + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    const uint4* src = mine + (i & 1) * stage;
    const uint4 lo = src[nt * 32];
    const uint4 hi = src[(nt + 1) * 32];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j < nt) mma_step64(acc[j], lo, hi, src[j * 32]);
    }
  }
}

// NT: the most n8-tiles a warp holds; the launch's N / 64 <= NT.
template <int NT>
__global__ void __launch_bounds__(kThreads, 1)
qmm_res_ln_kernel(const int8_t* __restrict__ hq, const float* __restrict__ hs, int hs_step,
                  const int8_t* __restrict__ w, const float* __restrict__ ws,
                  const float* __restrict__ bias, const void* __restrict__ x_prev,
                  const float* __restrict__ gamma, const float* __restrict__ beta,
                  const float* __restrict__ out_scale, void* __restrict__ x_new,
                  int8_t* __restrict__ yq, int M, int K, int N, float eps, int io_f32) {
  extern __shared__ uint4 ring[];
  __shared__ float red[2][kWarps][kRows];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int nt = N / (8 * kWarps);
  const int col0 = warp * nt * 8;
  const int ra = blockIdx.x * kRows + g;
  const int rb = ra + 8;
  const bool va = ra < M;
  const bool vb = rb < M;
  const int8_t* pa = hq + (long long)(va ? ra : 0) * K + 16 * t;
  const int8_t* pb = hq + (long long)(vb ? rb : 0) * K + 16 * t;
  const int8_t* pw = w + (long long)(col0 + g) * K + 16 * t;

  int acc[NT][4];
  k_loop<NT>(acc, ring, pa, pb, pw, va, vb, K, nt, warp, lane, t);

  // k-exit: y, the residual add and x_new; the first pass of the statistics
  const float ha = va ? hs[(long long)ra * hs_step] : 0.0f;
  const float hb = vb ? hs[(long long)rb * hs_step] : 0.0f;
  const long long oa = (long long)ra * N;
  const long long ob = (long long)rb * N;
  float v[NT][4];
  float sa = 0.0f, sb = 0.0f;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (j < nt) {
      const int c = col0 + j * 8 + 2 * t;
      residual(v[j], acc[j], ha, hb, c, ws, bias, x_prev, oa, ob, va, vb, io_f32);
      if (va) store_pair(x_new, oa + c, v[j][0], v[j][1], io_f32);
      if (vb) store_pair(x_new, ob + c, v[j][2], v[j][3], io_f32);
      sa += v[j][0] + v[j][1];
      sb += v[j][2] + v[j][3];
    }
  }
  row_sums(sa, sb, red[0], warp, g, t);
  const float fn = static_cast<float>(N);
  const float mean_a = __fdiv_rn(sa, fn);
  const float mean_b = __fdiv_rn(sb, fn);

  // the second pass: the centred sum of squares
  float qa = 0.0f, qb = 0.0f;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (j < nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float da = __fsub_rn(v[j][e], mean_a);
        const float db = __fsub_rn(v[j][2 + e], mean_b);
        qa = __fadd_rn(qa, __fmul_rn(da, da));
        qb = __fadd_rn(qb, __fmul_rn(db, db));
      }
    }
  }
  row_sums(qa, qb, red[1], warp, g, t);
  const float inv_a = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(__fdiv_rn(qa, fn), eps)));
  const float inv_b = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(__fdiv_rn(qb, fn), eps)));
  const float inv_os = __fdiv_rn(1.0f, out_scale[0]);

  // normalize, affine, static int8
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (j < nt) {
      const int c = col0 + j * 8 + 2 * t;
      int8_t code[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float mean = e < 2 ? mean_a : mean_b;
        const float inv = e < 2 ? inv_a : inv_b;
        const int cc = c + (e & 1);
        code[e] = ln_code(v[j][e], mean, inv, gamma[cc], beta[cc], inv_os);
      }
      if (va) *reinterpret_cast<char2*>(yq + oa + c) = make_char2(code[0], code[1]);
      if (vb) *reinterpret_cast<char2*>(yq + ob + c) = make_char2(code[2], code[3]);
    }
  }
}

// N > kChunk: the block walks N in chunks of at most kChunk columns (equal
// widths, multiples of 128). Per chunk it runs the K loop for the chunk's
// columns, writes x_new and stages xn in fp32 in ``staged`` (M, N), and adds
// to its row sums; then the centred sum of squares and the codes come from
// the staged rows. Each thread reads back only what it wrote, so no barrier
// guards the staging; one guards the ring between chunks, whose lane slots
// move when the chunk width does.
template <int NT>
__global__ void __launch_bounds__(kThreads, 1)
qmm_res_ln_wide_kernel(const int8_t* __restrict__ hq, const float* __restrict__ hs,
                       int hs_step, const int8_t* __restrict__ w, const float* __restrict__ ws,
                       const float* __restrict__ bias, const void* __restrict__ x_prev,
                       const float* __restrict__ gamma, const float* __restrict__ beta,
                       const float* __restrict__ out_scale, void* __restrict__ x_new,
                       int8_t* __restrict__ yq, float* __restrict__ staged, int M, int K, int N,
                       float eps, int io_f32) {
  extern __shared__ uint4 ring[];
  __shared__ float red[2][kWarps][kRows];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int ra = blockIdx.x * kRows + g;
  const int rb = ra + 8;
  const bool va = ra < M;
  const bool vb = rb < M;
  const int8_t* pa = hq + (long long)(va ? ra : 0) * K + 16 * t;
  const int8_t* pb = hq + (long long)(vb ? rb : 0) * K + 16 * t;
  const float ha = va ? hs[(long long)ra * hs_step] : 0.0f;
  const float hb = vb ? hs[(long long)rb * hs_step] : 0.0f;
  const long long oa = (long long)ra * N;
  const long long ob = (long long)rb * N;
  const int width = chunk_width(N);
  // the n8-tiles of this warp in the chunk at c0, and the first one's column
  auto tiles = [&](int c0) { return min(width, N - c0) / (8 * kWarps); };

  float sa = 0.0f, sb = 0.0f;
  for (int c0 = 0; c0 < N; c0 += width) {
    const int nt = tiles(c0);
    const int col0 = c0 + warp * nt * 8;
    int acc[NT][4];
    __syncthreads();                   // every lane is done with the previous chunk's ring
    k_loop<NT>(acc, ring, pa, pb, w + (long long)(col0 + g) * K + 16 * t, va, vb, K, nt, warp,
               lane, t);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j < nt) {
        const int c = col0 + j * 8 + 2 * t;
        float v[4];
        residual(v, acc[j], ha, hb, c, ws, bias, x_prev, oa, ob, va, vb, io_f32);
        if (va) {
          store_pair(x_new, oa + c, v[0], v[1], io_f32);
          *reinterpret_cast<float2*>(staged + oa + c) = make_float2(v[0], v[1]);
        }
        if (vb) {
          store_pair(x_new, ob + c, v[2], v[3], io_f32);
          *reinterpret_cast<float2*>(staged + ob + c) = make_float2(v[2], v[3]);
        }
        sa += v[0] + v[1];
        sb += v[2] + v[3];
      }
    }
  }
  row_sums(sa, sb, red[0], warp, g, t);
  const float fn = static_cast<float>(N);
  const float mean_a = __fdiv_rn(sa, fn);
  const float mean_b = __fdiv_rn(sb, fn);

  // this thread's staged values: xn of rows a, b at columns c, c + 1
  auto staged_at = [&](int c, float (&v)[4]) {
    const float2 a = va ? *reinterpret_cast<const float2*>(staged + oa + c) : make_float2(0.f, 0.f);
    const float2 b = vb ? *reinterpret_cast<const float2*>(staged + ob + c) : make_float2(0.f, 0.f);
    v[0] = a.x;
    v[1] = a.y;
    v[2] = b.x;
    v[3] = b.y;
  };
  float qa = 0.0f, qb = 0.0f;
  for (int c0 = 0; c0 < N; c0 += width) {
    const int nt = tiles(c0);
    for (int j = 0; j < nt; ++j) {
      float v[4];
      staged_at(c0 + (warp * nt + j) * 8 + 2 * t, v);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float da = __fsub_rn(v[e], mean_a);
        const float db = __fsub_rn(v[2 + e], mean_b);
        qa = __fadd_rn(qa, __fmul_rn(da, da));
        qb = __fadd_rn(qb, __fmul_rn(db, db));
      }
    }
  }
  row_sums(qa, qb, red[1], warp, g, t);
  const float inv_a = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(__fdiv_rn(qa, fn), eps)));
  const float inv_b = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(__fdiv_rn(qb, fn), eps)));
  const float inv_os = __fdiv_rn(1.0f, out_scale[0]);

  for (int c0 = 0; c0 < N; c0 += width) {
    const int nt = tiles(c0);
    for (int j = 0; j < nt; ++j) {
      const int c = c0 + (warp * nt + j) * 8 + 2 * t;
      float v[4];
      staged_at(c, v);
      int8_t code[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int cc = c + (e & 1);
        code[e] = e < 2 ? ln_code(v[e], mean_a, inv_a, gamma[cc], beta[cc], inv_os)
                        : ln_code(v[e], mean_b, inv_b, gamma[cc], beta[cc], inv_os);
      }
      if (va) *reinterpret_cast<char2*>(yq + oa + c) = make_char2(code[0], code[1]);
      if (vb) *reinterpret_cast<char2*>(yq + ob + c) = make_char2(code[2], code[3]);
    }
  }
}

template <int NT>
cudaError_t launch(const void* hq, const float* hs, int hs_step, const void* w, const float* ws,
                   const float* bias, const void* x_prev, const float* gamma, const float* beta,
                   const float* out_scale, void* x_new, void* yq, float* staged, int M, int K,
                   int N, float eps, int io_f32, cudaStream_t stream) {
  const bool wide = N > kChunk;
  const size_t smem = ring_bytes((wide ? chunk_width(N) : N) / 64);
  const dim3 grid((M + kRows - 1) / kRows);
  if (wide) {
    cudaError_t err = cudaFuncSetAttribute(qmm_res_ln_wide_kernel<NT>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    qmm_res_ln_wide_kernel<NT><<<grid, kThreads, smem, stream>>>(
        static_cast<const int8_t*>(hq), hs, hs_step, static_cast<const int8_t*>(w), ws, bias,
        x_prev, gamma, beta, out_scale, x_new, static_cast<int8_t*>(yq), staged, M, K, N, eps,
        io_f32);
    return cudaGetLastError();
  }
  cudaError_t err = cudaFuncSetAttribute(
      qmm_res_ln_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  qmm_res_ln_kernel<NT><<<grid, kThreads, smem, stream>>>(
      static_cast<const int8_t*>(hq), hs, hs_step, static_cast<const int8_t*>(w), ws, bias,
      x_prev, gamma, beta, out_scale, x_new, static_cast<int8_t*>(yq), M, K, N, eps, io_f32);
  return cudaGetLastError();
}


// --------------------------------------------------------------------------
// the cluster form
// --------------------------------------------------------------------------

namespace cl {

using namespace stllm::hopper;

constexpr int kC = 8;                 // CTAs a cluster, along N
constexpr int kBM = 128;              // rows a cluster owns
constexpr int kConsumers = kBM / 64;  // warpgroups, 64 rows each
constexpr int kBK = 128;              // K bytes a stage: one swizzle span
constexpr int kStages = 4;
constexpr int kBlocksPerSM = 1;
constexpr int kPiece = kBM / kC;      // hq rows each CTA multicasts
constexpr int kProducerWarp = 4 * kConsumers;
constexpr int kThreads = kConsumers * 128 + 32;

template <int S>
struct Layout {
  static constexpr int kABytes = kBM * kBK;           // the hq tile
  static constexpr int kBBytes = S * kBK;             // the weight slice's tile
  static constexpr int kStage = kABytes + kBBytes;    // a 1024-byte multiple
  static constexpr size_t kSmem =
      1024 + static_cast<size_t>(kStages) * kStage + 2 * kStages * sizeof(uint64_t);
};

template <int S>
__device__ __forceinline__ void wgmma_s8(int (&acc)[S / 2], uint64_t da, uint64_t db) {
  if constexpr (S == 128) {
    wgmma_m64n128k32_s8(acc, da, db);
  } else if constexpr (S == 176) {
    wgmma_m64n176k32_s8(acc, da, db);
  } else {
    wgmma_m64n256k32_s8(acc, da, db);
  }
}

// S: the columns of each CTA's slice, N / 8.
template <int S>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
qmm_res_ln_cluster_kernel(const __grid_constant__ CUtensorMap hq_map,
                          const __grid_constant__ CUtensorMap w_map, const float* __restrict__ hs,
                          int hs_step, const float* __restrict__ ws,
                          const float* __restrict__ bias, const void* __restrict__ x_prev,
                          const float* __restrict__ gamma, const float* __restrict__ beta,
                          const float* __restrict__ out_scale, void* __restrict__ x_new,
                          int8_t* __restrict__ yq, int M, int K, int N, float eps, int io_f32) {
  using L = Layout<S>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ float red_sum[kBM], red_sq[kBM];
  __shared__ float v_ws[S], v_bias[S], v_gamma[S], v_beta[S];   // this slice's columns
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + kStages * L::kStage);
  uint64_t* empty = full + kStages;

  const uint32_t rank = cluster_rank();
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int m0 = blockIdx.y * kBM;
  const int steps = (K + kBK - 1) / kBK;
  const bool consumer = warp < kProducerWarp;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);                   // the producer's expect_tx
      mbar_init(&empty[s], kConsumers * kC);    // every consumer warpgroup of the cluster
    }
    mbar_init_fence();
  }
  for (int i = threadIdx.x; i < S; i += kThreads) {
    const int c = static_cast<int>(rank) * S + i;
    v_ws[i] = ws[c];
    v_bias[i] = bias ? bias[c] : 0.0f;
    v_gamma[i] = gamma[c];
    v_beta[i] = beta[c];
  }
  cluster_sync();                               // the cluster's barriers and vectors ready

  // consumer warpgroup wg owns rows [64 wg, 64 wg + 64); lane (g, t) of warp
  // w holds rows 16 w + g and + 8, columns 8 j + 2 t and + 1 of the slice
  const int wg = warp >> 2;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int la = wg * 64 + (warp & 3) * 16 + g;
  const int lb = la + 8;
  const int ra = m0 + la;
  const int rb = m0 + lb;
  const bool va = consumer && ra < M;
  const bool vb = consumer && rb < M;
  int acc[S / 2];
#pragma unroll
  for (int i = 0; i < S / 2; ++i) acc[i] = 0;

  if (warp == kProducerWarp) {
    // the whole warp walks the ring and lane 0 issues the copies: a warp
    // whose lanes split between this loop and the cluster barriers below
    // would run those .aligned barriers diverged
    int stage = 0;
    uint32_t phase = 0;
    for (int s = 0; s < steps; ++s) {
      mbar_wait(&empty[stage], phase ^ 1);      // a fresh barrier passes at once
      if (lane == 0) {
        unsigned char* dst = base + stage * L::kStage;
        mbar_arrive_expect_tx(&full[stage], L::kStage);
        tma_load_2d_multicast(dst + rank * kPiece * kBK, &hq_map, &full[stage],
                              static_cast<uint16_t>((1u << kC) - 1), s * kBK,
                              m0 + static_cast<int>(rank) * kPiece);
        tma_load_2d(dst + L::kABytes, &w_map, &full[stage], s * kBK, static_cast<int>(rank) * S);
      }
      __syncwarp();
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
  } else {
    int stage = 0, prev = -1;
    uint32_t phase = 0;
    for (int s = 0; s < steps; ++s) {
      mbar_wait(&full[stage], phase);
      const unsigned char* src = base + stage * L::kStage;
      const uint64_t da = desc_k_sw128(src + wg * 64 * kBK);
      const uint64_t db = desc_k_sw128(src + L::kABytes);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < kBK / 32; ++j) wgmma_s8<S>(acc, da + 2 * j, db + 2 * j);
      wgmma_commit();
      wgmma_wait<1>();                          // the previous stage's products are done
      if (prev >= 0 && (threadIdx.x & 127) == 0) {
        for (int r = 0; r < kC; ++r) mbar_arrive_cluster(&empty[prev], r);
      }
      __syncwarp();
      prev = stage;
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    fence_regs(acc);
  }

  // k-exit: y, the residual add and x_new; this slice's row sums. x_prev
  // is read 8 n8-tiles at a time, all 16 loads in flight before the first
  // store, and the per-column vectors come from shared memory.
  constexpr int kTiles = S / 8;                          // n8-tiles of the slice
  constexpr int kGroup = 8;
  const int c0 = static_cast<int>(rank) * S + 2 * t;     // this thread's first column
  const float ha = va ? hs[static_cast<long long>(ra) * hs_step] : 0.0f;
  const float hb = vb ? hs[static_cast<long long>(rb) * hs_step] : 0.0f;
  const long long oa = static_cast<long long>(ra) * N;
  const long long ob = static_cast<long long>(rb) * N;
  float v[kTiles][4];
  if (consumer) {
    float sa = 0.0f, sb = 0.0f;
#pragma unroll
    for (int j0 = 0; j0 < kTiles; j0 += kGroup) {
      float2 xa[kGroup], xb[kGroup];
#pragma unroll
      for (int i = 0; i < kGroup && j0 + i < kTiles; ++i) {
        const int c = c0 + 8 * (j0 + i);
        xa[i] = va ? load_pair(x_prev, oa + c, io_f32) : make_float2(0.0f, 0.0f);
        xb[i] = vb ? load_pair(x_prev, ob + c, io_f32) : make_float2(0.0f, 0.0f);
      }
#pragma unroll
      for (int i = 0; i < kGroup && j0 + i < kTiles; ++i) {
        const int j = j0 + i;
        const float x[4] = {xa[i].x, xa[i].y, xb[i].x, xb[i].y};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int lc = 8 * j + 2 * t + (e & 1);        // column within the slice
          const float h = e < 2 ? ha : hb;
          // xn = x_prev + ((acc * hs) * ws + bias), each step rounded on its own
          v[j][e] = __fadd_rn(x[e], __fadd_rn(__fmul_rn(__fmul_rn(__int2float_rn(acc[4 * j + e]),
                                                                  h), v_ws[lc]), v_bias[lc]));
        }
        const int c = c0 + 8 * j;
        if (va) store_pair(x_new, oa + c, v[j][0], v[j][1], io_f32);
        if (vb) store_pair(x_new, ob + c, v[j][2], v[j][3], io_f32);
        sa += v[j][0] + v[j][1];
        sb += v[j][2] + v[j][3];
      }
    }
    sa += __shfl_xor_sync(0xffffffffu, sa, 1);
    sa += __shfl_xor_sync(0xffffffffu, sa, 2);
    sb += __shfl_xor_sync(0xffffffffu, sb, 1);
    sb += __shfl_xor_sync(0xffffffffu, sb, 2);
    if (t == 0) {
      red_sum[la] = sa;
      red_sum[lb] = sb;
    }
  }
  cluster_sync();                               // every slice's row sums are out

  const float fn = static_cast<float>(N);
  float mean_a = 0.0f, mean_b = 0.0f;
  if (consumer) {
    float sa = 0.0f, sb = 0.0f;
    for (int r = 0; r < kC; ++r) {              // rank order: one sum on every CTA
      sa = __fadd_rn(sa, ld_cluster_f32(&red_sum[la], r));
      sb = __fadd_rn(sb, ld_cluster_f32(&red_sum[lb], r));
    }
    mean_a = __fdiv_rn(sa, fn);
    mean_b = __fdiv_rn(sb, fn);
    float qa = 0.0f, qb = 0.0f;
#pragma unroll
    for (int j = 0; j < S / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float da = __fsub_rn(v[j][e], mean_a);
        const float db = __fsub_rn(v[j][2 + e], mean_b);
        qa = __fadd_rn(qa, __fmul_rn(da, da));
        qb = __fadd_rn(qb, __fmul_rn(db, db));
      }
    }
    qa += __shfl_xor_sync(0xffffffffu, qa, 1);
    qa += __shfl_xor_sync(0xffffffffu, qa, 2);
    qb += __shfl_xor_sync(0xffffffffu, qb, 1);
    qb += __shfl_xor_sync(0xffffffffu, qb, 2);
    if (t == 0) {
      red_sq[la] = qa;
      red_sq[lb] = qb;
    }
  }
  cluster_sync();                               // every slice's centred squares are out

  if (consumer) {
    float qa = 0.0f, qb = 0.0f;
    for (int r = 0; r < kC; ++r) {
      qa = __fadd_rn(qa, ld_cluster_f32(&red_sq[la], r));
      qb = __fadd_rn(qb, ld_cluster_f32(&red_sq[lb], r));
    }
    const float inv_a = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(__fdiv_rn(qa, fn), eps)));
    const float inv_b = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(__fdiv_rn(qb, fn), eps)));
    const float inv_os = __fdiv_rn(1.0f, out_scale[0]);
#pragma unroll
    for (int j = 0; j < S / 8; ++j) {
      const int c = c0 + 8 * j;
      int8_t code[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int lc = 8 * j + 2 * t + (e & 1);
        code[e] = e < 2 ? ln_code(v[j][e], mean_a, inv_a, v_gamma[lc], v_beta[lc], inv_os)
                        : ln_code(v[j][e], mean_b, inv_b, v_gamma[lc], v_beta[lc], inv_os);
      }
      if (va) *reinterpret_cast<char2*>(yq + oa + c) = make_char2(code[0], code[1]);
      if (vb) *reinterpret_cast<char2*>(yq + ob + c) = make_char2(code[2], code[3]);
    }
  }
  cluster_sync();                               // no CTA leaves while another reads it
}

template <int S>
cudaError_t configure(cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr, int M,
                      cudaStream_t stream) {
  constexpr size_t smem = Layout<S>::kSmem;
  const cudaError_t err = cudaFuncSetAttribute(
      qmm_res_ln_cluster_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(kC, (M + kBM - 1) / kBM);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kC;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaSuccess;
}

template <int S>
cudaError_t launch(const void* hq, const float* hs, int hs_step, const void* w, const float* ws,
                   const float* bias, const void* x_prev, const float* gamma, const float* beta,
                   const float* out_scale, void* x_new, void* yq, int M, int K, int N, float eps,
                   int io_f32, cudaStream_t stream) {
  if ((M + kBM - 1) / kBM > 65535) return cudaErrorInvalidValue;
  CUtensorMap hq_map, w_map;
  cudaError_t err = tensor_map_2d(&hq_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, hq, K, M, K, kBK, kPiece);
  if (err != cudaSuccess) return err;
  err = tensor_map_2d(&w_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, w, K, N, K, kBK, S);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  err = configure<S>(cfg, attr, M, stream);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(&cfg, qmm_res_ln_cluster_kernel<S>, hq_map, w_map, hs, hs_step, ws,
                           bias, x_prev, gamma, beta, out_scale, x_new,
                           static_cast<int8_t*>(yq), M, K, N, eps, io_f32);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// blocks an SM holds, or (clusters) clusters the card holds at once, at M rows
template <int S>
int occupancy(int clusters, int M) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  if (configure<S>(cfg, attr, M, nullptr) != cudaSuccess) return -1;
  int n = -1;
  const cudaError_t err =
      clusters ? cudaOccupancyMaxActiveClusters(&n, qmm_res_ln_cluster_kernel<S>, &cfg)
               : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                     &n, qmm_res_ln_cluster_kernel<S>, kThreads, Layout<S>::kSmem);
  return err == cudaSuccess ? n : -1;
}

}  // namespace cl

}  // namespace

// Plain C entry point, loaded with ctypes. hq: int8 (M, K) row-major; hs: fp32,
// one per row (hs_step 1) or one scalar (hs_step 0); w: int8 (N, K) row-major,
// i.e. the (K, N) weight column-major; ws: fp32 (N,); bias: fp32 (N,) or null;
// x_prev and x_new: (M, N), bf16 or, with io_f32, fp32; gamma, beta: fp32
// (N,); out_scale: one fp32 on the device; yq: int8 (M, N); staged: fp32
// (M, N) scratch for N > 1536, else unused (may be null). Every tensor
// contiguous and 16-byte aligned; K a multiple of 16 (the wrapper pads a
// shorter one with zero codes), N a multiple of 128. One launch in either
// case, on ``stream``; returns the CUDA error of the launch (0 on success);
// never synchronises.
extern "C" int stllm_qmm_res_ln(const void* hq, const void* hs, int hs_step, const void* w,
                                const void* ws, const void* bias, const void* x_prev,
                                const void* gamma, const void* beta, const void* out_scale,
                                void* x_new, void* yq, void* staged, int M, int K, int N,
                                float eps, int io_f32, void* stream) {
  if (M < 0 || K <= 0 || K % 16 != 0 || N <= 0 || N % 128 != 0 ||
      (hs_step != 0 && hs_step != 1) || (N > kChunk && !staged)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (M == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* f_hs = static_cast<const float*>(hs);
  const float* f_ws = static_cast<const float*>(ws);
  const float* f_b = static_cast<const float*>(bias);
  const float* f_g = static_cast<const float*>(gamma);
  const float* f_be = static_cast<const float*>(beta);
  const float* f_os = static_cast<const float*>(out_scale);
  float* f_st = static_cast<float*>(staged);
  const int nt = (N > kChunk ? chunk_width(N) : N) / 64;
  cudaError_t err;
  if (nt <= 8) {
    err = launch<8>(hq, f_hs, hs_step, w, f_ws, f_b, x_prev, f_g, f_be, f_os, x_new, yq, f_st, M,
                    K, N, eps, io_f32, st);
  } else if (nt <= 16) {
    err = launch<16>(hq, f_hs, hs_step, w, f_ws, f_b, x_prev, f_g, f_be, f_os, x_new, yq, f_st,
                     M, K, N, eps, io_f32, st);
  } else {
    err = launch<24>(hq, f_hs, hs_step, w, f_ws, f_b, x_prev, f_g, f_be, f_os, x_new, yq, f_st,
                     M, K, N, eps, io_f32, st);
  }
  return static_cast<int>(err);
}

// The cluster form, for N = 8 x 128, 8 x 176 or 8 x 256: the arguments of
// stllm_qmm_res_ln without the scratch row; hq and the weight 16-byte aligned
// with K a multiple of 16. One launch of a (8, ceil(M / 128)) grid in
// clusters of 8 on ``stream``; returns the CUDA error (0 on success); never
// synchronises.
extern "C" int stllm_qmm_res_ln_cluster(const void* hq, const void* hs, int hs_step, const void* w,
                                        const void* ws, const void* bias, const void* x_prev,
                                        const void* gamma, const void* beta,
                                        const void* out_scale, void* x_new, void* yq, int M, int K,
                                        int N, float eps, int io_f32, void* stream) {
  if (M < 0 || K <= 0 || K % 16 != 0 || N % cl::kC != 0 || (hs_step != 0 && hs_step != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (M == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* f_hs = static_cast<const float*>(hs);
  const float* f_ws = static_cast<const float*>(ws);
  const float* f_b = static_cast<const float*>(bias);
  const float* f_g = static_cast<const float*>(gamma);
  const float* f_be = static_cast<const float*>(beta);
  const float* f_os = static_cast<const float*>(out_scale);
  cudaError_t err;
  switch (N / cl::kC) {
    case 128:
      err = cl::launch<128>(hq, f_hs, hs_step, w, f_ws, f_b, x_prev, f_g, f_be, f_os, x_new, yq,
                            M, K, N, eps, io_f32, st);
      break;
    case 176:
      err = cl::launch<176>(hq, f_hs, hs_step, w, f_ws, f_b, x_prev, f_g, f_be, f_os, x_new, yq,
                            M, K, N, eps, io_f32, st);
      break;
    case 256:
      err = cl::launch<256>(hq, f_hs, hs_step, w, f_ws, f_b, x_prev, f_g, f_be, f_os, x_new, yq,
                            M, K, N, eps, io_f32, st);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// Occupancy of the form that runs N at M rows: blocks an SM holds
// (what = 0), or for the cluster form clusters the card holds (what = 1);
// cluster = 0 asks the one-pass 16-row kernel. -1 on an error.
extern "C" int stllm_qmm_res_ln_occupancy(int cluster, int what, int M, int N) {
  if (cluster) {
    switch (N / cl::kC) {
      case 128: return cl::occupancy<128>(what, M);
      case 176: return cl::occupancy<176>(what, M);
      case 256: return cl::occupancy<256>(what, M);
      default: return -1;
    }
  }
  if (what != 0 || N > kChunk || N % 128) return -1;
  const size_t smem = ring_bytes(N / 64);
  int n = -1;
  auto occ = [&](auto kernel) {
    if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem)) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads, smem) != cudaSuccess) {
      n = -1;
    }
  };
  if (N / 64 <= 8) {
    occ(qmm_res_ln_kernel<8>);
  } else if (N / 64 <= 16) {
    occ(qmm_res_ln_kernel<16>);
  } else {
    occ(qmm_res_ln_kernel<24>);
  }
  return n;
}
