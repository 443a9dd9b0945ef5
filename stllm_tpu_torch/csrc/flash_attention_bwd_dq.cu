// Flash attention backward, dQ, for Hopper (sm_90a).
//
// Replaces stllm_tpu/ops/attention.py:_flash_bwd_dq_kernel. From q, k, v,
// kv_mask, dO, the forward's lse and delta = sum(dO * O) it recomputes
// p = exp(q . k^T * scale - lse) on the visible keys, ds = p * (dO . v^T -
// delta) * scale, and accumulates dq = ds . k over the key tiles in fp32; the
// result is stored as bf16 (the TPU kernel stores fp32 and its wrapper
// casts). A block owns 64 query rows, so no two blocks write one row and no
// atomics are needed; causal key tiles past the block's last row are skipped.
//
// Bound on the H100 at (1, 1024, 32, 128) causal: 6 * B * H * S^2 * D / 2 =
// 12.9 GFLOP (13.0 us at 989 TFLOP/s) against 42 MB moved (12.6 us): bound by
// operations, narrowly. What the loop does about it (flash_attention.cuh):
// 64-key tiles of K, V and the mask words come through a two-stage cp.async
// ring, one barrier a tile, with the next tile's copies in flight under the
// current tile's products; each warp's Q and dO fragments stay in registers;
// the query tiles that walk the most keys (the last ones, under causal)
// launch first. It keeps mma.sync: a wgmma form of the same loop (S and dP
// from shared memory, dS as register A, one or two warpgroups a block) was
// right and slower on an H100 (0.092 against 0.088 ms at the shape above).
// An fp32 q, k, v, dO takes the fp32 instantiation of attention_f32.cuh.
// A head_dim that is no multiple of 8 reaches the tile loops zero-padded by
// the wrapper; one above 128 takes the "any" form of flash_attention_any.cuh
// (bf16 or fp32, CUDA-core loops), as the TPU kernel takes every head_dim.

#include "attention_f32.cuh"
#include "flash_attention.cuh"
#include "flash_attention_any.cuh"

// strides: 12 long longs (batch, sequence, head for q, k, v, dO); lse and
// delta fp32 (B, H, Sq); dq bf16 (B, Sq, H, D) contiguous.
extern "C" int stllm_flash_attention_bwd_dq_bf16(const void* q, const void* k, const void* v,
                                                 const void* d_out, const long long* strides,
                                                 const void* kv_mask, const void* lse,
                                                 const void* delta, void* dq, int B, int Sq,
                                                 int Sk, int H, int D, int causal, float scale,
                                                 void* stream) {
  stllm::flash::Params p = stllm::flash::make_params(q, k, v, d_out, strides, kv_mask, B, Sq,
                                                     Sk, H, D, causal, 0, scale);
  p.lse_in = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.out = static_cast<__nv_bfloat16*>(dq);
  return static_cast<int>(stllm::flash::launch_dq(p, static_cast<cudaStream_t>(stream)));
}

// The same with fp32 q, k, v, dO and dq (attention_f32.cuh).
extern "C" int stllm_flash_attention_bwd_dq_f32(const void* q, const void* k, const void* v,
                                                const void* d_out, const long long* strides,
                                                const void* kv_mask, const void* lse,
                                                const void* delta, void* dq, int B, int Sq,
                                                int Sk, int H, int D, int causal, float scale,
                                                void* stream) {
  stllm::f32attn::Params p = stllm::f32attn::make_params(q, k, v, d_out, strides, kv_mask, B,
                                                         Sq, Sk, H, D, causal, 0, scale);
  p.lse_in = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.out = static_cast<float*>(dq);
  return static_cast<int>(stllm::f32attn::launch_dq(p, static_cast<cudaStream_t>(stream)));
}

// The "any" form (flash_attention_any.cuh), for a head_dim above the tile
// loops' 128: the arguments of the bf16 entry point, then whether q, k, v,
// dO and dq are fp32.
extern "C" int stllm_flash_attention_bwd_dq_any(const void* q, const void* k, const void* v,
                                                const void* d_out, const long long* strides,
                                                const void* kv_mask, const void* lse,
                                                const void* delta, void* dq, int B, int Sq,
                                                int Sk, int H, int D, int causal, float scale,
                                                int io_f32, void* stream) {
  namespace a = stllm::attn_any;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (io_f32) {
    a::Params<float> p = a::make_params<float>(q, k, v, d_out, strides, kv_mask, B, Sq, Sk, H, D,
                                               causal, 0, scale);
    p.lse_in = static_cast<const float*>(lse);
    p.delta = static_cast<const float*>(delta);
    p.out = static_cast<float*>(dq);
    return static_cast<int>(a::launch_dq(p, st));
  }
  a::Params<__nv_bfloat16> p = a::make_params<__nv_bfloat16>(q, k, v, d_out, strides, kv_mask,
                                                             B, Sq, Sk, H, D, causal, 0, scale);
  p.lse_in = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.out = static_cast<__nv_bfloat16*>(dq);
  return static_cast<int>(a::launch_dq(p, st));
}

// Resident blocks of the bf16 kernel a streaming multiprocessor holds at
// head_dim D (-1 on an error).
extern "C" int stllm_flash_attention_bwd_dq_occupancy(int D) {
  return stllm::flash::dq_occupancy(D);
}
