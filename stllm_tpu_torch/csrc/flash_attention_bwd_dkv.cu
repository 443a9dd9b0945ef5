// Flash attention backward, dK and dV, for Hopper (sm_90a).
//
// Replaces stllm_tpu/ops/attention.py:_flash_bwd_dkv_kernel. From the same
// inputs as the dQ kernel it recomputes p and ds on the transposed scores
// k . q^T and accumulates dv = p^T . dO and dk = ds^T . q over the query
// tiles in fp32, stored as bf16. A block owns 128 keys, so no two blocks
// write one row and no atomics are needed; causal query tiles before the
// block's first key are skipped.
//
// Bound on the H100 at (1, 1024, 32, 128) causal: 8 * B * H * S^2 * D / 2 =
// 17.2 GFLOP (17.4 us at 989 TFLOP/s) against 50 MB moved (15 us): bound by
// operations. What the loop does about it (flash_attention.cuh): the four
// products run on wgmma, two warpgroups of 64 keys sharing each walked tile;
// 64-query tiles of Q, dO, lse and delta come through a two-stage cp.async
// ring, one barrier a tile, with the next tile's copies in flight under the
// current tile's products; the key tiles that walk the most queries (the
// first ones, under causal) launch first. An fp32 q, k, v, dO takes the fp32
// instantiation of attention_f32.cuh.
// A head_dim that is no multiple of 8 reaches the tile loops zero-padded by
// the wrapper; one above 128 takes the "any" form of flash_attention_any.cuh
// (bf16 or fp32, CUDA-core loops), as the TPU kernel takes every head_dim.

#include "attention_f32.cuh"
#include "flash_attention.cuh"
#include "flash_attention_any.cuh"

// As stllm_flash_attention_bwd_dq_bf16; dk and dv bf16 (B, Sk, H, D)
// contiguous.
extern "C" int stllm_flash_attention_bwd_dkv_bf16(const void* q, const void* k, const void* v,
                                                  const void* d_out, const long long* strides,
                                                  const void* kv_mask, const void* lse,
                                                  const void* delta, void* dk, void* dv, int B,
                                                  int Sq, int Sk, int H, int D, int causal,
                                                  float scale, void* stream) {
  stllm::flash::Params p = stllm::flash::make_params(q, k, v, d_out, strides, kv_mask, B, Sq,
                                                     Sk, H, D, causal, 0, scale);
  p.lse_in = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.out2 = static_cast<__nv_bfloat16*>(dk);
  p.out3 = static_cast<__nv_bfloat16*>(dv);
  return static_cast<int>(stllm::flash::launch_dkv(p, static_cast<cudaStream_t>(stream)));
}

// The same with fp32 q, k, v, dO, dk and dv (attention_f32.cuh).
extern "C" int stllm_flash_attention_bwd_dkv_f32(const void* q, const void* k, const void* v,
                                                 const void* d_out, const long long* strides,
                                                 const void* kv_mask, const void* lse,
                                                 const void* delta, void* dk, void* dv, int B,
                                                 int Sq, int Sk, int H, int D, int causal,
                                                 float scale, void* stream) {
  stllm::f32attn::Params p = stllm::f32attn::make_params(q, k, v, d_out, strides, kv_mask, B,
                                                         Sq, Sk, H, D, causal, 0, scale);
  p.lse_in = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.out2 = static_cast<float*>(dk);
  p.out3 = static_cast<float*>(dv);
  return static_cast<int>(stllm::f32attn::launch_dkv(p, static_cast<cudaStream_t>(stream)));
}

// The "any" form (flash_attention_any.cuh), for a head_dim above the tile
// loops' 128: the arguments of the bf16 entry point, then whether q, k, v,
// dO, dk and dv are fp32.
extern "C" int stllm_flash_attention_bwd_dkv_any(const void* q, const void* k, const void* v,
                                                 const void* d_out, const long long* strides,
                                                 const void* kv_mask, const void* lse,
                                                 const void* delta, void* dk, void* dv, int B,
                                                 int Sq, int Sk, int H, int D, int causal,
                                                 float scale, int io_f32, void* stream) {
  namespace a = stllm::attn_any;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (io_f32) {
    a::Params<float> p = a::make_params<float>(q, k, v, d_out, strides, kv_mask, B, Sq, Sk, H, D,
                                               causal, 0, scale);
    p.lse_in = static_cast<const float*>(lse);
    p.delta = static_cast<const float*>(delta);
    p.out2 = static_cast<float*>(dk);
    p.out3 = static_cast<float*>(dv);
    return static_cast<int>(a::launch_dkv(p, st));
  }
  a::Params<__nv_bfloat16> p = a::make_params<__nv_bfloat16>(q, k, v, d_out, strides, kv_mask,
                                                             B, Sq, Sk, H, D, causal, 0, scale);
  p.lse_in = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.out2 = static_cast<__nv_bfloat16*>(dk);
  p.out3 = static_cast<__nv_bfloat16*>(dv);
  return static_cast<int>(a::launch_dkv(p, st));
}

// Resident blocks of the bf16 kernel a streaming multiprocessor holds at
// head_dim D (-1 on an error).
extern "C" int stllm_flash_attention_bwd_dkv_occupancy(int D) {
  return stllm::flash::dkv_occupancy(D);
}
