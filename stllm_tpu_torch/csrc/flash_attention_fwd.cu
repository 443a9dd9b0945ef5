// Flash attention forward for Hopper (sm_90a), bf16 (or fp32) in and out, fp32 lse.
//
// Replaces stllm_tpu/ops/attention.py:_flash_kernel, the attention of the
// cache-less LLaMA forward at 1024 keys and over. It computes what that
// kernel computes: out = softmax(q . k^T * scale) . v over the visible keys
// (kv_mask, and key <= query when causal) by the online-softmax recurrence,
// and the per-row logsumexp for the backward; a row with no visible key
// gives output 0 and lse = 1e30, so the backward's exp(s - lse) is 0 there.
// Where the TPU kernel multiplies q by the scale first and keeps P in fp32,
// this one scales the fp32 scores after the product and rounds P to bf16 for
// the tensor cores; both stay within the bf16 tolerance of the plain version.
//
// The TPU kernel walks a (batch*head, q block, kv block) grid in order with
// accumulators carried in scratch memory, on tensors folded to (B*H, S, D)
// and padded to 256-row blocks and 128 lanes. Here a block owns 64 query
// rows and loops over the key tiles itself; q, k and v are read in place
// through their (B, S, H, D) strides and ragged edges are masked.
//
// Bound on the H100 at (1, 1024, 32, 128) causal: 33.7 MB moved (10 us at
// 3.35 TB/s) against 8.6 GFLOP of visible products (8.7 us at 989 TFLOP/s):
// bound by bytes, with the operations close behind. The tile loop is in
// flash_attention.cuh: K, V and the mask words through a two-stage cp.async
// ring, q in registers, heaviest causal tiles first, three blocks an SM at
// D = 128. An fp32 q, k, v takes the fp32 instantiation of attention_f32.cuh.
// A head_dim that is no multiple of 8 reaches the tile loops zero-padded by
// the wrapper; one above 128 takes the "any" form of flash_attention_any.cuh
// (bf16 or fp32, CUDA-core loops), as the TPU kernel takes every head_dim.

#include "attention_f32.cuh"
#include "flash_attention.cuh"
#include "flash_attention_any.cuh"

// As stllm_fused_short_attention_bf16, plus lse fp32 (B, H, Sq); causal is
// key <= query with no offset, as in the TPU kernel.
extern "C" int stllm_flash_attention_fwd_bf16(const void* q, const void* k, const void* v,
                                              const long long* strides, const void* kv_mask,
                                              void* out, void* lse, int B, int Sq, int Sk,
                                              int H, int D, int causal, float scale,
                                              void* stream) {
  stllm::flash::Params p = stllm::flash::make_params(q, k, v, nullptr, strides, kv_mask, B, Sq,
                                                     Sk, H, D, causal, 0, scale);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.lse_out = static_cast<float*>(lse);
  return static_cast<int>(
      stllm::flash::launch_fwd<false>(p, static_cast<cudaStream_t>(stream)));
}

// The same with fp32 q, k, v and out (attention_f32.cuh).
extern "C" int stllm_flash_attention_fwd_f32(const void* q, const void* k, const void* v,
                                             const long long* strides, const void* kv_mask,
                                             void* out, void* lse, int B, int Sq, int Sk, int H,
                                             int D, int causal, float scale, void* stream) {
  stllm::f32attn::Params p = stllm::f32attn::make_params(q, k, v, nullptr, strides, kv_mask, B,
                                                         Sq, Sk, H, D, causal, 0, scale);
  p.out = static_cast<float*>(out);
  p.lse_out = static_cast<float*>(lse);
  return static_cast<int>(stllm::f32attn::launch_fwd<stllm::f32attn::kFlash>(
      p, static_cast<cudaStream_t>(stream)));
}

// The "any" form (flash_attention_any.cuh), for a head_dim above the tile
// loops' 128: the arguments of the bf16 entry point, then whether q, k, v
// and out are fp32.
extern "C" int stllm_flash_attention_fwd_any(const void* q, const void* k, const void* v,
                                             const long long* strides, const void* kv_mask,
                                             void* out, void* lse, int B, int Sq, int Sk, int H,
                                             int D, int causal, float scale, int io_f32,
                                             void* stream) {
  namespace a = stllm::attn_any;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (io_f32) {
    a::Params<float> p = a::make_params<float>(q, k, v, nullptr, strides, kv_mask, B, Sq, Sk, H,
                                               D, causal, 0, scale);
    p.out = static_cast<float*>(out);
    p.lse_out = static_cast<float*>(lse);
    return static_cast<int>(a::launch_fwd<float, a::kFlash>(p, st));
  }
  a::Params<__nv_bfloat16> p = a::make_params<__nv_bfloat16>(q, k, v, nullptr, strides, kv_mask,
                                                             B, Sq, Sk, H, D, causal, 0, scale);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.lse_out = static_cast<float*>(lse);
  return static_cast<int>(a::launch_fwd<__nv_bfloat16, a::kFlash>(p, st));
}

// Resident blocks of the bf16 kernel a streaming multiprocessor holds at
// head_dim D (-1 on an error).
extern "C" int stllm_flash_attention_fwd_occupancy(int D) {
  return stllm::flash::fwd_occupancy<false>(D);
}
