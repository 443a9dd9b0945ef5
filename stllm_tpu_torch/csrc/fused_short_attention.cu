// Fused short-sequence attention for Hopper (sm_90a), bf16 (or fp32) in and out.
//
// Replaces stllm_tpu/ops/attention.py:_fused_short_kernel, the attention of
// the cache-less LLaMA forward below 1024 keys (training batches of 640 to
// 896 packed tokens) and of a ViT run with use_flash=True. It computes what
// that kernel computes: out = softmax(q . k^T * scale) . v with a
// max-subtracted softmax over the full score row, scores scaled in fp32
// after the product, causal with offset Sk - Sq, kv_mask, masked scores at
// -1e30 (so a row with no visible key averages v over every key), P cast to
// bf16 for P . V with fp32 accumulation.
//
// The TPU kernel holds a whole (Sq, Sk) score tile in on-chip memory and
// packs several heads into one grid step to fit its lane width. A 768-key
// score row does not fit a thread's registers here, so the kernel walks the
// keys 64 at a time with the online-softmax recurrence (running maximum and
// rescaled sums), which gives the same max-subtracted softmax; the scores
// never leave the SM. q, k and v are read in place through their strides.
//
// Bound on the H100 at the LLaMA shape (1, 768, 32, 128) causal: 25 MB moved
// (7.5 us at 3.35 TB/s) against 4.8 GFLOP of visible products (4.9 us at
// 989 TFLOP/s): bound by bytes, with the operations close behind. The tile
// loop is flash_attention.cuh's forward (mma.sync fed by ldmatrix, K and V
// through a two-stage cp.async ring, causal query tiles heaviest first, K
// and V re-read once per 64 query rows); wgmma and TMA are later work. An
// fp32 q, k, v takes the fp32 instantiation of attention_f32.cuh.
// A head_dim that is no multiple of 8 reaches the tile loops zero-padded by
// the wrapper; one above 128 takes the "any" form of flash_attention_any.cuh
// (bf16 or fp32, CUDA-core loops), as the TPU kernel takes every head_dim.

#include "attention_f32.cuh"
#include "flash_attention.cuh"
#include "flash_attention_any.cuh"

// q (B, Sq, H, D), k and v (B, Sk, H, D) bf16 through ``strides`` (12 long
// longs: batch, sequence, head for q, k, v; the last three unused), kv_mask
// int32 (B, Sk) or null, out bf16 (B, Sq, H, D) contiguous. Launches on
// ``stream`` and returns the CUDA error of the launch; never synchronises.
extern "C" int stllm_fused_short_attention_bf16(const void* q, const void* k, const void* v,
                                                const long long* strides, const void* kv_mask,
                                                void* out, int B, int Sq, int Sk, int H, int D,
                                                int causal, float scale, void* stream) {
  stllm::flash::Params p = stllm::flash::make_params(q, k, v, nullptr, strides, kv_mask, B, Sq,
                                                     Sk, H, D, causal, Sk - Sq, scale);
  p.out = static_cast<__nv_bfloat16*>(out);
  return static_cast<int>(
      stllm::flash::launch_fwd<true>(p, static_cast<cudaStream_t>(stream)));
}

// The same with fp32 q, k, v and out (attention_f32.cuh).
extern "C" int stllm_fused_short_attention_f32(const void* q, const void* k, const void* v,
                                               const long long* strides, const void* kv_mask,
                                               void* out, int B, int Sq, int Sk, int H, int D,
                                               int causal, float scale, void* stream) {
  stllm::f32attn::Params p = stllm::f32attn::make_params(q, k, v, nullptr, strides, kv_mask, B,
                                                         Sq, Sk, H, D, causal, Sk - Sq, scale);
  p.out = static_cast<float*>(out);
  return static_cast<int>(stllm::f32attn::launch_fwd<stllm::f32attn::kUniform>(
      p, static_cast<cudaStream_t>(stream)));
}

// The "any" form (flash_attention_any.cuh), for a head_dim above the tile
// loops' 128: the arguments of the bf16 entry point, then whether q, k, v
// and out are fp32.
extern "C" int stllm_fused_short_attention_any(const void* q, const void* k, const void* v,
                                               const long long* strides, const void* kv_mask,
                                               void* out, int B, int Sq, int Sk, int H, int D,
                                               int causal, float scale, int io_f32,
                                               void* stream) {
  namespace a = stllm::attn_any;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (io_f32) {
    a::Params<float> p = a::make_params<float>(q, k, v, nullptr, strides, kv_mask, B, Sq, Sk, H,
                                               D, causal, Sk - Sq, scale);
    p.out = static_cast<float*>(out);
    return static_cast<int>(a::launch_fwd<float, a::kUniform>(p, st));
  }
  a::Params<__nv_bfloat16> p = a::make_params<__nv_bfloat16>(q, k, v, nullptr, strides, kv_mask,
                                                             B, Sq, Sk, H, D, causal, Sk - Sq,
                                                             scale);
  p.out = static_cast<__nv_bfloat16*>(out);
  return static_cast<int>(a::launch_fwd<__nv_bfloat16, a::kUniform>(p, st));
}
