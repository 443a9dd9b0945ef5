// Packed-qkv attention for Hopper (sm_90a), bf16 (or fp32) in and out.
//
// Replaces stllm_tpu/ops/attention.py:_packed_qkv_kernel, the attention of
// every EVA-ViT-g trunk block and every BTAdapter temporal and spatial layer.
// It computes what that kernel computes:
//   qkv (B, S, 3*H*D), q|k|v by thirds, heads contiguous within a third
//   s   = q . k^T * scale * log2(e)                    (fp32 accumulation)
//   p   = exp2(min(s, 50) - 50)        clamped softmax numerator, no row max
//   out = (bf16(p) . v) / sum(p)       fp32 accumulation, 0 where sum(p) == 0
// Keys past S contribute p = 0; query rows past S are not stored.
//
// Bound on the H100 at the ViT-g shape (16, 257, 3*16*88): each call reads
// 34.7 MB and writes 11.6 MB, about 13.8 us at 3.35 TB/s, against 5.95 GFLOP,
// about 6 us at 989 TFLOP/s, so it is bound by memory. The design reads q, k
// and v straight from the packed rows (row stride 3*H*D), so the qkv
// projection feeds it with no split copies. Because the softmax subtracts a
// fixed 50 and not the row maximum, one pass over the keys accumulates
// sum(p) and sum(p . v) with no online rescale.
//
// The tile loop is in packed_qkv_attention.cuh: K and V tiles as
// [key][dim] through a two-stage cp.async ring with one barrier a tile,
// ldmatrix fragments (.trans for V), mma.sync m16n8k16 with fp32
// accumulation; a long form whose blocks split a sequence's query rows
// evenly (two blocks of 9 and 8 warps at S = 257, two blocks an SM) and a
// short form that gives each warp of a block its own sequence (S <= 16, the
// BTAdapter's temporal attention). An fp32 qkv takes the fp32
// instantiation of attention_f32.cuh (CUDA-core products). Those loops take
// head_dim a multiple of 8 up to 128; every other head_dim takes the "any"
// form (packed_qkv_any.cuh), whose entry point is the _any one below.

#include "attention_f32.cuh"
#include "packed_qkv_any.cuh"
#include "packed_qkv_attention.cuh"

// Plain C entry points, loaded with ctypes. qkv and out are contiguous
// device buffers of (B, S, 3*H*D) and (B, S, H*D), 16-byte aligned, bf16 or
// (the _f32 entry) fp32; D is a multiple of 8 and at most 128. Each launches
// on ``stream`` and returns the CUDA error of the launch (0 on success);
// never synchronises.
extern "C" int stllm_packed_qkv_attention_bf16(const void* qkv, void* out, int B,
                                               int S, int H, int D,
                                               float scale_log2e, void* stream) {
  return static_cast<int>(stllm::packed::launch(qkv, static_cast<__nv_bfloat16*>(out), B, S,
                                                H, D, scale_log2e,
                                                static_cast<cudaStream_t>(stream)));
}

extern "C" int stllm_packed_qkv_attention_f32(const void* qkv, void* out, int B, int S, int H,
                                              int D, float scale_log2e, void* stream) {
  if (D % 8 || D > stllm::packed::kMaxHeadDim) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(stllm::f32attn::launch_packed(qkv, static_cast<float*>(out), B, S,
                                                        H, D, scale_log2e,
                                                        static_cast<cudaStream_t>(stream)));
}

// The "any" form: any D >= 1 and S <= 1023; qkv and out bf16, or fp32 with
// io_f32, contiguous (no alignment past the element's).
extern "C" int stllm_packed_qkv_attention_any(const void* qkv, void* out, int B, int S, int H,
                                              int D, float scale_log2e, int io_f32,
                                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (io_f32) {
    return static_cast<int>(stllm::packed_any::launch<float, float, false>(
        static_cast<const float*>(qkv), nullptr, scale_log2e, static_cast<float*>(out), B, S,
        H, D, st));
  }
  return static_cast<int>(stllm::packed_any::launch<__nv_bfloat16, __nv_bfloat16, true>(
      static_cast<const __nv_bfloat16*>(qkv), nullptr, scale_log2e,
      static_cast<__nv_bfloat16*>(out), B, S, H, D, st));
}

// Resident blocks a streaming multiprocessor holds for the bf16 kernel at
// sequence length S and head_dim D (-1 on an error).
extern "C" int stllm_packed_qkv_attention_occupancy(int S, int D) {
  return stllm::packed::occupancy<__nv_bfloat16>(S, D);
}
