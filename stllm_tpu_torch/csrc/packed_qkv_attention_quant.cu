// Packed-qkv attention with a per-row int8 epilogue, for Hopper (sm_90a):
// bf16 (or fp32) qkv in, int8 out plus an fp32 scale per row.
//
// Replaces stllm_tpu/ops/attention.py:_packed_qkv_quant_kernel, the attention
// of every trunk block of the dynamic-int8 EVA-ViT-g and of its calibration.
// It computes the attention of packed_qkv_attention.cu, out (B, S, H*D) =
// (bf16(p) . v) / sum(p), and then quantizes each full output row over all
// H*D columns (rowwise_quant.cuh): amax, s = amax / 127, q = rint(out / s).
//
// Bound on the H100 at the ViT-g shape (16, 257, 3*16*88): each call reads
// 34.7 MB of qkv and writes 5.8 MB of int8 and 16 KB of scales, 40.5 MB,
// about 12.1 us at 3.35 TB/s, against 5.95 GFLOP, about 6 us at 989 TFLOP/s,
// so it is bound by memory.
//
// The trouble is the epilogue's amax: it spans all H heads of a row, and a
// block of the attention kernel owns one head. The design runs in two
// launches: the per-head blocks of the bf16 kernel (the tile loop of
// packed_qkv_attention.cuh; for an fp32 qkv the fp32 instantiation of
// attention_f32.cuh) write the fp32 rows o / sum(p) to a scratch buffer the
// wrapper allocates, and a row-quant pass (one block per row) quantizes
// them. It keeps the attention kernel's 512 blocks of 9 warps at the trunk
// shape, where a block per query tile that loops over the heads would hold
// a 180 KB fp32 row tile in shared memory and run one block of few warps
// per SM. The price is the scratch round trip:
// 23.1 MB written and read again, much of it from the 50 MB L2. A head_dim
// the tile loops do not take (not a multiple of 8, or above 128) writes its
// rows with the "any" form of packed_qkv_any.cuh (the _any entry point).

#include "attention_f32.cuh"
#include "packed_qkv_any.cuh"
#include "packed_qkv_attention.cuh"
#include "rowwise_quant.cuh"

namespace {

cudaError_t quantize(float* rows, void* out_q, void* out_scale, int B, int S, int H, int D,
                     cudaStream_t st) {
  return stllm::launch_rowwise_quant(rows, static_cast<int8_t*>(out_q),
                                     static_cast<float*>(out_scale),
                                     static_cast<long long>(B) * S, H * D, st);
}

}  // namespace

// Plain C entry points, loaded with ctypes. qkv: contiguous (B, S, 3*H*D),
// 16-byte aligned, bf16 or (the _f32 entry) fp32; scratch: fp32 (B, S, H*D);
// out_q: int8 (B, S, H*D); out_scale: fp32 (B, S). D is a multiple of 8 and
// at most 128; any H*D (rowwise_quant.cuh). Each launches on ``stream`` and
// returns the CUDA error of the launches (0 on success).
extern "C" int stllm_packed_qkv_attention_quant_bf16(const void* qkv, void* scratch,
                                                     void* out_q, void* out_scale,
                                                     int B, int S, int H, int D,
                                                     float scale_log2e, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* rows = static_cast<float*>(scratch);
  cudaError_t err = stllm::packed::launch(qkv, rows, B, S, H, D, scale_log2e, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(quantize(rows, out_q, out_scale, B, S, H, D, st));
}

extern "C" int stllm_packed_qkv_attention_quant_f32(const void* qkv, void* scratch,
                                                    void* out_q, void* out_scale, int B, int S,
                                                    int H, int D, float scale_log2e,
                                                    void* stream) {
  if (D % 8 || D > stllm::packed::kMaxHeadDim) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* rows = static_cast<float*>(scratch);
  cudaError_t err = stllm::f32attn::launch_packed(qkv, rows, B, S, H, D, scale_log2e, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(quantize(rows, out_q, out_scale, B, S, H, D, st));
}

// The "any" form: any D >= 1 and S <= 1023, bf16 or (io_f32) fp32 qkv,
// contiguous; any H*D.
extern "C" int stllm_packed_qkv_attention_quant_any(const void* qkv, void* scratch,
                                                    void* out_q, void* out_scale, int B, int S,
                                                    int H, int D, float scale_log2e,
                                                    int io_f32, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* rows = static_cast<float*>(scratch);
  cudaError_t err =
      io_f32 ? stllm::packed_any::launch<float, float, false>(
                   static_cast<const float*>(qkv), nullptr, scale_log2e, rows, B, S, H, D, st)
             : stllm::packed_any::launch<__nv_bfloat16, float, true>(
                   static_cast<const __nv_bfloat16*>(qkv), nullptr, scale_log2e, rows, B, S,
                   H, D, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(quantize(rows, out_q, out_scale, B, S, H, D, st));
}
