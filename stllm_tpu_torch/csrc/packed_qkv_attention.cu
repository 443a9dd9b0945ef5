// Packed-qkv attention for Hopper (sm_90a), bf16 in and out.
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
// and v straight from the packed rows (row stride 3*H*D) with 16-byte loads,
// so the qkv projection feeds it with no split copies; products run on the
// tensor cores (mma.sync m16n8k16, bf16 in, fp32 accumulate) with D padded
// to a multiple of 16 in shared memory. Because the softmax subtracts a fixed
// 50 and not the row maximum, one pass over the keys accumulates sum(p) and
// sum(p . v) with no online rescale.
//
// The tile loop is in packed_qkv_attention.cuh: grid (ceil(S/64), H, B), a
// block of 4 warps owns 64 query rows of one head, each warp 16 rows, and
// walks the keys 64 at a time. K and V tiles are not double-buffered, each
// K/V tile is read once per query tile, and the S = 16 temporal shape leaves
// three of the four warps idle; wgmma, TMA and a tiling for short sequences
// are later work.

#include "packed_qkv_attention.cuh"

// Plain C entry point, loaded with ctypes. qkv and out are contiguous bf16
// device buffers of (B, S, 3*H*D) and (B, S, H*D), 16-byte aligned; D is a
// multiple of 8 and at most 112. Launches on ``stream`` and returns the CUDA
// error of the launch (0 on success); never synchronises.
extern "C" int stllm_packed_qkv_attention_bf16(const void* qkv, void* out, int B,
                                               int S, int H, int D,
                                               float scale_log2e, void* stream) {
  if (!stllm::packed_shape_ok(B, S, H, D)) return static_cast<int>(cudaErrorInvalidValue);
  stllm::launch_packed_any(qkv, static_cast<__nv_bfloat16*>(out), B, S, H, D, scale_log2e,
                           static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}
