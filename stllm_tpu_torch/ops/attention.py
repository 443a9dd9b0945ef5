"""Attention ops (stllm_tpu/ops/attention.py).

``mha_reference`` is the plain attention the reference leaves to XLA (Q-Former,
LLaMA prefill-into-cache and decode); here it is plain torch.
``fused_qkv_attention`` is the packed-qkv attention of the ViT and BTAdapter
blocks; ``fused_qkv_attention_quant`` adds the per-row int8 epilogue of the
dynamic-int8 blocks and ``fused_qkv_attention_quant_static`` takes the
static-int8 qkv of the calibrated blocks. Each runs its hand-written CUDA
kernel in ``ops/kernels.py``.

API convention: q/k/v are (batch, seq, heads, head_dim); ``kv_mask`` and
``q_mask`` are (batch, seq) validity masks (True = real token).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from stllm_tpu_torch.ops import kernels

NEG_INF = -1e30


def mha_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    q_mask: Optional[torch.Tensor] = None,
    kv_mask: Optional[torch.Tensor] = None,
    mask: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Plain softmax attention. q, k, v: (B, S, H, D).

    Precision as in the reference: the logits form in the INPUT dtype, are
    multiplied by ``scale`` and only then cast to fp32; softmax runs in fp32;
    P is cast to v.dtype and P.V accumulates in fp32. ``mask``: optional
    (B, Sq, Sk) boolean, True = attend."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    scale = (d ** -0.5) if scale is None else scale
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    logits = (torch.matmul(qt, kt.transpose(-1, -2)) * scale).float()
    if bias is not None:
        logits = logits + bias.float()
    if mask is not None:
        logits = torch.where(mask[:, None].bool(), logits, NEG_INF)
    if causal:
        qi = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
        ki = torch.arange(sk, device=q.device)[None, :]
        logits = torch.where(ki <= qi, logits, NEG_INF)
    if kv_mask is not None:
        logits = torch.where(kv_mask[:, None, None, :].bool(), logits, NEG_INF)
    weights = torch.softmax(logits, dim=-1)
    # one rounding of the fp32-accumulated product, as the reference's
    # fp32 einsum followed by the final cast to q.dtype
    out = torch.matmul(weights.to(v.dtype), vt).transpose(1, 2)
    if q_mask is not None:
        out = out * q_mask[:, :, None, None].to(out.dtype)
    return out.to(q.dtype)


def fused_qkv_attention(qkv: torch.Tensor, heads: int, head_dim: int, *,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Non-causal attention on a PACKED (B, S, 3*H*D) qkv tensor (q|k|v on
    the feature axis, heads contiguous within each third). Returns
    (B, S, H*D). On a CUDA tensor this launches the packed-qkv kernel; on a
    CPU tensor it runs the kernel's plain version."""
    if qkv.shape[-1] != 3 * heads * head_dim:
        raise ValueError(f"qkv width {qkv.shape[-1]} != 3 * {heads} * {head_dim}")
    scale = (head_dim ** -0.5) if scale is None else scale
    return kernels.packed_qkv_attention(qkv, heads, head_dim, scale)


def fused_qkv_attention_quant(qkv: torch.Tensor, heads: int, head_dim: int, *,
                              scale: Optional[float] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Packed-qkv attention with a W8A8 epilogue: returns (out_q int8
    (B, S, H*D), out_scale fp32 (B, S, 1)), the per-row int8 of
    ``fused_qkv_attention``'s fp32 rows. Inference only."""
    if qkv.shape[-1] != 3 * heads * head_dim:
        raise ValueError(f"qkv width {qkv.shape[-1]} != 3 * {heads} * {head_dim}")
    scale = (head_dim ** -0.5) if scale is None else scale
    return kernels.packed_qkv_attention_quant(qkv, heads, head_dim, scale)


def packed_qkv_feasible(seq: int, heads: int, head_dim: int, itemsize: int) -> bool:
    """The reference's rule for when its single-pass packed kernels run
    (stllm_tpu/ops/attention.py:_packed_qkv_feasible): S < 1024 and the
    block's working set within its on-chip budget."""
    hd = heads * head_dim
    vmem = seq * 3 * hd * itemsize * 2
    vmem += seq * hd * 4
    vmem += seq * seq * 4
    return seq < 1024 and vmem <= 10 * 1024 * 1024


def fused_qkv_attention_quant_static(qkv_q: torch.Tensor, qkv_scales: torch.Tensor,
                                     heads: int, head_dim: int, *,
                                     scale: Optional[float] = None,
                                     int8_dot: bool = True
                                     ) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
    """Packed-qkv attention on STATIC-int8 qkv (B, S, 3*H*D) with its
    calibrated per-third scales ``qkv_scales`` (fp32 (3,) = q, k, v; the
    reference passes them as three arguments). Returns (out_q int8
    (B, S, H*D), out_scale fp32 (B, S, 1)) like fused_qkv_attention_quant.

    Returns None where the reference's kernel declines the shape
    (``packed_qkv_feasible`` with 1-byte items fails, e.g. S >= 1024); the
    caller then takes fused_qkv_attention_quant on the bf16 qkv, as the
    reference's ``_attn_quant_static`` does. That is the reference path's
    dispatch rule, not a fallback from a failure. ``int8_dot`` chooses the
    reference's s8 or bf16 q.k^T; integer products are exact in fp32
    (127^2 * D < 2^24), so both give the same numbers and the kernel always
    runs the s8 product."""
    b, s, f = qkv_q.shape
    if f != 3 * heads * head_dim:
        raise ValueError(f"qkv width {f} != 3 * {heads} * {head_dim}")
    if not packed_qkv_feasible(s, heads, head_dim, 1):
        return None
    scale = (head_dim ** -0.5) if scale is None else scale
    return kernels.packed_qkv_attention_s8(qkv_q, qkv_scales, heads, head_dim, scale)
