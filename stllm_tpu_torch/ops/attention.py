"""Attention ops (stllm_tpu/ops/attention.py).

``mha_reference`` is the plain attention the reference leaves to XLA (Q-Former,
LLaMA prefill-into-cache and decode); here it is plain torch.
``fused_qkv_attention`` is the packed-qkv attention of the ViT and BTAdapter
blocks; it runs the hand-written CUDA kernel in ``ops/kernels.py``.

API convention: q/k/v are (batch, seq, heads, head_dim); ``kv_mask`` and
``q_mask`` are (batch, seq) validity masks (True = real token).
"""

from __future__ import annotations

from typing import Optional

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
