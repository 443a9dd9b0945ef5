"""Attention ops (stllm_tpu/ops/attention.py).

``mha_reference`` is the plain attention the reference leaves to XLA (Q-Former,
LLaMA prefill-into-cache and decode); here it is plain torch.
``fused_qkv_attention`` is the packed-qkv attention of the ViT and BTAdapter
blocks; ``fused_qkv_attention_quant`` adds the per-row int8 epilogue of the
dynamic-int8 blocks and ``fused_qkv_attention_quant_static`` takes the
static-int8 qkv of the calibrated blocks. ``flash_attention`` is the
attention of the cache-less LLaMA forward (training) and of a ViT with
``use_flash`` set: the fused single-pass kernel below 1024 keys, the flash
forward and its two backward kernels from 1024 keys on. Each runs its
hand-written CUDA kernel in ``ops/kernels.py`` (bf16 or fp32); the three
differentiable ones are ``torch.autograd.Function``s here. The packed pair
keeps the reference's dispatch rule (``_packed_kernel_runs``): past it they
run ``_packed_reference`` in plain torch, as the reference leaves it to XLA.

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


def _packed_reference(qkv: torch.Tensor, heads: int, head_dim: int,
                      scale: float) -> torch.Tensor:
    """Plain-softmax attention on packed qkv: the function whose vjp is the
    packed kernel's backward."""
    b, s, _ = qkv.shape
    q, k, v = (t.reshape(b, s, heads, head_dim) for t in qkv.chunk(3, dim=-1))
    return mha_reference(q, k, v, scale=scale).reshape(b, s, heads * head_dim)


def _recompute_grads(fn, inputs, grad_out):
    """The vjp of ``fn`` at ``inputs`` applied to ``grad_out``, by running
    ``fn`` again under autograd."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in inputs]
        out = fn(*leaves)
    return torch.autograd.grad(out, leaves, grad_out)


class _PackedQKVAttention(torch.autograd.Function):
    """Forward: the packed-qkv kernel (clamped exp2 softmax, no row max).
    Backward: the vjp of the plain-softmax packed reference, recomputed, the
    reference's own asymmetry (stllm_tpu/ops/attention.py:_packed_bwd)."""

    @staticmethod
    def forward(ctx, qkv, heads, head_dim, scale):
        ctx.save_for_backward(qkv)
        ctx.args = (heads, head_dim, scale)
        return kernels.packed_qkv_attention(qkv, heads, head_dim, scale)

    @staticmethod
    def backward(ctx, g):
        (qkv,) = ctx.saved_tensors
        (d_qkv,) = _recompute_grads(lambda t: _packed_reference(t, *ctx.args), [qkv], g)
        return d_qkv, None, None, None


def _packed_kernel_runs(qkv: torch.Tensor, heads: int, head_dim: int) -> bool:
    """Whether the packed kernel (#1, #2) takes this call: the reference's
    feasibility rule, whatever the head_dim (``kernels.packed_form`` picks
    the kernel's form for it). Where it fails, the reference runs
    ``_packed_reference`` (the max-subtracted softmax, left to XLA) and so
    does the port, in plain torch on either device; no kernel launches for
    such a call."""
    return packed_qkv_feasible(qkv.shape[1], heads, head_dim, qkv.element_size())


def fused_qkv_attention(qkv: torch.Tensor, heads: int, head_dim: int, *,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Non-causal attention on a PACKED (B, S, 3*H*D) qkv tensor (q|k|v on
    the feature axis, heads contiguous within each third). Returns
    (B, S, H*D). Where ``_packed_kernel_runs`` holds, a CUDA tensor launches
    the packed-qkv kernel and a CPU tensor runs the kernel's plain version;
    elsewhere both run ``_packed_reference``, as the reference does.
    Differentiable: the backward recomputes through the plain-softmax
    reference."""
    if qkv.shape[-1] != 3 * heads * head_dim:
        raise ValueError(f"qkv width {qkv.shape[-1]} != 3 * {heads} * {head_dim}")
    scale = (head_dim ** -0.5) if scale is None else scale
    if not _packed_kernel_runs(qkv, heads, head_dim):
        return _packed_reference(qkv, heads, head_dim, scale)
    return _PackedQKVAttention.apply(qkv, heads, head_dim, scale)


def fused_qkv_attention_quant(qkv: torch.Tensor, heads: int, head_dim: int, *,
                              scale: Optional[float] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Packed-qkv attention with a W8A8 epilogue: returns (out_q int8
    (B, S, H*D), out_scale fp32 (B, S, 1)), the per-row int8 of
    ``fused_qkv_attention``'s fp32 rows. Where ``_packed_kernel_runs``
    fails, the per-row int8 of ``_packed_reference``'s rows (in the io
    dtype), as the reference quantizes them. Inference only."""
    if qkv.shape[-1] != 3 * heads * head_dim:
        raise ValueError(f"qkv width {qkv.shape[-1]} != 3 * {heads} * {head_dim}")
    scale = (head_dim ** -0.5) if scale is None else scale
    if not _packed_kernel_runs(qkv, heads, head_dim):
        return kernels.rowwise_quant_plain(_packed_reference(qkv, heads, head_dim, scale).float())
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


# ---------------------------------------------------------------------------
# flash_attention: the training path's attention
# ---------------------------------------------------------------------------

# The reference's rule for which function runs: the fused single-pass
# attention below 1024 keys while the (Sq, Sk) score matrix has at most
# 1024 * 1024 elements, the flash kernels from 1024 keys on.
_FUSED_MAX_SCORE_ELEMS = 1024 * 1024


def _row_mask(out: torch.Tensor, q_mask: Optional[torch.Tensor]) -> torch.Tensor:
    return out if q_mask is None else out * q_mask[:, :, None, None].to(out.dtype)


class _FusedShortAttention(torch.autograd.Function):
    """Forward: the fused short-sequence kernel (#7). Backward: the vjp of
    ``mha_reference`` recomputed, as the reference does
    (stllm_tpu/ops/attention.py:_fused_short_bwd): at these lengths the
    O(S^2) recompute is cheap."""

    @staticmethod
    def forward(ctx, q, k, v, q_mask, kv_mask, causal, scale):
        ctx.save_for_backward(q, k, v)
        ctx.args = (q_mask, kv_mask, causal, scale)
        return _row_mask(kernels.fused_short_attention(q, k, v, kv_mask, causal, scale), q_mask)

    @staticmethod
    def backward(ctx, g):
        q_mask, kv_mask, causal, scale = ctx.args
        dq, dk, dv = _recompute_grads(
            lambda q, k, v: mha_reference(q, k, v, causal=causal, q_mask=q_mask,
                                          kv_mask=kv_mask, scale=scale),
            ctx.saved_tensors, g)
        return dq, dk, dv, None, None, None, None


class _FlashAttentionCore(torch.autograd.Function):
    """Forward: the flash kernel (#4), saving out and the per-row logsumexp.
    Backward: the dQ kernel (#5) and the dK/dV kernel (#6) by recompute from
    lse and delta = sum(dO * O), O(S) memory."""

    @staticmethod
    def forward(ctx, q, k, v, q_mask, kv_mask, causal, scale):
        out, lse = kernels.flash_attention_fwd(q, k, v, kv_mask, causal, scale)
        out = _row_mask(out, q_mask)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (q_mask, kv_mask, causal, scale)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        q_mask, kv_mask, causal, scale = ctx.args
        g = _row_mask(g, q_mask)
        delta = (g.float() * out.float()).sum(dim=-1).transpose(1, 2).contiguous()  # (B, H, Sq)
        dq = kernels.flash_attention_bwd_dq(q, k, v, kv_mask, g, lse, delta, causal, scale)
        dk, dv = kernels.flash_attention_bwd_dkv(q, k, v, kv_mask, g, lse, delta, causal, scale)
        return dq, dk, dv, None, None, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    q_mask: Optional[torch.Tensor] = None,
    kv_mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    use_pallas: Optional[bool] = None,
) -> torch.Tensor:
    """Attention with the reference's tiers. q, k, v: (B, S, H, D); returns
    (B, Sq, H, D). ``use_pallas`` keeps the reference's name for "run the
    hand-written kernels": True runs the flash kernels, False plain
    ``mha_reference``, None picks by shape: the fused single-pass kernel for
    Sk < 1024 and Sq * Sk <= 1024 * 1024, the flash kernels for Sk >= 1024,
    ``mha_reference`` for what is left (Sk < 1024 under a very long Sq).

    Only the rule that decides WHICH function runs is kept. The reference
    also sends a fused-tier shape to ``mha_reference`` when no head chunk of
    it fits the TPU's on-chip memory; that is a storage rule of the TPU
    kernel, and ``mha_reference`` is the same function, so it is dropped.
    So are its mesh clauses (the global batch, or the folded B * H, divides
    over the shards), which its shard_map wrapper needs: under a mesh each
    rank runs the tier's kernel on its own rows (``ops/spmd.py``).
    On a CUDA tensor each tier launches its kernel (bf16 or fp32; other
    dtypes raise); on a CPU tensor it runs the plain version of that same
    kernel.
    The flash tier's causal mask is key <= query (the reference's, no
    Sk - Sq offset)."""
    scale = (q.shape[-1] ** -0.5) if scale is None else scale
    if use_pallas is None:
        if k.shape[1] < 1024 and q.shape[1] * k.shape[1] <= _FUSED_MAX_SCORE_ELEMS:
            return _FusedShortAttention.apply(q, k, v, q_mask, kv_mask, causal, scale)
        use_pallas = k.shape[1] >= 1024
    if not use_pallas:
        return mha_reference(q, k, v, causal=causal, q_mask=q_mask, kv_mask=kv_mask, scale=scale)
    return _FlashAttentionCore.apply(q, k, v, q_mask, kv_mask, causal, scale)
