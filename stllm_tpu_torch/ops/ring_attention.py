"""Ring attention: sequence-parallel attention over a process group
(stllm_tpu/ops/ring_attention.py).

Each rank holds one contiguous shard of the sequence. Queries stay put
while the K/V shards (and their validity) rotate one rank forward per step,
and the normalized partial results merge online through their logsumexp:
exact attention over the whole sequence, the distributed form of the flash
recurrence. The rotation is ``dist.batch_isend_irecv`` inside an autograd
Function whose backward rotates the cotangents one rank back, so gradients
flow as they do through the reference's ``lax.scan``.

The partial attention is plain torch: the reference's is an XLA einsum, not
a Pallas kernel.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist

from stllm_tpu_torch.parallel.collectives import group_rank, group_size

NEG_INF = -1e30


def _partial_attention(
    q: torch.Tensor,            # (B, Sq, H, D) local queries
    k: torch.Tensor,            # (B, Sk, H, D) current kv shard
    v: torch.Tensor,
    kv_valid: torch.Tensor,     # (B, Sk) bool for this shard
    q_off: int,                 # global offset of the q shard
    kv_off: int,                # global offset of the kv shard
    causal: bool,
    scale: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (normalized out (B,Sq,H,D) fp32, lse (B,H,Sq) fp32); rows with
    no attendable keys get lse = NEG_INF and out = 0."""
    sq, sk = q.shape[1], k.shape[1]
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    logits = (torch.matmul(qt, kt.transpose(-1, -2)) * scale).float()
    mask = kv_valid[:, None, None, :]
    if causal:
        qi = q_off + torch.arange(sq, device=q.device)[:, None]
        ki = kv_off + torch.arange(sk, device=q.device)[None, :]
        mask = mask & (ki <= qi)[None, None]
    logits = torch.where(mask, logits, NEG_INF)
    m = logits.amax(dim=-1, keepdim=True)                          # (B,H,Sq,1)
    any_valid = m > NEG_INF / 2
    m_safe = torch.where(any_valid, m, 0.0)
    p = torch.where(mask, torch.exp(logits - m_safe), 0.0)
    l = p.sum(dim=-1, keepdim=True).clamp(min=1e-30)
    out = torch.matmul(p.to(v.dtype), vt).float() / l
    lse = torch.where(any_valid[..., 0], (m_safe + torch.log(l))[..., 0], NEG_INF)
    out = torch.where(any_valid, out, 0.0)
    return out.transpose(1, 2), lse


def _send_recv(x: torch.Tensor, group, shift: int) -> torch.Tensor:
    """Every rank sends ``x`` to the rank ``shift`` ahead in the group and
    returns what the rank ``shift`` behind sent."""
    n, r = group_size(group), group_rank(group)
    x = x.contiguous()
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, dist.get_global_rank(group, (r + shift) % n), group),
           dist.P2POp(dist.irecv, out, dist.get_global_rank(group, (r - shift) % n), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _Rotate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _send_recv(x, group, 1)

    @staticmethod
    def backward(ctx, g):
        return _send_recv(g, ctx.group, -1), None


def _rotate(x: torch.Tensor, group) -> torch.Tensor:
    if not x.requires_grad:
        return _send_recv(x, group, 1)
    return _Rotate.apply(x, group)


def ring_attention(
    q: torch.Tensor,            # (B, S_local, H, D): this rank's shard of the sequence
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    group,
    causal: bool = False,
    kv_mask: Optional[torch.Tensor] = None,   # (B, S_local) local validity
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Exact attention over the group's shards joined in rank order; rank r
    holds positions r * S_local .. (r + 1) * S_local - 1. Returns this
    rank's (B, S_local, H, D) in q's dtype. A None group is one shard."""
    b, s_local, _, d = q.shape
    scale = (d ** -0.5) if scale is None else scale
    n, my = group_size(group), group_rank(group)
    if kv_mask is None:
        kv_mask = torch.ones((b, s_local), dtype=torch.bool, device=q.device)
    kv_mask = kv_mask.to(torch.uint8)      # rotates as bytes on every backend
    q_off = my * s_local
    out = lse = None
    for i in range(n):
        kv_off = ((my - i) % n) * s_local
        out_i, lse_i = _partial_attention(q, k, v, kv_mask.bool(), q_off, kv_off, causal,
                                           scale)
        if out is None:
            out, lse = out_i, lse_i
        else:
            # online merge of normalized partials via logsumexp
            lse_new = torch.logaddexp(lse, lse_i)
            w_acc = torch.exp(lse - lse_new).transpose(1, 2)[..., None]
            w_i = torch.exp(lse_i - lse_new).transpose(1, 2)[..., None]
            out, lse = out * w_acc + out_i * w_i, lse_new
        if i + 1 < n:
            k, v, kv_mask = _rotate(k, group), _rotate(v, group), _rotate(kv_mask, group)
    return out.to(q.dtype)
