"""H2O-style KV-cache eviction (heavy-hitter oracle) for LLaMA decode
(stllm_tpu/models/h2o.py).

The KV cache holds a fixed ``budget`` of slots per layer: tokens with the
highest accumulated attention mass ("heavy hitters") plus the most recent
``recent`` tokens survive, and the lowest-mass old token is evicted when a
new one needs a slot (Zhang et al., "H2O: Heavy-Hitter Oracle for Efficient
Generative Inference of Large Language Models", NeurIPS 2023). Mass is
accumulated per layer, summed over heads and query steps. Each slot keeps its
token's absolute position, so RoPE and causality stay exact for
non-contiguous slot contents; eviction is an argmin and a scatter.

  h2o_prefill(params, embeds, mask, cfg, budget, recent) -> (hidden, cache)
  h2o_decode_step(params, token_ids, cache, cfg)         -> (logits, cache)
  h2o_decode_chunk_greedy(params, token_ids, cache, cfg, n) -> (tokens, cache)

Exactness: with budget >= prompt + max_new_tokens nothing is evicted and the
tokens and logits equal the dense cache's to fp32 tolerance. Attention runs
in plain torch (it reads per-slot positions, which no kernel of the port
takes). The decode step updates the cache's buffers in place.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from stllm_tpu_torch.models.llama import LlamaConfig, _qkv_proj, lm_head
from stllm_tpu_torch.ops.layers import gather_rows, linear, rms_norm, swiglu_mlp
from stllm_tpu_torch.ops.rope import rope_rows, rope_table, rotate

NEG_INF = -1e30


class H2OCache(NamedTuple):
    """Layer-major tuples of (B, budget, ...) slot tensors. ``pos`` is the
    absolute position held by each slot (-1 empty), ``mass`` the attention
    probability its token has received (summed over heads and steps),
    ``next_pos`` (B,) the next absolute position and ``filled`` the occupied
    slots per layer (prefill fills compactly). Slots whose position is
    within ``recent`` of the newest are never evicted."""

    k: Tuple[torch.Tensor, ...]       # L x (B, budget, H, D)
    v: Tuple[torch.Tensor, ...]       # L x (B, budget, H, D)
    pos: Tuple[torch.Tensor, ...]     # L x (B, budget) int32
    mass: Tuple[torch.Tensor, ...]    # L x (B, budget) fp32
    next_pos: torch.Tensor            # (B,) int32
    filled: Tuple[torch.Tensor, ...]  # L x (B,) int32
    recent: int = 32


def _attend_slots(q, ck, cv, pos, cur_pos, scale):
    """q (B, 1, H, D) against slot caches (B, N, H, D) with per-slot absolute
    positions. Returns (out (B, 1, H, D), probs (B, H, N) fp32)."""
    logits = torch.einsum("bqhd,bnhd->bhqn", q, ck).float() * scale
    valid = (pos >= 0) & (pos <= cur_pos[:, None])                     # (B, N)
    logits = torch.where(valid[:, None, None, :], logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)                                  # (B, H, 1, N)
    out = torch.einsum("bhqn,bnhd->bqhd", p.to(cv.dtype).float(), cv.float()).to(q.dtype)
    return out, p[:, :, 0, :]


def _evict_slot(ck, cv, pos, mass, filled, new_k, new_v, new_pos, recent: int):
    """Place each row's incoming token (new_k/new_v (B, 1, H, D)) in the
    first empty slot, else the lowest-mass slot outside the recency window,
    in place. Returns the layer's (filled + 1, capped at the budget)."""
    b, n = pos.shape
    protected = (pos >= (new_pos[:, None] - recent)) & (pos >= 0)
    score = torch.where(protected, torch.inf, mass)
    score = torch.where(pos < 0, -torch.inf, score)      # prefer an empty slot
    slot = torch.where(filled < n, filled.long(), torch.argmin(score, dim=-1))
    rows = torch.arange(b, device=pos.device)
    ck[rows, slot] = new_k[:, 0].to(ck.dtype)
    cv[rows, slot] = new_v[:, 0].to(cv.dtype)
    pos[rows, slot] = new_pos.to(pos.dtype)
    mass[rows, slot] = 0.0
    return torch.clamp(filled + 1, max=n)


@torch.no_grad()
def h2o_decode_step(params: Dict, token_ids: torch.Tensor, cache: H2OCache,
                    cfg: LlamaConfig) -> Tuple[torch.Tensor, H2OCache]:
    """One decode step over the budgeted cache. token_ids: (B,). Returns
    (logits (B, V) fp32, cache)."""
    b = token_ids.shape[0]
    x = gather_rows(params["embed_tokens"], token_ids)[:, None].to(cfg.dtype)  # (B, 1, d)
    cos, sin = rope_table(cfg.head_dim, cfg.max_positions, cfg.rope_theta, device=x.device)
    rope = rope_rows(cos, sin, cache.next_pos.long()[:, None])
    scale = cfg.head_dim ** -0.5
    filled = []
    for i, layer in enumerate(params["layers"]):
        h = rms_norm(layer["input_norm"], x, cfg.rms_eps)
        q, k, v = _qkv_proj(layer, h, b, 1, cfg)
        q, k = rotate(q, *rope), rotate(k, *rope)
        ck, cv, pos, mass = cache.k[i], cache.v[i], cache.pos[i], cache.mass[i]
        filled.append(_evict_slot(ck, cv, pos, mass, cache.filled[i], k, v, cache.next_pos,
                                  cache.recent))
        out, probs = _attend_slots(q, ck.to(x.dtype), cv.to(x.dtype), pos, cache.next_pos, scale)
        mass += probs.sum(dim=1)                         # accumulated over heads
        x = x + linear(layer["o"], out.reshape(b, 1, cfg.hidden))
        h2 = rms_norm(layer["post_norm"], x, cfg.rms_eps)
        x = x + swiglu_mlp(layer, h2)
    x = rms_norm(params["norm"], x, cfg.rms_eps)
    logits = lm_head(params, x)[:, 0]
    return logits, cache._replace(next_pos=cache.next_pos + 1, filled=tuple(filled))


@torch.no_grad()
def h2o_prefill(params: Dict, inputs_embeds: torch.Tensor, attention_mask, cfg: LlamaConfig,
                budget: int, recent: int = 32) -> Tuple[torch.Tensor, H2OCache]:
    """Run the prompt densely, accumulate each token's attention column mass
    per layer, then keep the ``budget`` highest-mass tokens per layer with
    the last ``recent`` valid tokens always kept, in positional order.
    Returns (hidden (B, S, d), compressed cache)."""
    if budget <= recent:
        # eviction needs at least one slot outside the recency window
        raise ValueError(f"h2o budget ({budget}) must exceed the recency window ({recent})")
    x = inputs_embeds.to(cfg.dtype)
    b, s, _ = x.shape
    dev = x.device
    if attention_mask is None:
        attention_mask = torch.ones((b, s), dtype=torch.int32, device=dev)
    valid = attention_mask.bool()
    cos, sin = rope_table(cfg.head_dim, cfg.max_positions, cfg.rope_theta, device=dev)
    rope = rope_rows(cos, sin, torch.arange(s, device=dev)[None].expand(b, s))
    scale = cfg.head_dim ** -0.5
    causal = torch.tril(torch.ones((s, s), dtype=torch.bool, device=dev))

    ks, vs, masses = [], [], []
    for layer in params["layers"]:
        h = rms_norm(layer["input_norm"], x, cfg.rms_eps)
        q, k, v = _qkv_proj(layer, h, b, s, cfg)
        q, k = rotate(q, *rope), rotate(k, *rope)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
        logits = torch.where(causal[None, None], logits, NEG_INF)
        logits = torch.where(valid[:, None, None, :], logits, NEG_INF)
        p = torch.softmax(logits, dim=-1)                               # (B, H, S, S)
        # column mass: attention token j receives from every valid query
        mass = torch.einsum("bhqk,bq->bk", p, valid.float())
        out = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float()).to(x.dtype)
        out = out * valid[:, :, None, None]
        x = x + linear(layer["o"], out.reshape(b, s, cfg.hidden))
        h2 = rms_norm(layer["post_norm"], x, cfg.rms_eps)
        x = x + swiglu_mlp(layer, h2)
        ks.append(k)
        vs.append(v)
        masses.append(mass)
    x = rms_norm(params["norm"], x, cfg.rms_eps)
    lengths = attention_mask.sum(dim=-1).to(torch.int32)                # (B,)

    # per layer: the recent valid tokens first, then by mass, pads last; the
    # kept set in positional order, empty slots past a short prompt
    take = min(budget, s)
    idx = torch.arange(s, device=dev)[None, :]
    is_valid = idx < lengths[:, None]
    protected = is_valid & (idx >= lengths[:, None] - recent)
    slot_ok = torch.arange(budget, device=dev)[None, :] < take
    ck, cv, cpos, cmass, cfill = [], [], [], [], []
    for k_l, v_l, m_l in zip(ks, vs, masses):
        rank = torch.where(protected, torch.inf, m_l)
        rank = torch.where(is_valid, rank, -torch.inf)
        order = torch.argsort(-rank, dim=-1, stable=True)
        keep = torch.sort(order[:, :take], dim=-1)[0]
        keep = torch.nn.functional.pad(keep, (0, budget - take))
        kept_valid = (keep < lengths[:, None]) & slot_ok
        gather = keep[:, :, None, None].expand(-1, -1, k_l.shape[2], k_l.shape[3])
        ck.append(torch.gather(k_l, 1, gather))
        cv.append(torch.gather(v_l, 1, gather))
        cpos.append(torch.where(kept_valid, keep, -1).to(torch.int32))
        cmass.append(torch.where(kept_valid, torch.gather(m_l, 1, keep), 0.0))
        cfill.append(kept_valid.sum(dim=-1).to(torch.int32))
    cache = H2OCache(k=tuple(ck), v=tuple(cv), pos=tuple(cpos), mass=tuple(cmass),
                     next_pos=lengths, filled=tuple(cfill), recent=recent)
    return x, cache


@torch.no_grad()
def h2o_decode_chunk_greedy(params, token_ids: torch.Tensor, cache: H2OCache,
                            cfg: LlamaConfig, n: int):
    """``n`` greedy tokens on the device with no host round trip. Returns
    ((B, n) int32 tokens, cache)."""
    cur, toks = token_ids, []
    for _ in range(n):
        logits, cache = h2o_decode_step(params, cur, cache, cfg)
        cur = torch.argmax(logits, dim=-1).to(torch.int32)
        toks.append(cur)
    return torch.stack(toks, dim=1), cache
