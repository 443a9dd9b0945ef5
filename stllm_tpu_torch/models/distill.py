"""Draft distillation for speculative decoding (stllm_tpu/models/distill.py).

Trains a shallow same-width LLaMA tower (the draft) to match the target's
next-token ARGMAX, the quantity greedy speculative acceptance tests
(``models/speculative.py``: a draft token is accepted iff it equals the
target's argmax). The loss is the hard-label cross-entropy to the teacher's
argmax plus ``kl_mix`` times the soft KL(teacher || draft) at temperature 1,
both in fp32.

Each model embeds the continuation ids with its OWN table, as generation
does, so a batch is (prompt embeds (B, S, hidden), continuation ids
(B, S2)); the natural continuations are the target's own greedy outputs.
The teacher runs under ``no_grad``. The optimizer is the reference's
``optax.adamw(learning_rate)``: weight decay 1e-4 on every leaf (1-D norms
included), eps 1e-8, no gradient clipping.

Usage:
    draft = init_llama(gen, dft_cfg)           # same hidden and vocab
    draft = distill_draft(target, draft, sample_batch, tgt_cfg=cfg7b,
                          dft_cfg=dft_cfg, steps=2000)
where ``sample_batch(i) -> (embeds (B, S, hidden), ids (B, S2) int)``.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch

from stllm_tpu_torch.models.llama import LlamaConfig, llama_forward, lm_head
from stllm_tpu_torch.ops.layers import gather_rows
from stllm_tpu_torch.train.step import AdamW, partition_params


def _next_token_logits(params, embeds: torch.Tensor, ids: torch.Tensor,
                       cfg: LlamaConfig) -> torch.Tensor:
    """fp32 logits (B, S + S2, V) over [embeds ; embed_tokens[ids]], the
    cache-less forward (the training attention tiers)."""
    tok = gather_rows(params["embed_tokens"], ids).to(cfg.dtype)
    full = torch.cat([embeds.to(cfg.dtype), tok], dim=1)
    hidden, _ = llama_forward(params, inputs_embeds=full, cfg=cfg)
    return lm_head(params, hidden)


def distill_optimizer(learning_rate: float) -> AdamW:
    """optax.adamw(learning_rate) with its defaults."""
    return AdamW(learning_rate, weight_decay=1e-4, eps=1e-8, max_grad_norm=None,
                 decay_all=True)


def make_distill_step(tgt_cfg: LlamaConfig, dft_cfg: LlamaConfig, opt: AdamW,
                      kl_mix: float = 0.1):
    """step(tgt_params, dft_leaves, opt_state, embeds, ids) -> (loss,
    argmax_match) as 0-d tensors, with the draft leaves ({path: tensor},
    ``requires_grad`` set, views of the draft tree) and the moments
    updated in place."""

    def step(tgt_params, dft_params, dft_leaves: Dict[str, torch.Tensor], opt_state,
             embeds: torch.Tensor, ids: torch.Tensor):
        with torch.no_grad():
            t_logits = _next_token_logits(tgt_params, embeds, ids, tgt_cfg)
            t_hard = t_logits.argmax(dim=-1)
            t_soft = torch.log_softmax(t_logits, dim=-1)
            del t_logits
        s_logits = _next_token_logits(dft_params, embeds, ids, dft_cfg)
        s_log = torch.log_softmax(s_logits, dim=-1)
        ce = -torch.gather(s_log, -1, t_hard[..., None]).mean()
        kl = (t_soft.exp() * (t_soft - s_log)).sum(-1).mean()
        loss = ce + kl_mix * kl
        acc = (s_logits.detach().argmax(dim=-1) == t_hard).float().mean()
        for p in dft_leaves.values():
            p.grad = None
        loss.backward()
        grads = {k: torch.zeros_like(p) if p.grad is None else p.grad
                 for k, p in dft_leaves.items()}
        for p in dft_leaves.values():
            p.grad = None
        opt.update(grads, opt_state, dft_leaves)
        return loss.detach(), acc

    return step


def distill_draft(
    tgt_params: Dict,
    dft_params: Dict,
    sample_batch: Callable[[int], Tuple[torch.Tensor, torch.Tensor]],
    *,
    tgt_cfg: LlamaConfig,
    dft_cfg: LlamaConfig,
    steps: int = 1000,
    learning_rate: float = 3e-4,
    kl_mix: float = 0.1,
    log_every: int = 0,
    metrics: Optional[List[Dict[str, float]]] = None,
) -> Dict:
    """Returns the distilled draft (``dft_params``, trained in place).
    ``sample_batch(step)`` supplies (prompt embeds (B, S, hidden),
    continuation ids (B, S2)) on the models' device. With ``metrics`` (a
    list) each step appends its loss and argmax match there, which reads
    them back from the device every step."""
    if dft_cfg.hidden != tgt_cfg.hidden:
        raise ValueError(f"the draft's width {dft_cfg.hidden} is not the target's "
                         f"{tgt_cfg.hidden}")
    leaves, _ = partition_params(dft_params, lambda path: True)
    opt = distill_optimizer(learning_rate)
    opt_state = opt.init(leaves)
    step = make_distill_step(tgt_cfg, dft_cfg, opt, kl_mix)
    for it in range(steps):
        embeds, ids = sample_batch(it)
        loss, acc = step(tgt_params, dft_params, leaves, opt_state, embeds, ids)
        if metrics is not None:
            metrics.append({"loss": float(loss), "argmax_match": float(acc)})
        if log_every and (it + 1) % log_every == 0:
            print(f"distill step {it + 1}: loss {float(loss):.4f} "
                  f"argmax-match {float(acc):.3f}", flush=True)
    for p in leaves.values():
        p.requires_grad_(False)
    return dft_params
