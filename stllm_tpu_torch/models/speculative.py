"""Greedy speculative decoding: draft-propose / target-verify
(stllm_tpu/models/speculative.py).

A shallow draft tower of the target's hidden width proposes k tokens; the
target verifies them in one forward over k + 1 positions. A draft token is
accepted iff it equals the target's argmax at its position, and the first
rejected position emits the target's argmax instead, so every emitted token
is the target's greedy choice given the accepted prefix: the output equals
target-only greedy decoding token for token (in fp32; in bf16 the verify
forward is another program shape and can flip a near tie).

Cache mechanics: a verify round writes k + 1 entries at each row's length,
then commits only the accepted prefix plus the correction by setting the
length to ``length - (k + 1) + count``. The next round's writes start at the
committed offset and cover the stale tail, and attention masks kv_pos <=
the query's absolute position, so stale entries are never read. The draft
runs k + 1 proposal steps (one past what verification consumes) so its cache
holds KV for every token the target may commit.

The rounds run eagerly on the device; the host reads their tokens once per
``_spec_rounds`` call (the batcher's step), and once per group of rounds in
``_spec_chunk``, never once per round.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from stllm_tpu_torch.models.generation import (
    GenerationConfig, _ends_with, _pad_prompt, _prefill)
from stllm_tpu_torch.models.llama import LlamaConfig, llama_forward, lm_head


def _argmax_tokens(params, hidden: torch.Tensor) -> torch.Tensor:
    return torch.argmax(lm_head(params, hidden).float(), dim=-1).to(torch.int32)


@torch.no_grad()
def _spec_round(tgt_params, dft_params, t0, tgt_cache, dft_cache, tgt_cfg: LlamaConfig,
                dft_cfg: LlamaConfig, k: int):
    """One draft-propose / target-verify round over every row. Returns
    (t_next (B,), caches, emit (B, k + 1) int32, count (B,) int32): row b
    emits the first count[b] tokens of emit[b]."""
    tok, drafts = t0, []
    for _ in range(k + 1):
        h, dft_cache = llama_forward(dft_params, input_ids=tok[:, None], cache=dft_cache,
                                     cfg=dft_cfg)
        tok = _argmax_tokens(dft_params, h)[:, 0]
        drafts.append(tok)
    d = torch.stack(drafts[:k], dim=1)                                  # (B, k)
    seq = torch.cat([t0[:, None], d], dim=1)                            # (B, k + 1)
    h, tgt_cache = llama_forward(tgt_params, input_ids=seq, cache=tgt_cache, cfg=tgt_cfg)
    tgt_tok = _argmax_tokens(tgt_params, h)                             # (B, k + 1)
    a = torch.cumprod((tgt_tok[:, :k] == d).to(torch.int32), dim=1).sum(dim=1)  # accepted
    t_next = torch.gather(tgt_tok, 1, a[:, None].long())[:, 0]
    idx = torch.arange(k + 1, device=d.device)[None, :]
    emit = torch.where(idx < a[:, None], F.pad(d, (0, 1)), 0)
    emit = torch.where(idx == a[:, None], t_next[:, None], emit).to(torch.int32)
    count = (a + 1).to(torch.int32)
    # commit the accepted prefix and the correction; roll back the stale tail
    tgt_cache = tgt_cache._replace(length=tgt_cache.length - (k + 1) + count)
    dft_cache = dft_cache._replace(length=dft_cache.length - (k + 1) + count)
    return t_next, tgt_cache, dft_cache, emit, count


@torch.no_grad()
def _spec_rounds(tgt_params, dft_params, t0, tgt_cache, dft_cache, *, tgt_cfg: LlamaConfig,
                 dft_cfg: LlamaConfig, k: int, rounds: int):
    """The serving form: a fixed number of rounds, batched over the server's
    slots with per-row acceptance and rollback, no host read. Returns
    (t_next, caches, emits (R, B, k + 1), counts (R, B))."""
    emits, counts = [], []
    for _ in range(rounds):
        t0, tgt_cache, dft_cache, emit, count = _spec_round(
            tgt_params, dft_params, t0, tgt_cache, dft_cache, tgt_cfg, dft_cfg, k)
        emits.append(emit)
        counts.append(count)
    return t0, tgt_cache, dft_cache, torch.stack(emits), torch.stack(counts)


@torch.no_grad()
def _spec_chunk(tgt_params, dft_params, t0, tgt_cache, dft_cache, budget: int, *,
                tgt_cfg: LlamaConfig, dft_cfg: LlamaConfig, k: int, max_rounds: int):
    """Verify rounds until the rows' least emitted count reaches ``budget``
    tokens (or ``max_rounds`` rounds ran): the reference's while loop. A
    round emits at most k + 1 tokens a row, so the next ceil(left / (k + 1))
    rounds all run before the loop can stop; they run as one group with one
    host read after it. Returns (t_next, caches, emit (r, B, k + 1), counts
    (r, B), r)."""
    r, total = 0, 0
    emits, counts = [], []
    while r < max_rounds and total < budget:
        n = min(max_rounds - r, -(-(budget - total) // (k + 1)))
        t0, tgt_cache, dft_cache, emit, count = _spec_rounds(
            tgt_params, dft_params, t0, tgt_cache, dft_cache, tgt_cfg=tgt_cfg,
            dft_cfg=dft_cfg, k=k, rounds=n)
        emits.append(emit)
        counts.append(count)
        r += n
        total += int(count.min(dim=1).values.sum())
    return t0, tgt_cache, dft_cache, torch.cat(emits), torch.cat(counts), r


def speculative_generate(
    tgt_params: Dict,
    dft_params: Dict,
    inputs_embeds: torch.Tensor,
    attention_mask: Optional[torch.Tensor] = None,
    *,
    tgt_cfg: LlamaConfig,
    dft_cfg: LlamaConfig,
    gen: GenerationConfig = GenerationConfig(),
    k: int = 6,
    return_stats: bool = False,
):
    """Greedy generation with draft speculation for one stream; the tokens
    equal ``generation.generate`` on the target alone. ``return_stats``
    also returns {"rounds", "mean_accepted", "tokens_per_round"}."""
    if gen.do_sample or gen.num_beams != 1:
        raise ValueError("speculative decoding is greedy, one beam")
    if gen.repetition_penalty != 1.0 or gen.min_length > 1:
        raise ValueError("speculative decoding takes no repetition penalty or min_length")
    if dft_cfg.hidden != tgt_cfg.hidden:
        raise ValueError("the draft tower must share the target's embedding width")
    b, s, _ = inputs_embeds.shape
    if b != 1:
        raise ValueError("speculative decoding drives one stream")
    if attention_mask is None:
        attention_mask = torch.ones((b, s), dtype=torch.int32, device=inputs_embeds.device)
    embeds, mask = _pad_prompt(inputs_embeds, attention_mask, gen.pad_to_multiple)
    # k + 1 of slack: a round may write past the budget before rolling back
    max_len = embeds.shape[1] + gen.max_new_tokens + k + 1
    logits, tgt_cache = _prefill(tgt_params, embeds, mask, tgt_cfg, max_len)
    _, dft_cache = _prefill(dft_params, embeds, mask, dft_cfg, max_len)

    can_stop = bool(gen.stop_sequences) or (
        gen.eos_token_id is not None and gen.eos_token_id >= 0)
    generated: List[int] = []
    rounds_run = 0
    accepted: List[int] = []
    cur = torch.argmax(logits, dim=-1).to(torch.int32)
    pending = [int(cur[0])]

    def done():
        return ([generated], _stats(rounds_run, accepted)) if return_stats else [generated]

    while True:
        for tok in pending:
            generated.append(tok)
            if tok == gen.eos_token_id or any(
                    _ends_with(generated, st) for st in gen.stop_sequences):
                return done()
            if len(generated) >= gen.max_new_tokens:
                return done()
        remaining = gen.max_new_tokens - len(generated)
        budget = min(remaining, 4 * (k + 1)) if can_stop else remaining
        cur, tgt_cache, dft_cache, emit, cnt, r = _spec_chunk(
            tgt_params, dft_params, cur, tgt_cache, dft_cache, budget, tgt_cfg=tgt_cfg,
            dft_cfg=dft_cfg, k=k, max_rounds=gen.max_new_tokens)
        emit_h, cnt_h = emit.cpu().numpy(), cnt.cpu().numpy()
        pending = []
        for ri in range(r):
            c = int(cnt_h[ri, 0])
            pending.extend(int(t) for t in emit_h[ri, 0, :c])
            accepted.append(c - 1)
        rounds_run += r


def _stats(rounds: int, accepted: List[int]) -> Dict:
    acc = np.asarray(accepted, np.float64) if accepted else np.zeros(1)
    return {"rounds": rounds, "mean_accepted": float(acc.mean()),
            "tokens_per_round": float(acc.mean() + 1.0)}
