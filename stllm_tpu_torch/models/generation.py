"""Autoregressive generation with a KV cache (stllm_tpu/models/generation.py):
greedy, nucleus (top-p) sampling, the repetition penalty and min_length.

Prefill writes the padded prompt into a fresh cache; decode then runs in
chunks of steps on the device (a Python loop stands in for the reference's
``lax.scan``), and the host checks the stop conditions between chunks,
truncating any over-generation. Only the (B, n) token block of a chunk
crosses to the host. Token selection stays on the device with no host round
trip: sampled row r draws one uniform per token from its own
``torch.Generator`` seeded ``seed + r``, so the same seed gives the same
tokens on the same device (the JAX package's PRNG streams are not
reproduced; its keep sets are). Beam search comes with a later slice.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F

from stllm_tpu_torch.models.llama import (
    KVCache, LlamaConfig, init_kv_cache, llama_forward, lm_head)
from stllm_tpu_torch.ops.layers import gather_rows


class UnsupportedRequest(ValueError):
    """A generation request this serving path cannot serve (sampling, beams,
    penalties, an over-budget prompt). Genuine bugs raise plain ValueError."""


@dataclasses.dataclass
class GenerationConfig:
    max_new_tokens: int = 300
    min_length: int = 1
    do_sample: bool = False
    num_beams: int = 1
    top_p: float = 0.9
    temperature: float = 1.0
    repetition_penalty: float = 1.0
    length_penalty: float = 1.0
    stop_sequences: Sequence[Sequence[int]] = ((835,), (2277, 29937))  # '###'
    eos_token_id: int = 2
    pad_to_multiple: int = 64


def check_greedy(gen: GenerationConfig, what: str = "request") -> None:
    """Raise UnsupportedRequest unless ``gen`` is plain greedy decoding (the
    continuous batcher's and the QA server's only mode)."""
    if (gen.do_sample or gen.num_beams > 1 or gen.repetition_penalty != 1.0
            or gen.min_length > 1):
        raise UnsupportedRequest(
            f"{what}: the batcher serves greedy decoding only; sampled, penalized "
            "and min_length requests run through generate, beams are not ported yet")


def _pad_prompt(embeds: torch.Tensor, mask: torch.Tensor, multiple: int):
    pad = (-embeds.shape[1]) % multiple
    if pad:
        embeds = F.pad(embeds, (0, 0, 0, pad))
        mask = F.pad(mask, (0, pad))
    return embeds, mask


@torch.no_grad()
def _prefill(params, embeds: torch.Tensor, mask: torch.Tensor, cfg: LlamaConfig,
             max_len: int):
    """Prefill a fresh cache of ``max_len``; returns (logits at each row's
    last valid position (B, V) fp32, cache)."""
    cache = init_kv_cache(cfg, embeds.shape[0], max_len, device=embeds.device)
    hidden, cache = llama_forward(params, inputs_embeds=embeds, attention_mask=mask,
                                  cache=cache, cfg=cfg)
    last = (mask.sum(dim=-1).long() - 1).clamp(min=0)
    last_hidden = hidden[torch.arange(hidden.shape[0], device=hidden.device), last]
    return lm_head(params, last_hidden[:, None])[:, 0], cache


@torch.no_grad()
def _decode_step_impl(params, token_ids: torch.Tensor, cache: KVCache, cfg: LlamaConfig):
    embeds = gather_rows(params["embed_tokens"], token_ids)[:, None].to(cfg.dtype)
    hidden, cache = llama_forward(params, inputs_embeds=embeds, cache=cache, cfg=cfg)
    return lm_head(params, hidden)[:, 0], cache


@torch.no_grad()
def _decode_chunk_greedy(params, token_ids: torch.Tensor, cache: KVCache,
                         cfg: LlamaConfig, n: int):
    """Decode ``n`` greedy tokens on the device with no host round trip.
    Returns ((B, n) int32 tokens, cache). argmax takes the first index on
    ties, as JAX's does."""
    cur, toks = token_ids, []
    for _ in range(n):
        logits, cache = _decode_step_impl(params, cur, cache, cfg)
        cur = torch.argmax(logits, dim=-1).to(torch.int32)
        toks.append(cur)
    return torch.stack(toks, dim=1), cache


_TOPK_PREFILTER = 128


def _pick(weights: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Inverse-CDF draw: per row, the index whose cumulative slice of
    ``weights`` (B, K), non-negative, holds ``u`` (B,) in [0, 1) times the
    row's total. Zero weights are never drawn."""
    cum = torch.cumsum(weights, dim=-1)
    idx = torch.searchsorted(cum, (u * cum[:, -1]).unsqueeze(-1).contiguous(), right=True)
    last = ((weights > 0).sum(dim=-1, keepdim=True) - 1).clamp(min=0)
    return torch.minimum(idx, last)[:, 0]


def _topp_next(logits: torch.Tensor, u: torch.Tensor, temperature: torch.Tensor,
               top_p: torch.Tensor, sample_mask: torch.Tensor) -> torch.Tensor:
    """Exact nucleus (top-p) sampling per row, on the device, with the JAX
    package's truncation rule: sort the temperature-scaled logits
    descending (ties lowest index first), keep tokens while the mass before
    each one is below top_p (so the crossing token is kept), renormalize
    over the kept set and draw. Rows where ``sample_mask`` is False take the
    argmax.

    As in the JAX package the draw comes from the first 128 of that order
    (probabilities from the full logsumexp) wherever they hold top_p of the
    mass, and from the full sort only for rows where they fall short;
    covered rows keep their prefiltered draw. One stable sort serves both
    (its first 128 entries are the prefilter, in the same order), and both
    draws are made with no host round trip.

    logits (B, V) fp32; u (B,) uniforms in [0, 1); temperature, top_p,
    sample_mask (B,). Returns (B,) int32."""
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    scaled = logits / torch.clamp(temperature, min=1e-5)[:, None]
    k = min(_TOPK_PREFILTER, scaled.shape[-1])
    sorted_v, order = torch.sort(scaled, dim=-1, descending=True, stable=True)
    lz = torch.logsumexp(scaled, dim=-1, keepdim=True)
    probs = torch.exp(sorted_v[:, :k] - lz)              # true softmax probs of the top k
    cum = torch.cumsum(probs, dim=-1)
    keep = (cum - probs) < top_p[:, None]                 # the first token always kept
    fast = torch.gather(order[:, :k], -1, _pick(probs * keep, u)[:, None])[:, 0]
    if k < scaled.shape[-1]:
        p = torch.softmax(sorted_v, dim=-1)
        cumf = torch.cumsum(p, dim=-1)
        keepf = (cumf - p) < top_p[:, None]
        full = torch.gather(order, -1, _pick(p * keepf, u)[:, None])[:, 0]
        fast = torch.where(cum[:, -1] >= top_p, fast, full)
    return torch.where(sample_mask, fast.to(torch.int32), greedy)


def _first_token_mixed(logits, u, temperature, top_p, sample_mask):
    """Sample or argmax the prefill logits (token index 0 of each stream)."""
    return _topp_next(logits.float(), u, temperature, top_p, sample_mask)


def _first_token_sampled(logits, seed: int, temperature: float, top_p: float):
    """Token index 0 of a one-row sampled stream seeded ``seed``. Returns
    (token (1,), the stream's generator, advanced past that draw)."""
    dev = logits.device
    g = torch.Generator(device=dev).manual_seed(int(seed))
    u = torch.rand((1,), generator=g, device=dev)
    tok = _topp_next(logits.float(), u, torch.full((1,), temperature, device=dev),
                     torch.full((1,), top_p, device=dev),
                     torch.ones((1,), dtype=torch.bool, device=dev))
    return tok, g


def _penalize_logits(lg: torch.Tensor, seen: torch.Tensor, penalty: torch.Tensor) -> torch.Tensor:
    """HF RepetitionPenaltyLogitsProcessor on raw logits: tokens generated
    so far (``seen`` (B, V) bool) have positive logits divided by the
    penalty and negative ones multiplied. ``penalty`` (B,); 1.0 is the exact
    identity (the reference forces 1.5 in simple-prompt chat,
    conversation.py:226)."""
    pen = penalty[:, None]
    return torch.where(seen, torch.where(lg < 0, lg * pen, lg / pen), lg)


def _mask_min_length(lg: torch.Tensor, step: torch.Tensor, min_len: torch.Tensor,
                     eos: torch.Tensor) -> torch.Tensor:
    """-1e30 in the eos column of rows whose emitted-token index ``step``
    (B,) is still below ``min_len`` (B,). A negative ``eos`` matches no
    column. The rule fires at step 0 even for the default min_length 1, as
    the reference's host loop does."""
    col = torch.arange(lg.shape[-1], device=lg.device)[None, :] == eos[:, None]
    return torch.where(col & (step < min_len)[:, None], torch.full_like(lg, -1e30), lg)


def _first_token_penalized(logits, u, temperature, top_p, sample_mask, min_len, eos):
    """Token index 0 under min_length eos masking (the repetition penalty is
    a no-op at step 0: nothing has been generated)."""
    lg = logits.float()
    step = torch.zeros(lg.shape[:1], dtype=torch.int32, device=lg.device)
    return _topp_next(_mask_min_length(lg, step, min_len, eos), u, temperature, top_p,
                      sample_mask)


@torch.no_grad()
def _decode_chunk_mixed(params, token_ids: torch.Tensor, cache: KVCache, cfg: LlamaConfig,
                        n: int, u: torch.Tensor, temperature, top_p, sample_mask):
    """Decode ``n`` tokens on the device with per-row greedy or top-p
    selection; ``u`` (B, n) holds each row's uniforms for these tokens.
    Returns ((B, n) int32 tokens, cache)."""
    cur, toks = token_ids, []
    for i in range(n):
        logits, cache = _decode_step_impl(params, cur, cache, cfg)
        cur = _topp_next(logits.float(), u[:, i], temperature, top_p, sample_mask)
        toks.append(cur)
    return torch.stack(toks, dim=1), cache


@torch.no_grad()
def _decode_chunk_penalized(params, token_ids: torch.Tensor, cache: KVCache,
                            seen: torch.Tensor, cfg: LlamaConfig, n: int, u: torch.Tensor,
                            counters: torch.Tensor, temperature, top_p, sample_mask,
                            penalty, min_len, eos):
    """_decode_chunk_mixed plus the repetition penalty over the (B, V)
    ``seen`` set of generated tokens (updated in place and returned, so it
    persists across chunks) and min_length eos masking at token index
    ``counters + i``. Returns ((B, n) tokens, cache, seen)."""
    rows = torch.arange(token_ids.shape[0], device=token_ids.device)
    cur, toks = token_ids, []
    for i in range(n):
        # the incoming token is part of the generated sequence the penalty reads
        seen[rows, cur.long()] = True
        logits, cache = _decode_step_impl(params, cur, cache, cfg)
        lg = _penalize_logits(logits.float(), seen, penalty)
        lg = _mask_min_length(lg, counters + i, min_len, eos)
        cur = _topp_next(lg, u[:, i], temperature, top_p, sample_mask)
        toks.append(cur)
    return torch.stack(toks, dim=1), cache, seen


def _ends_with(ids: List[int], suffix: Sequence[int]) -> bool:
    n = len(suffix)
    return len(ids) >= n and ids[-n:] == list(suffix)


@torch.no_grad()
def generate(
    params,
    inputs_embeds: torch.Tensor,
    attention_mask: Optional[torch.Tensor] = None,
    *,
    llama_cfg: LlamaConfig,
    gen: GenerationConfig = GenerationConfig(),
    seed: int = 0,
) -> List[List[int]]:
    """Token ids per batch row (stop sequence included when hit): greedy,
    sampled (``gen.do_sample``, row r seeded ``seed + r``), or penalized
    (repetition_penalty != 1 or min_length > 1, greedy or sampled)."""
    if gen.num_beams > 1:
        raise UnsupportedRequest("generate: beam search is not ported yet")
    b, s, _ = inputs_embeds.shape
    if attention_mask is None:
        attention_mask = torch.ones((b, s), dtype=torch.int32, device=inputs_embeds.device)
    embeds, mask = _pad_prompt(inputs_embeds, attention_mask, gen.pad_to_multiple)
    logits, cache = _prefill(params, embeds, mask, llama_cfg,
                             embeds.shape[1] + gen.max_new_tokens)
    if gen.repetition_penalty == 1.0 and gen.min_length <= 1:
        if not gen.do_sample:
            return _generate_greedy_ondevice(params, logits, cache, llama_cfg, gen, b)[0]
        return _generate_sample_ondevice(params, logits, cache, llama_cfg, gen, b, seed)[0]
    return _generate_penalized_ondevice(params, logits, cache, llama_cfg, gen, b, seed)[0]


def _generate_greedy_ondevice(params, logits, cache: KVCache, llama_cfg: LlamaConfig,
                              gen: GenerationConfig, b: int, chunk: int = 16):
    """Greedy loop, ``chunk`` tokens per device run. Returns (generated,
    final cache)."""
    state = {"cur": torch.argmax(logits, dim=-1).to(torch.int32), "cache": cache}

    def run_chunk(n):
        toks, state["cache"] = _decode_chunk_greedy(
            params, state["cur"], state["cache"], llama_cfg, n)
        state["cur"] = toks[:, -1]
        return toks

    out = _chunked_decode_loop(b, gen, state["cur"], run_chunk, chunk)
    return out, state["cache"]


def _row_uniforms(seed: int, b: int, n: int, device) -> torch.Tensor:
    """(b, n) uniforms: row r is the first n draws of a torch.Generator on
    ``device`` seeded ``seed + r``; token index t of row r uses column t,
    whatever the chunking."""
    return torch.stack([torch.rand((n,), generator=torch.Generator(device=device)
                                   .manual_seed(seed + r), device=device)
                        for r in range(b)])


def _row_params(gen: GenerationConfig, b: int, device):
    """Per-row temperature and top_p tensors (B,)."""
    return (torch.full((b,), gen.temperature, dtype=torch.float32, device=device),
            torch.full((b,), gen.top_p, dtype=torch.float32, device=device))


def _generate_sample_ondevice(params, logits, cache: KVCache, llama_cfg: LlamaConfig,
                              gen: GenerationConfig, b: int, seed: int, chunk: int = 16):
    """Nucleus sampling in the same chunked loop as greedy. Returns
    (generated, final cache)."""
    dev = logits.device
    u = _row_uniforms(seed, b, gen.max_new_tokens, dev)
    temp, topp = _row_params(gen, b, dev)
    samp = torch.ones((b,), dtype=torch.bool, device=dev)
    first = _first_token_mixed(logits, u[:, 0], temp, topp, samp)
    state = {"cur": first, "cache": cache, "count": 1}

    def run_chunk(n):
        c = state["count"]
        toks, state["cache"] = _decode_chunk_mixed(
            params, state["cur"], state["cache"], llama_cfg, n, u[:, c:c + n], temp, topp, samp)
        state["cur"] = toks[:, -1]
        state["count"] += n
        return toks

    out = _chunked_decode_loop(b, gen, first, run_chunk, chunk)
    return out, state["cache"]


def _generate_penalized_ondevice(params, logits, cache: KVCache, llama_cfg: LlamaConfig,
                                 gen: GenerationConfig, b: int, seed: int, chunk: int = 16):
    """The chunked loop for repetition-penalty and min_length configs,
    greedy or sampled (the simple-prompt chat mode, where the reference
    forces repetition_penalty 1.5). Greedy tokens equal the JAX package's.
    Returns (generated, final cache)."""
    dev = logits.device
    u = _row_uniforms(seed, b, gen.max_new_tokens, dev)
    temp, topp = _row_params(gen, b, dev)
    samp = torch.full((b,), bool(gen.do_sample), dtype=torch.bool, device=dev)
    pen = torch.full((b,), gen.repetition_penalty, dtype=torch.float32, device=dev)
    minl = torch.full((b,), gen.min_length, dtype=torch.int32, device=dev)
    eos_id = -1 if gen.eos_token_id is None else gen.eos_token_id
    eos = torch.full((b,), eos_id, dtype=torch.int32, device=dev)
    first = _first_token_penalized(logits, u[:, 0], temp, topp, samp, minl, eos)
    state = {"cur": first, "cache": cache, "count": 1,
             "seen": torch.zeros((b, logits.shape[-1]), dtype=torch.bool, device=dev)}

    def run_chunk(n):
        c = state["count"]
        toks, state["cache"], state["seen"] = _decode_chunk_penalized(
            params, state["cur"], state["cache"], state["seen"], llama_cfg, n, u[:, c:c + n],
            torch.full((b,), c, dtype=torch.int32, device=dev), temp, topp, samp, pen, minl, eos)
        state["cur"] = toks[:, -1]
        state["count"] += n
        return toks

    out = _chunked_decode_loop(b, gen, first, run_chunk, chunk)
    return out, state["cache"]


def _chunked_decode_loop(b: int, gen: GenerationConfig, first: torch.Tensor,
                         run_chunk, chunk: int) -> List[List[int]]:
    """Host side of the chunked decode: emit tokens, check per-row stop
    conditions between chunks, truncate over-generation. When no early stop
    is possible the whole budget runs as one chunk."""
    can_stop = bool(gen.stop_sequences) or (
        gen.eos_token_id is not None and gen.eos_token_id >= 0)
    if not can_stop:
        chunk = gen.max_new_tokens
    generated: List[List[int]] = [[] for _ in range(b)]
    done = [False] * b
    emitted = 0
    pending = first.cpu().numpy()[:, None]
    while True:
        for col in range(pending.shape[1]):
            for i in range(b):
                if not done[i]:
                    generated[i].append(int(pending[i, col]))
                    if int(pending[i, col]) == gen.eos_token_id or any(
                            _ends_with(generated[i], st) for st in gen.stop_sequences):
                        done[i] = True
            emitted += 1
            if emitted >= gen.max_new_tokens or all(done):
                return generated
        pending = run_chunk(min(chunk, gen.max_new_tokens - emitted)).cpu().numpy()
