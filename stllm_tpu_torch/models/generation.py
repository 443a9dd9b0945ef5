"""Autoregressive generation with a KV cache (stllm_tpu/models/generation.py):
greedy, nucleus (top-p) sampling, the repetition penalty and min_length,
multi-turn prefix reuse (``PrefixSession``) and beam search (solo, batched
over P prompts, and the step-wise host loop that is its oracle).

Prefill writes the padded prompt into a fresh cache; decode then runs in
chunks of steps on the device (a Python loop stands in for the reference's
``lax.scan``), and the host checks the stop conditions between chunks,
truncating any over-generation. Only the (B, n) token block of a chunk
crosses to the host. Token selection stays on the device with no host round
trip: sampled row r draws one uniform per token from its own
``torch.Generator`` seeded ``seed + r``, so the same seed gives the same
tokens on the same device (the JAX package's PRNG streams are not
reproduced; its keep sets are).

Beam search decodes on ``llama_decode_prefix``: the prompt is prefilled once
and each beam keeps only its generated tokens' KV. The device form runs
``chunk`` whole beam steps (decode, candidate ranking, the pool of finished
hypotheses, survivor selection) with no host round trip and returns
backpointer records the host walks back into sequences. Every ranking is a
stable descending sort, so ties fall in beam-major order, as ``lax.top_k``
breaks them in the reference.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from stllm_tpu_torch.models.llama import (
    KVCache, LlamaConfig, init_kv_cache, llama_decode_prefix, llama_forward, lm_head)
from stllm_tpu_torch.ops.layers import gather_rows
from stllm_tpu_torch.ops.spmd import model_parallel
from stllm_tpu_torch.parallel.mesh import MODEL_AXIS
from stllm_tpu_torch.parallel.sharding import compute_tree, llama_tp_plan


class UnsupportedRequest(ValueError):
    """A generation request this serving path cannot serve (sampling, beams,
    penalties, an over-budget prompt). Callers catch exactly this to fall
    back to solo ``generate``; genuine bugs raise plain ValueError."""


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


def _pad_kv_time(cache: KVCache, w: int) -> KVCache:
    """Zero-pad every buffer of ``cache`` (the int8 scale planes too) along
    the time axis to width ``w`` >= its own, into new buffers whatever ``w``
    is (``torch.cat`` always copies): callers write the result in place and
    keep the input (the batcher's stored shared prefix)."""
    def pad_to(c):
        return torch.cat([c, c.new_zeros((c.shape[0], w - c.shape[1]) + c.shape[2:])], dim=1)

    scales = {}
    if cache.k_scale is not None:
        scales = {"k_scale": tuple(pad_to(c) for c in cache.k_scale),
                  "v_scale": tuple(pad_to(c) for c in cache.v_scale)}
    return cache._replace(k=tuple(pad_to(c) for c in cache.k),
                          v=tuple(pad_to(c) for c in cache.v), **scales)


@torch.no_grad()
def _prefill_delta(params, embeds: torch.Tensor, mask: torch.Tensor, cache: KVCache,
                   cfg: LlamaConfig):
    """Prefill a right-padded chunk of NEW tokens into an existing cache at
    each row's ``cache.length`` (absolute RoPE positions, attention causal
    against the cache), which equals prefilling the whole prompt from
    scratch: every kv position at or below a real query's position was
    written this turn or an earlier one, and positions past the valid ones
    are read only by pad queries, whose outputs are dropped. Writes in
    place. Returns (logits at the last valid position (B, V), cache)."""
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


def _reorder_cache(cache: KVCache, reorder: torch.Tensor) -> KVCache:
    """Gather beam rows ``reorder`` in every per-layer buffer, in place (the
    buffers keep their addresses)."""
    idx = reorder.long()
    for group in (cache.k, cache.v, cache.k_scale or (), cache.v_scale or ()):
        for a in group:
            a.copy_(a.index_select(0, idx))
    return cache._replace(length=cache.length.index_select(0, idx))


def _top_k(x: torch.Tensor, k: int):
    """``lax.top_k`` along the last axis: the k largest values, descending,
    ties in index order (a stable sort; torch.topk orders no ties)."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


@torch.no_grad()
def _decode_step_logp_prefix(params, token_ids: torch.Tensor, prefix: KVCache,
                             gen_cache: KVCache, reorder: torch.Tensor, cfg: LlamaConfig):
    """A beam step's decode: reorder the beams' generated cache, decode one
    token a row against the shared prefix, and return (log-softmax (B, V)
    fp32, gen cache). The host loop's penalized form takes the full logp
    (the penalty reshuffles ranks, so no top-k can be taken before it)."""
    gen_cache = _reorder_cache(gen_cache, reorder)
    embeds = gather_rows(params["embed_tokens"], token_ids)[:, None].to(cfg.dtype)
    hidden, gen_cache = llama_decode_prefix(params, embeds, prefix, gen_cache, cfg)
    return torch.log_softmax(lm_head(params, hidden)[:, 0], dim=-1), gen_cache


@torch.no_grad()
def _decode_step_topk_prefix(params, token_ids: torch.Tensor, prefix: KVCache,
                             gen_cache: KVCache, reorder: torch.Tensor, cfg: LlamaConfig, k: int):
    """The host beam loop's device step: beam reorder, prefix-shared decode,
    log-softmax and top-k in one call, so only (B, k) values and ids cross
    to the host. Returns (top values, top ids int32, gen cache)."""
    logp, gen_cache = _decode_step_logp_prefix(params, token_ids, prefix, gen_cache, reorder, cfg)
    top_v, top_i = _top_k(logp, k)
    return top_v, top_i.to(torch.int32), gen_cache


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
    mesh=None,
    specs=None,
) -> List[List[int]]:
    """Token ids per batch row (stop sequence included when hit): greedy,
    sampled (``gen.do_sample``, row r seeded ``seed + r``), penalized
    (repetition_penalty != 1 or min_length > 1, greedy or sampled), or beam
    search (``gen.num_beams > 1``, each row on its own).

    On a ``mesh`` (``parallel/mesh.py``) ``params`` is this rank's slice of
    the LLaMA tree by ``specs`` (``stllm_param_shardings``): the leaves are
    gathered over 'data' and, where the rules split them, the layers and the
    head run tensor-parallel over 'model' with a cache of this rank's heads.
    Every rank runs the same loop on the same prompts and returns the same
    tokens."""
    if mesh is not None:
        plan = llama_tp_plan(mesh, params, specs, llama_cfg.heads)
        tree = compute_tree(mesh, params, specs, plan)
        with model_parallel(mesh.groups[MODEL_AXIS], plan):
            return generate(tree, inputs_embeds, attention_mask, llama_cfg=llama_cfg, gen=gen,
                            seed=seed)
    if gen.num_beams > 1:
        return [beam_search(params, inputs_embeds[i:i + 1],
                            None if attention_mask is None else attention_mask[i:i + 1],
                            llama_cfg=llama_cfg, gen=gen)
                for i in range(inputs_embeds.shape[0])]
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


def _apply_repetition_penalty(logits: np.ndarray, generated: List[List[int]],
                              penalty: float) -> np.ndarray:
    """The host loop's penalty, in place on (B, V) logits."""
    if penalty == 1.0:
        return logits
    for row, ids in enumerate(generated):
        for t in set(ids):
            v = logits[row, t]
            logits[row, t] = v * penalty if v < 0 else v / penalty
    return logits


def _generate_host_loop(params, logits, cache: KVCache, llama_cfg: LlamaConfig,
                        gen: GenerationConfig, b: int, seed: int):
    """The per-token greedy host loop, kept as the oracle of the penalized
    chunked loop (same signature; ``seed`` is unused). Returns (generated,
    final cache)."""
    if gen.do_sample:
        raise ValueError("the host loop is the greedy oracle; sampling runs on the device")
    generated: List[List[int]] = [[] for _ in range(b)]
    done = [False] * b
    for step in range(gen.max_new_tokens):
        lg = _apply_repetition_penalty(np.array(logits.float().cpu(), np.float32), generated,
                                       gen.repetition_penalty)
        if step < gen.min_length:
            lg[:, gen.eos_token_id] = -1e30
        nxt = lg.argmax(axis=-1)
        for i in range(b):
            if not done[i]:
                generated[i].append(int(nxt[i]))
                if int(nxt[i]) == gen.eos_token_id or any(
                        _ends_with(generated[i], stop) for stop in gen.stop_sequences):
                    done[i] = True
        if all(done):
            break
        cur = torch.as_tensor(nxt, dtype=torch.int32, device=logits.device)
        logits, cache = _decode_step_impl(params, cur, cache, llama_cfg)
    return generated, cache


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


class PrefixSession:
    """Multi-turn KV reuse for one conversation. Every chat turn's prompt
    holds the whole conversation (system text, the video block, earlier
    turns); the session keeps the conversation's cache between turns,
    matches the new prompt against what is cached (text tokens by id, video
    tokens by the embedding tensor's identity and position) and prefills
    only the unmatched tail.

    A changed prompt (another video, edited history, a ``max_length`` cut
    that shifts the window) degrades to a full re-prefill, never a wrong
    answer: the cache length is reset to the matched count, so a stale
    position is read only after this turn has rewritten it. In fp32 the
    tokens equal solo ``generate``'s; in bf16 the delta prefill is another
    program shape and can flip a near tie.

    The cache is written in place; a turn drops its handle on the cache
    before the delta prefill, so a turn that dies mid-write leaves no
    half-written buffer to reuse: the next turn re-prefills from scratch.
    """

    # cache-width growth bucket: keeps early turns near their solo-prefill
    # attention cost while bounding how often the cache is regrown
    _WINDOW = 256

    def __init__(self, params, llama_cfg: LlamaConfig, max_len: int = 2048):
        self.params = params
        self.cfg = llama_cfg
        self.max_len = max_len
        self.cache: Optional[KVCache] = None
        self.items: List = []      # identity of each cached position
        self.last_reused = 0       # positions the last turn took from the cache

    class _Ref:
        """Identity wrapper for a video-embedding tensor: equal only to a
        wrapper of the same tensor object (values are never compared), and
        it keeps the tensor alive, so a recycled ``id()`` cannot alias a
        dropped upload."""

        __slots__ = ("a",)

        def __init__(self, a):
            self.a = a

        def __eq__(self, other):
            return isinstance(other, PrefixSession._Ref) and self.a is other.a

        def __hash__(self):
            return id(self.a)

    @staticmethod
    def items_for(segment_ids: Sequence[Sequence[int]], img_list: Sequence) -> List:
        """Flatten interleaved [text ids, video, text ids, ...] into
        per-token identity items: ("t", id) for text, ("v", ref, j) for
        position j of a video embedding (1, V, D)."""
        items: List = []
        for i, ids in enumerate(segment_ids):
            items.extend(("t", int(t)) for t in ids)
            if i < len(img_list):
                ref = PrefixSession._Ref(img_list[i])
                items.extend(("v", ref, j) for j in range(img_list[i].shape[1]))
        return items

    @torch.no_grad()
    def generate(self, inputs_embeds: torch.Tensor, items: Sequence,
                 gen: GenerationConfig = GenerationConfig(), *, seed: int = 0) -> List[int]:
        """One turn: delta-prefill against the cached prefix, decode (greedy,
        sampled or penalized, through the chunked loops), keep the cache and
        the token record. Returns the tokens ``generate`` gives for the full
        prompt. Raises UnsupportedRequest for what the session cannot serve
        (batch > 1, beams, a prompt plus budget past max_len)."""
        b, s, _ = inputs_embeds.shape
        if b != 1:
            raise UnsupportedRequest("PrefixSession is per-conversation (batch 1)")
        if gen.num_beams > 1:
            raise UnsupportedRequest("beam search needs solo generate")
        if s != len(items):
            raise ValueError(f"items/embeds length mismatch: {len(items)} vs {s}")
        # write extents: a from-scratch prefill writes pad(s) slots, decode
        # [s, s + budget); both must fit, since a write start past the end
        # is clamped back onto committed positions
        pad_m = gen.pad_to_multiple
        s_pad = s + (-s) % pad_m
        if max(s_pad, s + gen.max_new_tokens) > self.max_len:
            raise UnsupportedRequest(
                f"prompt {s} (padded {s_pad}) + budget {gen.max_new_tokens} exceeds "
                f"session max_len {self.max_len}")

        items = list(items)
        p = 0
        if self.cache is not None:
            # no cache with items left = a turn died after dropping it:
            # re-prefill from scratch
            for a, bb in zip(self.items, items):
                if a != bb:
                    break
                p += 1
        # the last prompt position is always recomputed: its logits seed decode
        p = min(p, s - 1)
        # the delta's padded write span [p, p + pad(s - p)) must fit max_len
        while p > 0 and p + (s - p) + (-(s - p)) % pad_m > self.max_len:
            p -= 1
        need = max(p + (s - p) + (-(s - p)) % pad_m, s + gen.max_new_tokens)
        w = min(self.max_len, -(-need // self._WINDOW) * self._WINDOW)
        delta, mask = _pad_prompt(inputs_embeds[:, p:],
                                  torch.ones((1, s - p), dtype=torch.int32,
                                             device=inputs_embeds.device), pad_m)
        if self.cache is None and p == 0:
            self.last_reused = 0
            logits, cache = _prefill(self.params, delta, mask, self.cfg, w)
        else:
            cache = self.cache
            self.cache = None  # written in place below; never keep a half-written one
            if cache.k[0].shape[1] < w:
                # grow to the next history bucket, not max_len: prefill and
                # decode attend over the whole buffer
                cache = _pad_kv_time(cache, w)
            self.last_reused = p
            cache = cache._replace(length=torch.full((1,), p, dtype=torch.int32,
                                                     device=cache.length.device))
            logits, cache = _prefill_delta(self.params, delta, mask, cache, self.cfg)

        if gen.repetition_penalty != 1.0 or gen.min_length > 1:
            out, cache = _generate_penalized_ondevice(self.params, logits, cache, self.cfg,
                                                      gen, 1, seed)
        elif not gen.do_sample:
            out, cache = _generate_greedy_ondevice(self.params, logits, cache, self.cfg, gen, 1)
        else:
            out, cache = _generate_sample_ondevice(self.params, logits, cache, self.cfg,
                                                   gen, 1, seed)
        self.cache = cache
        generated = out[0]
        # the last emitted token may not have been fed back (no KV for it)
        self.items = items + [("t", int(t)) for t in generated[:-1]]
        return list(generated)

    def release(self) -> None:
        """Drop the cache now; the next turn re-prefills from scratch."""
        self.cache = None
        self.items = []
        self.last_reused = 0


# ---------------------------------------------------------------------------
# Beam search
# ---------------------------------------------------------------------------
#
# The device form replicates the host loop candidate for candidate: all
# k * 2k candidates ranked by score (ties in beam-major order), scanned in
# rank order, finished candidates pooled until the k-th survivor is found,
# survivors padded by repetition when fewer than k exist. It covers stop
# sequences of up to 2 tokens plus eos (the protocol's '###' stops), with
# min_length by candidate exclusion; longer stops take the host loop.


class _BeamProto(NamedTuple):
    """The static part of a GenerationConfig the beam step reads."""
    eos: int
    stops1: Tuple[int, ...]              # single-token stop ids
    stops2: Tuple[Tuple[int, int], ...]  # two-token stop suffixes
    min_length: int
    length_penalty: float
    rep_penalty: float = 1.0

    @staticmethod
    def from_gen(gen: GenerationConfig) -> "_BeamProto":
        return _BeamProto(
            eos=gen.eos_token_id,
            stops1=tuple(s[-1] for s in gen.stop_sequences if len(s) == 1),
            stops2=tuple(tuple(s) for s in gen.stop_sequences if len(s) == 2),
            min_length=gen.min_length, length_penalty=gen.length_penalty,
            rep_penalty=gen.repetition_penalty)


def beam_device_supported(gen: GenerationConfig) -> bool:
    return all(len(s) <= 2 for s in gen.stop_sequences)


def _penalize_logp(logp: torch.Tensor, seen: torch.Tensor, pen: float) -> torch.Tensor:
    """HF's beam-mode repetition penalty: on the LOG-SOFTMAXED scores, per
    beam, over that beam's generated tokens (greedy and sampling apply it to
    raw logits instead). The reference forces 1.5 into simple-prompt beam
    answers, which qabench and vcgbench run (conversation.py:220, 240)."""
    return torch.where(seen, torch.where(logp < 0, logp * pen, logp / pen), logp)


def _update_seen(seen: torch.Tensor, parents: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """seen (P, k, V) bool: each new beam inherits its parent's token set
    plus its own new token."""
    out = seen.gather(1, parents.long()[..., None].expand(-1, -1, seen.shape[-1]))
    return out.scatter_(2, tokens.long()[..., None], True)


class _BeamState(NamedTuple):
    """Beam-search state of P prompts; every field has a leading P axis."""
    scores: torch.Tensor        # (P, k) cumulative log-probs
    last_token: torch.Tensor    # (P, k) int32, the token to feed next
    reorder: torch.Tensor       # (P, k) int32, parent beam for the next decode
    step: torch.Tensor          # (P,) int32, tokens emitted so far
    fin_count: torch.Tensor     # (P,) int32, finished hypotheses so far
    pool_score: torch.Tensor    # (P, k) length-penalized scores of the best finished
    pool_step: torch.Tensor     # (P, k) step at which each pool entry finished
    pool_parent: torch.Tensor   # (P, k) its parent beam at that step
    pool_token: torch.Tensor    # (P, k) its final token
    no_survivors: torch.Tensor  # (P,) bool, a step left no survivor


def _beam_state0(p: int, k: int, device) -> _BeamState:
    """Beam 0 at score 0, beams 1..k-1 at -1e9 (so the first step's
    candidates all come from beam 0), an empty pool."""
    scores = torch.full((p, k), -1e9, dtype=torch.float32, device=device)
    scores[:, 0] = 0.0
    zeros = torch.zeros((p, k), dtype=torch.int32, device=device)
    return _BeamState(
        scores=scores, last_token=zeros, reorder=zeros + torch.arange(k, dtype=torch.int32,
                                                                     device=device),
        step=torch.zeros((p,), dtype=torch.int32, device=device),
        fin_count=torch.zeros((p,), dtype=torch.int32, device=device),
        pool_score=torch.full((p, k), float("-inf"), device=device),
        pool_step=zeros, pool_parent=zeros, pool_token=zeros,
        no_survivors=torch.zeros((p,), dtype=torch.bool, device=device))


def _beam_transition(state: _BeamState, top_v: torch.Tensor, top_i: torch.Tensor,
                     proto: _BeamProto, k: int):
    """One beam step of P prompts from their (P, k, 2k) per-beam top
    log-probs. Returns the new state and this step's backpointer record
    {parent, token}, each (P, k)."""
    p, _, w = top_v.shape
    dev = top_v.device
    n_cand = k * w
    # all k * 2k candidates, beam-major (the host loop's enumeration order)
    cand_score = (state.scores[:, :, None] + top_v).reshape(p, n_cand)
    cand_token = top_i.reshape(p, n_cand)
    cand_parent = torch.arange(k, dtype=torch.int32, device=dev).repeat_interleave(w)

    # min_length: drop eos candidates while step < min_length (the host
    # loop's check fires at step 0 even for the default min_length 1)
    if proto.min_length > 0:
        excl = (cand_token == proto.eos) & (state.step[:, None] < proto.min_length)
        cand_score = torch.where(excl, float("-inf"), cand_score)

    sort_v, sort_idx = torch.sort(cand_score, dim=-1, descending=True, stable=True)
    sort_token = cand_token.gather(1, sort_idx)
    sort_parent = cand_parent[sort_idx]

    fin = sort_token == proto.eos
    for t in proto.stops1:
        fin = fin | (sort_token == t)
    for a, b in proto.stops2:
        # the candidate's last two tokens: its parent's last one and its own
        fin = fin | ((state.last_token.gather(1, sort_parent.long()) == a)
                     & (sort_token == b) & (state.step[:, None] >= 1))

    # survivors fill the beam in rank order; finished candidates ranked
    # before the k-th survivor join the pool
    surv_cum = torch.cumsum((~fin).to(torch.int32), dim=-1)
    total = surv_cum[:, -1]
    n_surv = total.clamp(max=k)
    processed = torch.where(total >= k, (surv_cum < k).sum(dim=-1) + 1, n_cand)
    ar = torch.arange(n_cand, device=dev)
    eligible = fin & (ar[None, :] < processed[:, None]) & torch.isfinite(sort_v)

    # pos_of_rank[r]: candidate index of the (r+1)-th survivor; finished and
    # rank >= k candidates land in slot k, which is dropped
    rank = torch.where(fin | (surv_cum > k), k, surv_cum - 1).long()
    pos_of_rank = torch.full((p, k + 1), n_cand - 1, dtype=torch.long, device=dev).scatter_reduce(
        1, rank, ar.expand(p, n_cand), "amin")[:, :k]
    last_surv = pos_of_rank.gather(1, (n_surv - 1).clamp(0, k - 1).long()[:, None])
    slots = torch.where(torch.arange(k, device=dev)[None, :] < n_surv[:, None],
                        pos_of_rank, last_surv)
    new_tokens = sort_token.gather(1, slots)
    new_parents = sort_parent.gather(1, slots)

    # pool the finished candidates, length-penalized; keep the best k
    length = (state.step + 1).float()
    fin_norm = torch.where(eligible, sort_v / (length ** proto.length_penalty)[:, None],
                           float("-inf"))
    best_v, best_i = _top_k(torch.cat([state.pool_score, fin_norm], dim=1), k)
    all_step = torch.cat([state.pool_step, state.step[:, None].expand(p, n_cand)], dim=1)
    all_parent = torch.cat([state.pool_parent, sort_parent], dim=1)
    all_token = torch.cat([state.pool_token, sort_token], dim=1)
    new_state = _BeamState(
        scores=sort_v.gather(1, slots), last_token=new_tokens, reorder=new_parents,
        step=state.step + 1,
        fin_count=state.fin_count + eligible.sum(dim=-1, dtype=torch.int32),
        pool_score=best_v, pool_step=all_step.gather(1, best_i),
        pool_parent=all_parent.gather(1, best_i), pool_token=all_token.gather(1, best_i),
        no_survivors=state.no_survivors | (n_surv == 0))
    return new_state, {"parent": new_parents, "token": new_tokens}


def _first_transition(logits: torch.Tensor, proto: _BeamProto, k: int, vocab: int):
    """The first beam step of P prompts from their prefill logits (P, V):
    the top 2k taken on the host by NumPy (its argsort, as the reference
    takes it), the transition on the device. Returns (state, seen, record)."""
    dev = logits.device
    lg = np.array(logits.float().cpu(), np.float32)
    mx = lg.max(-1, keepdims=True)
    logp0 = lg - np.log(np.exp(lg - mx).sum(-1, keepdims=True)) - mx
    order = np.argsort(-logp0, axis=-1)[:, :2 * k]                      # (P, 2k)
    top_v = np.repeat(np.take_along_axis(logp0, order, -1)[:, None], k, 1)
    top_i = np.repeat(order[:, None], k, 1)                             # (P, k, 2k)
    p = lg.shape[0]
    state, rec = _beam_transition(
        _beam_state0(p, k, dev), torch.from_numpy(top_v).to(dev),
        torch.from_numpy(top_i.astype(np.int32)).to(dev), proto, k)
    seen = torch.zeros((p, k, vocab), dtype=torch.bool, device=dev)
    seen.scatter_(2, state.last_token.long()[..., None], True)
    return state, seen, rec


@torch.no_grad()
def _beam_chunk_device(params, state: _BeamState, seen: torch.Tensor, prefix: KVCache,
                       gen_cache: KVCache, cfg: LlamaConfig, proto: _BeamProto, k: int,
                       chunk: int):
    """``chunk`` whole beam steps of P prompts (P * k decode rows, each
    prompt's KV once in ``prefix``) on the device, with no host round trip.
    A prompt whose search has ended (pool full or no survivor) keeps
    decoding but its state and ``seen`` (P, k, V) freeze, and its records
    are marked not alive. Solo beam search is P = 1. Returns (state, seen,
    gen cache, records {parent, token: (chunk, P, k), alive: (chunk, P)})."""
    p = state.scores.shape[0]
    offs = (torch.arange(p, dtype=torch.int32, device=seen.device) * k)[:, None]
    records = {"parent": [], "token": [], "alive": []}
    for _ in range(chunk):
        alive = (state.fin_count < k) & ~state.no_survivors             # (P,)
        logp, gen_cache = _decode_step_logp_prefix(
            params, state.last_token.reshape(-1), prefix, gen_cache,
            (state.reorder + offs).reshape(-1), cfg)
        if proto.rep_penalty != 1.0:
            logp = _penalize_logp(logp.reshape(p, k, -1), seen,
                                  proto.rep_penalty).reshape(p * k, -1)
        top_v, top_i = _top_k(logp, 2 * k)
        new_state, rec = _beam_transition(state, top_v.reshape(p, k, 2 * k),
                                          top_i.to(torch.int32).reshape(p, k, 2 * k), proto, k)
        new_seen = _update_seen(seen, new_state.reorder, new_state.last_token)
        state = _BeamState(*(torch.where(alive.reshape((p,) + (1,) * (n.ndim - 1)), n, o)
                             for n, o in zip(new_state, state)))
        seen = torch.where(alive[:, None, None], new_seen, seen)
        for key, val in (("parent", rec["parent"]), ("token", rec["token"]), ("alive", alive)):
            records[key].append(val)
    return state, seen, gen_cache, {key: torch.stack(v) for key, v in records.items()}


def _host_read(state: _BeamState, records=None):
    """The host's reads after a chunk: (fin_count, no_survivors, records),
    as NumPy."""
    rec = None if records is None else {k: v.cpu().numpy() for k, v in records.items()}
    return state.fin_count.cpu().numpy(), state.no_survivors.cpu().numpy(), rec


def _reconstruct(parents, tokens, v: int, step: int, parent: int, token: int) -> List[int]:
    """Walk prompt v's backpointers: the sequence of length step + 1 ending
    in ``token``, whose parent at ``step`` is beam ``parent``."""
    seq = [int(token)]
    b = int(parent)
    for t in range(step - 1, -1, -1):
        seq.append(int(tokens[t][v][b]))
        b = int(parents[t][v][b])
    return seq[::-1]


def _beam_search_ondevice(params, embeds: torch.Tensor, mask: torch.Tensor, *,
                          llama_cfg: LlamaConfig, gen: GenerationConfig,
                          chunk: int = 16) -> List[int]:
    """Device beam search of one padded prompt: ``beam_search_batched`` at
    P = 1."""
    return beam_search_batched(params, [embeds], masks=[mask], llama_cfg=llama_cfg, gen=gen,
                               chunk=chunk)[0]


@torch.no_grad()
def beam_search_batched(params, prompts: List[torch.Tensor], *, llama_cfg: LlamaConfig,
                        gen: GenerationConfig, chunk: int = 16,
                        masks: Optional[List[torch.Tensor]] = None) -> List[List[int]]:
    """Beam search over P prompts (each (1, S_i, d), with an optional (1,
    S_i) mask each, all ones by default) in one device program, P * k decode
    rows a step, each prompt's KV stored once: the batched-eval form of
    ``beam_search`` for the beam-5 VideoQA / VCG-Bench protocol, and its
    device form at P = 1. Prompts are right-padded to a common bucket; a
    prompt whose search has ended freezes until the slowest one ends. Per
    prompt the tokens equal ``beam_search``'s alone."""
    if not beam_device_supported(gen):
        raise UnsupportedRequest("batched beam search takes stop sequences of up to 2 tokens")
    k = gen.num_beams
    p = len(prompts)
    proto = _BeamProto.from_gen(gen)
    dev = prompts[0].device
    s_max = max(e.shape[1] for e in prompts)
    s_max += (-s_max) % gen.pad_to_multiple
    embeds = torch.cat([F.pad(e, (0, 0, 0, s_max - e.shape[1])) for e in prompts], dim=0)
    if masks is None:
        masks = [torch.ones((1, e.shape[1]), dtype=torch.int32, device=dev) for e in prompts]
    mask = torch.cat([F.pad(m.to(torch.int32), (0, s_max - m.shape[1])) for m in masks], dim=0)
    logits, prefix = _prefill(params, embeds, mask, llama_cfg, s_max)
    gen_cache = init_kv_cache(llama_cfg, p * k, gen.max_new_tokens, device=dev)
    state, seen, rec0 = _first_transition(logits, proto, k, llama_cfg.vocab_size)
    fin, nosurv, _ = _host_read(state)

    parents = [rec0["parent"].cpu().numpy()]          # each (P, k)
    tokens = [rec0["token"].cpu().numpy()]
    alive_hist = [np.ones((p,), bool)]
    emitted = 1
    while emitted < gen.max_new_tokens and ((fin < k) & ~nosurv).any():
        n = min(chunk, gen.max_new_tokens - emitted)
        state, seen, gen_cache, records = _beam_chunk_device(
            params, state, seen, prefix, gen_cache, llama_cfg, proto, k, n)
        fin, nosurv, rec = _host_read(state, records)
        parents.extend(rec["parent"])
        tokens.extend(rec["token"])
        alive_hist.extend(rec["alive"])
        emitted += n

    pool_score = state.pool_score.cpu().numpy()
    pool = torch.stack([state.pool_step, state.pool_parent, state.pool_token]).cpu().numpy()
    live_scores = state.scores.cpu().numpy()
    alive_mat = np.stack(alive_hist)                  # (T, P)
    results: List[List[int]] = []
    for v in range(p):
        best, best_seq = -np.inf, None
        for i in range(k):
            if np.isfinite(pool_score[v, i]) and pool_score[v, i] > best:
                best = float(pool_score[v, i])
                best_seq = _reconstruct(parents, tokens, v, *pool[:, v, i])
        if best_seq is None:
            # nothing finished: the normalized live beams compete; n_emit
            # counts this prompt's steps, less a no-survivor step's record
            n_emit = int(alive_mat[:, v].sum()) - (1 if nosurv[v] else 0)
            if n_emit > 0:
                t_last = n_emit - 1
                for b in range(k):
                    sc = live_scores[v, b] / (max(n_emit, 1) ** gen.length_penalty)
                    if sc > best:
                        best = float(sc)
                        best_seq = _reconstruct(parents, tokens, v, t_last,
                                                parents[t_last][v][b], tokens[t_last][v][b])
        results.append(best_seq if best_seq is not None else [])
    return results


@torch.no_grad()
def beam_search(params, inputs_embeds: torch.Tensor, attention_mask: Optional[torch.Tensor], *,
                llama_cfg: LlamaConfig, gen: GenerationConfig) -> List[int]:
    """HF-style length-penalized beam search of one prompt (1, S, d). The
    prompt is prefilled once at batch 1 and decode attends the shared
    prefix plus a small per-beam generated cache (llama_decode_prefix).
    Configs the device form covers run it; others (stop sequences longer
    than 2 tokens) run the step-wise host loop, which is also its oracle."""
    k = gen.num_beams
    s = inputs_embeds.shape[1]
    dev = inputs_embeds.device
    if attention_mask is None:
        attention_mask = torch.ones((1, s), dtype=torch.int32, device=dev)
    embeds, mask = _pad_prompt(inputs_embeds, attention_mask, gen.pad_to_multiple)
    if beam_device_supported(gen):
        return _beam_search_ondevice(params, embeds, mask, llama_cfg=llama_cfg, gen=gen)
    logits, prefix = _prefill(params, embeds, mask, llama_cfg, embeds.shape[1])
    gen_cache = init_kv_cache(llama_cfg, k, gen.max_new_tokens, device=dev)

    beams: List[Tuple[float, List[int]]] = [(0.0, [])] + [(-1e9, [])] * (k - 1)
    finished: List[Tuple[float, List[int]]] = []
    pen = gen.repetition_penalty
    # first step: candidates from the prefill logits; later steps move only
    # (k, 2k) device top-k results (or, penalized, the full logp)
    lg = np.array(logits.float().cpu(), np.float32)
    mx = lg.max(-1, keepdims=True)
    logp0 = lg - np.log(np.exp(lg - mx).sum(-1, keepdims=True)) - mx
    order = np.argsort(-logp0, axis=-1)[:, :2 * k]
    top_v = np.repeat(np.take_along_axis(logp0, order, axis=-1), k, axis=0)
    top_i = np.repeat(order, k, axis=0)

    for step in range(gen.max_new_tokens):
        cand = []
        for bi, (score, ids) in enumerate(beams):
            for v, t in zip(top_v[bi], top_i[bi]):
                if step < gen.min_length and int(t) == gen.eos_token_id:
                    continue
                cand.append((score + float(v), ids + [int(t)], bi))
        cand.sort(key=lambda c: -c[0])   # stable: ties stay beam-major

        new_beams, reorder, next_tokens = [], [], []
        for score, ids, bi in cand:
            if ids[-1] == gen.eos_token_id or any(_ends_with(ids, st)
                                                  for st in gen.stop_sequences):
                finished.append((score / (len(ids) ** gen.length_penalty), ids))
            else:
                new_beams.append((score, ids))
                reorder.append(bi)
                next_tokens.append(ids[-1])
            if len(new_beams) == k:
                break
        if len(finished) >= k or not new_beams or step + 1 == gen.max_new_tokens:
            beams = new_beams or beams
            break
        while len(new_beams) < k:  # degenerate: pad with copies
            new_beams.append(new_beams[-1])
            reorder.append(reorder[-1])
            next_tokens.append(next_tokens[-1])
        beams = new_beams
        cur = torch.as_tensor(next_tokens, dtype=torch.int32, device=dev)
        ro = torch.as_tensor(reorder, dtype=torch.int32, device=dev)
        if pen != 1.0:
            # HF's beam-mode rule (_penalize_logp) on each beam's ids, on the host
            lp, gen_cache = _decode_step_logp_prefix(params, cur, prefix, gen_cache, ro,
                                                     llama_cfg)
            lp = np.array(lp.float().cpu(), np.float32)
            for bi, (_, ids) in enumerate(beams):
                for t in set(ids):
                    v = lp[bi, t]
                    lp[bi, t] = v * pen if v < 0 else v / pen
            order2 = np.argsort(-lp, axis=-1)[:, :2 * k]
            top_v, top_i = np.take_along_axis(lp, order2, axis=-1), order2
        else:
            tv, ti, gen_cache = _decode_step_topk_prefix(params, cur, prefix, gen_cache, ro,
                                                         llama_cfg, 2 * k)
            top_v, top_i = tv.cpu().numpy(), ti.cpu().numpy()

    if not finished:
        finished = [(score / (max(len(ids), 1) ** gen.length_penalty), ids)
                    for score, ids in beams]
    finished.sort(key=lambda c: -c[0])
    return finished[0][1]
