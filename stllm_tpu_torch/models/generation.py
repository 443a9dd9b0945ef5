"""Autoregressive generation with a KV cache (stllm_tpu/models/generation.py),
greedy only.

Prefill writes the padded prompt into a fresh cache; decode then runs in
chunks of steps on the device (a Python loop stands in for the reference's
``lax.scan``), and the host checks the stop conditions between chunks,
truncating any over-generation. Only the (B, n) token block of a chunk
crosses to the host. Sampling, beams and penalties come with a later slice.
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
    """Raise UnsupportedRequest unless ``gen`` is plain greedy decoding."""
    if (gen.do_sample or gen.num_beams > 1 or gen.repetition_penalty != 1.0
            or gen.min_length > 1):
        raise UnsupportedRequest(
            f"{what}: only greedy decoding is ported; sampling, beams, "
            "repetition penalty and min_length come with a later slice")


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
) -> List[List[int]]:
    """Greedy token ids per batch row (stop sequence included when hit)."""
    check_greedy(gen, "generate")
    b, s, _ = inputs_embeds.shape
    if attention_mask is None:
        attention_mask = torch.ones((b, s), dtype=torch.int32, device=inputs_embeds.device)
    embeds, mask = _pad_prompt(inputs_embeds, attention_mask, gen.pad_to_multiple)
    logits, cache = _prefill(params, embeds, mask, llama_cfg,
                             embeds.shape[1] + gen.max_new_tokens)
    return _generate_greedy_ondevice(params, logits, cache, llama_cfg, gen, b)[0]


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
