"""Continuous-batching greedy server: slot-based multi-stream decode
(stllm_tpu/serving.py).

The KV cache is one (slots, max_len, H, D) buffer set per layer with per-row
valid lengths, so rows at different progress share one decode step. Requests
are admitted into free slots as they arrive: a (1, S) prefill fills the row,
the shared decode chunk advances all slots together, and finished slots are
refilled without stopping the others. Greedy answers are token-identical to
``generation.generate`` run alone. Sampled streams, shared prompt prefixes
and the speculative draft tower come with later slices.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

from stllm_tpu_torch.models.generation import (
    GenerationConfig, UnsupportedRequest, _decode_chunk_greedy, _ends_with,
    _pad_prompt, _prefill, check_greedy)
from stllm_tpu_torch.models.llama import KVCache, LlamaConfig, init_kv_cache


def _insert_slot(cache: KVCache, prefix: KVCache, slot: int) -> KVCache:
    """Copy a (1, S, H, D)-per-layer prefill cache into row ``slot`` of the
    batched cache (in place) and set that row's length. Stale tail entries
    past the new length are overwritten by decode writes before they become
    attendable."""
    for c, p in zip(cache.k + cache.v, prefix.k + prefix.v):
        c[slot, :p.shape[1]] = p[0].to(c.dtype)
    cache.length[slot] = prefix.length[0]
    return cache


class Request:
    def __init__(self, rid, inputs_embeds: torch.Tensor, gen: GenerationConfig):
        if inputs_embeds.dim() != 3 or inputs_embeds.shape[0] != 1:
            raise ValueError("inputs_embeds must be (1, S, D)")
        self.rid = rid
        self.embeds = inputs_embeds
        self.gen = gen
        self.tokens: List[int] = []
        self.done = False


class ContinuousBatcher:
    """Slot-based greedy server over one model replica.

    >>> cb = ContinuousBatcher(params, cfg, slots=8, max_len=1024)
    >>> cb.submit("a", embeds_a, gen); cb.submit("b", embeds_b, gen)
    >>> answers = cb.run()   # {"a": [...tokens...], "b": [...]}
    """

    def __init__(self, params: Dict, cfg: LlamaConfig, *, slots: int = 8,
                 max_len: int = 1024, chunk: int = 8,
                 draft_params: Optional[Dict] = None):
        self.params = params
        self.cfg = cfg
        self.slots = slots
        self.max_len = max_len
        self.chunk = chunk
        self.spec = draft_params is not None
        self.device = params["embed_tokens"].device
        self.cache = init_kv_cache(cfg, slots, max_len, device=self.device)
        self.cur = torch.zeros((slots,), dtype=torch.int32, device=self.device)
        self.active: List[Optional[Request]] = [None] * slots
        self.queue: List[Request] = []
        self._finished: List[Request] = []

    def submit(self, rid, inputs_embeds: torch.Tensor,
               gen: GenerationConfig = GenerationConfig(), *, seed: int = 0,
               prefix: Optional[KVCache] = None, prefix_len: int = 0):
        """``seed`` is the reference's sampling seed; greedy streams draw
        nothing from it."""
        check_greedy(gen, f"request {rid!r}")
        if self.spec:
            raise UnsupportedRequest(
                f"request {rid!r}: speculative decoding with a draft tower is not ported yet")
        if prefix is not None:
            raise UnsupportedRequest(
                f"request {rid!r}: shared prompt prefixes are not ported yet")
        s = inputs_embeds.shape[1]
        s_pad = s + (-s) % gen.pad_to_multiple
        if s_pad + gen.max_new_tokens > self.max_len:
            raise UnsupportedRequest(
                f"request {rid!r}: padded prompt ({s_pad}) + budget "
                f"({gen.max_new_tokens}) exceeds server max_len ({self.max_len})")
        self.queue.append(Request(rid, inputs_embeds, gen))

    # -- internals --------------------------------------------------------

    def _admit(self):
        for slot in range(self.slots):
            if self.active[slot] is not None or not self.queue:
                continue
            req = self.queue.pop(0)
            ones = torch.ones(req.embeds.shape[:2], dtype=torch.int32, device=self.device)
            emb, mask = _pad_prompt(req.embeds, ones, req.gen.pad_to_multiple)
            logits, prefix = _prefill(self.params, emb, mask, self.cfg, emb.shape[1])
            self.cache = _insert_slot(self.cache, prefix, slot)
            req.embeds = None  # the prompt embeddings are consumed; free them
            first = int(torch.argmax(logits, dim=-1)[0])
            self.cur[slot] = first
            self.active[slot] = req
            self._emit(slot, [first])

    def _emit(self, slot: int, tokens: Sequence[int]):
        req = self.active[slot]
        for tok in tokens:
            if req.done:
                break
            req.tokens.append(tok)
            if tok == req.gen.eos_token_id or any(
                    _ends_with(req.tokens, st) for st in req.gen.stop_sequences):
                req.done = True
            elif len(req.tokens) >= req.gen.max_new_tokens:
                req.done = True
        if req.done:
            self.active[slot] = None
            self._finished.append(req)
            # Rewind the freed row. Idle rows still advance by `chunk` per
            # step until re-admitted, which is safe (cache writes clamp at
            # max_len - 1, rope positions clamp into the table, and _admit
            # resets the length); this keeps the common case in the buffer.
            self.cache.length[slot] = 0

    def step(self) -> List[Request]:
        """Admit queued requests, run one decode chunk, return the requests
        that finished during this step."""
        self._admit()
        if any(r is not None for r in self.active):
            before = [s for s, r in enumerate(self.active) if r is not None]
            toks, self.cache = _decode_chunk_greedy(
                self.params, self.cur, self.cache, self.cfg, self.chunk)
            toks_h = toks.cpu().numpy()
            self.cur = toks[:, -1].contiguous()
            for slot in before:
                self._emit(slot, [int(t) for t in toks_h[slot]])
        finished, self._finished = self._finished, []
        return finished

    def run(self) -> Dict[object, List[int]]:
        """Drain the queue and all active slots; returns rid -> tokens."""
        out: Dict[object, List[int]] = {}
        while self.queue or self._finished or any(r is not None for r in self.active):
            for req in self.step():
                out[req.rid] = req.tokens
        return out
