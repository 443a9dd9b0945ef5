"""Continuous-batching server: slot-based multi-stream decode
(stllm_tpu/serving.py).

The KV cache is one (slots, max_len, H, D) buffer set per layer with per-row
valid lengths, so rows at different progress share one decode step. Requests
are admitted into free slots as they arrive: a (1, S) prefill fills the row,
the shared decode chunk advances all slots together, and finished slots are
refilled without stopping the others. Every step runs under
``torch.no_grad()``: the parameters may be a trainer's, flagged for
gradients, and the KV cache is written in place.

Greedy answers are token-identical to ``generation.generate`` run alone.
Sampled requests (``do_sample``, the reference chat demo's default) run exact
nucleus sampling on the device in the same decode chunk as greedy rows: at
admit each stream draws its ``max_new_tokens`` uniforms from a
``torch.Generator`` seeded with its seed, exactly as solo ``generate`` draws
them, and token t uses uniform t. A sampled request therefore returns the
same tokens in a busy server as alone, whatever its slot, co-tenants or the
chunk size, and the same tokens as solo ``generate(do_sample=True, seed)``
on the same device. Generators differ between devices, so sampled streams
are reproducible within a device, not across devices nor against the JAX
package.

A request may carry a shared prompt prefix (``prefix=``, a (1, P) KV cache):
its suffix is delta-prefilled on a copy of the prefix at admit
(``VideoQAServer`` shares one video+system prefill across the questions on
one video). With a draft tower (``draft_params``) the batcher runs greedy
speculative rounds instead of the plain decode chunk (models/speculative.py).

``AnswerService`` is a thread-safe blocking front end over one batcher.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from stllm_tpu_torch.models.generation import (
    GenerationConfig, UnsupportedRequest, _decode_chunk_greedy, _decode_chunk_mixed, _ends_with,
    _first_token_mixed, _pad_kv_time, _pad_prompt, _prefill, _prefill_delta, _row_uniforms)
from stllm_tpu_torch.models.llama import KVCache, LlamaConfig, init_kv_cache
from stllm_tpu_torch.models.speculative import _spec_rounds


def _insert_slot(cache: KVCache, prefix: KVCache, slot: int) -> KVCache:
    """Copy a (1, S, H, D)-per-layer prefill cache, and the int8 cache's
    (1, S, H) scales, into row ``slot`` of the batched cache (in place) and
    set that row's length. Stale tail entries past the new length are
    overwritten by decode writes before they become attendable."""
    pairs = list(zip(cache.k + cache.v, prefix.k + prefix.v))
    if cache.k_scale is not None:
        pairs += zip(cache.k_scale + cache.v_scale, prefix.k_scale + prefix.v_scale)
    for c, p in pairs:
        c[slot, :p.shape[1]] = p[0].to(c.dtype)
    cache.length[slot] = prefix.length[0]
    return cache


class Request:
    def __init__(self, rid, inputs_embeds: torch.Tensor, gen: GenerationConfig, seed: int = 0,
                 prefix: Optional[KVCache] = None, prefix_len: int = 0):
        if inputs_embeds.dim() != 3 or inputs_embeds.shape[0] != 1:
            raise ValueError("inputs_embeds must be (1, S, D)")
        self.rid = rid
        self.embeds = inputs_embeds
        self.gen = gen
        self.seed = seed
        self.prefix = prefix          # shared prompt-prefix KV (1, P, ...)
        self.prefix_len = prefix_len  # host-known valid length of ``prefix``
        self.tokens: List[int] = []
        self.done = False


class ContinuousBatcher:
    """Slot-based server over one model replica.

    >>> cb = ContinuousBatcher(params, cfg, slots=8, max_len=1024)
    >>> cb.submit("a", embeds_a, gen); cb.submit("b", embeds_b, gen)
    >>> answers = cb.run()   # {"a": [...tokens...], "b": [...]}

    New requests may be submitted between ``step()`` calls while others are
    mid-decode; ``run()`` drains the queue. With ``draft_params`` (a draft
    tower of the target's hidden width) each step runs ``spec_rounds``
    draft-propose / target-verify rounds of ``spec_k`` proposals, greedy
    streams only."""

    def __init__(self, params: Dict, cfg: LlamaConfig, *, slots: int = 8,
                 max_len: int = 1024, chunk: int = 8,
                 draft_params: Optional[Dict] = None,
                 draft_cfg: Optional[LlamaConfig] = None,
                 spec_k: int = 4, spec_rounds: int = 4):
        self.params = params
        self.cfg = cfg
        self.slots = slots
        self.max_len = max_len
        self.chunk = chunk
        self.device = params["embed_tokens"].device
        self.draft_params = draft_params
        self.draft_cfg = draft_cfg
        self.spec_k = spec_k
        self.spec_rounds = spec_rounds
        self.spec = draft_params is not None
        cache_len = max_len
        if self.spec:
            if draft_cfg is None:
                raise ValueError("draft_params needs draft_cfg")
            if draft_cfg.hidden != cfg.hidden:
                raise ValueError("the draft tower must share the target's embedding width")
            # spec_k + 1 of slack: a verify round writes k + 1 entries past
            # the committed length before it rolls back
            cache_len = max_len + spec_k + 1
            self.draft_cache = init_kv_cache(draft_cfg, slots, cache_len, device=self.device)
        self.cache = init_kv_cache(cfg, slots, cache_len, device=self.device)
        self.cur = torch.zeros((slots,), dtype=torch.int32, device=self.device)
        self.active: List[Optional[Request]] = [None] * slots
        self.queue: List[Request] = []
        self._finished: List[Request] = []
        # blocking device-to-host reads: one per admit (its first token) and
        # one per decode chunk or speculative step
        self.host_pulls = 0
        # per-slot sampling state (inert for greedy rows): row s holds its
        # stream's uniforms, column t for token t
        self.uniforms = torch.zeros((slots, max_len + chunk), dtype=torch.float32,
                                    device=self.device)
        self.counters = np.zeros((slots,), np.int64)
        self.temp = np.ones((slots,), np.float32)
        self.topp = np.ones((slots,), np.float32)
        self.samp = np.zeros((slots,), bool)

    def submit(self, rid, inputs_embeds: torch.Tensor,
               gen: GenerationConfig = GenerationConfig(), *, seed: int = 0,
               prefix: Optional[KVCache] = None, prefix_len: int = 0):
        """Queue a request. ``seed`` seeds a sampled stream. ``prefix``: a
        shared prompt-prefix KV cache (1, P, ...) of host-known valid length
        ``prefix_len``; ``inputs_embeds`` is then only this request's
        suffix, delta-prefilled on a copy of the prefix at admit. The
        stored prefix is never written.

        Raises as ``refuse`` does, and UnsupportedRequest for a padded
        prompt plus budget past max_len."""
        self.refuse(rid, gen, prefix is not None)
        s = inputs_embeds.shape[1]
        s_pad = prefix_len + s + (-s) % gen.pad_to_multiple
        if s_pad + gen.max_new_tokens > self.max_len:
            raise UnsupportedRequest(
                f"request {rid!r}: padded prompt ({s_pad}) + budget "
                f"({gen.max_new_tokens}) exceeds server max_len ({self.max_len})")
        self.queue.append(Request(rid, inputs_embeds, gen, seed, prefix, prefix_len))

    def refuse(self, rid, gen: GenerationConfig, prefix: bool = False) -> None:
        """Raise UnsupportedRequest for what the batcher does not serve
        (beams, the repetition penalty, min_length, and in speculative mode
        sampled and prefix requests) and ValueError for a top_p outside
        (0, 1] on a sampled request."""
        if gen.num_beams > 1 or gen.repetition_penalty != 1.0 or gen.min_length > 1:
            raise UnsupportedRequest(
                f"request {rid!r}: the continuous batcher serves greedy and top-p-sampled "
                "streams; beam/penalty/min_length requests must go through generation.generate")
        if gen.do_sample and not 0.0 < gen.top_p <= 1.0:
            # a config bug, not a capability gap: callers that fall back to
            # solo generate must not swallow it
            raise ValueError(f"request {rid!r}: top_p must be in (0, 1], got {gen.top_p}")
        if gen.do_sample and self.spec:
            raise UnsupportedRequest(
                f"request {rid!r}: this server runs speculative greedy decoding; submit "
                "sampled requests to a server without a draft or to generation.generate")
        if prefix and self.spec:
            raise UnsupportedRequest(
                f"request {rid!r}: prefix sharing is not composed with speculative mode "
                "(the draft tower has no shared prefix)")

    # -- internals --------------------------------------------------------

    def _admit(self):
        for slot in range(self.slots):
            if self.active[slot] is not None or not self.queue:
                continue
            req = self.queue.pop(0)
            ones = torch.ones(req.embeds.shape[:2], dtype=torch.int32, device=self.device)
            emb, mask = _pad_prompt(req.embeds, ones, req.gen.pad_to_multiple)
            s_pad = emb.shape[1]
            if req.prefix is not None:
                # the suffix delta-prefilled on a padded copy of the prefix
                # (the stored one serves later requests): the same attention
                # sums as a prefill of the whole prompt
                w = max(req.prefix.k[0].shape[1], req.prefix_len + s_pad)
                logits, prefix = _prefill_delta(self.params, emb, mask,
                                                _pad_kv_time(req.prefix, w), self.cfg)
                # drop the handle now: the slot holds the copy, and an evicted
                # prefix must not stay pinned for this request's whole decode
                req.prefix = None
            else:
                logits, prefix = _prefill(self.params, emb, mask, self.cfg, s_pad)
            self.cache = _insert_slot(self.cache, prefix, slot)
            if self.spec:
                _, dprefix = _prefill(self.draft_params, emb, mask, self.draft_cfg, s_pad)
                self.draft_cache = _insert_slot(self.draft_cache, dprefix, slot)
            req.embeds = None  # the prompt embeddings are consumed; free them
            g = req.gen
            self.samp[slot] = g.do_sample
            self.temp[slot] = g.temperature
            self.topp[slot] = g.top_p
            self.counters[slot] = 1  # token 0 is chosen here
            if g.do_sample:
                u = _row_uniforms(req.seed, 1, g.max_new_tokens, self.device)[0]
                self.uniforms[slot].zero_()
                self.uniforms[slot, :g.max_new_tokens] = u
                tok = _first_token_mixed(
                    logits, u[:1], torch.full((1,), g.temperature, device=self.device),
                    torch.full((1,), g.top_p, device=self.device),
                    torch.ones((1,), dtype=torch.bool, device=self.device))
            else:
                tok = torch.argmax(logits, dim=-1).to(torch.int32)
            self.cur[slot] = tok[0]
            self.host_pulls += 1
            self.active[slot] = req
            self._emit(slot, [int(tok[0])])

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
            self.samp[slot] = False  # a freed row falls back to argmax
            # Rewind the freed row. Idle rows still advance by `chunk` per
            # step until re-admitted, which is safe (cache writes clamp at
            # the end, rope positions clamp into the table, and _admit
            # resets the length); this keeps the common case in the buffer.
            self.cache.length[slot] = 0
            if self.spec:
                self.draft_cache.length[slot] = 0

    def _host(self, a: np.ndarray, dtype=None) -> torch.Tensor:
        """A copy of host state on the device (the chunk never sees later
        host mutations)."""
        return torch.tensor(a, dtype=dtype, device=self.device)

    def _spec_step(self, before: List[int]):
        t_next, self.cache, self.draft_cache, emits, cnts = _spec_rounds(
            self.params, self.draft_params, self.cur, self.cache, self.draft_cache,
            tgt_cfg=self.cfg, dft_cfg=self.draft_cfg, k=self.spec_k, rounds=self.spec_rounds)
        self.host_pulls += 1
        emits_h, cnts_h = emits.cpu().numpy(), cnts.cpu().numpy()
        self.cur = t_next
        for slot in before:
            toks = []
            for r in range(self.spec_rounds):
                toks.extend(int(t) for t in emits_h[r, slot, :cnts_h[r, slot]])
            self._emit(slot, toks)

    @torch.no_grad()
    def step(self) -> List[Request]:
        """Admit queued requests, run one decode chunk (or the speculative
        rounds), return the requests that finished during this step
        (including any whose first token already completed them)."""
        self._admit()
        if any(r is not None for r in self.active):
            before = [s for s, r in enumerate(self.active) if r is not None]
            if self.spec:
                self._spec_step(before)
            else:
                if self.samp.any():
                    cols = self._host(self.counters)[:, None] + torch.arange(
                        self.chunk, device=self.device)[None, :]
                    u = torch.gather(self.uniforms, 1, cols.clamp(max=self.uniforms.shape[1] - 1))
                    toks, self.cache = _decode_chunk_mixed(
                        self.params, self.cur, self.cache, self.cfg, self.chunk, u,
                        self._host(self.temp), self._host(self.topp), self._host(self.samp))
                    self.counters += self.chunk
                else:
                    # all-greedy traffic skips the per-step vocabulary sort
                    toks, self.cache = _decode_chunk_greedy(
                        self.params, self.cur, self.cache, self.cfg, self.chunk)
                self.host_pulls += 1
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


class AnswerService:
    """Thread-safe blocking front end over a ContinuousBatcher.

    Concurrent callers (one thread per chat user) call :meth:`answer` and
    block until their tokens are ready, while one service thread advances
    every resident stream through the batcher's shared decode chunk. Tokens
    equal solo ``generation.generate``'s (the batcher's contract), sampled
    streams included.

    The batcher is not thread-safe: every touch happens under one condition
    variable, and the service thread holds it across a single ``step()``,
    so a submitter waits at most one chunk to enqueue. A step that raises
    kills the service: every waiting and later caller gets RuntimeError
    from that exception."""

    def __init__(self, batcher: ContinuousBatcher):
        self.cb = batcher
        self._cond = threading.Condition()
        self._results: Dict[object, List[int]] = {}
        self._next = 0
        self._stop = False
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._loop, name="answer-service", daemon=True)
        self._thread.start()

    def close(self):
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        self._thread.join()

    def answer(self, inputs_embeds: torch.Tensor, gen: GenerationConfig = GenerationConfig(), *,
               seed: int = 0) -> List[int]:
        """Submit one request and block until its tokens are complete. The
        batcher's refusals (UnsupportedRequest, ValueError) raise here
        without blocking, so callers can fall back to solo generate."""
        with self._cond:
            if self._error is not None:
                raise RuntimeError("AnswerService is dead (a step failed)") from self._error
            rid = self._next
            self._next += 1
            self.cb.submit(rid, inputs_embeds, gen, seed=seed)  # may raise
            self._cond.notify_all()
            while rid not in self._results:
                if self._error is not None:
                    raise RuntimeError("AnswerService died mid-request") from self._error
                self._cond.wait()
            return self._results.pop(rid)

    def _busy(self) -> bool:
        return bool(self.cb.queue) or any(r is not None for r in self.cb.active)

    def _loop(self):
        while True:
            with self._cond:
                while not self._stop and not self._busy():
                    self._cond.wait()
                if self._stop:
                    return
                try:
                    for req in self.cb.step():
                        self._results[req.rid] = req.tokens
                except Exception as e:
                    # wake every waiter (they re-raise it) and end the loop:
                    # the error reaches every current and later caller
                    self._error = e
                    self._cond.notify_all()
                    return
                self._cond.notify_all()
