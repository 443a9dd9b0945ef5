"""Full-pipeline video-QA serving: encode interleaved with batched decode
(stllm_tpu/pipeline_serving.py).

A request is (uint8 frames, prompt ids around the video, GenerationConfig).
Encode runs lazily, only when a decode slot is free for the result, so a
burst of submissions does not queue N encodes in front of the streams in
flight; the assembled embeddings stay on the device and flow straight into
the batcher's prefill. Decode advances all active slots together. Greedy
answers are token-identical to the offline path (encode_img ->
generation.generate). Encode and decode run under ``torch.no_grad()``.

Requests submitted with the same ``prefix_key`` (the caller's identity of a
video and its system prompt) share one prefill of that prefix: the first
request of a key encodes the video and prefills the prefix once, later ones
embed only their suffix and delta-prefill it on a copy (no encode). The
store is an LRU of ``prefix_cache_size`` entries, guarded by the Q-Former
text and the resolved encode config, so a change in either misses. A
``vit.merge_level`` of "auto" resolves per request at submit from the
video's own redundancy.
"""

from __future__ import annotations

import collections
from typing import Dict, List, Optional

import numpy as np
import torch

from stllm_tpu_torch.models.generation import (
    GenerationConfig, UnsupportedRequest, _pad_prompt, _prefill)
from stllm_tpu_torch.models.stllm import (
    STLLMConfig, apply_video_input, encode_img, resolve_auto_merge)
from stllm_tpu_torch.ops.layers import gather_rows
from stllm_tpu_torch.serving import ContinuousBatcher


@torch.no_grad()
def _encode_assemble(params, frames, prefix_ids, suffix_ids, q_ids, q_mask,
                     cfg: STLLMConfig) -> torch.Tensor:
    """Encode one video and splice its tokens between the text embeddings:
    (1, lp + V + ls, D)."""
    vid = apply_video_input(params, encode_img(params, frames, cfg, q_ids, q_mask), cfg)
    table = params["llama"]["embed_tokens"]
    pre = gather_rows(table, prefix_ids).to(vid.dtype)
    suf = gather_rows(table, suffix_ids).to(vid.dtype)
    return torch.cat([pre, vid, suf], dim=1)


def _embed_suffix(params, suffix_ids, cfg: STLLMConfig) -> torch.Tensor:
    """The suffix-only embedding row of a prefix-cache hit (no encode)."""
    return gather_rows(params["llama"]["embed_tokens"], suffix_ids).to(cfg.llama.dtype)


class QARequest:
    def __init__(self, rid, frames, prefix_ids, suffix_ids, q_ids, q_mask,
                 gen: GenerationConfig, seed: int = 0, prefix_key=None,
                 cfg: Optional[STLLMConfig] = None):
        self.cfg = cfg                  # the request's resolved encode config
        self.prefix_key = prefix_key
        self.seed = seed
        self.rid = rid
        self.frames = frames
        self.prefix_ids = prefix_ids
        self.suffix_ids = suffix_ids
        self.q_ids = q_ids
        self.q_mask = q_mask
        self.gen = gen


def _ids_row(ids, device) -> torch.Tensor:
    return torch.as_tensor(ids, dtype=torch.int32, device=device).reshape(1, -1)


class VideoQAServer:
    """Continuous video-QA server over one model replica.

    >>> srv = VideoQAServer(params, cfg, slots=4, max_len=1024)
    >>> srv.submit("a", frames_a, prefix_ids, suffix_ids)
    >>> answers = srv.run()          # {"a": [...tokens...]}

    ``params`` is the full ST-LLM tree on the device the server runs on;
    ``frames`` is (1, T, H, W, 3) uint8 (tensor or array); prefix and suffix
    are token-id rows embedded around the video tokens. ``batcher`` serves
    the decode from a given ContinuousBatcher instead of a new one (its own
    slots, max_len and chunk then hold). ``prefix_cache_size`` caps the
    shared-prefix store (entries of (1, P) KV caches)."""

    def __init__(self, params: Dict, cfg: STLLMConfig, *, slots: int = 4,
                 max_len: int = 1024, chunk: int = 16,
                 batcher: Optional[ContinuousBatcher] = None,
                 prefix_cache_size: int = 2):
        self.params = params
        self.cfg = cfg
        self.batcher = batcher or ContinuousBatcher(
            params["llama"], cfg.llama, slots=slots, max_len=max_len, chunk=chunk)
        self.device = self.batcher.device
        self.encode_queue: List[QARequest] = []
        # prefix_key -> (prefix KV (1, P), P, guard)
        self._prefix_lru = collections.OrderedDict()
        self._prefix_cache_size = prefix_cache_size

    def submit(self, rid, frames, prefix_ids, suffix_ids,
               gen: GenerationConfig = GenerationConfig(), *,
               qformer_text_ids=None, qformer_text_mask=None, seed: int = 0,
               prefix_key=None):
        """``seed`` seeds a sampled request. ``prefix_key``: an opaque
        identity of (video, system prompt); requests of one key share the
        system+video prefix KV, computed once. The guard (Q-Former text,
        resolved encode config) forces a fresh prefill when either differs,
        so a stale hit cannot change an answer. Refusals raise here, with
        the batcher's own admission formula: a request accepted now never
        fails mid-drain."""
        self.batcher.refuse(rid, gen, prefix_key is not None)
        # "auto" resolves from the frames as handed in, before any upload
        req_cfg = resolve_auto_merge(self.cfg, frames)
        frames = torch.as_tensor(frames, device=self.device)
        if frames.dim() != 5 or frames.shape[0] != 1:
            raise ValueError("frames must be (1, T, H, W, C)")
        prefix_ids = _ids_row(prefix_ids, self.device)
        suffix_ids = _ids_row(suffix_ids, self.device)
        if qformer_text_ids is not None:
            qformer_text_ids = _ids_row(qformer_text_ids, self.device)
            qformer_text_mask = (torch.ones_like(qformer_text_ids) if qformer_text_mask is None
                                 else _ids_row(qformer_text_mask, self.device))
        plen = prefix_ids.shape[1] + self.cfg.num_video_tokens(frames.shape[1])
        slen = suffix_ids.shape[1]
        if prefix_key is not None:
            # the batcher pads only the suffix on top of the unpadded prefix
            s_pad = plen + slen + (-slen) % gen.pad_to_multiple
        else:
            s = plen + slen
            s_pad = s + (-s) % gen.pad_to_multiple
        if s_pad + gen.max_new_tokens > self.batcher.max_len:
            raise UnsupportedRequest(
                f"request {rid!r}: padded prompt ({s_pad}) + budget "
                f"({gen.max_new_tokens}) exceeds server max_len ({self.batcher.max_len})")
        self.encode_queue.append(QARequest(rid, frames, prefix_ids, suffix_ids,
                                           qformer_text_ids, qformer_text_mask, gen, seed,
                                           prefix_key, req_cfg))

    def _free_slots(self) -> int:
        b = self.batcher
        return max(0, sum(r is None for r in b.active) - len(b.queue))

    def _prefix_guard(self, req: QARequest):
        """The content a prefix-cache hit must match: the Q-Former text and
        mask bytes and the resolved encode config."""
        qb = None if req.q_ids is None else req.q_ids.cpu().numpy().astype(np.int32).tobytes()
        mb = None if req.q_mask is None else req.q_mask.cpu().numpy().astype(np.int32).tobytes()
        return (qb, mb, req.cfg)

    def _admit_one(self, req: QARequest):
        key = req.prefix_key
        guard = None if key is None else self._prefix_guard(req)
        if key is not None and key in self._prefix_lru:
            pkv, plen, stored = self._prefix_lru[key]
            if stored == guard:
                self._prefix_lru.move_to_end(key)
                req.frames = None
                self.batcher.submit(req.rid, _embed_suffix(self.params, req.suffix_ids, self.cfg),
                                    req.gen, seed=req.seed, prefix=pkv, prefix_len=plen)
                return
        embeds = _encode_assemble(self.params, req.frames, req.prefix_ids, req.suffix_ids,
                                  req.q_ids, req.q_mask, req.cfg)
        req.frames = None
        if key is None:
            self.batcher.submit(req.rid, embeds, req.gen, seed=req.seed)
            return
        # the first request of a key prefills the system+video prefix once and
        # then takes the shared path later ones take (the same program shapes,
        # so the same numbers for every answer of the key)
        plen = embeds.shape[1] - req.suffix_ids.shape[1]
        pemb, pmask = _pad_prompt(embeds[:, :plen],
                                  torch.ones((1, plen), dtype=torch.int32, device=self.device),
                                  req.gen.pad_to_multiple)
        _, pkv = _prefill(self.params["llama"], pemb, pmask, self.cfg.llama, pemb.shape[1])
        self._prefix_lru[key] = (pkv, plen, guard)
        while len(self._prefix_lru) > self._prefix_cache_size:
            # drop the store's reference only: a queued request may still hold
            # this prefix, and its admit copies it before the memory goes
            self._prefix_lru.popitem(last=False)
        self.batcher.submit(req.rid, embeds[:, plen:], req.gen, seed=req.seed,
                            prefix=pkv, prefix_len=plen)

    @torch.no_grad()
    def step(self) -> List:
        """Encode as many queued videos as there are free decode slots, hand
        their embeddings to the batcher, advance one decode chunk. Returns
        the requests finished this step."""
        for _ in range(min(self._free_slots(), len(self.encode_queue))):
            self._admit_one(self.encode_queue.pop(0))
        return self.batcher.step()

    def run(self) -> Dict[object, List[int]]:
        """Drain the encode queue and all decode slots; rid -> tokens."""
        out: Dict[object, List[int]] = {}
        b = self.batcher
        while (self.encode_queue or b.queue or b._finished
               or any(r is not None for r in b.active)):
            for req in self.step():
                out[req.rid] = req.tokens
        return out
