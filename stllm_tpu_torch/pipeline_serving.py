"""Full-pipeline video-QA serving: encode interleaved with batched decode
(stllm_tpu/pipeline_serving.py).

A request is (uint8 frames, prompt ids around the video, GenerationConfig).
Encode runs lazily, only when a decode slot is free for the result, so a
burst of submissions does not queue N encodes in front of the streams in
flight; the assembled embeddings stay on the device and flow straight into
the batcher's prefill. Decode advances all active slots together. Greedy
answers are token-identical to the offline path (encode_img ->
generation.generate). Cross-request prefix sharing (``prefix_key``) comes
with a later slice.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from stllm_tpu_torch.models.generation import (
    GenerationConfig, UnsupportedRequest, check_greedy)
from stllm_tpu_torch.models.stllm import (
    STLLMConfig, apply_video_input, encode_img, resolve_auto_merge)
from stllm_tpu_torch.ops.layers import gather_rows
from stllm_tpu_torch.serving import ContinuousBatcher


def _encode_assemble(params, frames, prefix_ids, suffix_ids, q_ids, q_mask,
                     cfg: STLLMConfig) -> torch.Tensor:
    """Encode one video and splice its tokens between the text embeddings:
    (1, lp + V + ls, D)."""
    vid = apply_video_input(params, encode_img(params, frames, cfg, q_ids, q_mask), cfg)
    table = params["llama"]["embed_tokens"]
    pre = gather_rows(table, prefix_ids).to(vid.dtype)
    suf = gather_rows(table, suffix_ids).to(vid.dtype)
    return torch.cat([pre, vid, suf], dim=1)


class QARequest:
    def __init__(self, rid, frames, prefix_ids, suffix_ids, q_ids, q_mask,
                 gen: GenerationConfig):
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
    are token-id rows embedded around the video tokens."""

    def __init__(self, params: Dict, cfg: STLLMConfig, *, slots: int = 4,
                 max_len: int = 1024, chunk: int = 16):
        self.params = params
        self.cfg = cfg
        self.batcher = ContinuousBatcher(
            params["llama"], cfg.llama, slots=slots, max_len=max_len, chunk=chunk)
        self.device = self.batcher.device
        self.encode_queue: List[QARequest] = []

    def submit(self, rid, frames, prefix_ids, suffix_ids,
               gen: GenerationConfig = GenerationConfig(), *,
               qformer_text_ids=None, qformer_text_mask=None, seed: int = 0,
               prefix_key=None):
        """``seed`` is the reference's sampling seed; greedy requests draw
        nothing from it."""
        check_greedy(gen, f"request {rid!r}")
        if prefix_key is not None:
            raise UnsupportedRequest(
                f"request {rid!r}: prefix_key sharing is not ported yet")
        frames = torch.as_tensor(frames, device=self.device)
        if frames.dim() != 5 or frames.shape[0] != 1:
            raise ValueError("frames must be (1, T, H, W, C)")
        prefix_ids = _ids_row(prefix_ids, self.device)
        suffix_ids = _ids_row(suffix_ids, self.device)
        if qformer_text_ids is not None:
            qformer_text_ids = _ids_row(qformer_text_ids, self.device)
            qformer_text_mask = (torch.ones_like(qformer_text_ids) if qformer_text_mask is None
                                 else _ids_row(qformer_text_mask, self.device))
        # surface bad configs and over-long prompts here, with the batcher's
        # own admission formula, so a request accepted now never fails mid-drain
        s = prefix_ids.shape[1] + self.cfg.num_video_tokens(frames.shape[1]) + suffix_ids.shape[1]
        s_pad = s + (-s) % gen.pad_to_multiple
        if s_pad + gen.max_new_tokens > self.batcher.max_len:
            raise UnsupportedRequest(
                f"request {rid!r}: padded prompt ({s_pad}) + budget "
                f"({gen.max_new_tokens}) exceeds server max_len ({self.batcher.max_len})")
        resolve_auto_merge(self.cfg, frames)
        self.encode_queue.append(QARequest(rid, frames, prefix_ids, suffix_ids,
                                           qformer_text_ids, qformer_text_mask, gen))

    def _free_slots(self) -> int:
        b = self.batcher
        return max(0, sum(r is None for r in b.active) - len(b.queue))

    def _admit_one(self, req: QARequest):
        embeds = _encode_assemble(self.params, req.frames, req.prefix_ids, req.suffix_ids,
                                  req.q_ids, req.q_mask, self.cfg)
        req.frames = None
        self.batcher.submit(req.rid, embeds, req.gen)

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
