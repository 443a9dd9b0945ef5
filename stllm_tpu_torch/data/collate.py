"""Host-side collator: instruction-tuning samples -> the static-shape packed
batch consumed by ``stllm_forward`` (the port's copy of
stllm_tpu/data/collate.py; NumPy only).

  - Q-Former text = instruction.split('Human: ')[1].split(' ###')[0];
  - answer text = answer + eos (qformer_text_input) or answer + end_sym,
    truncated to max_txt_len, no special tokens;
  - BOS is prepended only when qformer_text_input is off;
  - mask rate ~ clip(N(0.5, 0.1), 0.1, 0.7) drawn once per batch, the same
    count per row, positions shuffled per row;
  - the sequence length is bucketed to a multiple of 128, so a batch falls in
    one of a few lengths (and so in one attention tier).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from stllm_tpu_torch.data.packing import bucket_seq_len, pack_training_batch, sample_video_mask


def qformer_text_from_instruction(instruction: str) -> str:
    """(reference: st_llm.py:457-458)"""
    return instruction.split("Human: ")[1].split(" ###")[0]


class TrainCollator:
    """samples (list of dicts from IT datasets) -> packed NumPy batch dict."""

    def __init__(
        self,
        cfg,                       # STLLMConfig
        llama_tokenizer,
        qformer_tokenizer=None,
        pad_id: int = 0,
        eos_id: int = 2,
        bos_id: int = 1,
        max_qformer_len: int = 32,
        seq_multiple: int = 128,
        use_mask: Optional[bool] = None,
        seed: Optional[int] = None,
    ):
        self.cfg = cfg
        self.llama_tokenizer = llama_tokenizer
        self.qformer_tokenizer = qformer_tokenizer
        self.pad_id = pad_id
        self.eos_id = eos_id
        self.bos_id = bos_id
        self.max_qformer_len = max_qformer_len
        self.seq_multiple = seq_multiple
        self.use_mask = cfg.use_mask if use_mask is None else use_mask
        self.rng = np.random.default_rng(seed)

    def _encode(self, text: str) -> List[int]:
        return list(self.llama_tokenizer.encode(text, add_special_tokens=False))

    def __call__(self, samples: Sequence[Dict]) -> Dict[str, np.ndarray]:
        b = len(samples)
        frames = np.stack([np.asarray(s["image"]) for s in samples])  # (B,T,H,W,C)
        t = frames.shape[1]
        num_video = self.cfg.num_video_tokens(t)

        before_ids, after_ids, answer_ids = [], [], []
        q_texts = []
        for s in samples:
            instruction = s["instruction_input"]
            before, after = instruction.split("<ImageHere>")
            before_ids.append(self._encode(before))
            # reference quirk preserved: the AFTER segment is tokenized with
            # add_special_tokens=qformer_text_input, injecting a BOS right
            # after the video tokens (st_llm.py:388-391)
            after = self._encode(after)
            if self.cfg.qformer_text_input:
                after = [self.bos_id] + after
            after_ids.append(after)
            if self.cfg.qformer_text_input:
                ans = self._encode(s["answer"])[: self.cfg.max_txt_len] + [self.eos_id]
            else:
                ans = self._encode(s["answer"] + self.cfg.end_sym)[: self.cfg.max_txt_len]
            answer_ids.append(ans)
            q_texts.append(qformer_text_from_instruction(instruction))

        keep = None
        if self.use_mask and t > 1:
            keep = sample_video_mask(
                self.rng, b, num_video,
                mean=self.cfg.mask_mean, std=self.cfg.mask_std,
                lo=self.cfg.mask_lo, hi=self.cfg.mask_hi,
            )

        required = max(
            (1 if not self.cfg.qformer_text_input else 0)
            + len(bi) + num_video + len(ai) + len(an)
            for bi, ai, an in zip(before_ids, after_ids, answer_ids)
        )
        seq_len = bucket_seq_len(required, self.seq_multiple)

        batch = pack_training_batch(
            before_ids, after_ids, answer_ids,
            num_video=num_video, seq_len=seq_len, pad_id=self.pad_id,
            keep=keep,
            bos_id=None if self.cfg.qformer_text_input else self.bos_id,
        )
        batch["frames"] = frames

        if self.cfg.qformer_text_input and self.qformer_tokenizer is not None:
            enc = [
                list(self.qformer_tokenizer.encode(q, add_special_tokens=True))
                [: self.max_qformer_len]
                for q in q_texts
            ]
            ql = max(len(e) for e in enc)
            ids = np.zeros((b, ql), np.int32)
            mask = np.zeros((b, ql), np.int32)
            for i, e in enumerate(enc):
                ids[i, : len(e)] = e
                mask[i, : len(e)] = 1
            batch["qformer_input_ids"] = ids
            batch["qformer_attention_mask"] = mask
        return batch
