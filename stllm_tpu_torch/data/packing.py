"""Host-side sequence packing: variable-length prompts -> static-shape arrays
(the port's copy of stllm_tpu/data/packing.py; NumPy only).

Every row becomes a fixed-length sequence of slots where each slot is either
a text token id or an index into the row's video tokens; the device then
assembles embeddings with one gather and a where
(``models.stllm.assemble_embeddings``). Layout per row, right-padded:

    [bos?] [prompt-before] [video tokens (kept)] [prompt-after] [answer] [pad..]

Labels are -100 everywhere except answer tokens. With a keep mask the batch
also carries the unmasked teacher pack and the gather arrays of the
masked-video-modeling loss.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

IGNORE = -100

# segment types
Text = Tuple[str, Sequence[int], Optional[Sequence[int]]]  # ("text", ids, labels|None)
Video = Tuple[str, Sequence[int]]                           # ("video", original indices)


def text_seg(ids: Sequence[int], labels: Optional[Sequence[int]] = None) -> Text:
    return ("text", list(ids), list(labels) if labels is not None else None)


def video_seg(indices: Sequence[int]) -> Video:
    return ("video", list(indices))


@dataclasses.dataclass
class Pack:
    token_ids: np.ndarray   # (B, S) int32
    video_slot: np.ndarray  # (B, S) int32, -1 = not a video slot
    attn_mask: np.ndarray   # (B, S) int32
    labels: np.ndarray      # (B, S) int32, IGNORE outside answers
    # per-row map: original video index -> slot in this pack (-1 if absent)
    video_pos: np.ndarray   # (B, V) int32

    def as_batch(self, prefix: str = "") -> Dict[str, np.ndarray]:
        return {
            f"{prefix}token_ids": self.token_ids,
            f"{prefix}video_slot": self.video_slot,
            f"{prefix}attn_mask": self.attn_mask,
            f"{prefix}labels": self.labels,
        }


def pack_rows(
    rows: List[List[Union[Text, Video]]],
    seq_len: int,
    pad_id: int,
    num_video: int,
) -> Pack:
    """Lay out each row's segments left-to-right into (B, seq_len) arrays.

    Rows longer than seq_len are truncated from the RIGHT (the reference
    truncates answers via max_txt_len before this point; overflow here means
    the bucket is too small and trailing answer tokens are dropped).
    """
    b = len(rows)
    token_ids = np.full((b, seq_len), pad_id, np.int32)
    video_slot = np.full((b, seq_len), -1, np.int32)
    attn = np.zeros((b, seq_len), np.int32)
    labels = np.full((b, seq_len), IGNORE, np.int32)
    video_pos = np.full((b, num_video), -1, np.int32)

    for i, segments in enumerate(rows):
        cur = 0
        for seg in segments:
            kind = seg[0]
            if kind == "text":
                _, ids, labs = seg
                n = min(len(ids), seq_len - cur)
                if n <= 0:
                    break
                token_ids[i, cur : cur + n] = np.asarray(ids[:n], np.int32)
                if labs is not None:
                    labels[i, cur : cur + n] = np.asarray(labs[:n], np.int32)
                attn[i, cur : cur + n] = 1
                cur += n
            elif kind == "video":
                _, idxs = seg
                n = min(len(idxs), seq_len - cur)
                if n <= 0:
                    break
                video_slot[i, cur : cur + n] = np.asarray(idxs[:n], np.int32)
                for j, v in enumerate(idxs[:n]):
                    video_pos[i, v] = cur + j
                attn[i, cur : cur + n] = 1
                cur += n
            else:
                raise ValueError(f"unknown segment kind {kind!r}")
    return Pack(token_ids, video_slot, attn, labels, video_pos)


def sample_video_mask(
    rng: np.random.Generator,
    batch: int,
    num_tokens: int,
    mean: float = 0.5,
    std: float = 0.1,
    lo: float = 0.1,
    hi: float = 0.7,
) -> np.ndarray:
    """(B, V) keep-mask. One rate per batch ~ clip(N(mean,std), lo, hi), the
    same masked COUNT per row, positions shuffled per row (reference:
    st_llm.py:484-486 + stllm/models/utils.py:4-16 RandomMaskingGenerator)."""
    rate = float(np.clip(rng.normal(mean, std), lo, hi))
    num_mask = int(rate * num_tokens)
    keep = np.ones((batch, num_tokens), bool)
    for i in range(batch):
        drop = rng.permutation(num_tokens)[:num_mask]
        keep[i, drop] = False
    return keep


def pack_training_batch(
    before_ids: List[Sequence[int]],
    after_ids: List[Sequence[int]],
    answer_ids: List[Sequence[int]],
    num_video: int,
    seq_len: int,
    pad_id: int,
    *,
    keep: Optional[np.ndarray] = None,     # (B, V) bool; None = no masking
    bos_id: Optional[int] = None,          # prepended when not qformer_text_input
) -> Dict[str, np.ndarray]:
    """Build the device batch dict consumed by stllm_forward.

    before/after = instruction split on '<ImageHere>' tokenized on host
    (reference: st_llm.py:386-396); answer tokens already carry the eos/end_sym
    (st_llm.py:498-508). With ``keep`` given, emits the masked student pack,
    the unmasked teacher pack and the MVM gather arrays.
    """
    b = len(before_ids)
    all_idx = list(range(num_video))

    def build(keep_row: Optional[np.ndarray], i: int) -> List:
        vid = all_idx if keep_row is None else [v for v in all_idx if keep_row[v]]
        segs: List = []
        if bos_id is not None:
            segs.append(text_seg([bos_id]))
        segs.append(text_seg(before_ids[i]))
        segs.append(video_seg(vid))
        segs.append(text_seg(after_ids[i]))
        segs.append(text_seg(answer_ids[i], labels=answer_ids[i]))
        return segs

    student = pack_rows([build(None if keep is None else keep[i], i) for i in range(b)],
                        seq_len, pad_id, num_video)
    batch = student.as_batch()

    if keep is not None:
        teacher = pack_rows([build(None, i) for i in range(b)], seq_len, pad_id, num_video)
        batch.update(
            t_token_ids=teacher.token_ids,
            t_video_slot=teacher.video_slot,
            t_attn_mask=teacher.attn_mask,
            mvm_student_slots=np.maximum(student.video_pos, 0).astype(np.int32),
            mvm_teacher_slots=np.maximum(teacher.video_pos, 0).astype(np.int32),
            mvm_weight=(student.video_pos >= 0).astype(np.float32),
        )
    return batch


def bucket_seq_len(required: int, multiple: int = 128, minimum: int = 128) -> int:
    """Round a required length up to a compile bucket so few distinct shapes
    are ever compiled."""
    return max(minimum, -(-required // multiple) * multiple)
