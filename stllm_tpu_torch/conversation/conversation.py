"""Conversation templates and the Chat API (upload_video, ask, answer):
the port of stllm_tpu/conversation/conversation.py
(reference: stllm/conversation/conversation.py:30-340).

The model is a (params, STLLMConfig) pair on one device and decoding is
``generation.generate``. Prompt formats, separator rules, the stop sequences
('###' as [835] or [2277, 29937]) and the output post-processing are the
reference's, so benchmark strings match. Tokenizers are duck-typed: anything
with ``encode(text, add_special_tokens=)`` and ``decode(ids)``; nothing here
imports transformers.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from stllm_tpu_torch.data.processors import ChatVideoEvalProcessor
from stllm_tpu_torch.models.generation import GenerationConfig, UnsupportedRequest, generate
from stllm_tpu_torch.models.stllm import encode_video_for_inference
from stllm_tpu_torch.ops.layers import gather_rows


class SeparatorStyle(enum.Enum):
    SINGLE = enum.auto()
    TWO = enum.auto()


class EasyDict(dict):
    """dict with attribute access (reference:
    stllm/conversation/mvbench_conversation.py EasyDict, the chat-state
    container the MVBench flow uses)."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name, value):
        self[name] = value


@dataclasses.dataclass
class Conversation:
    """Dialog state + prompt renderer.

    The rendered prompt layout is protocol (it must match the reference's
    output strings, conversation.py:30-102, so benchmark prompts tokenize
    identically — pinned by tests/test_conversation.py): the system text,
    then each turn as ``{role}{message}{separator}``. A turn whose message
    is None renders as the bare role — that trailing cue is what the model
    completes. SINGLE style uses one separator everywhere (also after the
    system text); TWO alternates ``sep``/``sep2`` by turn parity, with
    ``sep`` after the system text.
    """

    system: str
    roles: Tuple[str, str]
    messages: List[List[Optional[str]]]
    offset: int
    instruction: bool
    sep_style: SeparatorStyle = SeparatorStyle.SINGLE
    sep: str = "###"
    sep2: Optional[str] = None
    skip_next: bool = False
    conv_id: Any = None

    def _separators(self) -> Tuple[str, str]:
        if self.sep_style == SeparatorStyle.SINGLE:
            return self.sep, self.sep
        if self.sep_style == SeparatorStyle.TWO:
            return self.sep, self.sep2 or ""
        raise ValueError(f"Invalid style: {self.sep_style}")

    def get_prompt(self) -> str:
        seps = self._separators()
        parts = [self.system, seps[0]]
        for i, (role, message) in enumerate(self.messages):
            parts.append(role)
            if message:
                parts.append(message)
                parts.append(seps[i % 2])
        return "".join(parts)

    def append_message(self, role: str, message: Optional[str]) -> None:
        self.messages.append([role, message])

    def copy(self) -> "Conversation":
        clone = dataclasses.replace(self, skip_next=False)  # transient flag
        clone.messages = [list(turn) for turn in self.messages]
        return clone

    def dict(self):
        keep = ("system", "roles", "messages", "offset", "sep", "sep2",
                "conv_id")
        return {k: getattr(self, k) for k in keep}


# Preset templates (reference: conversation.py:127-179)

CONV_VISION_Vicuna0 = Conversation(
    system="Give the following image: <Img>ImageContent</Img>. "
           "You will be able to see the image once I provide it to you. "
           "Please answer my questions.",
    roles=("Human: ", "Assistant: "),
    messages=[],
    offset=2,
    instruction=True,
    sep_style=SeparatorStyle.SINGLE,
    sep="###",
)

CONV_VIDEO_Vicuna0 = Conversation(
    system="Give the following video: <Video>VideoContent</Video>. "
           "You will be able to see the video once I provide it to you. "
           "Please answer my questions.",
    roles=("Human: ", "Assistant: "),
    messages=[],
    offset=2,
    instruction=True,
    sep_style=SeparatorStyle.SINGLE,
    sep="###",
)

CONV_instructblip_Vicuna0 = Conversation(
    system="Carefully watch the video and pay attention to the cause and "
           "sequence of events, the detail and movement of objects, and the "
           "action and pose of persons. Based on your observations, give your "
           "answer that best addresses the question.\n",
    roles=("Human: ", "Assistant: "),
    messages=[],
    instruction=False,
    offset=2,
    sep_style=SeparatorStyle.SINGLE,
    sep="###",
)

CONV_VISION_LLama2 = Conversation(
    system="Give the following image: <Img>ImageContent</Img>. "
           "You will be able to see the image once I provide it to you. "
           "Please answer my questions.",
    roles=("<s>[INST] ", " [/INST] "),
    messages=[],
    offset=2,
    instruction=True,
    sep_style=SeparatorStyle.SINGLE,
    sep="",
)

CONV_VIDEO_LLama2 = Conversation(
    system="Give the following video: <Img>VideoContent</Img>. "
           "You will be able to see the video once I provide it to you. "
           "Please answer my questions.",
    roles=("<s>[INST] ", " [/INST] "),
    messages=[],
    offset=2,
    instruction=True,
    sep_style=SeparatorStyle.SINGLE,
    sep="",
)


def _encode(tokenizer, text: str, add_special_tokens: bool) -> List[int]:
    ids = tokenizer.encode(text, add_special_tokens=add_special_tokens)
    return list(ids)


class Chat:
    """Chat over one model (reference Chat, conversation.py:181-340).

    Parameters
    ----------
    params / cfg : the STLLM param tree (on the device the chat runs on)
        and its STLLMConfig.
    llama_tokenizer : encode/decode duck-typed tokenizer for the LLM.
    qformer_tokenizer : optional tokenizer for Q-Former text input
        (qformer_text_input mode); must also expose
        ``encode(text, add_special_tokens=)``.
    """

    def __init__(self, params, cfg, llama_tokenizer, qformer_tokenizer=None,
                 image_size: int = 224, max_qformer_len: int = 32):
        self.params = params
        self.cfg = cfg
        self.llama_tokenizer = llama_tokenizer
        self.qformer_tokenizer = qformer_tokenizer
        self.device = params["llama"]["embed_tokens"].device
        # normalize=False: frames stay uint8 on the host and are
        # CLIP-normalized on the device inside encode_img
        self.transform = ChatVideoEvalProcessor(image_size=image_size, normalize=False,
                                                device=self.device)
        self.max_qformer_len = max_qformer_len

    # -- prompt management -------------------------------------------------

    def ask(self, text: str, conv: Conversation) -> None:
        """Merge consecutive Human turns after a media upload
        (reference: conversation.py:205-211)."""
        if (
            len(conv.messages) > 0
            and conv.messages[-1][0] == conv.roles[0]
            and conv.messages[-1][1] is not None
            and (
                conv.messages[-1][1][-6:] == "</Img>"
                or conv.messages[-1][1][-8:] == "</Video>"
                or conv.messages[-1][1][-8:] == "</Frame>"
            )
        ):
            conv.messages[-1][1] = " ".join([conv.messages[-1][1], text])
        else:
            conv.append_message(conv.roles[0], text)

    # -- media upload ------------------------------------------------------

    def _qformer_text(self, text: Optional[str]):
        if not (self.cfg.qformer_text_input and text and self.qformer_tokenizer):
            return None, None
        ids = _encode(self.qformer_tokenizer, text, True)[: self.max_qformer_len]
        arr = torch.tensor([ids], dtype=torch.int32, device=self.device)
        return arr, torch.ones_like(arr)

    def upload_video(self, video, conv: Conversation, img_list: List,
                     num_frame: int = 64, text: Optional[str] = None) -> str:
        """Decode, transform and encode a video; appends the (1, V, D) video
        embedding (reference: conversation.py:274-299, with the
        inference-side video_input stage in stllm.apply_video_input)."""
        from stllm_tpu_torch.data.samplers import get_seq_frames
        from stllm_tpu_torch.data.video_reader import open_video

        if isinstance(video, str):
            vr = open_video(video)
            try:
                raw = vr.get_batch(get_seq_frames(len(vr), num_frame))
            finally:
                vr.close()
        else:
            raw = np.asarray(video)
        frames = self.transform(raw)                       # (T, H, W, C) uint8
        q_ids, q_mask = self._qformer_text(text)
        emb = encode_video_for_inference(
            self.params, torch.as_tensor(frames, device=self.device), self.cfg, q_ids, q_mask)
        img_list.append(emb)                                # (1, V, D)
        conv.append_message(conv.roles[0], "<Video><ImageHere></Video>")
        return "Received."

    def upload_img(self, image, conv: Conversation, img_list: List) -> str:
        """Single image (reference: conversation.py:255-272)."""
        raw = np.asarray(image.convert("RGB")) if hasattr(image, "convert") else np.asarray(image)
        frame = self.transform(raw[None] if raw.ndim == 3 else raw)
        emb = encode_video_for_inference(
            self.params, torch.as_tensor(frame, device=self.device), self.cfg)
        img_list.append(emb)
        conv.append_message(conv.roles[0], "<Img><ImageHere></Img>")
        return "Received."

    # -- embedding assembly ------------------------------------------------

    def _embed_ids(self, ids: Sequence[int]) -> torch.Tensor:
        table = self.params["llama"]["embed_tokens"]
        ids = torch.as_tensor(list(ids), dtype=torch.long, device=table.device)
        return gather_rows(table, ids)[None].to(self.cfg.llama.dtype)

    def _context_segment_ids(self, conv: Conversation, img_list: List) -> List[List[int]]:
        """Tokenize the prompt's text segments around each <ImageHere>."""
        segs = conv.get_prompt().split("<ImageHere>")
        assert len(segs) == len(img_list) + 1, \
            "Unmatched numbers of image placeholders and images."
        return [_encode(self.llama_tokenizer, seg, i == 0) for i, seg in enumerate(segs)]

    def _assemble_context(self, seg_ids: List[List[int]], img_list: List) -> torch.Tensor:
        seg_embs = [self._embed_ids(ids) for ids in seg_ids]
        mixed = [emb for pair in zip(seg_embs[:-1], img_list) for emb in pair]
        mixed.append(seg_embs[-1])
        return torch.cat([m.to(self.cfg.llama.dtype) for m in mixed], dim=1)

    def get_context_emb(self, conv: Conversation, img_list: List) -> torch.Tensor:
        """Interleave text-segment embeddings with video embeddings at each
        <ImageHere> (reference: conversation.py:301-320)."""
        return self._assemble_context(self._context_segment_ids(conv, img_list), img_list)

    def _sim_text_ids(self, conv: Conversation, system: bool) -> List[int]:
        question = conv.messages[0][1]
        # the reference splits only on '</Video> ' (its demos are video-only);
        # the image tag is accepted too so simple-mode image QA works
        for tag in ("</Video> ", "</Img> ", "</Frame> "):
            if tag in question:
                question = question.split(tag)[1]
                break
        sys_txt = conv.system if system else ""
        text = sys_txt + "###Human: " + question + " ###Assistant: "
        return _encode(self.llama_tokenizer, text, True)

    def get_context_emb_sim(self, conv: Conversation, img_list: List,
                            system: bool = True) -> torch.Tensor:
        """Simple mode: [video tokens] + [system###Human: q ###Assistant: ]
        (reference: conversation.py:322-340)."""
        seg = self._embed_ids(self._sim_text_ids(conv, system))
        return torch.cat([img_list[0].to(seg.dtype), seg], dim=1)

    # -- generation --------------------------------------------------------

    def answer(self, conv: Conversation, img_list: List,
               max_new_tokens: int = 300, num_beams: int = 1,
               min_length: int = 1, top_p: float = 0.9, system: bool = True,
               repetition_penalty: float = 1.0, length_penalty: float = 1.0,
               temperature: float = 1.0, max_length: int = 2000,
               do_sample: bool = True, seed: int = 0,
               service=None, kv_session=None) -> Tuple[str, np.ndarray]:
        """Generate the Assistant turn with the reference's defaults (top-p
        sampling) and its forced repetition_penalty 1.5 in simple mode.
        ``service`` (an AnswerService) and ``kv_session`` (a PrefixSession)
        are not ported yet and raise when given; ``num_beams > 1`` raises
        UnsupportedRequest from generate."""
        if service is not None:
            raise NotImplementedError("Chat.answer(service=...): AnswerService is not ported yet")
        if kv_session is not None:
            raise NotImplementedError(
                "Chat.answer(kv_session=...): PrefixSession is not ported yet")
        conv.append_message(conv.roles[1], None)
        if conv.instruction:
            embs = self._assemble_context(self._context_segment_ids(conv, img_list), img_list)
        else:
            # sim items: [] text before the video block, then the one segment
            embs = self._assemble_context([[], self._sim_text_ids(conv, system)],
                                          img_list[:1])
            repetition_penalty = 1.5  # reference: conversation.py:226

        current_max_len = embs.shape[1] + max_new_tokens
        begin_idx = max(0, current_max_len - max_length)
        embs = embs[:, begin_idx:]

        gen = GenerationConfig(
            max_new_tokens=max_new_tokens, min_length=min_length,
            do_sample=do_sample, num_beams=num_beams, top_p=top_p,
            temperature=temperature, repetition_penalty=repetition_penalty,
            length_penalty=length_penalty,
        )
        tokens = generate(self.params["llama"], embs, llama_cfg=self.cfg.llama, gen=gen,
                          seed=seed)[0]
        text = _strip_answer(self.llama_tokenizer, tokens)
        conv.messages[-1][1] = text
        return text, np.asarray(_strip_leading(tokens))

    def answer_batched(self, convs: List[Conversation], img_lists: List[List],
                       max_new_tokens: int = 300, num_beams: int = 5,
                       min_length: int = 1, length_penalty: float = 1.0,
                       system: bool = True, max_length: int = 2000) -> List[str]:
        """Batched-eval beam answers: beam search is not ported yet."""
        raise UnsupportedRequest("Chat.answer_batched: beam search is not ported yet")


def _strip_leading(tokens: Sequence[int]) -> List[int]:
    """Drop a leading <unk> (0), then a leading <s> (1)
    (reference: conversation.py:245-249)."""
    tokens = list(tokens)
    if tokens and tokens[0] == 0:
        tokens = tokens[1:]
    if tokens and tokens[0] == 1:
        tokens = tokens[1:]
    return tokens


def _strip_answer(tokenizer, tokens: Sequence[int]) -> str:
    """Decode, cut at '###', keep the text after the last 'Assistant:'."""
    text = tokenizer.decode(_strip_leading(tokens))
    return text.split("###")[0].split("Assistant:")[-1].strip()
