"""ST-LLM fusion model, inference half (stllm_tpu/models/stllm.py):
ViT (+ BTAdapter) -> fp32 ln_vision -> Q-Former -> llama_proj -> LLaMA.

The training forward (masked student + teacher passes, MVM loss) comes with
the training slice; ``init_stllm`` already builds the full parameter tree so
the converter and the trees match the reference key for key.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from stllm_tpu_torch.models.btadapter import btadapter_forward, init_btadapter
from stllm_tpu_torch.models.generation import UnsupportedRequest
from stllm_tpu_torch.models.llama import VICUNA_7B, LlamaConfig, init_llama
from stllm_tpu_torch.models.qformer import (
    INSTRUCT_BLIP_QFORMER, QFormerConfig, init_qformer, qformer_forward)
from stllm_tpu_torch.models.vit import EVA_VIT_G, ViTConfig, init_vit, vit_forward
from stllm_tpu_torch.ops.layers import gather_rows, init_layer_norm, init_linear, layer_norm, linear

# CLIP normalization constants (the reference's data/processors.py)
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


@dataclasses.dataclass(frozen=True)
class STLLMConfig:
    vit: ViTConfig = EVA_VIT_G
    qformer: QFormerConfig = INSTRUCT_BLIP_QFORMER
    llama: LlamaConfig = VICUNA_7B
    # 'all' | 'mean' | 'residual' | None
    video_input: Optional[str] = "residual"
    residual_size: int = 4
    use_mask: bool = True
    mvm_decode: bool = False
    qformer_text_input: bool = True
    vit_model: str = "eva_clip_g"     # or "eva_btadapter_g"
    btadapter_depth: int = 3
    max_txt_len: int = 32
    end_sym: str = "\n"
    mask_mean: float = 0.5
    mask_std: float = 0.1
    mask_lo: float = 0.1
    mask_hi: float = 0.7

    @property
    def num_query(self) -> int:
        return self.qformer.num_query

    def num_video_tokens(self, num_frames: int) -> int:
        """Video tokens the LLM sees after the video_input stage."""
        if num_frames == 1:
            return self.num_query
        if self.video_input == "mean":
            return self.num_query
        if self.video_input == "residual":
            return self.residual_size * self.num_query
        return num_frames * self.num_query


def residual_frame_index(sample_segments: int, total_segments: int):
    """Uniform segment-midpoint frame indices for the global-local module."""
    seg = float(total_segments) / sample_segments
    return [int(seg / 2 + round(seg * i)) for i in range(sample_segments)]


def init_stllm(gen: torch.Generator, cfg: STLLMConfig, init_llama_params: bool = True) -> Dict:
    """Random init of the full stack on ``gen``'s device."""
    dev = gen.device
    vit_params = (init_btadapter(gen, cfg.vit, cfg.btadapter_depth)
                  if cfg.vit_model == "eva_btadapter_g" else init_vit(gen, cfg.vit))
    d_llm = cfg.llama.hidden
    params: Dict = {
        "vit": vit_params,
        "ln_vision": init_layer_norm(cfg.vit.width, torch.float32, dev),
        "qformer": init_qformer(gen, cfg.qformer, text_input=cfg.qformer_text_input),
        "llama_proj": init_linear(gen, cfg.qformer.hidden, d_llm, cfg.llama.dtype),
        "llama": init_llama(gen, cfg.llama) if init_llama_params else None,
    }
    if cfg.video_input == "residual":
        # kaiming_uniform(a=sqrt(5)) down, ZERO up: no contribution at step 0
        d_mid = d_llm // 4
        bound = (6.0 / (6.0 * d_llm)) ** 0.5
        down = torch.empty((d_llm, d_mid), dtype=torch.float32, device=dev)
        down.uniform_(-bound, bound, generator=gen)
        params["residual"] = {
            "down": {"w": down.to(cfg.llama.dtype),
                     "b": torch.zeros((d_mid,), dtype=cfg.llama.dtype, device=dev)},
            "up": {"w": torch.zeros((d_mid, d_llm), dtype=cfg.llama.dtype, device=dev),
                   "b": torch.zeros((d_llm,), dtype=cfg.llama.dtype, device=dev)},
        }
    if cfg.mvm_decode:
        params["mvm_decoder"] = {
            "head": init_linear(gen, d_llm, d_llm, cfg.llama.dtype),
            "norm": init_layer_norm(d_llm, torch.float32, dev),
        }
    return params


def encode_img(
    params: Dict,
    frames: torch.Tensor,                            # (B, T, H, W, C) normalized or uint8
    cfg: STLLMConfig,
    qformer_text_ids: Optional[torch.Tensor] = None,   # (B, Lq)
    qformer_text_mask: Optional[torch.Tensor] = None,  # (B, Lq)
) -> torch.Tensor:
    """ViT over B*T frames -> fp32 ln_vision -> Q-Former (the question
    repeated per frame) -> llama_proj. Returns (B, T, num_query, d_llm).
    uint8 frames are CLIP-normalized on the device."""
    if frames.dtype == torch.uint8:
        mean = torch.tensor(CLIP_MEAN, dtype=torch.float32, device=frames.device) * 255.0
        std = torch.tensor(CLIP_STD, dtype=torch.float32, device=frames.device) * 255.0
        frames = ((frames.float() - mean) / std).to(cfg.vit.dtype)
    b, t = frames.shape[:2]
    flat = frames.reshape((b * t,) + tuple(frames.shape[2:]))
    if cfg.vit_model == "eva_btadapter_g":
        image_embeds = btadapter_forward(params["vit"], flat, cfg.vit, num_frames=t)
    else:
        image_embeds = vit_forward(params["vit"], flat, cfg.vit)
    image_embeds = layer_norm(params["ln_vision"], image_embeds, 1e-6)

    ids = mask = None
    if cfg.qformer_text_input and qformer_text_ids is not None:
        ids = torch.repeat_interleave(qformer_text_ids, t, dim=0)
        if qformer_text_mask is not None:
            mask = torch.repeat_interleave(qformer_text_mask, t, dim=0)

    q_out = qformer_forward(params["qformer"], encoder_hidden_states=image_embeds,
                            input_ids=ids, attention_mask=mask,
                            cfg=cfg.qformer)[:, :cfg.num_query]
    tokens = linear(params["llama_proj"], q_out.to(cfg.llama.dtype))
    return tokens.reshape(b, t, cfg.num_query, -1)


def apply_video_input(params: Dict, img_embeds: torch.Tensor, cfg: STLLMConfig) -> torch.Tensor:
    """(B, T, Q, D) -> (B, V, D) per the video_input mode; T == 1 (an image)
    passes through."""
    b, t, q, d = img_embeds.shape
    if t == 1:
        return img_embeds.reshape(b, q, d)
    if cfg.video_input == "mean":
        return img_embeds.mean(dim=1)
    if cfg.video_input == "residual":
        idx = residual_frame_index(cfg.residual_size, t)
        local = img_embeds[:, idx]                                        # (B, R, Q, D)
        glob = img_embeds.mean(dim=1, keepdim=True)                       # (B, 1, Q, D)
        adapter = linear(params["residual"]["up"],
                         torch.relu(linear(params["residual"]["down"], glob)))
        return (local + adapter).reshape(b, cfg.residual_size * q, d)
    return img_embeds.reshape(b, t * q, d)


def assemble_embeddings(
    embed_tokens: torch.Tensor,   # (vocab, D)
    token_ids: torch.Tensor,      # (B, S) text token per slot
    video_slot: torch.Tensor,     # (B, S) index into video tokens, or -1
    video_embeds: torch.Tensor,   # (B, V, D)
) -> torch.Tensor:
    """Fill each slot with its text embedding or its video token."""
    text = gather_rows(embed_tokens, token_ids).to(video_embeds.dtype)
    idx = video_slot.long().clamp(0, video_embeds.shape[1] - 1)
    gathered = torch.gather(
        video_embeds, 1, idx[..., None].expand(-1, -1, video_embeds.shape[-1]))
    return torch.where((video_slot >= 0)[..., None], gathered, text)


def resolve_auto_merge(cfg: STLLMConfig, frames) -> STLLMConfig:
    """Token merging is not ported yet: only ``merge_level == ""`` runs."""
    if cfg.vit.merge_level != "":
        raise UnsupportedRequest(
            f"vit.merge_level={cfg.vit.merge_level!r}: token merging is not ported yet")
    return cfg


def encode_video_for_inference(
    params: Dict,
    frames: torch.Tensor,         # (T, H, W, C) or (B, T, H, W, C)
    cfg: STLLMConfig,
    qformer_text_ids: Optional[torch.Tensor] = None,
    qformer_text_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """encode_img + video_input for generation. Returns (B, V, D)."""
    if frames.dim() == 4:
        frames = frames[None]
    cfg = resolve_auto_merge(cfg, frames)
    img = encode_img(params, frames, cfg, qformer_text_ids, qformer_text_mask)
    return apply_video_input(params, img, cfg)
