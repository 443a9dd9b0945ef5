"""ST-LLM fusion model (stllm_tpu/models/stllm.py):
ViT (+ BTAdapter) -> fp32 ln_vision -> Q-Former -> llama_proj -> LLaMA.

``stllm_forward`` is the training forward on a host-packed batch
(``data/packing.py``): the masked student pass through the cache-less LLaMA,
the shifted cross entropy, and, with dynamic video-token masking, a
no-gradient teacher pass over the unmasked pack and the masked-video-modeling
loss (mean over kept video tokens of 2 - 2 * cosine between student and
teacher hidden states). The encode functions serve generation and
the MVBench harness (``encode_img_mapped``: one video at a time).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from stllm_tpu_torch.models.btadapter import btadapter_forward, init_btadapter
from stllm_tpu_torch.models.llama import (
    VICUNA_7B, LlamaConfig, init_llama, llama_forward, lm_head)
from stllm_tpu_torch.models.qformer import (
    INSTRUCT_BLIP_QFORMER, QFormerConfig, init_qformer, qformer_forward)
from stllm_tpu_torch.models.vit import (
    EVA_VIT_G, ViTConfig, init_vit, normalize_uint8, vit_forward)
from stllm_tpu_torch.ops.layers import gather_rows, init_layer_norm, init_linear, layer_norm, linear
from stllm_tpu_torch.ops.spmd import batch_group, kernel_sharding
from stllm_tpu_torch.ops.tome import MERGE_LEVELS, scale_level_to_depth, select_merge_level
from stllm_tpu_torch.parallel.collectives import concat_all_gather, psum_scalar
from stllm_tpu_torch.parallel.mesh import DATA_AXIS
from stllm_tpu_torch.parallel.sharding import compute_tree, local_batch


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
    *,
    mesh=None,
    specs=None,
) -> torch.Tensor:
    """ViT over B*T frames -> fp32 ln_vision -> Q-Former (the question
    repeated per frame) -> llama_proj. Returns (B, T, num_query, d_llm).
    uint8 frames are CLIP-normalized on the device.

    On a ``mesh`` (``parallel/mesh.py``) ``params`` is this rank's slice of
    the tree by ``specs`` (``stllm_param_shardings``) and the inputs are the
    whole batch on every rank: each rank encodes its rows
    (``parallel.sharding.local_batch``) with the encoder's leaves gathered,
    and the rows are gathered back, so every rank returns the whole result."""
    if mesh is not None:
        return _encode_img_sharded(params, frames, cfg, qformer_text_ids, qformer_text_mask,
                                   mesh, specs)
    if frames.dtype == torch.uint8:
        frames = normalize_uint8(frames, cfg.vit.dtype)
    b, t = frames.shape[:2]
    flat = frames.reshape((b * t,) + tuple(frames.shape[2:]))
    if cfg.vit_model == "eva_btadapter_g":
        image_embeds = btadapter_forward(params["vit"], flat, cfg.vit, num_frames=t)
    else:
        image_embeds = vit_forward(params["vit"], flat, cfg.vit, num_frames=t)
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


_ENCODER = ("vit", "ln_vision", "qformer", "llama_proj")


def _encode_img_sharded(params, frames, cfg, ids, mask, mesh, specs) -> torch.Tensor:
    tree = compute_tree(mesh, {k: params[k] for k in _ENCODER}, {k: specs[k] for k in _ENCODER})
    batch = {k: v for k, v in (("frames", frames), ("ids", ids), ("mask", mask))
             if v is not None}
    local, split = local_batch(mesh, batch)
    with kernel_sharding(mesh if split else None):
        out = encode_img(tree, local["frames"], cfg, local.get("ids"), local.get("mask"))
    return concat_all_gather(out, mesh.groups[DATA_AXIS]) if split else out


def encode_img_mapped(
    params: Dict,
    frames: torch.Tensor,                            # (B, T, H, W, C)
    cfg: STLLMConfig,
    qformer_text_ids: Optional[torch.Tensor] = None,   # (B, Lq)
    qformer_text_mask: Optional[torch.Tensor] = None,  # (B, Lq)
) -> torch.Tensor:
    """Batched-eval encode that runs the videos one at a time through
    ``encode_img`` and concatenates the results, instead of widening every
    matmul to B videos (the JAX package's ``lax.map`` form). Same outputs
    as ``encode_img`` for any B; ``q_mask`` defaults to ones."""
    if frames.shape[0] == 1:
        return encode_img(params, frames, cfg, qformer_text_ids, qformer_text_mask)
    if qformer_text_ids is None:
        return torch.cat([encode_img(params, f[None], cfg) for f in frames])
    if qformer_text_mask is None:
        qformer_text_mask = torch.ones_like(qformer_text_ids)
    return torch.cat([encode_img(params, f[None], cfg, i[None], m[None])
                      for f, i, m in zip(frames, qformer_text_ids, qformer_text_mask)])


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


def _mvm_project(params: Dict, x: torch.Tensor, cfg: STLLMConfig) -> torch.Tensor:
    """The optional linear decoder head on the student states."""
    if cfg.mvm_decode and params.get("mvm_decoder") is not None:
        dec = params["mvm_decoder"]
        return layer_norm(dec["norm"], linear(dec["head"], x), 1e-5)
    return x


def _global_count(x: torch.Tensor) -> torch.Tensor:
    """A loss's denominator over the whole batch: summed over the ranks
    that split the batch under a mesh (``ops.spmd.batch_group``), so each
    rank's loss is its share of the global mean."""
    return psum_scalar(x, batch_group())


def cross_entropy_shifted(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Shifted cross entropy with -100 ignored, mean over the real targets
    of the whole batch (1 where there is none), in fp32."""
    shift_logits = logits[:, :-1].float()
    shift_labels = labels[:, 1:].long()
    valid = shift_labels != -100
    safe = shift_labels.clamp(min=0)
    logz = torch.logsumexp(shift_logits, dim=-1)
    tok = torch.gather(shift_logits, -1, safe[..., None])[..., 0]
    nll = (logz - tok) * valid
    return nll.sum() / _global_count(valid.sum()).clamp(min=1)


def _gather_slots(hidden: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """hidden (B, S, D) at slots (B, V) -> (B, V, D)."""
    idx = slots.long()[..., None].expand(-1, -1, hidden.shape[-1])
    return torch.gather(hidden, 1, idx)


def stllm_forward(params: Dict, batch: Dict[str, torch.Tensor],
                  cfg: STLLMConfig) -> Dict[str, torch.Tensor]:
    """Full training forward: encode, assemble the packed sequence, masked
    LLaMA pass, CE; with ``mvm_weight`` in the batch also the teacher pass
    and the MVM loss. ``batch`` comes from ``data.packing`` (tensors on the
    params' device):

      frames             (B, T, H, W, C)
      qformer_input_ids  (B, Lq)  [optional]   qformer_attention_mask (B, Lq)
      token_ids          (B, S)   student slot text ids
      video_slot         (B, S)   student slot video index or -1
      attn_mask          (B, S)   1 = real slot
      labels             (B, S)   -100 except answer tokens
      [with masking]
      t_token_ids / t_video_slot / t_attn_mask    teacher (unmasked) pack
      mvm_student_slots  (B, V)   slot of video token v in the student pack (0 if dropped)
      mvm_teacher_slots  (B, V)   slot of video token v in the teacher pack
      mvm_weight         (B, V)   1.0 where kept

    Returns loss_ce, loss, logits and, with masking, loss_mvm. The teacher
    runs under ``torch.no_grad()`` on detached embeddings: it records no
    graph."""
    img = encode_img(params, batch["frames"], cfg, batch.get("qformer_input_ids"),
                     batch.get("qformer_attention_mask"))
    video = apply_video_input(params, img, cfg)   # (B, V, D)
    llama = params["llama"]

    embeds = assemble_embeddings(llama["embed_tokens"], batch["token_ids"],
                                 batch["video_slot"], video)
    hidden, _ = llama_forward(llama, inputs_embeds=embeds, attention_mask=batch["attn_mask"],
                              cfg=cfg.llama)
    logits = lm_head(llama, hidden)
    loss_ce = cross_entropy_shifted(logits, batch["labels"])
    out = {"loss_ce": loss_ce, "loss": loss_ce, "logits": logits}

    if "mvm_weight" in batch:
        with torch.no_grad():
            t_embeds = assemble_embeddings(llama["embed_tokens"], batch["t_token_ids"],
                                           batch["t_video_slot"], video.detach())
            t_hidden, _ = llama_forward(llama, inputs_embeds=t_embeds,
                                        attention_mask=batch["t_attn_mask"], cfg=cfg.llama)
            tf = _gather_slots(t_hidden, batch["mvm_teacher_slots"]).float()
            tf = tf / torch.linalg.vector_norm(tf, dim=-1, keepdim=True).clamp(min=1e-6)
        s_vid = _mvm_project(params, _gather_slots(hidden, batch["mvm_student_slots"]), cfg)
        sf = s_vid.float()
        sf = sf / torch.linalg.vector_norm(sf, dim=-1, keepdim=True).clamp(min=1e-6)
        per_tok = 2.0 - 2.0 * (sf * tf).sum(dim=-1)                   # (B, V)
        w = batch["mvm_weight"].float()
        loss_mvm = (per_tok * w).sum() / _global_count(w.sum()).clamp(min=1.0)
        out["loss_mvm"] = loss_mvm
        out["loss"] = loss_ce + loss_mvm
    return out


def resolve_auto_merge(cfg: STLLMConfig, frames) -> STLLMConfig:
    """Resolve ``vit.merge_level == "auto"`` against this video's measured
    redundancy (ops/tome.py select_merge_level, host-side); any other level
    passes through unchanged. ``frames`` (B, T, H, W, C), array or tensor.
    A trunk of another geometry than 257 tokens a frame (a debug size) runs
    unmerged: the levels' token counts are EVA-ViT-g's."""
    if cfg.vit.merge_level != "auto":
        return cfg
    off = dataclasses.replace(cfg.vit, merge_level="")
    if cfg.vit.seq_len != 257:
        return dataclasses.replace(cfg, vit=off)
    level = select_merge_level(frames)
    if level == "off":
        return dataclasses.replace(cfg, vit=off)
    sched = (MERGE_LEVELS[level] if cfg.vit.depth == 39
             else scale_level_to_depth(level, cfg.vit.depth))
    return dataclasses.replace(cfg, vit=dataclasses.replace(off, **sched))


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
