"""Q-Former: BERT encoder with query tokens and periodic cross-attention
(stllm_tpu/models/qformer.py).

Query tokens (32) precede the text embeddings and the embedding LayerNorm
covers both; layers with ``layer % cross_attention_freq == 0`` cross-attend
the ViT sequence from the query positions only; query and text positions have
separate FFNs; post-norm residuals, LN eps 1e-12, exact GELU. Attention is
``mha_reference`` in plain torch. The UniLM decoder path comes later.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from stllm_tpu_torch.ops.attention import mha_reference
from stllm_tpu_torch.ops.layers import (
    gather_rows, gelu, init_layer_norm, init_linear, layer_norm, linear, normal)


@dataclasses.dataclass(frozen=True)
class QFormerConfig:
    hidden: int = 768
    num_layers: int = 12
    heads: int = 12
    intermediate: int = 3072
    encoder_width: int = 1408
    cross_attention_freq: int = 2
    num_query: int = 32
    vocab_size: int = 30523          # bert-base-uncased + [DEC]
    max_positions: int = 512
    ln_eps: float = 1e-12
    dtype: Any = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.hidden // self.heads


INSTRUCT_BLIP_QFORMER = QFormerConfig()


def init_qformer(gen: torch.Generator, cfg: QFormerConfig, text_input: bool = True) -> Dict:
    """Random init; ``text_input=False`` leaves the word/position embeddings
    and the text FFN out (None), as the reference does without text input."""
    d, m = cfg.hidden, cfg.intermediate
    dev = gen.device

    def attn(kv_width: int) -> Dict:
        return {
            "q": init_linear(gen, d, d, cfg.dtype),
            "k": init_linear(gen, kv_width, d, cfg.dtype),
            "v": init_linear(gen, kv_width, d, cfg.dtype),
            "out": init_linear(gen, d, d, cfg.dtype),
            "out_norm": init_layer_norm(d, cfg.dtype, dev),
        }

    params: Dict = {
        "query_tokens": normal(gen, (1, cfg.num_query, d), 0.02, cfg.dtype),
        "embeddings": {
            "word": normal(gen, (cfg.vocab_size, d), 0.02, cfg.dtype) if text_input else None,
            "position": (normal(gen, (cfg.max_positions, d), 0.02, cfg.dtype)
                         if text_input else None),
            "norm": init_layer_norm(d, cfg.dtype, dev),
        },
        "layers": [],
    }
    for i in range(cfg.num_layers):
        layer: Dict = {
            "attention": attn(d),
            "intermediate_query": init_linear(gen, d, m, cfg.dtype),
            "output_query": {
                "dense": init_linear(gen, m, d, cfg.dtype),
                "norm": init_layer_norm(d, cfg.dtype, dev),
            },
        }
        if i % cfg.cross_attention_freq == 0:
            layer["crossattention"] = attn(cfg.encoder_width)
        if text_input:
            layer["intermediate"] = init_linear(gen, d, m, cfg.dtype)
            layer["output"] = {
                "dense": init_linear(gen, m, d, cfg.dtype),
                "norm": init_layer_norm(d, cfg.dtype, dev),
            }
        params["layers"].append(layer)
    return params


def _mha(attn_params: Dict, x: torch.Tensor, kv: torch.Tensor, cfg: QFormerConfig,
         kv_mask: Optional[torch.Tensor]) -> torch.Tensor:
    b, n, _ = x.shape
    m = kv.shape[1]
    q = linear(attn_params["q"], x).reshape(b, n, cfg.heads, cfg.head_dim)
    k = linear(attn_params["k"], kv).reshape(b, m, cfg.heads, cfg.head_dim)
    v = linear(attn_params["v"], kv).reshape(b, m, cfg.heads, cfg.head_dim)
    out = mha_reference(q, k, v, kv_mask=kv_mask)
    return linear(attn_params["out"], out.reshape(b, n, cfg.hidden))


def _post_norm_residual(dense_out: torch.Tensor, residual: torch.Tensor, norm: Dict,
                        eps: float) -> torch.Tensor:
    return layer_norm(norm, dense_out + residual, eps)


def qformer_forward(
    params: Dict,
    *,
    encoder_hidden_states: torch.Tensor,          # (B, S_img, encoder_width)
    input_ids: Optional[torch.Tensor] = None,     # (B, T) padded
    attention_mask: Optional[torch.Tensor] = None,  # (B, T) 1 = real
    encoder_mask: Optional[torch.Tensor] = None,  # (B, S_img)
    query_embeds: Optional[torch.Tensor] = None,  # default: params["query_tokens"]
    cfg: QFormerConfig = INSTRUCT_BLIP_QFORMER,
) -> torch.Tensor:
    """Returns (B, num_query + T, hidden); callers slice [:, :num_query]."""
    b = encoder_hidden_states.shape[0]
    dev = encoder_hidden_states.device
    emb = params["embeddings"]
    if query_embeds is None:
        query_embeds = params["query_tokens"].expand(
            b, cfg.num_query, cfg.hidden).to(cfg.dtype)
    q_len = query_embeds.shape[1]

    if input_ids is not None:
        t = input_ids.shape[1]
        tok = gather_rows(emb["word"], input_ids).to(cfg.dtype)
        pos = gather_rows(emb["position"], torch.arange(t, device=dev))[None].to(cfg.dtype)
        x = torch.cat([query_embeds, tok + pos], dim=1)
        if attention_mask is None:
            attention_mask = torch.ones((b, t), dtype=torch.int32, device=dev)
        self_mask = torch.cat(
            [torch.ones((b, q_len), dtype=attention_mask.dtype, device=dev),
             attention_mask], dim=1)
    else:
        x = query_embeds
        self_mask = torch.ones((b, q_len), dtype=torch.int32, device=dev)

    x = layer_norm(emb["norm"], x, cfg.ln_eps)

    for layer in params["layers"]:
        att = _mha(layer["attention"], x, x, cfg, kv_mask=self_mask)
        x = _post_norm_residual(att, x, layer["attention"]["out_norm"], cfg.ln_eps)

        q_part, t_part = x[:, :q_len], x[:, q_len:]
        if layer.get("crossattention") is not None:
            ca = _mha(layer["crossattention"], q_part, encoder_hidden_states, cfg,
                      kv_mask=encoder_mask)
            q_part = _post_norm_residual(
                ca, q_part, layer["crossattention"]["out_norm"], cfg.ln_eps)

        q_ffn = linear(layer["output_query"]["dense"],
                       gelu(linear(layer["intermediate_query"], q_part)))
        q_part = _post_norm_residual(q_ffn, q_part, layer["output_query"]["norm"], cfg.ln_eps)
        if t_part.shape[1] > 0:
            t_ffn = linear(layer["output"]["dense"],
                           gelu(linear(layer["intermediate"], t_part)))
            t_part = _post_norm_residual(t_ffn, t_part, layer["output"]["norm"], cfg.ln_eps)
            x = torch.cat([q_part, t_part], dim=1)
        else:
            x = q_part
    return x
