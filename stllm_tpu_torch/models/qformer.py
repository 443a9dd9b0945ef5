"""Q-Former: BERT encoder with query tokens and periodic cross-attention
(stllm_tpu/models/qformer.py).

Query tokens (32) precede the text embeddings and the embedding LayerNorm
covers both; layers with ``layer % cross_attention_freq == 0`` cross-attend
the ViT sequence from the query positions only; query and text positions have
separate FFNs; post-norm residuals, LN eps 1e-12, exact GELU. Attention is
``mha_reference`` in plain torch.

The UniLM decoder path of the reference's ``BertLMHeadModel``:
``unilm_attention_mask`` (queries attend queries, text attends every query
and the text before it), ``qformer_lm_logits`` (transform, GELU, LN, the
decoder tied to the word embeddings, fp32 logits), ``qformer_lm_forward``
(shifted CE with label smoothing 0.1) and greedy ``qformer_lm_generate``.
No path of ST-LLM decodes through the Q-Former; answers come from LLaMA.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

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
         kv_mask: Optional[torch.Tensor], mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    b, n, _ = x.shape
    m = kv.shape[1]
    q = linear(attn_params["q"], x).reshape(b, n, cfg.heads, cfg.head_dim)
    k = linear(attn_params["k"], kv).reshape(b, m, cfg.heads, cfg.head_dim)
    v = linear(attn_params["v"], kv).reshape(b, m, cfg.heads, cfg.head_dim)
    out = mha_reference(q, k, v, kv_mask=kv_mask, mask=mask)
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
    self_attn_mask: Optional[torch.Tensor] = None,  # (B, Q+T, Q+T) bool, True = attend
) -> torch.Tensor:
    """Returns (B, num_query + T, hidden); callers slice [:, :num_query].

    ``self_attn_mask`` replaces the bidirectional padding mask of the
    self-attention with a full (from, to) mask: the UniLM decoder path's
    ``unilm_attention_mask``."""
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
    self_mask3 = None
    if self_attn_mask is not None:
        self_mask3, self_mask = self_attn_mask.bool(), None

    for layer in params["layers"]:
        att = _mha(layer["attention"], x, x, cfg, kv_mask=self_mask, mask=self_mask3)
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


# ---------------------------------------------------------------------------
# UniLM decoder path
# ---------------------------------------------------------------------------

def unilm_attention_mask(attention_mask: torch.Tensor, query_len: int) -> torch.Tensor:
    """The seq2seq self-attention mask of the reference's
    ``get_extended_attention_mask(is_decoder=True, has_query=True)``: a
    causal triangle over the text positions, query rows banned from the
    text, every row attending all queries, and the padding mask on the
    to-axis. ``attention_mask``: (B, query_len + T), 1 = real. Returns
    (B, query_len + T, query_len + T) bool, True = attend."""
    b, total = attention_mask.shape
    t = total - query_len
    dev = attention_mask.device
    causal = torch.tril(torch.ones((t, t), dtype=torch.bool, device=dev))
    rows_q = torch.zeros((query_len, t), dtype=torch.bool, device=dev)
    right = torch.cat([rows_q, causal], dim=0)                               # (Q+T, T)
    left = torch.ones((total, query_len), dtype=torch.bool, device=dev)      # (Q+T, Q)
    full = torch.cat([left, right], dim=1)
    return full[None] & attention_mask.bool()[:, None, :]


def init_qformer_lm(gen: torch.Generator, cfg: QFormerConfig) -> Dict:
    """init_qformer with text input, plus the MLM head ``cls``: transform
    dense, its LayerNorm and a free fp32 bias; the decoder weight is the
    word embedding table."""
    params = init_qformer(gen, cfg, text_input=True)
    params["cls"] = {
        "transform": init_linear(gen, cfg.hidden, cfg.hidden, cfg.dtype),
        "transform_norm": init_layer_norm(cfg.hidden, cfg.dtype, gen.device),
        "bias": torch.zeros((cfg.vocab_size,), dtype=torch.float32, device=gen.device),
    }
    return params


def qformer_lm_logits(params: Dict, hidden: torch.Tensor, cfg: QFormerConfig) -> torch.Tensor:
    """MLM head over hidden states: transform -> GELU -> LN -> tied decoder.
    Returns fp32 logits (B, T, vocab), the product accumulated in fp32."""
    cls = params["cls"]
    h = gelu(linear(cls["transform"], hidden))
    h = layer_norm(cls["transform_norm"], h, cfg.ln_eps)
    w = params["embeddings"]["word"]                       # (vocab, d), tied
    logits = torch.matmul(h.to(w.dtype).float(), w.float().t())
    return logits + cls["bias"]


def qformer_lm_forward(
    params: Dict,
    *,
    input_ids: torch.Tensor,                      # (B, T)
    encoder_hidden_states: torch.Tensor,          # (B, S_img, encoder_width)
    attention_mask: Optional[torch.Tensor] = None,   # (B, T) 1 = real
    encoder_mask: Optional[torch.Tensor] = None,
    labels: Optional[torch.Tensor] = None,        # (B, T), -100 = ignore
    label_smoothing: float = 0.1,                 # the reference's
    cfg: QFormerConfig = INSTRUCT_BLIP_QFORMER,
):
    """BertLMHeadModel's forward: the UniLM-masked pass with the query
    prefix, logits over the TEXT positions, and with ``labels`` the
    next-token CE (logits shifted by one) with label smoothing, the mean
    over the positions whose label is not -100. Returns logits (B, T,
    vocab) or (loss, logits)."""
    b, t = input_ids.shape
    dev = input_ids.device
    if attention_mask is None:
        attention_mask = torch.ones((b, t), dtype=torch.int32, device=dev)
    full_mask = torch.cat([torch.ones((b, cfg.num_query), dtype=attention_mask.dtype,
                                      device=dev), attention_mask], dim=1)
    hidden = qformer_forward(
        params, encoder_hidden_states=encoder_hidden_states, input_ids=input_ids,
        attention_mask=attention_mask, encoder_mask=encoder_mask, cfg=cfg,
        self_attn_mask=unilm_attention_mask(full_mask, cfg.num_query))
    logits = qformer_lm_logits(params, hidden[:, cfg.num_query:], cfg)
    if labels is None:
        return logits
    lg = logits[:, :-1].float()
    lb = labels[:, 1:]
    valid = lb != -100
    logp = torch.log_softmax(lg, dim=-1)
    nll = -logp.gather(-1, torch.where(valid, lb, 0)[..., None].long())[..., 0]
    smooth = -logp.mean(dim=-1)
    per_tok = (1.0 - label_smoothing) * nll + label_smoothing * smooth
    loss = torch.where(valid, per_tok, 0.0).sum() / valid.sum().clamp(min=1)
    return loss, logits


@torch.no_grad()
def qformer_lm_generate(
    params: Dict,
    encoder_hidden_states: torch.Tensor,
    *,
    bos_token_id: int,
    eos_token_id: Optional[int] = None,
    max_new_tokens: int = 20,
    encoder_mask: Optional[torch.Tensor] = None,
    cfg: QFormerConfig = INSTRUCT_BLIP_QFORMER,
) -> List[List[int]]:
    """Greedy decode through the UniLM path, one full forward a step (the
    reference's generation through this head). A finished row is padded
    with ``eos_token_id`` (0 without one); decoding stops when every row
    has emitted eos. Returns each row's tokens after bos."""
    b = encoder_hidden_states.shape[0]
    dev = encoder_hidden_states.device
    ids = [[bos_token_id] for _ in range(b)]
    done = [False] * b
    for _ in range(max_new_tokens):
        input_ids = torch.tensor(ids, dtype=torch.int32, device=dev)
        logits = qformer_lm_forward(params, input_ids=input_ids,
                                    encoder_hidden_states=encoder_hidden_states,
                                    encoder_mask=encoder_mask, cfg=cfg)
        nxt = logits[:, -1].argmax(dim=-1).tolist()
        for i in range(b):
            tok = int(nxt[i]) if not done[i] else (eos_token_id or 0)
            ids[i].append(tok)
            if eos_token_id is not None and tok == eos_token_id:
                done[i] = True
        if eos_token_id is not None and all(done):
            break
    return [row[1:] for row in ids]
