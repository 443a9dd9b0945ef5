"""LLaMA decoder, Vicuna-7B (stllm_tpu/models/llama.py), KV-cache path.

LLaMA-1 / Vicuna-7B v1.1: RMSNorm (eps 1e-6), RoPE theta 10000, SwiGLU MLP
(intermediate 11008), 32 layers x 32 heads x 128 head_dim, vocab 32000,
untied lm_head; bf16 params, fp32 norm statistics and fp32 logits.

``llama_forward`` serves prefill-into-cache and decode: new k/v land at each
row's cache offset and attention is causal against absolute positions
(kv_pos <= cache_len + i), through ``mha_reference``. The cache-less forward
(training, the reference's flash kernels) and the int8 KV cache come later.

The cache buffers are updated IN PLACE (the reference donates them to XLA for
the same effect); ``llama_forward`` returns a KVCache over the same buffers
with the new lengths.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from stllm_tpu_torch.ops.attention import mha_reference
from stllm_tpu_torch.ops.layers import (
    gather_rows, init_linear, init_rms_norm, linear, matmul_f32, normal, rms_norm,
    swiglu_mlp)
from stllm_tpu_torch.ops.quant import W4A16_SLICE, quantize_linear_params
from stllm_tpu_torch.ops.rope import rope_rows, rope_table, rotate


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden: int = 4096
    num_layers: int = 32
    heads: int = 32
    intermediate: int = 11008
    max_positions: int = 2048
    rms_eps: float = 1e-6
    rope_theta: float = 10000.0
    dtype: Any = torch.bfloat16
    remat: bool = False               # a training option; inference ignores it
    use_flash: Optional[bool] = None  # the cache-less forward's kernel choice
    kv_int8: bool = False             # not ported yet

    @property
    def head_dim(self) -> int:
        return self.hidden // self.heads


VICUNA_7B = LlamaConfig()


class KVCache(NamedTuple):
    """Static-shape KV cache, layer-major: k/v are length-``layers`` tuples
    of (B, max_len, heads, head_dim) tensors; ``length`` (B,) int32 is the
    number of valid positions per row."""

    k: Tuple[torch.Tensor, ...]
    v: Tuple[torch.Tensor, ...]
    length: torch.Tensor


def init_kv_cache(cfg: LlamaConfig, batch: int, max_len: int, dtype=None,
                  device=None) -> KVCache:
    if cfg.kv_int8:
        raise NotImplementedError("the int8 KV cache is not ported yet")
    shape = (batch, max_len, cfg.heads, cfg.head_dim)
    dtype = dtype or cfg.dtype
    return KVCache(
        k=tuple(torch.zeros(shape, dtype=dtype, device=device) for _ in range(cfg.num_layers)),
        v=tuple(torch.zeros(shape, dtype=dtype, device=device) for _ in range(cfg.num_layers)),
        length=torch.zeros((batch,), dtype=torch.int32, device=device),
    )


def init_llama(gen: torch.Generator, cfg: LlamaConfig) -> Dict:
    d, m = cfg.hidden, cfg.intermediate
    dev = gen.device
    params: Dict = {
        "embed_tokens": normal(gen, (cfg.vocab_size, d), 0.02, cfg.dtype),
        "norm": init_rms_norm(d, cfg.dtype, dev),
        "lm_head": init_linear(gen, d, cfg.vocab_size, cfg.dtype, bias=False),
        "layers": [],
    }
    for _ in range(cfg.num_layers):
        params["layers"].append(
            {
                "input_norm": init_rms_norm(d, cfg.dtype, dev),
                "q": init_linear(gen, d, d, cfg.dtype, bias=False),
                "k": init_linear(gen, d, d, cfg.dtype, bias=False),
                "v": init_linear(gen, d, d, cfg.dtype, bias=False),
                "o": init_linear(gen, d, d, cfg.dtype, bias=False),
                "post_norm": init_rms_norm(d, cfg.dtype, dev),
                "gate": init_linear(gen, d, m, cfg.dtype, bias=False),
                "up": init_linear(gen, d, m, cfg.dtype, bias=False),
                "down": init_linear(gen, m, d, cfg.dtype, bias=False),
            }
        )
    return params


def _write_at(c: torch.Tensor, new: torch.Tensor, off: torch.Tensor) -> None:
    """Write new (B, s, ...) into c (B, max_len, ...) at each row's offset,
    in place. The start is clamped so the window fits, as JAX's
    dynamic_update_slice clamps it: idle batcher rows run past max_len."""
    b, s = new.shape[:2]
    start = off.long().clamp(0, c.shape[1] - s)
    rows = torch.arange(b, device=c.device)[:, None]
    cols = start[:, None] + torch.arange(s, device=c.device)[None, :]
    c[rows, cols] = new.to(c.dtype)


def _layer(
    layer: Dict,
    x: torch.Tensor,
    rope: Tuple[torch.Tensor, torch.Tensor],
    mask: torch.Tensor,
    cfg: LlamaConfig,
    cache_kv: Tuple[torch.Tensor, torch.Tensor],
    cache_len: torch.Tensor,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """One decoder layer on the cache path. ``rope``: the positions' cos and
    sin rows; ``mask``: (B, S, max_len), True where kv_pos <= cache_len + i."""
    b, s, d = x.shape
    h = rms_norm(layer["input_norm"], x, cfg.rms_eps)
    q = linear(layer["q"], h).reshape(b, s, cfg.heads, cfg.head_dim)
    k = linear(layer["k"], h).reshape(b, s, cfg.heads, cfg.head_dim)
    v = linear(layer["v"], h).reshape(b, s, cfg.heads, cfg.head_dim)
    q = rotate(q, *rope)
    k = rotate(k, *rope)

    ck, cv = cache_kv
    _write_at(ck, k, cache_len)
    _write_at(cv, v, cache_len)
    out = mha_reference(q, ck, cv, mask=mask)

    x = x + linear(layer["o"], out.reshape(b, s, d))
    h2 = rms_norm(layer["post_norm"], x, cfg.rms_eps)
    return x + swiglu_mlp(layer, h2), (ck, cv)


def llama_forward(
    params: Dict,
    *,
    input_ids: Optional[torch.Tensor] = None,
    inputs_embeds: Optional[torch.Tensor] = None,
    attention_mask: Optional[torch.Tensor] = None,  # (B, S) validity of the inputs
    positions: Optional[torch.Tensor] = None,        # (B, S) absolute positions
    cache: Optional[KVCache] = None,
    cfg: LlamaConfig = VICUNA_7B,
) -> Tuple[torch.Tensor, KVCache]:
    """Returns (hidden_states (B, S, d), cache with the new lengths).

    Prefill: pass a fresh ``init_kv_cache``; the k/v land at 0..S. Decode:
    pass the running cache; positions default to cache.length."""
    if cache is None:
        raise NotImplementedError("the cache-less forward (training) is not ported yet")
    if inputs_embeds is None:
        inputs_embeds = gather_rows(params["embed_tokens"], input_ids)
    x = inputs_embeds.to(cfg.dtype)
    b, s, _ = x.shape
    cos, sin = rope_table(cfg.head_dim, cfg.max_positions, cfg.rope_theta, device=x.device)
    if positions is None:
        positions = cache.length.long()[:, None] + torch.arange(s, device=x.device)[None, :]
    # position-dependent tensors shared by every layer
    rope = rope_rows(cos, sin, positions)
    kv_pos = torch.arange(cache.k[0].shape[1], device=x.device)[None, None, :]
    q_abs = cache.length.long()[:, None, None] + torch.arange(s, device=x.device)[None, :, None]
    mask = kv_pos <= q_abs

    new_k, new_v = [], []
    for i, layer in enumerate(params["layers"]):
        x, (ck, cv) = _layer(layer, x, rope, mask, cfg, (cache.k[i], cache.v[i]),
                             cache.length)
        new_k.append(ck)
        new_v.append(cv)

    x = rms_norm(params["norm"], x, cfg.rms_eps)
    valid = (attention_mask.sum(dim=-1).to(torch.int32) if attention_mask is not None
             else torch.full((b,), s, dtype=torch.int32, device=x.device))
    return x, KVCache(k=tuple(new_k), v=tuple(new_v), length=cache.length + valid)


def quantize_llama_params(params: Dict, free_dense: bool = False,
                          a16: bool = False) -> Dict:
    """Inference-time W8A8 conversion of every decoder-layer matmul (q, k, v,
    o, gate, up, down). Embeddings, lm_head and norms stay dense.
    ``free_dense=True`` drops each dense weight as soon as it is quantized,
    layer by layer, so peak memory stays near the dense tree plus one
    layer; the input tree is unusable afterwards. The weight-only ``a16``
    form comes with the W4A16 slice."""
    if a16:
        raise NotImplementedError(W4A16_SLICE)
    out = dict(params)
    out["layers"] = [
        {**layer, **{n: quantize_linear_params(layer[n], free_dense)
                     for n in ("q", "k", "v", "o", "gate", "up", "down")}}
        for layer in params["layers"]]
    return out


def lm_head(params: Dict, hidden: torch.Tensor) -> torch.Tensor:
    """Logits in fp32: the matmul runs in the param dtype with fp32
    accumulation and an fp32 result."""
    w = params["lm_head"]["w"]
    return matmul_f32(hidden.to(w.dtype), w)
