"""LLaMA decoder, Vicuna-7B (stllm_tpu/models/llama.py).

LLaMA-1 / Vicuna-7B v1.1: RMSNorm (eps 1e-6), RoPE theta 10000, SwiGLU MLP
(intermediate 11008), 32 layers x 32 heads x 128 head_dim, vocab 32000,
untied lm_head; bf16 params, fp32 norm statistics and fp32 logits.

``llama_forward`` serves prefill-into-cache and decode: new k/v land at each
row's cache offset and attention is causal against absolute positions
(kv_pos <= cache_len + i), through ``mha_reference``. With ``cfg.kv_int8``
the cache holds per-(token, head) int8 k/v with fp32 scales, dequantized
whole before attention, as the reference does. Without a cache (training)
it runs causal ``flash_attention`` with the padding mask over positions
0..S-1, returns no cache, and with ``cfg.remat`` recomputes each layer in the
backward (``torch.utils.checkpoint``).

Quantized decoder trees: ``quantize_llama_params`` (W8A8, or weight-only
``a16``) and ``quantize_llama_params_int4`` (W4A16, optionally with q|k|v
and gate|up fused along N and an int8 ``w_q16`` lm_head).

``llama_decode_prefix`` is beam search's decode step: one token a row
against P shared prompt caches (row r reads prompt r // k) plus a small
per-row cache of the generated tokens, so a prompt's KV is stored once, not
once per beam.

The cache buffers are updated IN PLACE (the reference donates them to XLA for
the same effect); ``llama_forward`` and ``llama_decode_prefix`` return a
KVCache over the same buffers with the new lengths.

Tensor parallel (under ``ops.spmd.model_parallel``): a layer holds this
rank's heads of q, k, v (columns) and o (rows) and its columns of gate and
up and rows of down; each block's input enters through ``copy_to`` and its
output leaves through one ``reduce_from`` (a sum over the group), and the
cache holds this rank's heads. A vocab-parallel lm_head gathers its logits.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from stllm_tpu_torch.models.lora import apply_lora
from stllm_tpu_torch.ops.attention import NEG_INF, flash_attention, mha_reference
from stllm_tpu_torch.ops.layers import (
    gather_rows, init_linear, init_rms_norm, linear, matmul_f32, normal, rms_norm,
    swiglu_mlp)
from stllm_tpu_torch.ops.quant import quantize_linear_params, quantize_linear_params_int4
from stllm_tpu_torch.ops.rope import rope_rows, rope_table, rotate
from stllm_tpu_torch.ops.spmd import head_group, layer_group, layer_shards
from stllm_tpu_torch.parallel.collectives import copy_to, gather_from, reduce_from


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
    remat: bool = False               # recompute each layer in the backward (cache-less forward)
    use_flash: Optional[bool] = None  # the cache-less forward's flash_attention(use_pallas=)
    kv_int8: bool = False             # int8 KV cache (see KVCache)

    @property
    def head_dim(self) -> int:
        return self.hidden // self.heads


VICUNA_7B = LlamaConfig()


class KVCache(NamedTuple):
    """Static-shape KV cache, layer-major: k/v are length-``layers`` tuples
    of (B, max_len, heads, head_dim) tensors; ``length`` (B,) int32 is the
    number of valid positions per row.

    int8 mode (``cfg.kv_int8``): k/v hold per-(token, head) symmetric int8
    codes and ``k_scale``/``v_scale`` (tuples of (B, max_len, heads) fp32)
    their scales; None otherwise."""

    k: Tuple[torch.Tensor, ...]
    v: Tuple[torch.Tensor, ...]
    length: torch.Tensor
    k_scale: Optional[Tuple[torch.Tensor, ...]] = None
    v_scale: Optional[Tuple[torch.Tensor, ...]] = None


def init_kv_cache(cfg: LlamaConfig, batch: int, max_len: int, dtype=None,
                  device=None) -> KVCache:
    """A zero cache; under tensor parallelism, of this rank's heads."""
    shape = (batch, max_len, cfg.heads // layer_shards(), cfg.head_dim)
    n = cfg.num_layers
    if cfg.kv_int8:
        return KVCache(
            k=tuple(torch.zeros(shape, dtype=torch.int8, device=device) for _ in range(n)),
            v=tuple(torch.zeros(shape, dtype=torch.int8, device=device) for _ in range(n)),
            length=torch.zeros((batch,), dtype=torch.int32, device=device),
            k_scale=tuple(torch.ones(shape[:-1], device=device) for _ in range(n)),
            v_scale=tuple(torch.ones(shape[:-1], device=device) for _ in range(n)),
        )
    dtype = dtype or cfg.dtype
    return KVCache(
        k=tuple(torch.zeros(shape, dtype=dtype, device=device) for _ in range(cfg.num_layers)),
        v=tuple(torch.zeros(shape, dtype=dtype, device=device) for _ in range(cfg.num_layers)),
        length=torch.zeros((batch,), dtype=torch.int32, device=device),
    )


def _quant_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., D) -> per-(...)-row int8 codes and fp32 scales (...,):
    s = amax / 127 (1 where amax is 0), codes round(x / s), no clamp."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(amax == 0.0, torch.ones_like(amax), amax / 127.0)
    return torch.round(xf / scale).to(torch.int8), scale[..., 0]


def _dequant_kv(q: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    """codes * scale in fp32 (the int8 -> fp32 promotion is exact), then dtype."""
    return (q * scale[..., None]).to(dtype)


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


def _qkv_proj(layer: Dict, h: torch.Tensor, b: int, s: int, cfg: LlamaConfig):
    """q/k/v projections; a ``qkv`` key holds the three weights fused along
    N (one weight-streaming call instead of three). LoRA deltas
    (``models/lora.py``) apply to the split outputs either way. Under
    tensor parallelism the weights hold this rank's heads."""
    h = copy_to(h, layer_group())
    if "qkv" in layer:
        q, k, v = linear(layer["qkv"], h).chunk(3, dim=-1)
    else:
        q, k, v = linear(layer["q"], h), linear(layer["k"], h), linear(layer["v"], h)
    return tuple(apply_lora(layer, n, h, t).reshape(b, s, -1, cfg.head_dim)
                 for n, t in (("q", q), ("k", k), ("v", v)))


def _layer(
    layer: Dict,
    x: torch.Tensor,
    rope: Tuple[torch.Tensor, torch.Tensor],
    mask: Optional[torch.Tensor],
    cfg: LlamaConfig,
    cache_kv: Optional[Tuple[torch.Tensor, ...]],
    cache_len: Optional[torch.Tensor],
) -> torch.Tensor:
    """One decoder layer. ``rope``: the positions' cos and sin rows.

    Without a cache (``cache_kv`` None): causal ``flash_attention`` with
    ``mask`` the (B, S) validity of the keys, or None.

    On the cache path it updates the buffers ``cache_kv`` ((k, v), or
    (k, v, k_scale, v_scale) for the int8 cache) in place; ``mask``:
    (B, S, max_len), True where kv_pos <= cache_len + i."""
    b, s, _ = x.shape
    h = rms_norm(layer["input_norm"], x, cfg.rms_eps)
    q, k, v = _qkv_proj(layer, h, b, s, cfg)
    q = rotate(q, *rope)
    k = rotate(k, *rope)

    if cache_kv is None:
        out = flash_attention(q, k, v, causal=True, kv_mask=mask, use_pallas=cfg.use_flash)
    elif len(cache_kv) == 4:
        # int8 cache: quantize the new k/v, write codes and scales at each
        # row's offset, then attend over the whole cache dequantized
        ck, cv, cks, cvs = cache_kv
        (kq, ks), (vq, vs) = _quant_kv(k), _quant_kv(v)
        for c, new in ((ck, kq), (cv, vq), (cks, ks), (cvs, vs)):
            _write_at(c, new, cache_len)
        out = mha_reference(q, _dequant_kv(ck, cks, x.dtype), _dequant_kv(cv, cvs, x.dtype),
                            mask=mask)
    else:
        ak, av = cache_kv
        _write_at(ak, k, cache_len)
        _write_at(av, v, cache_len)
        out = mha_reference(q, ak, av, mask=mask)

    return _residual_blocks(layer, x, out.reshape(b, s, -1), cfg)


def _residual_blocks(layer: Dict, x: torch.Tensor, attn: torch.Tensor,
                     cfg: LlamaConfig) -> torch.Tensor:
    """x + o(attn), then x + mlp(post_norm(x)); under tensor parallelism
    each block's partial sums are summed over the group."""
    g = layer_group()
    x = x + reduce_from(linear(layer["o"], attn), g)
    h2 = rms_norm(layer["post_norm"], x, cfg.rms_eps)
    return x + reduce_from(swiglu_mlp(layer, copy_to(h2, g)), g)


def llama_forward(
    params: Dict,
    *,
    input_ids: Optional[torch.Tensor] = None,
    inputs_embeds: Optional[torch.Tensor] = None,
    attention_mask: Optional[torch.Tensor] = None,  # (B, S) validity of the inputs
    positions: Optional[torch.Tensor] = None,        # (B, S) absolute positions
    cache: Optional[KVCache] = None,
    cfg: LlamaConfig = VICUNA_7B,
) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """Returns (hidden_states (B, S, d), cache with the new lengths or None).

    Without a cache (training): causal attention over positions 0..S-1 with
    ``attention_mask`` as the key padding mask; differentiable; nothing is
    kept. Prefill: pass a fresh ``init_kv_cache``; the k/v land at 0..S.
    Decode: pass the running cache; positions default to cache.length."""
    if inputs_embeds is None:
        inputs_embeds = gather_rows(params["embed_tokens"], input_ids)
    x = inputs_embeds.to(cfg.dtype)
    b, s, _ = x.shape
    cos, sin = rope_table(cfg.head_dim, cfg.max_positions, cfg.rope_theta, device=x.device)
    if positions is None:
        start = 0 if cache is None else cache.length.long()[:, None]
        positions = (start + torch.arange(s, device=x.device)[None, :]).expand(b, s)
    # position-dependent tensors shared by every layer
    rope = rope_rows(cos, sin, positions)
    if cache is None:
        for layer in params["layers"]:
            if cfg.remat and torch.is_grad_enabled():
                x = checkpoint(_layer, layer, x, rope, attention_mask, cfg, None, None,
                               use_reentrant=False, preserve_rng_state=False)
            else:
                x = _layer(layer, x, rope, attention_mask, cfg, None, None)
        return rms_norm(params["norm"], x, cfg.rms_eps), None
    kv_pos = torch.arange(cache.k[0].shape[1], device=x.device)[None, None, :]
    q_abs = cache.length.long()[:, None, None] + torch.arange(s, device=x.device)[None, :, None]
    mask = kv_pos <= q_abs

    quantized = cache.k_scale is not None
    for i, layer in enumerate(params["layers"]):
        cache_kv = ((cache.k[i], cache.v[i], cache.k_scale[i], cache.v_scale[i]) if quantized
                    else (cache.k[i], cache.v[i]))
        x = _layer(layer, x, rope, mask, cfg, cache_kv, cache.length)

    x = rms_norm(params["norm"], x, cfg.rms_eps)
    valid = (attention_mask.sum(dim=-1).to(torch.int32) if attention_mask is not None
             else torch.full((b,), s, dtype=torch.int32, device=x.device))
    return x, cache._replace(length=cache.length + valid)


def llama_decode_prefix(params: Dict, inputs_embeds: torch.Tensor, prefix: KVCache,
                        gen: KVCache, cfg: LlamaConfig) -> Tuple[torch.Tensor, KVCache]:
    """Single-token decode against shared prompt caches plus per-row
    generated caches. ``inputs_embeds`` (B, 1, d) with B = P * k rows;
    ``prefix`` holds P prompts (P, S, H, D per layer; ``length`` the valid
    count of each), ``gen`` the B rows' generated tokens (B, G, H, D).
    Row r attends prefix row r // k and its own generated cache; the two
    score segments are joined before one softmax, so the result is the
    attention over a replicated cache. The new k/v are written into ``gen``
    in place (int8 codes and scales when the caches are int8).

    Rounding follows the reference: the scores form in the model dtype, are
    scaled, then cast to fp32; masked lanes take -1e30; the softmax weights
    are cast back to the model dtype for the two value products, which are
    summed in the model dtype. The beams of a prompt enter its prefix
    products as k query rows of one matrix product, so the prefix is never
    copied per beam. Returns (hidden (B, 1, d), gen with length + 1)."""
    x = inputs_embeds.to(cfg.dtype)
    b, s, _ = x.shape
    if s != 1:
        raise ValueError(f"llama_decode_prefix decodes one token a row, got {s}")
    p = prefix.k[0].shape[0]
    if b % p:
        raise ValueError(f"{b} rows do not split into {p} prompts")
    kr, h, hd = b // p, cfg.heads // layer_shards(), cfg.head_dim
    dev = x.device
    positions = (prefix.length.long().repeat_interleave(kr) + gen.length.long())[:, None]
    cos, sin = rope_table(hd, cfg.max_positions, cfg.rope_theta, device=dev)
    rope = rope_rows(cos, sin, positions)
    s_p, g_max = prefix.k[0].shape[1], gen.k[0].shape[1]
    mask_p = (torch.arange(s_p, device=dev)[None, :]
              < prefix.length[:, None])[:, None, None, :]              # (P, 1, 1, S)
    mask_g = (torch.arange(g_max, device=dev)[None, :]
              <= gen.length[:, None])[:, None, None, :]                # (B, 1, 1, G)
    scale = hd ** -0.5
    quantized = prefix.k_scale is not None
    for i, layer in enumerate(params["layers"]):
        hn = rms_norm(layer["input_norm"], x, cfg.rms_eps)
        q, k, v = _qkv_proj(layer, hn, b, s, cfg)
        q = rotate(q, *rope)
        k = rotate(k, *rope)
        if quantized:
            (k, ks), (v, vs) = _quant_kv(k), _quant_kv(v)
            _write_at(gen.k_scale[i], ks, gen.length)
            _write_at(gen.v_scale[i], vs, gen.length)
        _write_at(gen.k[i], k, gen.length)
        _write_at(gen.v[i], v, gen.length)
        if quantized:
            pk, pv = (_dequant_kv(prefix.k[i], prefix.k_scale[i], x.dtype),
                      _dequant_kv(prefix.v[i], prefix.v_scale[i], x.dtype))
            gk, gv = (_dequant_kv(gen.k[i], gen.k_scale[i], x.dtype),
                      _dequant_kv(gen.v[i], gen.v_scale[i], x.dtype))
        else:
            pk, pv, gk, gv = prefix.k[i], prefix.v[i], gen.k[i], gen.v[i]
        pk, pv, gk, gv = (t.transpose(1, 2) for t in (pk, pv, gk, gv))   # (., H, len, D)
        qt = q.transpose(1, 2)                                            # (B, H, 1, D)
        # a prompt's k beams as the query rows of one product: (P, H, k, D)
        qp = qt.reshape(p, kr, h, hd).transpose(1, 2)
        s_pfx = (torch.matmul(qp, pk.transpose(-1, -2)) * scale).float()  # (P, H, k, S)
        s_gen = (torch.matmul(qt, gk.transpose(-1, -2)) * scale).float()  # (B, H, 1, G)
        s_pfx = torch.where(mask_p, s_pfx, NEG_INF)
        s_gen = torch.where(mask_g, s_gen, NEG_INF)
        s_pfx = s_pfx.transpose(1, 2).reshape(b, h, 1, s_p)
        w = torch.softmax(torch.cat([s_pfx, s_gen], dim=-1), dim=-1).to(x.dtype)
        w_p = w[..., :s_p].reshape(p, kr, h, s_p).transpose(1, 2)        # (P, H, k, S)
        out = (torch.matmul(w_p, pv).transpose(1, 2).reshape(b, h, 1, hd)
               + torch.matmul(w[..., s_p:], gv))                          # (B, H, 1, D)
        x = _residual_blocks(layer, x, out.transpose(1, 2).reshape(b, s, -1), cfg)
    x = rms_norm(params["norm"], x, cfg.rms_eps)
    return x, gen._replace(length=gen.length + 1)


def quantize_llama_params(params: Dict, free_dense: bool = False,
                          a16: bool = False) -> Dict:
    """Inference-time W8A8 conversion of every decoder-layer matmul (q, k, v,
    o, gate, up, down). Embeddings, lm_head and norms stay dense.
    ``free_dense=True`` drops each dense weight as soon as it is quantized,
    layer by layer, so peak memory stays near the dense tree plus one
    layer; the input tree is unusable afterwards. ``a16=True`` stores each
    as the weight-only form (the ``w_q16`` key, ops/quant.py:w8a16_matmul):
    int8 weight bytes, bf16 activations. LoRA adapters (``*_lora``) stay
    dense."""
    def convert(p: Dict) -> Dict:
        q = quantize_linear_params(p, free_dense)
        if a16:
            q["w_q16"] = q.pop("w_q")
        return q

    out = dict(params)
    out["layers"] = [
        {**layer, **{n: convert(layer[n]) for n in ("q", "k", "v", "o", "gate", "up", "down")}}
        for layer in params["layers"]]
    return out


def quantize_llama_params_int4(params: Dict, group: Optional[int] = 128,
                               free_dense: bool = False, quant_head: bool = False,
                               fuse: bool = False) -> Dict:
    """W4A16 conversion of the decoder-layer matmuls (ops/quant.py int4
    storage): ``group`` sets per-group scales along K (default 128),
    ``group=None`` per-output-channel scales (the form the W4A16 kernel
    runs). Embeddings and norms stay dense; ``quant_head=True`` stores the
    lm_head as weight-only int8 (``w_q16``). ``fuse=True`` packs q|k|v and
    gate|up each as one weight along N (the ``qkv``/``gateup`` keys): four
    weight-streaming calls a layer instead of seven; with per-channel scales
    the fused math equals the unfused. Layers carrying LoRA adapters stay
    unfused. ``free_dense=True`` drops each dense weight as it goes."""
    out = dict(params)
    out["layers"] = []
    for layer in params["layers"]:
        l = dict(layer)
        plain = ("q", "k", "v", "o", "gate", "up", "down")
        if fuse and not any(k.endswith("_lora") for k in layer):
            for names, fused in ((("q", "k", "v"), "qkv"), (("gate", "up"), "gateup")):
                if any(layer[n].get("b") is not None for n in names):
                    raise ValueError(f"fusing {names}: the projections carry biases")
                w = torch.cat([layer[n]["w"] for n in names], dim=1)
                for n in names:
                    if free_dense:
                        del layer[n]["w"]
                    del l[n]
                l[fused] = quantize_linear_params_int4({"w": w}, group=group, free_dense=True)
                del w
            plain = ("o", "down")
        for name in plain:
            l[name] = quantize_linear_params_int4(layer[name], group=group,
                                                  free_dense=free_dense)
        out["layers"].append(l)
    if quant_head:
        h = quantize_linear_params(params["lm_head"], free_dense=free_dense)
        out["lm_head"] = {"w_q16": h.pop("w_q"), "w_scale": h["w_scale"]}
    return out


def lm_head(params: Dict, hidden: torch.Tensor) -> torch.Tensor:
    """Logits in fp32: the matmul runs in the param dtype with fp32
    accumulation and an fp32 result. The weight-only int8 head (``w_q16``)
    takes bf16 hidden states times the codes upcast to bf16, fp32
    accumulation, times the fp32 scale. A vocab-parallel head computes
    this rank's columns and gathers the rest."""
    head = params["lm_head"]
    if "w_q16" in head:
        y = matmul_f32(hidden.to(torch.bfloat16), head["w_q16"].to(torch.bfloat16))
        return y * head["w_scale"].float()
    w, g = head["w"], head_group()
    return gather_from(matmul_f32(copy_to(hidden, g).to(w.dtype), w), g, -1)


@torch.no_grad()
def prefill_with_cache(params: Dict, inputs_embeds: torch.Tensor, attention_mask: torch.Tensor,
                       max_len: int, cfg: LlamaConfig) -> Tuple[torch.Tensor, KVCache]:
    """Prefill a fresh cache of ``max_len`` and return (hidden, cache).
    Prompts are right-padded; cache.length is each row's valid count, so
    decode writes land right after each row's real prompt."""
    cache = init_kv_cache(cfg, inputs_embeds.shape[0], max_len, device=inputs_embeds.device)
    return llama_forward(params, inputs_embeds=inputs_embeds, attention_mask=attention_mask,
                         cache=cache, cfg=cfg)
