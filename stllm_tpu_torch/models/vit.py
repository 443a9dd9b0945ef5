"""EVA-ViT-g visual encoder (stllm_tpu/models/vit.py): bf16 and int8 blocks.

Patch 14, width 1408, depth 39, 16 heads (head_dim 88), MLP hidden 6144, abs
pos embed, pre-norm blocks with q/v-only qkv bias (k bias fixed at zero), LN
eps 1e-6, all 257 tokens out. Images are NHWC; the patch embedding is a
reshape plus matmul. The attention of every block is a packed-qkv CUDA
kernel (``use_flash=None``), or ``flash_attention`` on the split heads
(``use_flash`` True or False). With ``remat`` each trunk block is recomputed
in the backward.

``vit_block`` runs one of three block forms, chosen by the params:
  - dense (bf16);
  - dynamic W8A8 (``quantize_vit_params``): LayerNorm and GELU emit int8
    with per-row scales (kernels #9, #10), attention quantizes its output
    in its epilogue (#2);
  - static int8 (``calibrate_vit_scales`` adds ``act_scales``): calibrated
    per-tensor scales, and attention on static-int8 qkv (#3).
Two settings of the reference choose among static forms, read from the
environment at import and kept as module attributes of the same names:
  - ``FUSED_LN`` (``STLLM_FUSED_LN``: "0" off, the default; "1" = "both",
    "proj", "fc2"): ``vit_forward`` runs the trunk as one pipeline whose
    LayerNorms ride in the epilogue of the int8 matmul before them (#11:
    proj -> norm2, fc2 -> the next block's norm1);
  - ``INT8_QKT`` (``STLLM_INT8_QKT``: "1", the default, static-int8 qkv into
    #3; "bf16", the same with the reference's bf16 q.k^T, which here is the
    same kernel; "0", the bf16 qkv into #2).

Token merging (ops/tome.py): ``merge_schedule`` merges tokens before the
given blocks, ``temporal_schedule`` folds adjacent frame rows and merges
across them; the trunk then runs at the merged lengths through the same
attention dispatch. A fold's output is unmerged back to per-frame rows at
the trunk's end, and a ``merge_schedule`` entry at block == depth re-merges
for the Q-Former. A merge or fold schedule turns the fused-LN trunk off, as
in the reference.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from stllm_tpu_torch.ops.attention import (
    flash_attention, fused_qkv_attention, fused_qkv_attention_quant,
    fused_qkv_attention_quant_static)
from stllm_tpu_torch.ops.layers import (
    gelu, init_layer_norm, init_linear, layer_norm, linear, trunc_normal)
from stllm_tpu_torch.ops.quant import (
    gelu_quant, layer_norm_quant, layer_norm_quant_static, quant_fc1_gelu_static,
    quant_matmul_pre, quant_matmul_res_ln_static, quant_mlp_static, quantize_activations,
    quantize_linear_params, quantize_static)
from stllm_tpu_torch.ops.tome import (
    bipartite_merge, fold_frames, init_merge_state, merge_to, unmerge)

# epilogue-carried LayerNorm in the static-int8 trunk (_vit_blocks_fused_static):
# "1" fuses both sites, "proj" or "fc2" one of them; off by default, as in the
# reference
FUSED_LN = os.environ.get("STLLM_FUSED_LN", "0")
FUSED_LN = {"0": False, "1": "both"}.get(FUSED_LN, FUSED_LN)

# static-int8 qkv into the attention: "1" s8 q.k^T, "bf16" the reference's
# upcast q.k^T (the same numbers, so the same kernel here), "0" off (bf16 qkv
# into the dynamic-epilogue kernel)
INT8_QKT = os.environ.get("STLLM_INT8_QKT", "1")

# CLIP normalization constants (the reference's data/processors.py)
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 14
    width: int = 1408
    depth: int = 39
    heads: int = 16
    mlp_hidden: int = 6144  # int(1408 * 4.3637)
    ln_eps: float = 1e-6
    dtype: Any = torch.bfloat16
    remat: bool = False            # recompute each trunk block in the backward
    # attention backend: None = the packed-qkv kernel; otherwise split q/k/v
    # through flash_attention(use_pallas=use_flash): True the flash kernels,
    # False plain mha_reference
    use_flash: Optional[bool] = None
    gelu_approx: bool = False
    # ((block, tokens_after), ...): merge before each block; block == depth
    # is the post-trunk re-merge (ops/tome.py)
    merge_schedule: tuple = ()
    # ((block, fold_group, tokens_after), ...): cross-frame folds
    temporal_schedule: tuple = ()
    # "" or "auto" (resolved per video by stllm.resolve_auto_merge); a named
    # level expands into the two schedules when the config is built (zoo)
    merge_level: str = ""

    @property
    def head_dim(self) -> int:
        return self.width // self.heads

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def seq_len(self) -> int:
        return self.num_patches + 1


EVA_VIT_G = ViTConfig()


def init_vit(gen: torch.Generator, cfg: ViTConfig) -> Dict:
    d, h = cfg.width, cfg.mlp_hidden
    dev = gen.device
    patch_dim = cfg.patch_size * cfg.patch_size * 3
    params: Dict = {
        "patch_embed": init_linear(gen, patch_dim, d, cfg.dtype),
        "cls_token": torch.zeros((1, 1, d), dtype=cfg.dtype, device=dev),
        "pos_embed": trunc_normal(gen, (1, cfg.seq_len, d), 0.02, cfg.dtype),
        "blocks": [],
    }
    for _ in range(cfg.depth):
        params["blocks"].append(
            {
                "norm1": init_layer_norm(d, cfg.dtype, dev),
                "qkv": init_linear(gen, d, 3 * d, cfg.dtype, bias=False),
                "q_bias": torch.zeros((d,), dtype=cfg.dtype, device=dev),
                "v_bias": torch.zeros((d,), dtype=cfg.dtype, device=dev),
                "proj": init_linear(gen, d, d, cfg.dtype),
                "norm2": init_layer_norm(d, cfg.dtype, dev),
                "fc1": init_linear(gen, d, h, cfg.dtype),
                "fc2": init_linear(gen, h, d, cfg.dtype),
            }
        )
    return params


def normalize_uint8(images: torch.Tensor, dtype) -> torch.Tensor:
    """uint8 pixels -> CLIP-normalized ``dtype``, on the images' device."""
    mean = torch.tensor(CLIP_MEAN, dtype=torch.float32, device=images.device) * 255.0
    std = torch.tensor(CLIP_STD, dtype=torch.float32, device=images.device) * 255.0
    return ((images.float() - mean) / std).to(dtype)


def quantize_vit_params(params: Dict, free_dense: bool = False) -> Dict:
    """Inference-time W8A8 conversion: every block matmul (qkv, proj, fc1,
    fc2) and, with a BTAdapter, every branch matmul (temporal qkv, proj,
    temporal_fc; spatial qkv, proj, fc1, fc2) becomes int8. Patch embed,
    norms and embeddings stay dense. ``free_dense`` drops each dense weight
    as soon as it is quantized (see ``quantize_linear_params``)."""
    out = dict(params)
    if "btadapter" in params:
        bt = dict(params["btadapter"])
        bt["temp"] = [
            {**t, **{n: quantize_linear_params(t[n], free_dense)
                     for n in ("qkv", "proj", "temporal_fc")}}
            for t in bt["temp"]]
        bt["spatial"] = [
            {**sp, **{n: quantize_linear_params(sp[n], free_dense)
                      for n in ("qkv", "proj", "fc1", "fc2")}}
            for sp in bt["spatial"]]
        out["btadapter"] = bt
    out["blocks"] = [
        {**blk, **{n: quantize_linear_params(blk[n], free_dense)
                   for n in ("qkv", "proj", "fc1", "fc2")}}
        for blk in params["blocks"]]
    return out


def _qkv_with_bias(block: Dict) -> Dict:
    """The qkv linear with its q|0|v bias (k bias fixed at zero)."""
    qkv_bias = torch.cat(
        [block["q_bias"], torch.zeros_like(block["q_bias"]), block["v_bias"]])
    return {**block["qkv"], "b": qkv_bias}


def _act_scale(margin: float, amax: torch.Tensor) -> torch.Tensor:
    """A calibrated scale from a recorded amax, in the reference's order."""
    return torch.tensor(margin, dtype=torch.float32, device=amax.device) * amax.float() / 127.0


def _block_stats(block: Dict, x: torch.Tensor, cfg: "ViTConfig"):
    """One dynamic-int8 block forward that also records the per-tensor amax
    of each quantized matmul input (from the per-row scales) and the
    per-third (q, k, v) amax of the qkv output."""
    hq, hs = layer_norm_quant(block["norm1"], x, cfg.ln_eps)
    qkv = quant_matmul_pre(hq, hs, _qkv_with_bias(block), x.dtype)
    oq, os_ = fused_qkv_attention_quant(qkv, cfg.heads, cfg.head_dim)
    x = x + quant_matmul_pre(oq, os_, block["proj"], x.dtype)
    hq2, hs2 = layer_norm_quant(block["norm2"], x, cfg.ln_eps)
    h = quant_matmul_pre(hq2, hs2, block["fc1"], x.dtype)
    gq, gs = gelu_quant(h, approx=cfg.gelu_approx)
    h = quant_matmul_pre(gq, gs, block["fc2"], x.dtype)
    b, n, _ = qkv.shape
    attn_amax = qkv.float().abs().reshape(b, n, 3, -1).amax(dim=(0, 1, 3))
    return x + h, {"qkv": 127.0 * hs.max(), "fc1": 127.0 * hs2.max(),
                   "fc2": 127.0 * gs.max(), "attn": attn_amax}


@torch.no_grad()
def calibrate_vit_scales(params_q: Dict, images: torch.Tensor, cfg: "ViTConfig",
                         margin: float = 1.0) -> Dict:
    """Static-W8A8 calibration: run the dynamic-int8 forward on a
    calibration batch, record the per-tensor amax of each quantized matmul
    input (qkv, fc1, fc2) and the per-third amax of the qkv output (attn),
    and return a copy of ``params_q`` whose blocks carry ``act_scales`` =
    margin * amax / 127 (fp32 device tensors: 0-d, and (3,) for attn).
    Those switch ``vit_block`` to the static path. uint8 images are
    CLIP-normalized first, as encode does."""
    if images.dtype == torch.uint8:
        images = normalize_uint8(images, cfg.dtype)
    x = embed_patches(params_q, images, cfg)
    out = dict(params_q)
    out["blocks"] = []
    for block in params_q["blocks"]:
        x, st = _block_stats(block, x, cfg)
        out["blocks"].append({**block, "act_scales": {
            k: _act_scale(margin, st[k]) for k in ("qkv", "fc1", "fc2", "attn")}})
    return out


def patchify(images: torch.Tensor, patch: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, h*w, patch*patch*C), row-major patches, features
    in (ph, pw, C) order."""
    b, hh, ww, c = images.shape
    nh, nw = hh // patch, ww // patch
    x = images.reshape(b, nh, patch, nw, patch, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, nh * nw, patch * patch * c)


def _split_heads(qkv: torch.Tensor, cfg: ViTConfig):
    b, n, _ = qkv.shape
    return (t.reshape(b, n, cfg.heads, cfg.head_dim) for t in qkv.chunk(3, dim=-1))


def _split_attention(qkv: torch.Tensor, cfg: ViTConfig) -> torch.Tensor:
    """Non-causal flash_attention on the heads of a packed qkv (read in
    place, no split copies): (B, N, 3 * width) -> (B, N, width)."""
    b, n, _ = qkv.shape
    out = flash_attention(*_split_heads(qkv, cfg), use_pallas=cfg.use_flash)
    return out.reshape(b, n, cfg.width)


def _attention(block: Dict, x: torch.Tensor, cfg: ViTConfig) -> torch.Tensor:
    qkv = linear(_qkv_with_bias(block), x)
    if cfg.use_flash is None:
        out = fused_qkv_attention(qkv, cfg.heads, cfg.head_dim)
        return linear(block["proj"], out)
    return linear(block["proj"], _split_attention(qkv, cfg))


def _vit_block_quant(block: Dict, x: torch.Tensor, cfg: ViTConfig) -> torch.Tensor:
    """Dynamic W8A8 block: LayerNorm and GELU emit int8 with per-row scales
    (kernels #9, #10), the packed attention quantizes its output rows in its
    epilogue (#2), and every matmul runs s8 x s8 -> s32."""
    hq, hs = layer_norm_quant(block["norm1"], x, cfg.ln_eps)
    qkv = quant_matmul_pre(hq, hs, _qkv_with_bias(block), x.dtype)
    if cfg.use_flash is None:
        oq, os_ = fused_qkv_attention_quant(qkv, cfg.heads, cfg.head_dim)
    else:
        oq, os_ = quantize_activations(_split_attention(qkv, cfg))
    x = x + quant_matmul_pre(oq, os_, block["proj"], x.dtype)
    hq, hs = layer_norm_quant(block["norm2"], x, cfg.ln_eps)
    h = quant_matmul_pre(hq, hs, block["fc1"], x.dtype)
    gq, gs = gelu_quant(h, approx=cfg.gelu_approx)
    return x + quant_matmul_pre(gq, gs, block["fc2"], x.dtype)


def _attn_quant_static(block: Dict, qkv: torch.Tensor, cfg: ViTConfig):
    """Attention of the static-int8 block: with calibrated per-third qkv
    scales (act_scales["attn"]) and INT8_QKT on, the qkv is quantized to
    static int8 and runs the s8 packed kernel (#3). Where that kernel
    declines the shape, INT8_QKT is "0", or the layer has no attn scales,
    the bf16 qkv takes the dynamic-epilogue kernel (#2), as in the
    reference. Returns (oq int8, os fp32)."""
    b, n, f = qkv.shape
    sc = block["act_scales"]
    if INT8_QKT != "0" and "attn" in sc and cfg.use_flash is None:
        # per-third scales broadcast over each third of the packed row
        qkv_q = quantize_static(qkv.reshape(b, n, 3, f // 3),
                                sc["attn"].float()[:, None]).reshape(b, n, f)
        res = fused_qkv_attention_quant_static(qkv_q, sc["attn"], cfg.heads, cfg.head_dim,
                                               int8_dot=INT8_QKT != "bf16")
        if res is not None:
            return res
    if cfg.use_flash is None:
        return fused_qkv_attention_quant(qkv, cfg.heads, cfg.head_dim)
    return quantize_activations(_split_attention(qkv, cfg))


def _vit_block_quant_static(block: Dict, x: torch.Tensor, cfg: ViTConfig) -> torch.Tensor:
    """int8 block with calibrated per-tensor activation scales
    (block["act_scales"], see calibrate_vit_scales): LayerNorm, GELU and the
    qkv output quantize elementwise; the attention output keeps its per-row
    epilogue."""
    sc = block["act_scales"]
    hq = layer_norm_quant_static(block["norm1"], x, sc["qkv"], cfg.ln_eps)
    qkv = quant_matmul_pre(hq, sc["qkv"], _qkv_with_bias(block), x.dtype)
    oq, os_ = _attn_quant_static(block, qkv, cfg)
    x = x + quant_matmul_pre(oq, os_, block["proj"], x.dtype)
    hq = layer_norm_quant_static(block["norm2"], x, sc["fc1"], cfg.ln_eps)
    return x + quant_mlp_static(hq, sc["fc1"], block["fc1"], sc["fc2"], block["fc2"],
                                x.dtype, approx=cfg.gelu_approx)


def _vit_blocks_fused_static(blocks, x: torch.Tensor, cfg: ViTConfig
                             ) -> Optional[torch.Tensor]:
    """The static-int8 trunk with epilogue-carried LayerNorm: each LayerNorm
    runs in the k-exit of the int8 matmul that produces its input (proj ->
    norm2 and fc2 -> the next block's norm1 at the sites FUSED_LN names), so
    the loop carries (x, hq), hq being the normalized int8 input of the next
    qkv matmul. The last block's fc2 has no LayerNorm after it and ends in
    the plain residual add. Returns None when a shape declines the fused
    kernel (the caller then runs the per-block loop)."""
    hq = layer_norm_quant_static(blocks[0]["norm1"], x, blocks[0]["act_scales"]["qkv"],
                                 cfg.ln_eps)
    for i, block in enumerate(blocks):
        sc = block["act_scales"]
        qkv = quant_matmul_pre(hq, sc["qkv"], _qkv_with_bias(block), x.dtype)
        oq, os_ = _attn_quant_static(block, qkv, cfg)
        if FUSED_LN in ("both", "proj"):
            fused = quant_matmul_res_ln_static(oq, os_, block["proj"], x, block["norm2"],
                                               sc["fc1"], cfg.ln_eps)
            if fused is None:
                return None
            x, hq = fused
        else:
            x = x + quant_matmul_pre(oq, os_, block["proj"], x.dtype)
            hq = layer_norm_quant_static(block["norm2"], x, sc["fc1"], cfg.ln_eps)
        gq = quant_fc1_gelu_static(hq, sc["fc1"], block["fc1"], sc["fc2"],
                                   approx=cfg.gelu_approx)
        if i + 1 == len(blocks):
            return x + quant_matmul_pre(gq, sc["fc2"], block["fc2"], x.dtype)
        nxt = blocks[i + 1]
        if FUSED_LN in ("both", "fc2"):
            fused = quant_matmul_res_ln_static(gq, sc["fc2"], block["fc2"], x, nxt["norm1"],
                                               nxt["act_scales"]["qkv"], cfg.ln_eps)
            if fused is None:
                return None
            x, hq = fused
        else:
            x = x + quant_matmul_pre(gq, sc["fc2"], block["fc2"], x.dtype)
            hq = layer_norm_quant_static(nxt["norm1"], x, nxt["act_scales"]["qkv"], cfg.ln_eps)
    return x


def vit_block(block: Dict, x: torch.Tensor, cfg: ViTConfig) -> torch.Tensor:
    if "act_scales" in block:  # static int8 (calibrate_vit_scales)
        return _vit_block_quant_static(block, x, cfg)
    if "w_q" in block["fc1"]:  # dynamic W8A8 (quantize_vit_params)
        return _vit_block_quant(block, x, cfg)
    x = x + _attention(block, layer_norm(block["norm1"], x, cfg.ln_eps), cfg)
    h = layer_norm(block["norm2"], x, cfg.ln_eps)
    h = linear(block["fc1"], h)
    h = F.gelu(h, approximate="tanh") if cfg.gelu_approx else gelu(h)
    return x + linear(block["fc2"], h)


def embed_patches(params: Dict, images: torch.Tensor, cfg: ViTConfig) -> torch.Tensor:
    """Patch embedding, cls token and abs pos embed: (B, H, W, C) -> (B, 257, width)."""
    x = linear(params["patch_embed"], patchify(images.to(cfg.dtype), cfg.patch_size))
    cls = params["cls_token"].to(x.dtype).expand(x.shape[0], 1, cfg.width)
    x = torch.cat([cls, x], dim=1)
    return x + params["pos_embed"].to(x.dtype)


def trunk_block(block: Dict, x: torch.Tensor, cfg: ViTConfig) -> torch.Tensor:
    """``vit_block``, recomputed in the backward when ``cfg.remat`` (and a
    gradient is being recorded)."""
    if cfg.remat and torch.is_grad_enabled():
        return checkpoint(vit_block, block, x, cfg, use_reentrant=False,
                          preserve_rng_state=False)
    return vit_block(block, x, cfg)


def vit_forward(params: Dict, images: torch.Tensor, cfg: ViTConfig, *,
                return_merge_origin: bool = False, num_frames: int = 0):
    """images: (B, H, W, C) normalized. Returns (B, 257, width) tokens, or
    (B, m, width) under ``cfg.merge_schedule``; ``return_merge_origin``
    also returns the (B, 257) origin map (None without merging).

    Under ``cfg.temporal_schedule`` the trunk runs on folded rows and the
    output is unfolded to per-frame rows (B, 257, width), or (B, m, width)
    when a post-trunk merge_schedule entry re-merges. ``num_frames`` (frames
    a video) lets the fold check that no group spans two videos.
    Under FUSED_LN a calibrated trunk without remat or merging runs the
    fused pipeline (_vit_blocks_fused_static), as in the reference."""
    x = embed_patches(params, images, cfg)
    schedule = dict(cfg.merge_schedule)
    folds = {blk: (g, m) for blk, g, m in cfg.temporal_schedule}
    blocks = params["blocks"]
    depth = len(blocks)
    if not all(0 <= k <= depth for k in schedule):
        raise ValueError(f"merge_schedule block indices must be in [0, {depth}] "
                         f"(== {depth} means post-trunk); got {sorted(schedule)}")
    if not all(0 <= k < depth for k in folds):
        raise ValueError(f"temporal_schedule block indices must be in [0, {depth}); "
                         f"got {sorted(folds)}")
    origin = None
    if schedule or folds:
        sizes, origin = init_merge_state(x.shape[0], x.shape[1], device=x.device)
    if folds:
        total_g = 1
        for g, _ in folds.values():
            total_g *= g
        t = num_frames or x.shape[0]
        if t % total_g or x.shape[0] % total_g:
            raise ValueError(f"temporal_schedule groups multiply to {total_g}; num_frames "
                             f"{t} must divide so folds never span videos")
        n0 = x.shape[1]
    if (FUSED_LN and not cfg.remat and not schedule and not folds and blocks
            and all("act_scales" in bl for bl in blocks)):
        fused = _vit_blocks_fused_static(blocks, x, cfg)
        if fused is not None:
            return (fused, None) if return_merge_origin else fused
    for i, block in enumerate(blocks):
        if i in folds:
            g, m = folds[i]
            n_pre = x.shape[1]
            x, sizes, origin = fold_frames(x, sizes, origin, g)
            # B = CLS + the group's first frame, A = the later frames, so
            # cross-frame duplicates are matchable
            x, sizes, origin = bipartite_merge(x, sizes, origin, m, nb=n_pre)
        if i in schedule:
            x, sizes, origin = bipartite_merge(x, sizes, origin, schedule[i])
        x = trunk_block(block, x, cfg)
    if folds:
        # unfold to per-frame full resolution (the Q-Former takes frame rows)
        x = unmerge(x, origin).reshape(x.shape[0] * total_g, n0, x.shape[-1])
        origin = None
        if depth in schedule:           # re-merge spatially for the Q-Former
            sizes, origin = init_merge_state(x.shape[0], n0, device=x.device)
            x, sizes, origin = merge_to(x, sizes, origin, schedule[depth])
    elif depth in schedule:             # post-trunk merge: fewer tokens to the Q-Former
        x, sizes, origin = merge_to(x, sizes, origin, schedule[depth])
    return (x, origin) if return_merge_origin else x
