"""BTAdapter: the temporal branch riding the EVA-ViT trunk
(stllm_tpu/models/btadapter.py), bf16 path.

Over the last ``depth`` trunk blocks a branch accumulates the trunk
activations and runs temporal attention (per patch location across the T
frames, zero-init ``temporal_fc``) followed by a spatial EVA block. The branch
keeps one cls token (the mean of the per-frame trunk cls) and patch tokens in
patch-major, time-minor ``(p t)`` order. Output = (trunk + branch broadcast
per frame) / 2. Both branch attentions, like the trunk's, run the packed-qkv
CUDA kernel. The whole forward is differentiable (the branch trains over a
frozen trunk); with ``cfg.remat`` the trunk blocks are recomputed in the
backward, the branch layers are not, as in the reference.

With W8A8 params (``vit.quantize_vit_params``) the branch matmuls run
dynamic int8 through ``linear`` around the bf16 attention kernel (#1).
``calibrate_btadapter_scales`` adds static scales to the trunk and the
branch: the static temporal layer keeps its short (T-long) attention in
plain torch, and the static spatial layer, of trunk geometry, takes the
static-int8 attention kernel (#3).
"""

from __future__ import annotations

import copy
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from stllm_tpu_torch.models.vit import (
    ViTConfig, _act_scale, _attention, _attn_quant_static, _check_supported,
    _qkv_with_bias, calibrate_vit_scales, embed_patches, init_vit, normalize_uint8,
    trunk_block, vit_block)
from stllm_tpu_torch.ops.attention import fused_qkv_attention_quant, mha_reference
from stllm_tpu_torch.ops.layers import (
    gelu, init_layer_norm, init_linear, layer_norm, linear, normal)
from stllm_tpu_torch.ops.quant import (
    layer_norm_quant_static, quant_linear, quant_matmul_pre, quant_mlp_static,
    quantize_static)

MAX_BTADAPTER_FRAMES = 64  # learned temporal embedding size


def init_btadapter(gen: torch.Generator, cfg: ViTConfig, depth: int = 3) -> Dict:
    """Trunk params plus a ``btadapter`` subtree. The spatial layers are
    copies (not aliases) of the last ``depth`` trunk blocks; temporal layers
    get a zero temporal_fc; the temporal embedding is N(0, 1)."""
    params = init_vit(gen, cfg)
    d = cfg.width
    dev = gen.device
    temp = []
    for _ in range(depth):
        temp.append(
            {
                "norm1": init_layer_norm(d, cfg.dtype, dev),
                "qkv": init_linear(gen, d, 3 * d, cfg.dtype, bias=False),
                "q_bias": torch.zeros((d,), dtype=cfg.dtype, device=dev),
                "v_bias": torch.zeros((d,), dtype=cfg.dtype, device=dev),
                "proj": init_linear(gen, d, d, cfg.dtype),
                "temporal_fc": {
                    "w": torch.zeros((d, d), dtype=cfg.dtype, device=dev),
                    "b": torch.zeros((d,), dtype=cfg.dtype, device=dev),
                },
            }
        )
    params["btadapter"] = {
        "cls": torch.zeros((1, 1, d), dtype=cfg.dtype, device=dev),
        "time_embed": normal(gen, (MAX_BTADAPTER_FRAMES, d), 1.0, cfg.dtype),
        "temp": temp,
        "spatial": copy.deepcopy(params["blocks"][-depth:]),
    }
    return params


def _temporal_layer(layer: Dict, x: torch.Tensor, b: int, t: int,
                    cfg: ViTConfig) -> torch.Tensor:
    """Per-patch attention across frames. x: (B, 1 + P*T, D) patch-major."""
    cls, q = x[:, :1], x[:, 1:]
    d = x.shape[-1]
    p = q.shape[1] // t
    qt = q.reshape(b * p, t, d)
    att = _attention(layer, layer_norm(layer["norm1"], qt, cfg.ln_eps), cfg)
    att = linear(layer["temporal_fc"], att)
    out = att.reshape(b, p * t, d) + q
    return torch.cat([cls, out], dim=1)


def _spatial_layer(layer: Dict, x: torch.Tensor, b: int, t: int,
                   cfg: ViTConfig) -> torch.Tensor:
    """Per-frame EVA block with the branch cls shared across frames."""
    h = layer_norm(layer["norm1"], _frames_view(x, b, t), cfg.ln_eps)
    x = x + _merge_frames(_attention(layer, h, cfg), b, t)
    h = layer_norm(layer["norm2"], x, cfg.ln_eps)
    return x + linear(layer["fc2"], gelu(linear(layer["fc1"], h)))


def _frames_view(x: torch.Tensor, b: int, t: int):
    """Branch state (B, 1 + P*T, D) -> per-frame rows (B*T, 1 + P, D), each
    with the shared branch cls."""
    d = x.shape[-1]
    cls, q = x[:, :1], x[:, 1:]
    p = q.shape[1] // t
    cls_t = torch.repeat_interleave(cls, t, dim=0)
    q_t = q.reshape(b, p, t, d).permute(0, 2, 1, 3).reshape(b * t, p, d)
    return torch.cat([cls_t, q_t], dim=1)


def _merge_frames(att: torch.Tensor, b: int, t: int) -> torch.Tensor:
    """Per-frame rows (B*T, 1 + P, D) -> branch layout (B, 1 + P*T, D), the
    cls averaged over the frames."""
    d = att.shape[-1]
    p = att.shape[1] - 1
    cls_out = att[:, :1].reshape(b, t, 1, d).mean(dim=1)
    sp = att[:, 1:].reshape(b, t, p, d).permute(0, 2, 1, 3).reshape(b, p * t, d)
    return torch.cat([cls_out, sp], dim=1)


def _temporal_attention(qkv: torch.Tensor, bp: int, t: int, cfg: ViTConfig) -> torch.Tensor:
    """Plain attention over the T frames of each patch: (B*P, T, 3D) -> (B*P, T, D)."""
    qh, kh, vh = (z.reshape(bp, t, cfg.heads, cfg.head_dim) for z in qkv.chunk(3, dim=-1))
    return mha_reference(qh, kh, vh).reshape(bp, t, cfg.width)


def _temporal_layer_quant_static(layer: Dict, x: torch.Tensor, b: int, t: int,
                                 cfg: ViTConfig) -> torch.Tensor:
    """Static-int8 temporal layer: LayerNorm emits static int8, the three
    matmuls (qkv, proj, temporal_fc) run s8 x s8 with calibrated scales, and
    the attention over T frames stays plain (mha_reference)."""
    sc = layer["act_scales"]
    cls, q = x[:, :1], x[:, 1:]
    d = x.shape[-1]
    p = q.shape[1] // t
    hq = layer_norm_quant_static(layer["norm1"], q.reshape(b * p, t, d), sc["qkv"],
                                 cfg.ln_eps)
    qkv = quant_matmul_pre(hq, sc["qkv"], _qkv_with_bias(layer), x.dtype)
    out = _temporal_attention(qkv, b * p, t, cfg)
    att = quant_matmul_pre(quantize_static(out, sc["proj"]), sc["proj"], layer["proj"],
                           x.dtype)
    att = quant_matmul_pre(quantize_static(att, sc["temporal_fc"]), sc["temporal_fc"],
                           layer["temporal_fc"], x.dtype)
    return torch.cat([cls, att.reshape(b, p * t, d) + q], dim=1)


def _spatial_layer_quant_static(layer: Dict, x: torch.Tensor, b: int, t: int,
                                cfg: ViTConfig) -> torch.Tensor:
    """Static-int8 spatial layer: the per-frame view has the trunk block's
    geometry, so it takes the trunk's static attention (#3) and static
    LayerNorm and MLP."""
    sc = layer["act_scales"]
    hq = layer_norm_quant_static(layer["norm1"], _frames_view(x, b, t), sc["qkv"],
                                 cfg.ln_eps)
    qkv = quant_matmul_pre(hq, sc["qkv"], _qkv_with_bias(layer), x.dtype)
    if "attn" in sc:
        oq, os_ = _attn_quant_static(layer, qkv, cfg)
    else:
        oq, os_ = fused_qkv_attention_quant(qkv, cfg.heads, cfg.head_dim)
    att = quant_matmul_pre(oq, os_, layer["proj"], x.dtype)
    x = x + _merge_frames(att, b, t)
    hq2 = layer_norm_quant_static(layer["norm2"], x, sc["fc1"], cfg.ln_eps)
    return x + quant_mlp_static(hq2, sc["fc1"], layer["fc1"], sc["fc2"], layer["fc2"],
                                x.dtype, approx=cfg.gelu_approx)


def _amax(v: torch.Tensor) -> torch.Tensor:
    return v.float().abs().max()


def _temporal_stats(layer: Dict, x: torch.Tensor, b: int, t: int, cfg: ViTConfig):
    """Dynamic-int8 temporal layer that records the amax of each matmul input."""
    cls, q = x[:, :1], x[:, 1:]
    d = x.shape[-1]
    p = q.shape[1] // t
    h = layer_norm(layer["norm1"], q.reshape(b * p, t, d), cfg.ln_eps)
    qkv = quant_linear(_qkv_with_bias(layer), h)
    out = _temporal_attention(qkv, b * p, t, cfg)
    att = quant_linear(layer["proj"], out)
    fc = quant_linear(layer["temporal_fc"], att)
    nxt = torch.cat([cls, fc.reshape(b, p * t, d) + q], dim=1)
    return nxt, {"qkv": _amax(h), "proj": _amax(out), "temporal_fc": _amax(att)}


def _spatial_stats(layer: Dict, x: torch.Tensor, b: int, t: int, cfg: ViTConfig):
    """Dynamic-int8 spatial layer, attention in plain torch, that records
    the amax of each matmul input and the per-third amax of the qkv output."""
    h = _frames_view(x, b, t)
    n = h.shape[1]
    hn = layer_norm(layer["norm1"], h, cfg.ln_eps)
    qkv = quant_linear(_qkv_with_bias(layer), hn)
    qh, kh, vh = (z.reshape(b * t, n, cfg.heads, cfg.head_dim) for z in qkv.chunk(3, dim=-1))
    out = mha_reference(qh, kh, vh).reshape(b * t, n, cfg.width)
    x = x + _merge_frames(quant_linear(layer["proj"], out), b, t)
    hn2 = layer_norm(layer["norm2"], x, cfg.ln_eps)
    f1 = quant_linear(layer["fc1"], hn2)
    g = F.gelu(f1, approximate="tanh") if cfg.gelu_approx else gelu(f1)
    nxt = x + quant_linear(layer["fc2"], g)
    attn_amax = qkv.float().abs().reshape(b * t, n, 3, -1).amax(dim=(0, 1, 3))
    return nxt, {"qkv": _amax(hn), "proj": _amax(out), "fc1": _amax(hn2),
                 "fc2": _amax(g), "attn": attn_amax}


@torch.no_grad()
def calibrate_btadapter_scales(params_q: Dict, images: torch.Tensor, cfg: ViTConfig,
                               num_frames: int, margin: float = 1.0) -> Dict:
    """Static-W8A8 calibration of the trunk and the branch.

    Trunk scales come from ``calibrate_vit_scales`` (exact for the trunk:
    the branch never feeds back into it). The branch is then replayed over
    the static trunk's activations, in dynamic int8, recording the
    per-tensor amax of each branch matmul input. ``params_q``: the W8A8 tree
    of ``quantize_vit_params``; images: (B*T, H, W, C), uint8 or normalized.
    Returns a copy with ``act_scales`` on every trunk block and branch
    layer; ``btadapter_forward`` then takes the static path."""
    params_q = calibrate_vit_scales(params_q, images, cfg, margin)
    t = num_frames
    b = images.shape[0] // t
    if b * t != images.shape[0]:
        raise ValueError(f"batch {images.shape[0]} not divisible by num_frames {t}")
    if images.dtype == torch.uint8:
        images = normalize_uint8(images, cfg.dtype)
    layers = params_q["btadapter"]
    start = cfg.depth - len(layers["temp"])
    x = embed_patches(params_q, images, cfg)
    branch: Optional[torch.Tensor] = None
    temp_stats, spat_stats = [], []
    for idx, block in enumerate(params_q["blocks"]):
        x = vit_block(block, x, cfg)
        if idx >= start:
            i = idx - start
            xr = x.reshape(b, t, *x.shape[1:])
            branch = (_branch_init(params_q, xr, cfg) if branch is None
                      else _branch_accumulate(branch, xr))
            branch, st = _temporal_stats(layers["temp"][i], branch, b, t, cfg)
            temp_stats.append(st)
            branch, st = _spatial_stats(layers["spatial"][i], branch, b, t, cfg)
            spat_stats.append(st)

    def attach(layer, st):
        return {**layer, "act_scales": {k: _act_scale(margin, v) for k, v in st.items()}}

    out = dict(params_q)
    out["btadapter"] = {
        **layers,
        "temp": [attach(l, s) for l, s in zip(layers["temp"], temp_stats)],
        "spatial": [attach(l, s) for l, s in zip(layers["spatial"], spat_stats)],
    }
    return out


def _branch_init(params: Dict, xr: torch.Tensor, cfg: ViTConfig) -> torch.Tensor:
    """Initial branch state from trunk activations xr: (B, T, L, D)."""
    bt_p = params["btadapter"]
    b, t, l, d = xr.shape
    p = l - 1
    cls_x = xr[:, :, 0].mean(dim=1, keepdim=True)                        # (B, 1, D)
    pos = params["pos_embed"].to(xr.dtype)
    cls_branch = (bt_p["cls"].to(xr.dtype) + pos[:, :1]).expand(b, 1, d)
    patches = xr[:, :, 1:] + pos[None, :, 1:]                            # (B, T, P, D)
    patches = patches.permute(0, 2, 1, 3)                                # (B, P, T, D)
    patches = patches + bt_p["time_embed"][:t].to(xr.dtype)
    patches = patches.reshape(b, p * t, d)
    cls = (cls_x + cls_branch) / 2
    return torch.cat([cls, patches], dim=1)


def _branch_accumulate(branch: torch.Tensor, xr: torch.Tensor) -> torch.Tensor:
    """Add the current trunk activations xr: (B, T, L, D) into the branch."""
    b, t, l, d = xr.shape
    cls = xr[:, :, 0].mean(dim=1, keepdim=True)
    patches = xr[:, :, 1:].permute(0, 2, 1, 3).reshape(b, (l - 1) * t, d)
    return branch + torch.cat([cls, patches], dim=1)


def btadapter_forward(params: Dict, images: torch.Tensor, cfg: ViTConfig,
                      num_frames: int) -> torch.Tensor:
    """Trunk + branch. images: (B*T, H, W, C) normalized. Returns
    (B*T, L, D) per-frame tokens with the branch averaged in."""
    _check_supported(cfg)
    t = num_frames
    bt = images.shape[0]
    b = bt // t
    if b * t != bt:
        raise ValueError(f"batch {bt} not divisible by num_frames {t}")
    if t > MAX_BTADAPTER_FRAMES:
        raise ValueError(f"{t} frames > temporal embedding {MAX_BTADAPTER_FRAMES}")
    x = embed_patches(params, images, cfg)
    n0 = x.shape[1]
    layers = params["btadapter"]
    start = cfg.depth - len(layers["temp"])
    branch: Optional[torch.Tensor] = None
    for idx, block in enumerate(params["blocks"]):
        x = trunk_block(block, x, cfg)
        if idx >= start:
            i = idx - start
            temp_l, spat_l = layers["temp"][i], layers["spatial"][i]
            xr = x.reshape(b, t, n0, x.shape[-1])
            branch = (_branch_init(params, xr, cfg) if branch is None
                      else _branch_accumulate(branch, xr))
            temporal = (_temporal_layer_quant_static if "act_scales" in temp_l
                        else _temporal_layer)
            spatial = (_spatial_layer_quant_static if "act_scales" in spat_l
                       else _spatial_layer)
            branch = spatial(spat_l, temporal(temp_l, branch, b, t, cfg), b, t, cfg)
    p = n0 - 1
    d = x.shape[-1]
    br_cls = torch.repeat_interleave(branch[:, :1], t, dim=0)            # (B*T, 1, D)
    br_patch = branch[:, 1:].reshape(b, p, t, d).permute(0, 2, 1, 3).reshape(bt, p, d)
    return (x + torch.cat([br_cls, br_patch], dim=1)) / 2
