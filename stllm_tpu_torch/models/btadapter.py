"""BTAdapter: the temporal branch riding the EVA-ViT trunk
(stllm_tpu/models/btadapter.py), bf16 path.

Over the last ``depth`` trunk blocks a branch accumulates the trunk
activations and runs temporal attention (per patch location across the T
frames, zero-init ``temporal_fc``) followed by a spatial EVA block. The branch
keeps one cls token (the mean of the per-frame trunk cls) and patch tokens in
patch-major, time-minor ``(p t)`` order. Output = (trunk + branch broadcast
per frame) / 2. Both branch attentions, like the trunk's, run the packed-qkv
CUDA kernel. The static-int8 layers come with the int8 slice.
"""

from __future__ import annotations

import copy
from typing import Dict, Optional

import torch

from stllm_tpu_torch.models.vit import (
    ViTConfig, _attention, _check_supported, embed_patches, init_vit, vit_block)
from stllm_tpu_torch.ops.layers import (
    gelu, init_layer_norm, init_linear, layer_norm, linear, normal)

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
    residual = x
    d = x.shape[-1]
    cls, q = x[:, :1], x[:, 1:]
    p = q.shape[1] // t
    cls_t = torch.repeat_interleave(cls, t, dim=0)                       # (B*T, 1, D)
    q_t = q.reshape(b, p, t, d).permute(0, 2, 1, 3).reshape(b * t, p, d)
    h = torch.cat([cls_t, q_t], dim=1)
    att = _attention(layer, layer_norm(layer["norm1"], h, cfg.ln_eps), cfg)
    cls_out = att[:, :1].reshape(b, t, 1, d).mean(dim=1)
    sp = att[:, 1:].reshape(b, t, p, d).permute(0, 2, 1, 3).reshape(b, p * t, d)
    x = residual + torch.cat([cls_out, sp], dim=1)
    h = layer_norm(layer["norm2"], x, cfg.ln_eps)
    return x + linear(layer["fc2"], gelu(linear(layer["fc1"], h)))


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
        x = vit_block(block, x, cfg)
        if idx >= start:
            i = idx - start
            temp_l, spat_l = layers["temp"][i], layers["spatial"][i]
            if "act_scales" in temp_l or "act_scales" in spat_l:
                raise NotImplementedError("static-int8 BTAdapter layers are not ported yet")
            xr = x.reshape(b, t, n0, x.shape[-1])
            branch = (_branch_init(params, xr, cfg) if branch is None
                      else _branch_accumulate(branch, xr))
            branch = _temporal_layer(temp_l, branch, b, t, cfg)
            branch = _spatial_layer(spat_l, branch, b, t, cfg)
    p = n0 - 1
    d = x.shape[-1]
    br_cls = torch.repeat_interleave(branch[:, :1], t, dim=0)            # (B*T, 1, D)
    br_patch = branch[:, 1:].reshape(b, p, t, d).permute(0, 2, 1, 3).reshape(bt, p, d)
    return (x + torch.cat([br_cls, br_patch], dim=1)) / 2
