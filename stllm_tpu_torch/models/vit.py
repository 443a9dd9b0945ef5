"""EVA-ViT-g visual encoder (stllm_tpu/models/vit.py), bf16 path.

Patch 14, width 1408, depth 39, 16 heads (head_dim 88), MLP hidden 6144, abs
pos embed, pre-norm blocks with q/v-only qkv bias (k bias fixed at zero), LN
eps 1e-6, all 257 tokens out. Images are NHWC; the patch embedding is a
reshape plus matmul. The attention of every block is the packed-qkv CUDA
kernel (``use_flash=None``). Token merging, frame folding and the int8
blocks come with later slices; their config fields are kept so configs
compare field by field with the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from stllm_tpu_torch.ops.attention import fused_qkv_attention, mha_reference
from stllm_tpu_torch.ops.layers import (
    gelu, init_layer_norm, init_linear, layer_norm, linear, trunc_normal)


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
    remat: bool = False            # a training option; inference ignores it
    # attention backend: None = the packed-qkv kernel; False = split q/k/v
    # through mha_reference; True (the reference's flash kernels) is not
    # ported yet
    use_flash: Optional[bool] = None
    gelu_approx: bool = False
    merge_schedule: tuple = ()
    temporal_schedule: tuple = ()
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


def _check_supported(cfg: ViTConfig) -> None:
    if cfg.merge_schedule or cfg.temporal_schedule:
        raise NotImplementedError("token merging and frame folding are not ported yet")


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


def patchify(images: torch.Tensor, patch: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, h*w, patch*patch*C), row-major patches, features
    in (ph, pw, C) order."""
    b, hh, ww, c = images.shape
    nh, nw = hh // patch, ww // patch
    x = images.reshape(b, nh, patch, nw, patch, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, nh * nw, patch * patch * c)


def _attention(block: Dict, x: torch.Tensor, cfg: ViTConfig) -> torch.Tensor:
    b, n, d = x.shape
    qkv_bias = torch.cat(
        [block["q_bias"], torch.zeros_like(block["q_bias"]), block["v_bias"]])
    # k bias fixed at zero (the reference EVA block has q/v biases only)
    qkv = linear({**block["qkv"], "b": qkv_bias}, x)
    if cfg.use_flash is None:
        out = fused_qkv_attention(qkv, cfg.heads, cfg.head_dim)
        return linear(block["proj"], out)
    if cfg.use_flash:
        raise NotImplementedError("use_flash=True needs the flash-attention kernels, "
                                  "not ported yet; use None (packed kernel) or False")
    q, k, v = (t.reshape(b, n, cfg.heads, cfg.head_dim) for t in qkv.chunk(3, dim=-1))
    out = mha_reference(q, k, v)
    return linear(block["proj"], out.reshape(b, n, d))


def vit_block(block: Dict, x: torch.Tensor, cfg: ViTConfig) -> torch.Tensor:
    if "act_scales" in block or "w" not in block["fc1"]:
        raise NotImplementedError("int8 ViT blocks are not ported yet")
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


def vit_forward(params: Dict, images: torch.Tensor, cfg: ViTConfig) -> torch.Tensor:
    """images: (B, H, W, C) normalized. Returns (B, 257, width) tokens."""
    _check_supported(cfg)
    x = embed_patches(params, images, cfg)
    for block in params["blocks"]:
        x = vit_block(block, x, cfg)
    return x
