"""Context-parallel LLaMA forward: activations split over the SEQUENCE
(stllm_tpu/parallel/context.py).

Every per-token op (norms, projections, MLP) runs on this rank's shard of
the sequence; attention runs as exact ring attention (ops/ring_attention.py)
with the K/V shards rotating over the group. It produces the hidden states
of ``llama_forward`` for full sequences whose length divides over the axis.

The gradients are the reference's too: the input's shard enters through
``scatter_to`` and the output leaves through ``gather_from``, and every
parameter through ``copy_to``, so each rank's gradients are the whole
sequence's, as a replicated parameter's are under the reference's
``shard_map``.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from stllm_tpu_torch.models.llama import LlamaConfig, _qkv_proj
from stllm_tpu_torch.ops.layers import linear, rms_norm, swiglu_mlp
from stllm_tpu_torch.ops.ring_attention import ring_attention
from stllm_tpu_torch.ops.rope import apply_rope, rope_table
from stllm_tpu_torch.parallel.collectives import copy_to, gather_from, scatter_to
from stllm_tpu_torch.parallel.mesh import Mesh, map_tree


def _layer_cp(layer: Dict, x: torch.Tensor, cos, sin, positions,
              kv_mask: Optional[torch.Tensor], group, cfg: LlamaConfig) -> torch.Tensor:
    b, s, _ = x.shape
    h = rms_norm(layer["input_norm"], x, cfg.rms_eps)
    q, k, v = _qkv_proj(layer, h, b, s, cfg)  # handles fused qkv trees
    q = apply_rope(q, cos, sin, positions)
    k = apply_rope(k, cos, sin, positions)
    out = ring_attention(q, k, v, group=group, causal=True, kv_mask=kv_mask)
    x = x + linear(layer["o"], out.reshape(b, s, -1))
    h2 = rms_norm(layer["post_norm"], x, cfg.rms_eps)
    return x + swiglu_mlp(layer, h2)


def context_parallel_forward(
    params: Dict,
    inputs_embeds: torch.Tensor,        # (B, S, D) FULL sequence, on every rank
    mesh: Mesh,
    cfg: LlamaConfig,
    axis_name: str = "data",
    attention_mask: Optional[torch.Tensor] = None,   # (B, S) validity
) -> torch.Tensor:
    """Run the LLaMA stack with the sequence split over ``axis_name``.
    Returns the full (B, S, hidden) hidden states (same as llama_forward)
    on every rank."""
    b, s, _ = inputs_embeds.shape
    n = mesh.shape[axis_name]
    if s % n:
        raise ValueError(f"sequence {s} not divisible by {axis_name}={n}")
    group = mesh.groups[axis_name]
    if attention_mask is None:
        attention_mask = torch.ones((b, s), dtype=torch.int32, device=inputs_embeds.device)
    s_local = s // n
    dev = inputs_embeds.device
    cos, sin = rope_table(cfg.head_dim, cfg.max_positions, cfg.rope_theta, device=dev)
    positions = (mesh.coords[axis_name] * s_local
                 + torch.arange(s_local, device=dev)[None, :]).expand(b, s_local)
    mask = attention_mask[:, mesh.coords[axis_name] * s_local:][:, :s_local].bool()
    p = map_tree(lambda _, leaf: copy_to(leaf, group), params)
    x = scatter_to(inputs_embeds.to(cfg.dtype), group, 1)
    for layer in p["layers"]:
        x = _layer_cp(layer, x, cos, sin, positions, mask, group, cfg)
    return gather_from(rms_norm(p["norm"], x, cfg.rms_eps), group, 1)
