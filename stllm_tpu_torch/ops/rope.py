"""Rotary position embeddings, LLaMA-1 style (stllm_tpu/ops/rope.py):
half-split ``rotate_half`` in fp32, indexed by absolute position so one
function serves prefill and decode."""

from __future__ import annotations

import torch

from stllm_tpu_torch.ops.layers import gather_rows


def rope_table(head_dim: int, max_pos: int, theta: float = 10000.0,
               device=None):
    """(cos, sin), each (max_pos, head_dim) fp32."""
    inv_freq = 1.0 / (theta ** (
        torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim))
    t = torch.arange(max_pos, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv_freq)
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos(), emb.sin()


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def rope_rows(cos: torch.Tensor, sin: torch.Tensor, positions: torch.Tensor):
    """The (B, S, 1, D) cos and sin rows of ``positions`` (B, S), clamped
    into the table as JAX's gather clamps them: idle batcher rows run past
    it. One gather per forward serves every layer."""
    return (gather_rows(cos, positions)[:, :, None, :],
            gather_rows(sin, positions)[:, :, None, :])


def rotate(x: torch.Tensor, c: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Rotate x (B, S, H, D) by the rows from ``rope_rows``, in fp32."""
    xf = x.float()
    return (xf * c + _rotate_half(xf) * s).to(x.dtype)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               positions: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) absolute positions."""
    return rotate(x, *rope_rows(cos, sin, positions))
