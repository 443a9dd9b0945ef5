"""Core NN primitives with the reference's dtype policy
(stllm_tpu/ops/layers.py).

Matmuls run in the io dtype with fp32 accumulation; normalization statistics
always run in fp32. Parameter layout is the JAX tree's, so the converter is a
copy by key path:
  linear:     {"w": (in, out), "b": (out,)}   computes x @ w + b
  layer_norm: {"scale": (dim,), "bias": (dim,)}
  rms_norm:   {"scale": (dim,)}
Dense forms only; the int8 and int4 linears come with the quantized slices.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def linear(params, x: torch.Tensor) -> torch.Tensor:
    if "w" not in params:
        raise NotImplementedError(
            f"linear params with keys {sorted(params)}: only the dense form "
            "is ported")
    y = torch.matmul(x, params["w"].to(x.dtype))
    b = params.get("b")
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (..., K) @ b (K, N) accumulated and returned in fp32 without
    upcasting the operands on the card (JAX ``preferred_element_type``)."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return torch.matmul(a, b)
    if a.is_cuda:
        out = torch.mm(a.reshape(-1, a.shape[-1]), b, out_dtype=torch.float32)
        return out.reshape(*a.shape[:-1], b.shape[-1])
    # bf16 products are exact in fp32, so this is the same sum on the CPU
    return torch.matmul(a.float(), b.float())


def gather_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` with JAX's gather rule: negative ids count from the
    end, then every id is clamped into range. Torch indexing would raise on
    an id JAX silently clamps."""
    n = table.shape[0]
    ids = torch.where(ids < 0, ids + n, ids).clamp(0, n - 1)
    return table[ids]


def layer_norm(params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm with fp32 statistics, output in x.dtype (even with fp32
    params, as ln_vision has)."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * params["scale"].float() + params["bias"].float()
    return y.to(x.dtype)


def rms_norm(params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm: fp32 statistics, cast to x.dtype, then scale in x.dtype
    (HF LlamaRMSNorm order)."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = (xf * torch.rsqrt(var + eps)).to(x.dtype)
    return y * params["scale"].to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU."""
    return F.gelu(x)


def mlp(params, x: torch.Tensor, act=gelu) -> torch.Tensor:
    """Two-layer MLP: fc1 -> act -> fc2."""
    return linear(params["fc2"], act(linear(params["fc1"], x)))


def swiglu_mlp(params, x: torch.Tensor) -> torch.Tensor:
    """LLaMA MLP: down(silu(gate(x)) * up(x))."""
    return linear(params["down"],
                  F.silu(linear(params["gate"], x)) * linear(params["up"], x))


# ---------------------------------------------------------------------------
# init helpers: random init from an explicit generator, on its device
# ---------------------------------------------------------------------------

def trunc_normal(gen: torch.Generator, shape, std: float, dtype) -> torch.Tensor:
    """N(0, std^2) truncated at two standard deviations, drawn in fp32."""
    w = torch.empty(shape, dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (w * std).to(dtype)


def normal(gen: torch.Generator, shape, std: float, dtype) -> torch.Tensor:
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=gen.device)
    return (w * std).to(dtype)


def init_linear(gen: torch.Generator, d_in: int, d_out: int, dtype=torch.float32,
                bias: bool = True, std: Optional[float] = 0.02):
    p = {"w": trunc_normal(gen, (d_in, d_out), std, dtype)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=gen.device)
    return p


def init_layer_norm(dim: int, dtype=torch.float32, device=None):
    return {"scale": torch.ones((dim,), dtype=dtype, device=device),
            "bias": torch.zeros((dim,), dtype=dtype, device=device)}


def init_rms_norm(dim: int, dtype=torch.float32, device=None):
    return {"scale": torch.ones((dim,), dtype=dtype, device=device)}
