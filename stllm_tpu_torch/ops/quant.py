"""W8A8 int8 inference (stllm_tpu/ops/quant.py), dynamic and static.

Weights are per-output-channel symmetric int8 (``w_q`` (K, N), ``w_scale``
(N,) fp32). Activations are quantized per row at run time (dynamic) or with
a calibrated per-tensor scale (static, ``act_scales`` from
``models/vit.calibrate_vit_scales``). The int8 product accumulates in int32,
as the reference's ``preferred_element_type=int32`` dot does; the reference
leaves that dot to XLA, and here it is ``torch._int_mm`` on the card. The
producer-fused quantizers ``layer_norm_quant`` and ``gelu_quant`` run the
hand-written kernels in ``ops/kernels.py``.

Each function follows the reference's order of operations: fp32 products do
not associate, and a code flipped at a rounding boundary moves its element
by one step.

The weight-only ``w_q16`` form and the int4 ``w4`` form come with the W4A16
slice.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from stllm_tpu_torch.ops import kernels

W4A16_SLICE = "the weight-only w_q16 and int4 w4 forms come with the W4A16 slice"


def quantize_weights(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric int8. w: (K, N) -> (w_q int8, scale (N,) fp32).
    w_q is a (K, N) tensor stored column-major, the layout in which cuBLASLt
    runs the int8 product (see ``_int8_dot``)."""
    w = w.float()
    amax = w.abs().amax(dim=0)
    scale = torch.where(amax == 0.0, torch.ones_like(amax), amax / 127.0)
    w_q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return w_q.t().contiguous().t(), scale


def quantize_activations(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row (last-axis) symmetric int8: (..., K) -> (int8, (..., 1) fp32)."""
    return kernels.rowwise_quant_plain(x.float())


# torch._int_mm on the card (torch 2.11) takes M > 16 rows and K, N multiples
# of 8, and wants a column-major (K, N) operand: cuBLASLt refuses a row-major
# one at some small shapes (CUBLAS_STATUS_NOT_SUPPORTED) and runs it slower
_INT_MM_MIN_ROWS = 17


def _int8_dot(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """s8 x s8 matmul over the last/first axes with int32 accumulation,
    returned in fp32. x_q: (..., K), w_q: (K, N). On the card a row-major
    w_q (a tree converted from JAX) is copied to column-major per call."""
    lead, k = x_q.shape[:-1], x_q.shape[-1]
    n = w_q.shape[1]
    a = x_q.reshape(-1, k)
    if a.is_cuda:
        m = a.shape[0]
        if k % 8 or n % 8:
            raise ValueError(f"int8 matmul on the card needs K ({k}) and N ({n}) "
                             "to be multiples of 8")
        if m < _INT_MM_MIN_ROWS:
            # decode runs 4 rows: pad with zero rows, which add nothing
            a = torch.cat([a, a.new_zeros((_INT_MM_MIN_ROWS - m, k))])
        if w_q.stride(0) != 1:
            w_q = w_q.t().contiguous().t()
        y = torch._int_mm(a.contiguous(), w_q)[:m]
    else:
        y = torch.matmul(a.to(torch.int32), w_q.to(torch.int32))
    return y.float().reshape(*lead, n)


def quant_matmul(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor) -> torch.Tensor:
    """Dynamic W8A8 matmul. x: (..., K), w_q: (K, N) int8, w_scale: (N,).
    Returns (..., N) in x.dtype."""
    x_q, x_scale = quantize_activations(x)
    y = _int8_dot(x_q, w_q)
    return (y * x_scale * w_scale.float()).to(x.dtype)


def quantize_linear_params(params: Dict, free_dense: bool = False) -> Dict:
    """Dense linear params {'w': (K, N), 'b': (N,)?} -> the quantized form
    {'w_q', 'w_scale', 'b'?} of ``quant_linear``. ``free_dense=True`` drops
    the dense weight from ``params`` once quantized, so its memory goes back
    to the allocator as soon as nothing else holds it (in-place conversion of
    trees too large for dense and quantized to coexist)."""
    w_q, scale = quantize_weights(params["w"])
    out = {"w_q": w_q, "w_scale": scale}
    if params.get("b") is not None:
        out["b"] = params["b"]
    if free_dense:
        del params["w"]
    return out


def quant_linear(params_q: Dict, x: torch.Tensor) -> torch.Tensor:
    """Drop-in for ops.layers.linear on quantized params: the product is
    cast to x.dtype first and the bias added in that dtype."""
    if "w_q" not in params_q:
        raise NotImplementedError(W4A16_SLICE)
    out = quant_matmul(x, params_q["w_q"], params_q["w_scale"])
    if "b" in params_q:
        out = out + params_q["b"].to(out.dtype)
    return out


def layer_norm_quant(params: Dict, x: torch.Tensor, eps: float = 1e-6
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused LayerNorm -> per-row int8 (kernel #9). x: (..., K). Returns
    (x_q int8, scale fp32 (..., 1)): layer_norm then quantize_activations,
    with the fp32 LayerNorm output quantized directly."""
    return kernels.layer_norm_quant(x, params["scale"], params["bias"], eps)


def gelu_quant(x: torch.Tensor, *, approx: bool = False
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused GELU -> per-row int8 (kernel #10), erf or tanh form."""
    return kernels.gelu_quant(x, approx)


def quant_matmul_pre(x_q: torch.Tensor, x_scale, params_q: Dict, out_dtype) -> torch.Tensor:
    """int8 matmul on pre-quantized activations (per-row or static scale):
    y * x_scale * w_scale and the bias in fp32, then one cast."""
    y = _int8_dot(x_q, params_q["w_q"])
    y = y * x_scale * params_q["w_scale"].float()
    if "b" in params_q:
        y = y + params_q["b"].float()
    return y.to(out_dtype)


# ---------------------------------------------------------------------------
# static (calibrated) activation scales
# ---------------------------------------------------------------------------

def quantize_static(x: torch.Tensor, scale) -> torch.Tensor:
    """Elementwise static-scale symmetric int8, saturating at +-127."""
    return torch.clamp(torch.round(x.float() / scale), -127, 127).to(torch.int8)


def layer_norm_quant_static(params: Dict, x: torch.Tensor, scale, eps: float = 1e-6
                            ) -> torch.Tensor:
    """LayerNorm in fp32 throughout (ops.layers.layer_norm's statistics),
    then static int8."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * params["scale"].float() + params["bias"].float()
    return quantize_static(y, scale)


def quant_fc1_gelu_static(hq: torch.Tensor, in_scale, fc1_q: Dict, gelu_scale, *,
                          approx: bool = False) -> torch.Tensor:
    """fc1 -> GELU -> static int8: y * (in_scale * w_scale), the bias in
    fp32, GELU in fp32."""
    y = _int8_dot(hq, fc1_q["w_q"])
    y = y * (in_scale * fc1_q["w_scale"].float())
    if "b" in fc1_q:
        y = y + fc1_q["b"].float()
    g = F.gelu(y, approximate="tanh" if approx else "none")
    return quantize_static(g, gelu_scale)


def quant_mlp_static(hq: torch.Tensor, in_scale, fc1_q: Dict, gelu_scale, fc2_q: Dict,
                     out_dtype, *, approx: bool = False) -> torch.Tensor:
    """fc1 -> GELU -> static int8 -> fc2 with calibrated scales."""
    gq = quant_fc1_gelu_static(hq, in_scale, fc1_q, gelu_scale, approx=approx)
    return quant_matmul_pre(gq, gelu_scale, fc2_q, out_dtype)


def quantize_tree_linears(tree, free_dense: bool = False):
    """Convert every linear param dict ({'w': 2-D tensor, ...}) in a tree to
    W8A8 form; other leaves (norms, embeddings, biases) pass through."""
    if isinstance(tree, dict):
        w = tree.get("w")
        if isinstance(w, torch.Tensor) and w.dim() == 2:
            return quantize_linear_params(tree, free_dense=free_dense)
        return {k: quantize_tree_linears(v, free_dense) for k, v in tree.items()}
    if isinstance(tree, list):
        return [quantize_tree_linears(v, free_dense) for v in tree]
    return tree
