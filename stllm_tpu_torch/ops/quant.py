"""Quantized inference (stllm_tpu/ops/quant.py): W8A8 int8, dynamic and
static, the weight-only int8 ``w_q16`` form, and W4A16 int4 storage.

Weights are per-output-channel symmetric int8 (``w_q`` (K, N), ``w_scale``
(N,) fp32). Activations are quantized per row at run time (dynamic) or with
a calibrated per-tensor scale (static, ``act_scales`` from
``models/vit.calibrate_vit_scales``). The int8 product accumulates in int32,
as the reference's ``preferred_element_type=int32`` dot does; the reference
leaves that dot to XLA, and here it is ``torch._int_mm`` on the card. The
producer-fused quantizers ``layer_norm_quant`` and ``gelu_quant``, the
static block's epilogue-carried LayerNorm ``quant_matmul_res_ln_static``, and
the reference's blockwise dynamic-quant matmul ``quant_matmul_pallas`` run the
hand-written kernels in ``ops/kernels.py``.

``w_q16`` (``w8a16_matmul``) keeps the activations in bf16 and upcasts the
int8 codes into an fp32-accumulated product; the reference leaves it to XLA,
and here it is plain torch.

W4A16 (``w4``, ``w4_scale``): symmetric int4 codes in [-7, 7] packed two to
a byte of one (K/2, N) int8 array, the codes of K rows [0, K/2) in the low
nibble and those of rows [K/2, K) in the high nibble, with per-channel (N,)
or per-group (K/group, N) fp32 scales. Per-channel packed weights are
K-padded at conversion exactly as the reference pads them for its TPU
kernel's tiling (``_w4_padded_k2``), so a tree converted from JAX and one
quantized here are bit-identical; the true half-K always comes from x. On a
CUDA tensor ``w4_linear`` runs the hand-written W4A16 kernel for every
per-channel shape it takes; per-group scales stay plain torch on either
device, as the reference leaves them to XLA.

Each function follows the reference's order of operations: fp32 products do
not associate, and a code flipped at a rounding boundary moves its element
by one step.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from stllm_tpu_torch.ops import kernels


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
_INT_MM_ALIGN = 8


def _int8_dot(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """s8 x s8 matmul over the last/first axes with int32 accumulation,
    returned in fp32. x_q: (..., K), w_q: (K, N). On the card a row-major
    w_q is copied to column-major per call; quantize_weights and
    load_jax_params store it column-major, so no model weight is. A K or N
    that is no multiple of 8 is padded with zero codes (copies of both
    operands), which leave the exact sums alone."""
    lead, k = x_q.shape[:-1], x_q.shape[-1]
    n = w_q.shape[1]
    a = x_q.reshape(-1, k)
    if a.is_cuda:
        m = a.shape[0]
        if k % _INT_MM_ALIGN or n % _INT_MM_ALIGN:
            kp, np_ = (-(-d // _INT_MM_ALIGN) * _INT_MM_ALIGN for d in (k, n))
            a = F.pad(a, (0, kp - k))
            wp = w_q.new_zeros((np_, kp))
            wp[:n, :k] = w_q.t()
            return _int8_dot(a, wp.t())[:, :n].reshape(*lead, n)
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


class _MmF32(torch.autograd.Function):
    """a (M, K) @ b (K, N) with an fp32 result on the card (``torch.mm`` with
    ``out_dtype`` has no derivative of its own). Backward: the fp32 cotangent
    is rounded to the operands' dtype and both products run in that dtype
    with fp32 accumulation, the usual mixed-precision rule."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.mm(a, b, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.to(a.dtype)
        return (torch.mm(g, b.t()) if ctx.needs_input_grad[0] else None,
                torch.mm(a.t(), g) if ctx.needs_input_grad[1] else None)


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (..., K) @ b (K, N) accumulated and returned in fp32 without
    upcasting the operands on the card (JAX ``preferred_element_type``)."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return torch.matmul(a, b)
    if a.is_cuda:
        out = _MmF32.apply(a.reshape(-1, a.shape[-1]), b)
        return out.reshape(*a.shape[:-1], b.shape[-1])
    # bf16 products are exact in fp32, so this is the same sum on the CPU
    return torch.matmul(a.float(), b.float())


def w8a16_matmul(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor) -> torch.Tensor:
    """Weight-only int8 matmul: bf16 x times the int8 codes upcast to bf16,
    fp32 accumulation, times the fp32 scale, out in x.dtype."""
    y = matmul_f32(x.to(torch.bfloat16), w_q.to(torch.bfloat16))
    return (y * w_scale.float()).to(x.dtype)


def quant_linear(params_q: Dict, x: torch.Tensor) -> torch.Tensor:
    """Drop-in for ops.layers.linear on quantized params: the product is
    cast to x.dtype first and the bias added in that dtype. A ``w_q16`` key
    (instead of ``w_q``) selects the weight-only form."""
    if "w_q16" in params_q:
        out = w8a16_matmul(x, params_q["w_q16"], params_q["w_scale"])
    else:
        out = quant_matmul(x, params_q["w_q"], params_q["w_scale"])
    if "b" in params_q:
        out = out + params_q["b"].to(out.dtype)
    return out


ROW_TILE_BYTES = 8 * 1024 * 1024   # the reference's fp32 working tile of a (S, K) block


def row_quant_fused(shape) -> bool:
    """The reference's tile rule for the producer-fused quantizers
    (``_rowwise_pallas``): a (B, S, K) x runs the fused kernel where its
    fp32 (S, K) block fits 8 MiB, and the unfused composition beyond. The
    reference's other clause, that under a mesh the global batch divide over
    the shards, is a need of its shard_map wrapper and is not kept: a rank
    runs the kernel on its own rows (``ops/spmd.py``). An x of another rank
    reads its second-to-last axis as S (1 for a single row)."""
    s = shape[-2] if len(shape) >= 2 else 1
    return s * shape[-1] * 4 <= ROW_TILE_BYTES


def layer_norm_quant(params: Dict, x: torch.Tensor, eps: float = 1e-6
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused LayerNorm -> per-row int8 (kernel #9). x: (..., K). Returns
    (x_q int8, scale fp32 (..., 1)): the fp32 LayerNorm output quantized
    directly where ``row_quant_fused`` holds; beyond, as the reference,
    layer_norm (rounded to x.dtype) then quantize_activations, plain torch
    on either device."""
    if not row_quant_fused(x.shape):
        from stllm_tpu_torch.ops.layers import layer_norm   # layers imports this module

        return quantize_activations(layer_norm(params, x, eps))
    return kernels.layer_norm_quant(x, params["scale"], params["bias"], eps)


def _gelu_in_dtype(x: torch.Tensor, approx: bool) -> torch.Tensor:
    """jax.nn.gelu as the reference's unfused path computes it: its formula
    and constants in x.dtype, each op rounded to x.dtype (torch rounds a
    bf16 op's fp32 result once, as XLA's CPU backend does)."""
    const = lambda c: torch.tensor(c, dtype=x.dtype).item()  # noqa: E731
    if approx:
        cube = x * x * x
        inner = torch.tanh(const((2 / math.pi) ** 0.5) * (x + const(0.044715) * cube))
        return x * (0.5 * (1.0 + inner))
    return 0.5 * x * torch.special.erfc(-x * const(0.5 ** 0.5))


def gelu_quant(x: torch.Tensor, *, approx: bool = False
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused GELU -> per-row int8 (kernel #10), erf or tanh form; beyond
    ``row_quant_fused``, as the reference, GELU in x.dtype then
    quantize_activations, plain torch on either device."""
    if not row_quant_fused(x.shape):
        return quantize_activations(_gelu_in_dtype(x, approx))
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


# ---------------------------------------------------------------------------
# epilogue-carried LayerNorm (kernel #11): in the static-int8 block every
# LayerNorm directly follows a residual add whose delta comes from an int8
# matmul (proj -> norm2, fc2 -> the next block's norm1), so the chain
#   s8 dot -> scales -> + bias -> + residual -> LayerNorm -> static int8
# is one kernel with two outputs: the new residual stream and the int8 input
# of the next matmul
# ---------------------------------------------------------------------------

def quant_matmul_res_ln_static(hq: torch.Tensor, hs, params_q: Dict, x_prev: torch.Tensor,
                               ln_params: Dict, out_scale, eps: float = 1e-6
                               ) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
    """x_new = x_prev + linear(hq * hs) and yq = static int8 of
    LayerNorm(x_new) with scale ``out_scale``, in one kernel. hq: (B, S, K)
    int8; hs: per-row (B, S, 1) fp32 or a scalar; params_q: {'w_q', 'w_scale',
    'b'?}; x_prev: (B, S, N). Returns (x_new in x_prev's dtype, yq int8), or
    None where the reference's kernel declines the shape (no k-tile of K,
    N % 128, or S * N * 4 above 4 MiB). That is the reference's dispatch
    rule, kept so that a shape goes the same way in both packages. Its other
    clause, that no kernel mesh of more than one shard be active, is a need
    of its shard_map wrapper and is not kept: under a mesh each rank runs the
    kernel on its own rows (``ops/spmd.py``). The scales stay device tensors:
    nothing here waits for the card."""
    b, s, k = hq.shape
    n = params_q["w_q"].shape[1]
    if _pick_tile(k, 2048) == 0 or n % 128 or s * n * 4 > 4 * 1024 * 1024:
        return None
    hs = torch.as_tensor(hs, dtype=torch.float32, device=hq.device)
    out_scale = torch.as_tensor(out_scale, dtype=torch.float32, device=hq.device)
    return kernels.qmm_res_ln(hq, hs, params_q["w_q"], params_q["w_scale"], params_q.get("b"),
                              x_prev, ln_params["scale"], ln_params["bias"], out_scale, eps)


def quant_matmul_res_ln_static_reference(hq: torch.Tensor, hs, params_q: Dict,
                                         x_prev: torch.Tensor, ln_params: Dict, out_scale,
                                         eps: float = 1e-6) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's XLA ground truth for the fused kernel: its math with
    the fp32 residual add, but dividing by ``out_scale`` where the kernel
    multiplies by its reciprocal, so codes may sit one step apart."""
    y = _int8_dot(hq, params_q["w_q"])
    y = y * torch.as_tensor(hs, dtype=torch.float32, device=hq.device) * params_q["w_scale"].float()
    if "b" in params_q:
        y = y + params_q["b"].float()
    xn = x_prev.float() + y
    mean = xn.mean(dim=-1, keepdim=True)
    var = (xn - mean).square().mean(dim=-1, keepdim=True)
    z = (xn - mean) * torch.rsqrt(var + eps)
    z = z * ln_params["scale"].float() + ln_params["bias"].float()
    yq = torch.clamp(torch.round(z / torch.as_tensor(out_scale, dtype=torch.float32,
                                                    device=hq.device)), -127, 127)
    return xn.to(x_prev.dtype), yq.to(torch.int8)


# ---------------------------------------------------------------------------
# the reference's fused dynamic-quant matmul (kernel #8): activations
# quantized per (row, k-block); no model calls it, in either package
# ---------------------------------------------------------------------------

# per-row symmetric int8 of one k-block of fp32 rows: (S, bk) -> (int8, (S, 1))
_quant_block = quantize_activations


def quant_matmul_pallas(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor
                        ) -> Optional[torch.Tensor]:
    """Dynamic W8A8 with per-(row, k-block) activation quantization (kernel
    #8; the reference's name): x (B, S, K) bf16 or fp32, w_q (K, N) int8,
    w_scale (N,) -> (B, S, N) in x's dtype, or None where the reference's
    tiling declines the shape (no k-tile of K up to 2048, or no n-tile of N
    up to 1536)."""
    k, n = x.shape[-1], w_q.shape[1]
    bk = _pick_tile(k, 2048)
    if bk == 0 or _pick_tile(n, 1536) == 0:
        return None
    return kernels.quant_matmul_blockwise(x, w_q, w_scale, bk)


def quant_matmul_pallas_reference(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
                                  bk: Optional[int] = None) -> torch.Tensor:
    """The kernel's exact math (same blockwise quantization, same
    accumulation order) in plain torch: the ground truth of the tests."""
    bk = bk or _pick_tile(x.shape[-1], 2048) or x.shape[-1]
    return kernels.quant_matmul_blockwise_plain(x, w_q, w_scale, bk)


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


# ---------------------------------------------------------------------------
# W4A16: int4 weight storage with bf16 compute
# ---------------------------------------------------------------------------

def _pick_tile(dim: int, preferred: int) -> int:
    """Largest 128-multiple divisor of ``dim`` that is <= preferred, or the
    whole dim; 0 if neither exists."""
    if dim <= preferred:
        return dim
    for cand in range(preferred, 127, -128):
        if cand % 128 == 0 and dim % cand == 0:
            return cand
    return 0


def _w4_tiles(k2: int, n: int) -> Optional[Tuple[int, int]]:
    """The reference's TPU tiling rule (bk, bn) for a (k2, N) packed weight,
    or None. Here it is a STORAGE rule only: it decides how far conversion
    K-pads the packed array (``_w4_padded_k2``), never which kernel runs."""
    bn = _pick_tile(n, 512)
    if bn == 0:
        return None
    for bk in (2048, 1408, 1024, 512, 256):
        if k2 % bk == 0 and 2 * bk * bn * 4 <= 9 * 1024 * 1024:
            return bk, bn
    return None


def _w4_padded_k2(k2: int, n: int) -> int:
    """Stored half-K of a per-channel packed weight: k2 when it tiles, else
    the next 512-multiple when that tiles (Vicuna-7B down: 5504 -> 5632),
    else k2 unpadded."""
    if _w4_tiles(k2, n):
        return k2
    k2p = -(-k2 // 512) * 512
    return k2p if _w4_tiles(k2p, n) else k2


def quantize_weights_int4(w: torch.Tensor, group: Optional[int] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """w (K, N) -> (packed int8 (K/2, N), scales fp32 (N,) or (K//group, N)).
    Symmetric codes in [-7, 7] (-8 unused), round half to even."""
    k, n = w.shape
    if k % 2:
        raise ValueError(f"int4 packing needs an even K, got {k}")
    wf = w.float()
    if group is None:
        amax = wf.abs().amax(dim=0)
        scale = torch.where(amax == 0.0, torch.ones_like(amax), amax / 7.0)
        q = torch.clamp(torch.round(wf / scale), -7, 7).to(torch.int8)
    else:
        if k % group or (k // 2) % group:
            raise ValueError(f"group {group} must divide K ({k}) and K/2")
        gview = wf.reshape(k // group, group, n)
        amax = gview.abs().amax(dim=1)
        scale = torch.where(amax == 0.0, torch.ones_like(amax), amax / 7.0)
        q = torch.clamp(torch.round(gview / scale[:, None]), -7, 7).to(torch.int8).reshape(k, n)
    top, bottom = q[: k // 2], q[k // 2:]
    return (top & 0x0F) | (bottom << 4), scale


def _unpack_int4(packed: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(K/2, N) int8 -> (top codes, bottom codes), each (K/2, N) int8."""
    return (packed << 4) >> 4, packed >> 4


def w4_matmul(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """x (..., K) @ int4-packed (K/2 or more, N) -> (..., N) in x.dtype, in
    plain torch (the reference's XLA path). Per-channel scales fold into the
    fp32 epilogue, which is kernel #12's plain version; per-group scales
    multiply the dequantized bf16 weights."""
    if scale.dim() == 1:
        return kernels.w4a16_matmul_plain(x, packed, scale)
    k2, n = packed.shape
    if x.shape[-1] // 2 != k2:
        raise ValueError("per-group scales cannot be K-padded")
    top, bottom = _unpack_int4(packed)
    xt = x[..., :k2].to(torch.bfloat16)
    xb = x[..., k2:].to(torch.bfloat16)
    g = 2 * k2 // scale.shape[0]
    gt = scale[: k2 // g].to(torch.bfloat16)
    gb = scale[k2 // g:].to(torch.bfloat16)
    wt = (top.reshape(k2 // g, g, n).to(torch.bfloat16) * gt[:, None]).reshape(k2, n)
    wb = (bottom.reshape(k2 // g, g, n).to(torch.bfloat16) * gb[:, None]).reshape(k2, n)
    return (matmul_f32(xt, wt) + matmul_f32(xb, wb)).to(x.dtype)


def quantize_linear_params_int4(params: Dict, group: Optional[int] = None,
                                free_dense: bool = False) -> Dict:
    """{'w': (K, N), 'b'?} -> {'w4', 'w4_scale', 'b'?} (see w4_linear).
    Per-channel packed weights are K-padded with zero rows by
    ``_w4_padded_k2``, as the reference pads them."""
    packed, scale = quantize_weights_int4(params["w"], group)
    if group is None:
        k2, n = packed.shape
        k2p = _w4_padded_k2(k2, n)
        if k2p != k2:
            packed = torch.cat([packed, packed.new_zeros((k2p - k2, n))])
    out = {"w4": packed, "w4_scale": scale}
    if params.get("b") is not None:
        out["b"] = params["b"]
    if free_dense:
        del params["w"]
    return out


def w4_linear(params: Dict, x: torch.Tensor) -> torch.Tensor:
    """Drop-in for ops.layers.linear on int4-packed params. Per-channel
    scales run the W4A16 kernel (#12) on a CUDA tensor and its plain version
    on a CPU one; per-group scales run ``w4_matmul``. The bias is added in
    the output dtype."""
    scale = params["w4_scale"]
    if scale.dim() == 1:
        out = kernels.w4a16_matmul(x, params["w4"], scale)
    else:
        out = w4_matmul(x, params["w4"], scale)
    if "b" in params:
        out = out + params["b"].to(out.dtype)
    return out
