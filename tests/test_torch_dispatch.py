"""PyTorch port, the packed-qkv attention's dispatch rule against the JAX
package: where the reference's ``_packed_qkv_feasible`` fails (S >= 1024, or
a working set over 10 MiB), both packages run the max-subtracted softmax of
``mha_reference`` and not the clamped, no-max kernel math;
``fused_qkv_attention_quant`` then quantizes those rows per row. The JAX
functions run there without ``interpret``, so on the CPU they take that
reference path at every shape, and the shapes here are the ones where the
port must take it too. Where the rule holds, both run the kernel math at
every head_dim (not a multiple of 8, or above 128, included: the port's
"any" form), held here to the JAX Pallas kernels in interpret mode.

Tolerances: fp32, 1e-5 absolute (summation order); int8 codes at most one
step apart (an fp32 value at a rounding boundary may round either way) with
scales within 1e-5 relative."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stllm_tpu.ops import attention as jattn
from stllm_tpu_torch.ops import attention as tattn
from stllm_tpu_torch.ops import kernels

ATOL = 1e-5


def _qkv(seed, b, s, h, d, qk_scale):
    """Packed fp32 qkv whose q and k are scaled by ``qk_scale``."""
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((b, s, 3 * h * d)).astype(np.float32)
    qkv[..., :2 * h * d] *= qk_scale
    return qkv


def _scaled_scores(qkv, h, d):
    """q . k^T * scale * log2(e), the kernel math's exp2 argument."""
    b, s, _ = qkv.shape
    q = qkv[..., :h * d].reshape(b, s, h, d)
    k = qkv[..., h * d:2 * h * d].reshape(b, s, h, d)
    return np.einsum("bqhd,bkhd->bhqk", q, k) * d ** -0.5 * np.log2(np.e)


def _check_quant(got, want):
    (gq, gs), (wq, ws) = got, want
    wq, ws = np.asarray(wq), np.asarray(ws)
    assert gq.dtype == torch.int8 and tuple(gq.shape) == wq.shape
    assert tuple(gs.shape) == ws.shape
    assert int(np.abs(gq.numpy().astype(np.int32) - wq.astype(np.int32)).max()) <= 1
    np.testing.assert_allclose(gs.numpy(), ws, rtol=1e-5, atol=0)


# (B, S, H, D, q and k scale, which clause of the rule fails)
CASES = [
    (1, 1024, 2, 8, 5.0, "S >= 1024"),
    (1, 490, 8, 88, 1.5, "10 MiB working set"),
]
# (B, S, H, D, q and k scale, what the head_dim is): shapes the rule admits
# whose head_dim the tile loops do not take
KERNEL_MATH_CASES = [
    (2, 40, 1, 136, 1.0, "head_dim above the tile loops' 128"),
    (1, 33, 2, 20, 1.0, "head_dim not a multiple of 8"),
    (2, 21, 3, 13, 1.0, "odd head_dim and H*D"),
    (1, 18, 3, 36, 1.0, "head_dim 36, H*D 108"),
]


@pytest.mark.parametrize("case", CASES, ids=[c[-1] for c in CASES])
def test_fused_qkv_attention_takes_the_reference_path(case):
    b, s, h, d, qk_scale, _ = case
    qkv = _qkv(60, b, s, h, d, qk_scale)
    want = np.asarray(jattn.fused_qkv_attention(jnp.asarray(qkv), h, d))
    t = torch.from_numpy(qkv)
    before = dict(kernels.LAUNCHES)
    got = tattn.fused_qkv_attention(t, h, d)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    _check_quant(tattn.fused_qkv_attention_quant(t, h, d),
                 jattn.fused_qkv_attention_quant(jnp.asarray(qkv), h, d))
    assert kernels.LAUNCHES == before
    assert not tattn._packed_kernel_runs(t, h, d)


@pytest.mark.parametrize("case", KERNEL_MATH_CASES, ids=[c[-1] for c in KERNEL_MATH_CASES])
def test_fused_qkv_attention_runs_the_kernel_math_at_any_head_dim(case):
    b, s, h, d, qk_scale, _ = case
    qkv = _qkv(63, b, s, h, d, qk_scale)
    t = torch.from_numpy(qkv)
    assert tattn._packed_kernel_runs(t, h, d) and kernels.packed_form(d) == "any"
    want = np.asarray(jattn.fused_qkv_attention(jnp.asarray(qkv), h, d, interpret=True))
    np.testing.assert_allclose(tattn.fused_qkv_attention(t, h, d).numpy(), want, atol=ATOL,
                               rtol=0)
    _check_quant(tattn.fused_qkv_attention_quant(t, h, d),
                 jattn.fused_qkv_attention_quant(jnp.asarray(qkv), h, d, interpret=True))


def test_reference_path_rule_clauses():
    """Each case above fails exactly the clause it names; one step inside
    each clause the kernel runs."""
    four = torch.zeros(1, 1, 1)
    assert not tattn.packed_qkv_feasible(1024, 2, 8, 4)
    assert tattn.packed_qkv_feasible(1023, 2, 8, 4)
    assert not tattn.packed_qkv_feasible(490, 8, 88, 4)
    assert tattn.packed_qkv_feasible(400, 8, 88, 4)
    # at ViT-g width in bf16 the 10 MiB clause fails from S = 433 on
    assert tattn.packed_qkv_feasible(432, 16, 88, 2)
    assert not tattn.packed_qkv_feasible(433, 16, 88, 2)
    assert tattn._packed_kernel_runs(four.new_zeros(1, 40, 3 * 128), 1, 128)
    assert tattn._packed_kernel_runs(four.new_zeros(1, 40, 3 * 136), 1, 136)
    assert tattn._packed_kernel_runs(four.new_zeros(1, 33, 3 * 2 * 24), 2, 24)
    assert tattn._packed_kernel_runs(four.new_zeros(1, 33, 3 * 2 * 20), 2, 20)
    assert not tattn._packed_kernel_runs(four.new_zeros(1, 1024, 3 * 2 * 20), 2, 20)


def test_kernel_math_departs_from_the_reference_past_the_clamp():
    """Why the rule matters: at the S = 1024 case the scores pass the clamp
    at 50, where the clamped no-max softmax (what the port ran before the
    rule, and what the kernels compute) weighs all such keys alike; it
    lands far outside the tolerance of the reference's softmax."""
    b, s, h, d, qk_scale, _ = CASES[0]
    qkv = _qkv(60, b, s, h, d, qk_scale)
    assert float(_scaled_scores(qkv, h, d).max()) > 2 * kernels._EXP2_CLAMP
    want = np.asarray(jattn.fused_qkv_attention(jnp.asarray(qkv), h, d))
    clamped = kernels.packed_qkv_attention_plain(torch.from_numpy(qkv), h, d, d ** -0.5)
    assert float(np.abs(clamped.numpy() - want).max()) > 1e3 * ATOL
    q, s_ = kernels.packed_qkv_attention_quant_plain(torch.from_numpy(qkv), h, d, d ** -0.5)
    wq, _ = jattn.fused_qkv_attention_quant(jnp.asarray(qkv), h, d)
    assert int(np.abs(q.numpy().astype(np.int32) - np.asarray(wq).astype(np.int32)).max()) > 1


def _grad_against_reference_vjp(case):
    b, s, h, d, qk_scale, _ = case
    qkv = torch.from_numpy(_qkv(61, b, s, h, d, qk_scale)).requires_grad_()
    g = torch.from_numpy(np.random.default_rng(62).standard_normal((b, s, h * d))
                         .astype(np.float32))
    (got,) = torch.autograd.grad(tattn.fused_qkv_attention(qkv, h, d), qkv, g)
    ref = qkv.detach().clone().requires_grad_()
    (want,) = torch.autograd.grad(tattn._packed_reference(ref, h, d, d ** -0.5), ref, g)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=0)


def test_reference_path_is_differentiable():
    """The reference path keeps the plain softmax's gradient."""
    assert not tattn._packed_kernel_runs(torch.zeros(1, CASES[1][1], 3 * 8 * 88), 8, 88)
    _grad_against_reference_vjp(CASES[1])


def test_kernel_path_gradient_is_the_recomputed_reference_vjp():
    """At head_dim 136 (the "any" form) the kernel path's backward is the
    reference's: the vjp of the plain-softmax reference, recomputed."""
    _grad_against_reference_vjp(KERNEL_MATH_CASES[0])
