"""PyTorch port, the packed-qkv kernels (#1, #2, #3) at every width the
reference's feasibility rule admits, on the CPU.

The JAX package runs its packed kernels wherever ``_packed_qkv_feasible``
holds (S < 1024 and the on-chip working set), whatever the head_dim and
H*D are; the port's wrappers take the same shapes on the card: head_dim a
multiple of 8 up to 128 in the tile loops, every other head_dim in the
"any" form, and rows of any H*D (the row-quant pass of #2 and #3 reads a
row too wide for a block's shared memory from device memory twice). Here
the plain versions the wrappers run on the CPU are held to the JAX Pallas
kernels in interpret mode at head_dim 128, at H*D = 98 x 128 = 12544, above
the 12288 a row block held, and (#3) at head_dim 13, 20, 36 and 136, and a
property test holds the wrappers' shape rule to the reference's
feasibility rule.

Tolerances: fp32 outputs within 1e-5 absolute (summation order); int8 codes
at most one step apart (an fp32 value on a rounding boundary may round
either way) with scales within 1e-5 relative."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import assume, given, settings
from hypothesis import strategies as st

from stllm_tpu.ops import attention as jattn
from stllm_tpu_torch.ops import attention as tattn
from stllm_tpu_torch.ops import kernels

ATOL, SCALE_RTOL = 1e-5, 1e-5


def _codes_close(got, want):
    (gq, gs), (wq, ws) = got, want
    wq, ws = np.asarray(wq), np.asarray(ws)
    assert gq.dtype == torch.int8 and tuple(gq.shape) == wq.shape
    assert tuple(gs.shape) == ws.shape
    assert int(np.abs(gq.numpy().astype(np.int32) - wq.astype(np.int32)).max()) <= 1
    np.testing.assert_allclose(gs.numpy(), ws, rtol=SCALE_RTOL, atol=0)


def _s8_inputs(seed, b, s, h, d):
    rng = np.random.default_rng(seed)
    return (rng.integers(-127, 128, (b, s, 3 * h * d)).astype(np.int8),
            np.array([0.01, 0.012, 0.008], np.float32))


@pytest.mark.parametrize("shape", [(1, 8, 2, 128), (1, 8, 98, 128)],
                         ids=["head_dim-128", "row-12544"])
def test_packed_s8_plain_matches_jax_at_wide_shapes(shape):
    """#3's plain version (what the wrapper runs on the CPU, and what the
    card's kernel is held to) against fused_qkv_attention_quant_static run
    as its Pallas kernel in interpret mode."""
    b, s, h, d = shape
    assert kernels.packed_shape_ok(b, s, h, d, torch.int8)
    qkv_q, sc = _s8_inputs(70, b, s, h, d)
    jq, js = jattn.fused_qkv_attention_quant_static(
        jnp.asarray(qkv_q), *map(jnp.asarray, sc), h, d, interpret=True)
    got = tattn.fused_qkv_attention_quant_static(torch.from_numpy(qkv_q), torch.from_numpy(sc),
                                                 h, d)
    assert got is not None
    _codes_close(got, (jq, js))


@pytest.mark.parametrize("shape", [(1, 9, 2, 20), (2, 17, 3, 36), (1, 8, 2, 136), (1, 11, 3, 13),
                                   (2, 6, 5, 13)],
                         ids=["head_dim-20", "head_dim-36", "head_dim-136", "head_dim-13",
                              "odd-H*D-65"])
def test_packed_s8_plain_matches_jax_at_any_head_dim(shape):
    """#3's plain version (the "any" form's function on the card) against
    fused_qkv_attention_quant_static in interpret mode at head_dims the tile
    loop does not take, H*D 40, 108, 272, 39 and 65."""
    b, s, h, d = shape
    assert kernels.packed_form(d) == "any" and kernels.packed_shape_ok(b, s, h, d, torch.int8)
    qkv_q, sc = _s8_inputs(72, b, s, h, d)
    jq, js = jattn.fused_qkv_attention_quant_static(
        jnp.asarray(qkv_q), *map(jnp.asarray, sc), h, d, interpret=True)
    got = tattn.fused_qkv_attention_quant_static(torch.from_numpy(qkv_q), torch.from_numpy(sc),
                                                 h, d)
    assert got is not None
    _codes_close(got, (jq, js))


@pytest.mark.parametrize("shape", [(1, 8, 98, 128), (2, 5, 100, 128)])
def test_packed_bf16_and_quant_match_jax_above_12288(shape):
    """#1 and #2 at H*D above 12288 (the row width the port's wrappers
    refused before), as the JAX package's own tests run its packed kernels:
    interpret mode, fp32 qkv."""
    b, s, h, d = shape
    assert h * d > kernels.MAX_ROW
    rng = np.random.default_rng(71)
    qkv = rng.standard_normal((b, s, 3 * h * d)).astype(np.float32)
    t = torch.from_numpy(qkv)
    assert tattn._packed_kernel_runs(t, h, d)
    assert kernels.packed_shape_ok(b, s, h, d, torch.bfloat16)
    assert kernels.packed_shape_ok(b, s, h, d, torch.float32)
    want = np.asarray(jattn.fused_qkv_attention(jnp.asarray(qkv), h, d, interpret=True))
    np.testing.assert_allclose(tattn.fused_qkv_attention(t, h, d).numpy(), want, atol=ATOL,
                               rtol=0)
    _codes_close(tattn.fused_qkv_attention_quant(t, h, d),
                 jattn.fused_qkv_attention_quant(jnp.asarray(qkv), h, d, interpret=True))


@settings(max_examples=400, deadline=None)
@given(b=st.integers(1, 1024), s=st.integers(1, 1023), head_dim=st.integers(1, 256),
       dtype=st.sampled_from([torch.int8, torch.bfloat16, torch.float32]), data=st.data())
def test_wrapper_shape_rule_takes_every_feasible_shape(b, s, head_dim, dtype, data):
    """Every shape (head_dim 1-256) that the reference's feasibility rule
    admits passes the wrappers' shape rule, in the tile loops or the "any"
    form, so a call the dispatch sends to a kernel never raises for its
    shape on the card; batches up to 1024 sequences, heads up to the most
    the rule admits at (S, head_dim)."""
    itemsize = torch.empty(0, dtype=dtype).element_size()
    budget = 10 * 1024 * 1024 - 4 * s * s          # the rule's working set, per H*D column
    most = budget // (s * (6 * itemsize + 4)) // head_dim
    assume(most >= 1)
    heads = data.draw(st.integers(1, most), label="heads")
    assert jattn._packed_qkv_feasible(s, heads, head_dim, itemsize)
    assert kernels.packed_shape_ok(b, s, heads, head_dim, dtype)
    if dtype != torch.int8:
        meta = torch.empty((b, s, 3 * heads * head_dim), dtype=dtype, device="meta")
        assert tattn._packed_kernel_runs(meta, heads, head_dim)
    # one head more is where the reference stops running its kernel
    assert not jattn._packed_qkv_feasible(s, (most + 1), head_dim, itemsize)


@pytest.mark.parametrize("head_dim", [20, 136, 13, 0])
def test_wrapper_shape_rule_keeps_the_head_dim_limits(head_dim):
    """The one head_dim limit left is head_dim >= 1: not a multiple of 8, or
    above 128, is taken by the "any" form; 0 is refused."""
    for dtype in (torch.int8, torch.bfloat16, torch.float32):
        assert kernels.packed_shape_ok(1, 16, 2, head_dim, dtype) == (head_dim > 0)
