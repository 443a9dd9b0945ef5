"""PyTorch port, int8 ops (stllm_tpu_torch/ops/quant.py, the int8 attention
entry points of ops/attention.py, and the plain versions of the int8
kernels in ops/kernels.py) against the JAX package, on the same numpy
inputs, in fp32.

Tolerances: int8 codes equal, or at most one step apart in fewer than 0.1%
of the elements where the two packages compute the value before rounding in
another order (summation order, erf/tanh/rsqrt implementations): an fp32
value that lands on a rounding boundary may round either way, and the code
then moves by one step. Float outputs within 1e-5 relative, a few fp32 ulps.
The JAX side of each int8 kernel runs its Pallas kernel in interpret mode,
as the JAX package's own tests run it on the CPU."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import example, given, settings
from hypothesis import strategies as st

from stllm_tpu.ops import attention as jattn
from stllm_tpu.ops import layers as jlayers
from stllm_tpu.ops import quant as jquant
from stllm_tpu_torch.convert.from_jax import load_jax_params
from stllm_tpu_torch.ops import attention as tattn
from stllm_tpu_torch.ops import kernels
from stllm_tpu_torch.ops import layers as tlayers
from stllm_tpu_torch.ops import quant as tquant

RTOL = 1e-5


def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _codes_close(got, want, exact=False):
    got, want = np.asarray(got).astype(np.int32), np.asarray(want).astype(np.int32)
    assert got.shape == want.shape
    diff = np.abs(got - want)
    if exact:
        assert diff.max() == 0
    else:
        assert diff.max() <= 1 and (diff > 0).mean() < 1e-3, (diff.max(), (diff > 0).mean())


def _float_close(got, want, rtol=RTOL, atol=1e-7):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=rtol, atol=atol)


def _lin(seed, k, n, bias=True):
    p = {"w": _rand(seed, k, n, scale=0.1)}
    p["w"][:, 3] = 0.0                       # an all-zero channel: scale 1
    if bias:
        p["b"] = _rand(seed + 1, n, scale=0.1)
    return p


# --------------------------------------------------------------------------
# weights, activations, the int8 product
# --------------------------------------------------------------------------

def test_quantize_weights_and_activations_match_jax():
    w = _lin(0, 96, 40)["w"]
    jq, js = jquant.quantize_weights(jnp.asarray(w))
    tq, ts = tquant.quantize_weights(_t(w))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    _codes_close(tq, jq, exact=True)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    x = _rand(1, 3, 7, 96)
    x[0, 2] = 0.0                            # an all-zero row: scale 1
    jq, js = jquant.quantize_activations(jnp.asarray(x))
    tq, ts = tquant.quantize_activations(_t(x))
    _codes_close(tq, jq, exact=True)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert ts.shape == (3, 7, 1) and float(ts[0, 2, 0]) == 1.0


def test_int8_dot_accumulates_in_int32_like_jax():
    rng = np.random.default_rng(2)
    x = rng.integers(-127, 128, (2, 5, 512)).astype(np.int8)
    w = rng.integers(-127, 128, (512, 24)).astype(np.int8)
    want = jquant._int8_dot(jnp.asarray(x), jnp.asarray(w))
    got = tquant._int8_dot(_t(x), _t(w))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    exact = (x.astype(np.int64).reshape(-1, 512) @ w.astype(np.int64)).reshape(2, 5, 24)
    np.testing.assert_array_equal(got.numpy(), exact.astype(np.float32))


@pytest.mark.parametrize("bias", [True, False])
def test_quant_linear_and_matmul_match_jax(bias):
    p = _lin(3, 64, 48, bias)
    jp = jquant.quantize_linear_params({k: jnp.asarray(v) for k, v in p.items()})
    tp = tquant.quantize_linear_params({k: _t(v) for k, v in p.items()})
    assert sorted(tp) == sorted(jp)
    _codes_close(tp["w_q"], jp["w_q"], exact=True)
    x = _rand(4, 2, 9, 64)
    want = jquant.quant_linear(jp, jnp.asarray(x))
    got = tquant.quant_linear(tp, _t(x))
    _float_close(got, want)
    # ops.layers.linear dispatches on the key, as the JAX linear does
    np.testing.assert_array_equal(tlayers.linear(tp, _t(x)).numpy(), got.numpy())
    _float_close(tquant.quant_matmul(_t(x), tp["w_q"], tp["w_scale"]),
                 jquant.quant_matmul(jnp.asarray(x), jp["w_q"], jp["w_scale"]))
    xq, xs = jquant.quantize_activations(jnp.asarray(x))
    _float_close(tquant.quant_matmul_pre(_t(xq), _t(xs), tp, torch.float32),
                 jquant.quant_matmul_pre(xq, xs, jp, jnp.float32))


def test_quantize_linear_params_free_dense_drops_the_weight():
    p = {k: _t(v) for k, v in _lin(5, 16, 8).items()}
    q = tquant.quantize_linear_params(p, free_dense=True)
    assert "w" not in p and sorted(q) == ["b", "w_q", "w_scale"]


@pytest.mark.parametrize("form", ["w_q16", "w4"])
def test_weight_only_and_int4_linears_match_jax(form):
    """ops.layers.linear dispatches the weight-only int8 (``w_q16``) and
    the int4 (``w4``) forms as the JAX linear does, bias included."""
    p = {k: jnp.asarray(v) for k, v in _lin(24, 64, 48).items()}
    if form == "w_q16":
        jp = jquant.quantize_linear_params(p)
        jp["w_q16"] = jp.pop("w_q")
    else:
        jp = jquant.quantize_linear_params_int4(p)
    tp = load_jax_params(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    x = _rand(25, 3, 64)
    _float_close(tlayers.linear(tp, _t(x)), jlayers.linear(jp, jnp.asarray(x)))


def test_quantize_tree_linears_matches_jax():
    tree = {"a": _lin(6, 16, 8), "norm": {"scale": _rand(7, 16), "bias": _rand(8, 16)},
            "layers": [{"fc": _lin(9, 8, 8, bias=False), "emb": _rand(10, 5, 8)}]}
    jt = jquant.quantize_tree_linears(jax.tree_util.tree_map(jnp.asarray, tree))
    tt = tquant.quantize_tree_linears(jax.tree_util.tree_map(_t, tree))
    jl, jdef = jax.tree_util.tree_flatten_with_path(jt)
    tl, tdef = jax.tree_util.tree_flatten_with_path(tt)
    assert jdef == tdef
    for (path, a), (_, b) in zip(jl, tl):
        assert np.dtype(a.dtype).name == str(b.dtype).replace("torch.", ""), path
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


# --------------------------------------------------------------------------
# static (calibrated) primitives
# --------------------------------------------------------------------------

def test_quantize_static_matches_jax():
    x = _rand(11, 4, 9, 48, scale=2.0)
    for scale in (np.float32(0.01), np.float32(0.02) * (1 + np.arange(48, dtype=np.float32))):
        want = jquant.quantize_static(jnp.asarray(x), jnp.asarray(scale))
        got = tquant.quantize_static(_t(x), _t(scale))
        _codes_close(got, want, exact=True)
    assert int(got.abs().max()) <= 127


def test_layer_norm_quant_static_matches_jax():
    x = _rand(12, 8, 33, 128, scale=3.0)
    p = {"scale": 1 + _rand(13, 128, scale=0.1), "bias": _rand(14, 128, scale=0.1)}
    s = np.float32(0.03)
    want = jquant.layer_norm_quant_static({k: jnp.asarray(v) for k, v in p.items()},
                                          jnp.asarray(x), jnp.asarray(s))
    got = tquant.layer_norm_quant_static({k: _t(v) for k, v in p.items()}, _t(x), _t(s))
    _codes_close(got, want)


@pytest.mark.parametrize("approx", [False, True])
def test_quant_mlp_static_matches_jax(approx):
    fc1, fc2 = _lin(15, 64, 128), _lin(17, 128, 64)
    j1, j2 = (jquant.quantize_linear_params({k: jnp.asarray(v) for k, v in p.items()})
              for p in (fc1, fc2))
    t1, t2 = (jax.tree_util.tree_map(_t, jax.tree_util.tree_map(np.asarray, p))
              for p in (j1, j2))
    hq = np.random.default_rng(19).integers(-127, 128, (4, 33, 64)).astype(np.int8)
    s_in, s_g = np.float32(0.02), np.float32(0.004)
    want = jquant.quant_fc1_gelu_static(jnp.asarray(hq), jnp.asarray(s_in), j1,
                                        jnp.asarray(s_g), approx=approx)
    got = tquant.quant_fc1_gelu_static(_t(hq), _t(s_in), t1, _t(s_g), approx=approx)
    _codes_close(got, want)
    want = jquant.quant_mlp_static(jnp.asarray(hq), jnp.asarray(s_in), j1, jnp.asarray(s_g),
                                   j2, jnp.float32, approx=approx)
    got = tquant.quant_mlp_static(_t(hq), _t(s_in), t1, _t(s_g), t2, torch.float32,
                                  approx=approx)
    # a flipped GELU code moves fc2's output by one step times one weight
    _float_close(got, want, rtol=1e-3, atol=1e-3)


# --------------------------------------------------------------------------
# producer-fused quantizers: plain versions of kernels #9 and #10
# --------------------------------------------------------------------------

def test_layer_norm_quant_plain_matches_jax_kernel():
    """Kernel #9's plain version against the JAX Pallas kernel (interpret
    mode on the CPU)."""
    x = _rand(20, 4, 37, 256, scale=2.0) + 0.5
    p = {"scale": 1 + _rand(21, 256, scale=0.1), "bias": _rand(22, 256, scale=0.1)}
    jq, js = jquant.layer_norm_quant({k: jnp.asarray(v) for k, v in p.items()},
                                     jnp.asarray(x), 1e-6)
    tq, ts = tquant.layer_norm_quant({k: _t(v) for k, v in p.items()}, _t(x), 1e-6)
    _codes_close(tq, jq)
    _float_close(ts, js)
    # the contract: quantize_activations of the fp32 LayerNorm
    rq, rs = tquant.quantize_activations(
        tlayers.layer_norm({k: _t(v) for k, v in p.items()}, _t(x)))
    _codes_close(tq, rq)


@pytest.mark.parametrize("approx", [False, True])
def test_gelu_quant_plain_matches_jax_kernel(approx):
    """Kernel #10's plain version against the JAX Pallas kernel (interpret
    mode on the CPU), both GELU forms."""
    x = _rand(23, 4, 37, 384, scale=2.0)
    jq, js = jquant.gelu_quant(jnp.asarray(x), approx=approx)
    tq, ts = tquant.gelu_quant(_t(x), approx=approx)
    _codes_close(tq, jq)
    _float_close(ts, js)
    want = jquant.quantize_activations(jax.nn.gelu(jnp.asarray(x), approximate=approx))
    _codes_close(tq, want[0])


def _bf16(x):
    """x rounded to bf16 once, as numpy fp32 (exact in both packages)."""
    return np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))


def _row_case(kernel, x, p, x_dtype, p_dtype):
    """#9 or #10 (erf, tanh) on the same values in both packages: x (and
    gamma, beta) cast to the named dtypes in each."""
    jx = jnp.asarray(x).astype(x_dtype)
    tx = _t(np.asarray(jx.astype(jnp.float32))).to(getattr(torch, jnp.dtype(x_dtype).name))
    if kernel == "layer_norm":
        jp = {k: jnp.asarray(v).astype(p_dtype) for k, v in p.items()}
        tp = {k: _t(np.asarray(v.astype(jnp.float32))).to(getattr(torch, jnp.dtype(p_dtype).name))
              for k, v in jp.items()}
        return jquant.layer_norm_quant(jp, jx, 1e-6), tquant.layer_norm_quant(tp, tx, 1e-6)
    approx = kernel == "gelu-tanh"
    return jquant.gelu_quant(jx, approx=approx), tquant.gelu_quant(tx, approx=approx)


def _row_params(seed, k):
    return {"scale": 1 + _rand(seed, k, scale=0.1), "bias": _rand(seed + 1, k, scale=0.1)}


@pytest.mark.parametrize("kernel", ["layer_norm", "gelu-erf", "gelu-tanh"])
def test_row_quant_past_the_reference_tile_budget_matches_jax(kernel):
    """Past the reference's 8 MiB fp32 (S, K) tile (S * K * 4 > 8 MiB),
    ``_rowwise_pallas`` declines and layer_norm_quant / gelu_quant run the
    unfused composition, which rounds the LayerNorm or GELU output to
    x.dtype before quantizing: at bf16 (1, 2049, 1024) the port follows it
    (quantizing the fp32 output instead moves some 5% of #9's codes and 3%
    of #10's by one step)."""
    x = _rand(30, 1, 2049, 1024, scale=2.0) + 0.5
    assert not tquant.row_quant_fused(x.shape)
    (jq, js), (tq, ts) = _row_case(kernel, x, _row_params(31, 1024), jnp.bfloat16, jnp.float32)
    _codes_close(tq, jq)
    _float_close(ts, js)


# (x dtype, gamma/beta dtype): fp32 throughout (an fp32 model), bf16 rows
# with the fp32 params ln_vision keeps, fp32 rows with bf16 params
ROW_DTYPES = [(jnp.float32, jnp.float32), (jnp.bfloat16, jnp.float32),
              (jnp.float32, jnp.bfloat16)]


@pytest.mark.parametrize("dtypes", ROW_DTYPES, ids=["fp32", "bf16-x", "bf16-params"])
@pytest.mark.parametrize("k", [13, 1412, 12287, 12296, 16384])
def test_layer_norm_quant_plain_matches_jax_kernel_at_any_width(k, dtypes):
    """#9's plain version (what the wrapper runs on the CPU and what the
    card's two forms are held to) against the Pallas kernel in interpret
    mode at widths neither of 8 (13, 1412; 12287, past the widest row the
    card's "any" form stages) nor under 12288 (12296, 16384), small S, each
    input type the kernel takes."""
    x = _rand(32, 2, 3, k, scale=2.0) + 0.5
    assert tquant.row_quant_fused(x.shape)
    (jq, js), (tq, ts) = _row_case("layer_norm", x, _row_params(33, k), *dtypes)
    _codes_close(tq, jq)
    _float_close(ts, js)


@pytest.mark.parametrize("x_dtype", [jnp.float32, jnp.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("kernel", ["gelu-erf", "gelu-tanh"])
@pytest.mark.parametrize("k", [13, 1412, 12287, 12296, 16384])
def test_gelu_quant_plain_matches_jax_kernel_at_any_width(k, kernel, x_dtype):
    """#10's plain version against the Pallas kernel in interpret mode, as
    #9's above."""
    x = _rand(34, 2, 3, k, scale=2.0)
    assert tquant.row_quant_fused(x.shape)
    (jq, js), (tq, ts) = _row_case(kernel, x, None, x_dtype, None)
    _codes_close(tq, jq)
    _float_close(ts, js)


def _reference_fuses(s, k):
    """Whether the reference's ``_rowwise_pallas`` runs its kernel on a
    (1, S, K) fp32 x, read from its traced result (no kernel runs)."""
    kernel = functools.partial(jquant._gelu_quant_kernel, approx=False)
    out = jax.eval_shape(lambda a: jquant._rowwise_pallas(kernel, a, [], True),
                         jax.ShapeDtypeStruct((1, s, k), jnp.float32))
    return out is not None


@settings(max_examples=60, deadline=None)
@given(st.integers(1, 9000), st.integers(1, 20000))
@example(2048, 1024)
@example(2049, 1024)
@example(257, 6144)
@example(1, 2 * 1024 * 1024 + 1)
def test_row_quant_route_rule_matches_reference(s, k):
    """The port's tile rule and ``_rowwise_pallas``'s agree on (S, K)."""
    assert tquant.row_quant_fused((1, s, k)) == _reference_fuses(s, k)


# --------------------------------------------------------------------------
# int8 packed attention: plain versions of kernels #2 and #3
# --------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 29, 4, 16), (1, 37, 2, 88)])
def test_packed_quant_plain_matches_jax_kernel(shape):
    """Kernel #2's plain version against fused_qkv_attention_quant run as
    its Pallas kernel in interpret mode."""
    b, s, h, d = shape
    qkv = _rand(30, b, s, 3 * h * d)
    jq, js = jattn.fused_qkv_attention_quant(jnp.asarray(qkv), h, d, interpret=True)
    tq, ts = tattn.fused_qkv_attention_quant(_t(qkv), h, d)
    assert tq.shape == (b, s, h * d) and ts.shape == (b, s, 1)
    _codes_close(tq, jq)
    _float_close(ts, js)
    np.testing.assert_array_equal(
        tq.numpy(), kernels.packed_qkv_attention_quant_plain(_t(qkv), h, d, d ** -0.5)[0].numpy())


def _s8_inputs(seed, b, s, h, d):
    rng = np.random.default_rng(seed)
    return (rng.integers(-127, 128, (b, s, 3 * h * d)).astype(np.int8),
            np.array([0.01, 0.012, 0.008], np.float32))


@pytest.mark.parametrize("int8_dot", [True, False])
@pytest.mark.parametrize("shape", [(2, 33, 4, 24), (1, 19, 2, 88)])
def test_packed_s8_plain_matches_jax_kernel(shape, int8_dot):
    """Kernel #3's plain version against fused_qkv_attention_quant_static
    run as its Pallas kernel in interpret mode, for both q.k^T forms; the
    port gives the same numbers for both."""
    b, s, h, d = shape
    qkv_q, sc = _s8_inputs(31, b, s, h, d)
    jsc = [jnp.asarray(v) for v in sc]
    jq, js = jattn.fused_qkv_attention_quant_static(jnp.asarray(qkv_q), *jsc, h, d,
                                                    int8_dot=int8_dot, interpret=True)
    got = tattn.fused_qkv_attention_quant_static(_t(qkv_q), _t(sc), h, d, int8_dot=int8_dot)
    assert got is not None
    tq, ts = got
    _codes_close(tq, jq)
    _float_close(ts, js)
    other = tattn.fused_qkv_attention_quant_static(_t(qkv_q), _t(sc), h, d,
                                                   int8_dot=not int8_dot)
    np.testing.assert_array_equal(other[0].numpy(), tq.numpy())


def test_packed_s8_declines_long_sequences_like_jax():
    qkv_q = np.zeros((1, 1100, 48), np.int8)
    sc = np.full(3, 0.01, np.float32)
    assert jattn.fused_qkv_attention_quant_static(jnp.asarray(qkv_q), 0.01, 0.01, 0.01,
                                                  2, 8) is None
    assert tattn.fused_qkv_attention_quant_static(_t(qkv_q), _t(sc), 2, 8) is None
    ok = np.zeros((1, 1023, 48), np.int8)
    assert tattn.fused_qkv_attention_quant_static(_t(ok), _t(sc), 2, 8) is not None
    assert tattn.packed_qkv_feasible(1023, 2, 8, 1) and not tattn.packed_qkv_feasible(1024, 2, 8, 1)


def test_packed_s8_zero_rows_and_clamp():
    """A query whose logits all saturate keeps a finite scale; an all-zero
    v third gives zero rows with scale 1, as the reference's guard does."""
    h, d = 1, 8
    qkv_q = np.zeros((1, 3, 3 * h * d), np.int8)
    qkv_q[0, :, :2 * d] = 127
    sc = np.array([1.0, 1.0, 0.5], np.float32)
    jq, js = jattn.fused_qkv_attention_quant_static(jnp.asarray(qkv_q), *map(jnp.asarray, sc),
                                                    h, d, interpret=True)
    tq, ts = tattn.fused_qkv_attention_quant_static(_t(qkv_q), _t(sc), h, d)
    _codes_close(tq, jq, exact=True)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert np.all(ts.numpy() == 1.0) and not tq.numpy().any()


# --------------------------------------------------------------------------
# converter
# --------------------------------------------------------------------------

def test_load_jax_params_carries_int8_trees():
    """A quantized, calibrated JAX tree converts leaf for leaf: int8 codes,
    fp32 weight scales, 0-d and (3,) activation scales."""
    jp = jquant.quantize_linear_params({"w": jnp.asarray(_rand(40, 16, 8)),
                                        "b": jnp.asarray(_rand(41, 8))})
    tree = {"fc": jp, "act_scales": {"qkv": jnp.float32(0.125) * jnp.float32(1.5),
                                     "attn": jnp.asarray([0.1, 0.2, 0.3], jnp.float32)}}
    np_tree = jax.tree_util.tree_map(np.asarray, tree)
    got = load_jax_params(np_tree, device="cpu")
    assert got["fc"]["w_q"].dtype == torch.int8 and got["fc"]["w_scale"].dtype == torch.float32
    assert got["act_scales"]["qkv"].shape == () and got["act_scales"]["attn"].shape == (3,)
    for path in (("fc", "w_q"), ("fc", "w_scale"), ("fc", "b"), ("act_scales", "qkv"),
                 ("act_scales", "attn")):
        a, b = np_tree[path[0]][path[1]], got[path[0]][path[1]]
        np.testing.assert_array_equal(b.numpy(), a)
    x = _rand(42, 3, 16)
    _float_close(tlayers.linear(got["fc"], _t(x)), jlayers.linear(jp, jnp.asarray(x)))
