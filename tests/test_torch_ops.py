"""PyTorch port, ops layer (stllm_tpu_torch/ops): the same numpy inputs go
through the JAX function and its port, in fp32 unless stated.

Tolerances: 1e-5 absolute for single fp32 ops (summation order and
transcendental implementations differ in the last ulps); the bf16 packed
attention case uses the bf16 attention tolerance of tests/test_ops.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stllm_tpu.ops import attention as jattn
from stllm_tpu.ops import layers as jlayers
from stllm_tpu.ops import rope as jrope
from stllm_tpu_torch.convert.from_jax import load_jax_params
from stllm_tpu_torch.models.llama import _write_at
from stllm_tpu_torch.ops import attention as tattn
from stllm_tpu_torch.ops import kernels
from stllm_tpu_torch.ops import layers as tlayers
from stllm_tpu_torch.ops import rope as trope

ATOL = 1e-5


def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _lin(seed, d_in, d_out, bias=True):
    p = {"w": _rand(seed, d_in, d_out, scale=0.1)}
    if bias:
        p["b"] = _rand(seed + 1, d_out, scale=0.1)
    return p


def _t(tree):
    return load_jax_params(tree, device="cpu")


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               atol=atol, rtol=0)


# --------------------------------------------------------------------------
# layers
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["linear", "linear_nobias", "layer_norm", "rms_norm",
                                  "gelu", "mlp", "swiglu_mlp"])
def test_layers_match_jax(name):
    x = _rand(0, 2, 5, 16)
    if name in ("linear", "linear_nobias"):
        p = _lin(1, 16, 8, bias=name == "linear")
        j, t = jlayers.linear(p, jnp.asarray(x)), tlayers.linear(_t(p), torch.from_numpy(x))
    elif name in ("layer_norm", "rms_norm"):
        p = {"scale": 1 + _rand(2, 16, scale=0.1), "bias": _rand(3, 16, scale=0.1)}
        if name == "rms_norm":
            p.pop("bias")
        j = getattr(jlayers, name)(p, jnp.asarray(x), 1e-6)
        t = getattr(tlayers, name)(_t(p), torch.from_numpy(x), 1e-6)
    elif name == "gelu":
        j, t = jlayers.gelu(jnp.asarray(x)), tlayers.gelu(torch.from_numpy(x))
    elif name == "mlp":
        p = {"fc1": _lin(4, 16, 32), "fc2": _lin(6, 32, 16)}
        j, t = jlayers.mlp(p, jnp.asarray(x)), tlayers.mlp(_t(p), torch.from_numpy(x))
    else:
        p = {"gate": _lin(7, 16, 32, False), "up": _lin(8, 16, 32, False),
             "down": _lin(9, 32, 16, False)}
        j = jlayers.swiglu_mlp(p, jnp.asarray(x))
        t = tlayers.swiglu_mlp(_t(p), torch.from_numpy(x))
    _close(t.numpy(), j)


def test_layer_norm_bf16_input_fp32_params_keeps_input_dtype():
    """ln_vision: fp32 params on bf16 activations -> bf16 out, fp32 stats."""
    x = _rand(10, 3, 4, 32)
    p = {"scale": 1 + _rand(11, 32, scale=0.1), "bias": _rand(12, 32, scale=0.1)}
    j = jlayers.layer_norm(p, jnp.asarray(x, jnp.bfloat16))
    t = tlayers.layer_norm(_t(p), torch.from_numpy(x).to(torch.bfloat16))
    assert t.dtype == torch.bfloat16
    _close(t.float().numpy(), np.asarray(j, np.float32), atol=2e-2)


def test_matmul_f32_accumulates_bf16_in_fp32():
    a = torch.from_numpy(_rand(13, 3, 64)).to(torch.bfloat16)
    b = torch.from_numpy(_rand(14, 64, 5)).to(torch.bfloat16)
    out = tlayers.matmul_f32(a, b)
    assert out.dtype == torch.float32
    want = jnp.dot(jnp.asarray(a.float().numpy(), jnp.bfloat16),
                   jnp.asarray(b.float().numpy(), jnp.bfloat16),
                   preferred_element_type=jnp.float32)
    _close(out.numpy(), want)


def test_gather_rows_clamps_like_jax():
    """JAX gathers normalize negative ids and clamp out-of-range ones; torch
    indexing raises. The port's gather takes JAX's rule."""
    table = _rand(15, 10, 3)
    ids = np.array([[-1, 12, -15, 3, 9, 0]], np.int32)
    want = jnp.asarray(table)[jnp.asarray(ids)]
    got = tlayers.gather_rows(torch.from_numpy(table), torch.from_numpy(ids))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("offsets", [[0, 3], [5, 7], [9, 40]])
def test_cache_write_clamps_like_dynamic_update_slice(offsets):
    """Idle batcher rows advance past max_len; the reference's
    dynamic_update_slice clamps the write window into the buffer."""
    c = _rand(16, 2, 8, 2, 3)
    new = _rand(17, 2, 2, 2, 3)
    off = np.array(offsets, np.int32)
    want = jax.vmap(lambda cr, nr, o: jax.lax.dynamic_update_slice(cr, nr, (o, 0, 0)))(
        jnp.asarray(c), jnp.asarray(new), jnp.asarray(off))
    ct = torch.from_numpy(c.copy())
    _write_at(ct, torch.from_numpy(new), torch.from_numpy(off))
    np.testing.assert_array_equal(ct.numpy(), np.asarray(want))


def test_argmax_ties_take_first_index():
    logits = np.array([[1.0, 3.0, 3.0, 0.0], [2.0, 2.0, 2.0, 2.0]], np.float32)
    want = np.asarray(jnp.argmax(jnp.asarray(logits), axis=-1))
    got = torch.argmax(torch.from_numpy(logits), dim=-1).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [1, 0])


# --------------------------------------------------------------------------
# RoPE
# --------------------------------------------------------------------------

def test_rope_table_and_apply_match_jax():
    jc, js = jrope.rope_table(16, 64)
    tc, ts = trope.rope_table(16, 64)
    _close(tc.numpy(), jc)
    _close(ts.numpy(), js)
    x = _rand(20, 2, 5, 3, 16)
    pos = np.array([[0, 1, 2, 3, 4], [7, 8, 9, 10, 70]], np.int32)  # 70 clamps
    want = jrope.apply_rope(jnp.asarray(x), jc, js, jnp.asarray(pos))
    got = trope.apply_rope(torch.from_numpy(x), tc, ts, torch.from_numpy(pos))
    _close(got.numpy(), want)


# --------------------------------------------------------------------------
# attention
# --------------------------------------------------------------------------

@pytest.mark.parametrize("variant", ["plain", "causal", "kv_mask", "mask", "q_mask",
                                     "bias", "cross"])
def test_mha_reference_matches_jax(variant):
    b, sq, sk, h, d = 2, 7, 7, 3, 8
    if variant == "cross":
        sk = 11
    q, k, v = _rand(30, b, sq, h, d), _rand(31, b, sk, h, d), _rand(32, b, sk, h, d)
    rng = np.random.default_rng(33)
    kw_np = {}
    if variant == "causal":
        kw_np["causal"] = True
    elif variant == "kv_mask":
        kv = np.ones((b, sk), np.int32)
        kv[0, 5:] = 0
        kv[1, :] = 0                  # a fully masked row: uniform weights
        kw_np["kv_mask"] = kv
    elif variant == "mask":
        kw_np["mask"] = rng.random((b, sq, sk)) > 0.4
    elif variant == "q_mask":
        qm = np.ones((b, sq), bool)
        qm[1, 3:] = False
        kw_np["q_mask"] = qm
    elif variant == "bias":
        kw_np["bias"] = _rand(34, b, h, sq, sk)
    want = jattn.mha_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               **{n: (jnp.asarray(a) if isinstance(a, np.ndarray) else a)
                                  for n, a in kw_np.items()})
    got = tattn.mha_reference(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                              **{n: (torch.from_numpy(a) if isinstance(a, np.ndarray) else a)
                                 for n, a in kw_np.items()})
    _close(got.numpy(), want)


@pytest.mark.parametrize("shape", [(2, 37, 4, 24), (1, 19, 2, 88)])
def test_packed_plain_matches_jax_kernel_interpret(shape):
    """The kernel's plain version against the JAX Pallas kernel in interpret
    mode (clamped exp2 softmax with no row max)."""
    b, s, h, d = shape
    qkv = _rand(40, b, s, 3 * h * d)
    want = jattn._packed_qkv_impl(jnp.asarray(qkv), h, d, d ** -0.5, True)
    got = kernels.packed_qkv_attention_plain(torch.from_numpy(qkv), h, d, d ** -0.5)
    _close(got.numpy(), want)
    # the public entry point takes the plain version for a CPU tensor
    got2 = tattn.fused_qkv_attention(torch.from_numpy(qkv), h, d)
    np.testing.assert_array_equal(got2.numpy(), got.numpy())


def test_packed_plain_bf16_matches_jax_kernel_interpret():
    b, s, h, d = 2, 33, 2, 88
    qkv = _rand(41, b, s, 3 * h * d)
    want = jattn._packed_qkv_impl(jnp.asarray(qkv, jnp.bfloat16), h, d, d ** -0.5, True)
    got = kernels.packed_qkv_attention_plain(
        torch.from_numpy(qkv).to(torch.bfloat16), h, d, d ** -0.5)
    assert got.dtype == torch.bfloat16
    _close(got.float().numpy(), np.asarray(want, np.float32), atol=3e-2)


def test_packed_clamp_and_zero_guard():
    """Logits past the clamp saturate and a row whose sum(p) underflows to 0
    outputs 0, as the JAX kernel does."""
    h, d = 1, 8
    qkv = np.zeros((1, 3, 3 * h * d), np.float32)
    qkv[0, :, :d] = 40.0                      # huge q.k -> clamped exp2
    qkv[0, :, d:2 * d] = 40.0
    qkv[0, :, 2 * d:] = _rand(42, 3, d)
    qkv[0, 2, :d] = -40.0                     # -> exp2 underflows: guarded 0
    want = jattn._packed_qkv_impl(jnp.asarray(qkv), h, d, d ** -0.5, True)
    got = kernels.packed_qkv_attention_plain(torch.from_numpy(qkv), h, d, d ** -0.5)
    _close(got.numpy(), want)
    assert np.all(got.numpy()[0, 2] == 0.0)


def test_packed_wrapper_refuses_other_devices():
    qkv = torch.zeros((1, 4, 3 * 2 * 8), device="meta")
    with pytest.raises(ValueError):
        kernels.packed_qkv_attention(qkv, 2, 8, 8 ** -0.5)


# --------------------------------------------------------------------------
# converter
# --------------------------------------------------------------------------

def test_load_jax_params_copies_tree_bit_exact():
    tree = {"a": {"w": jnp.asarray(_rand(50, 3, 4), jnp.bfloat16), "b": None},
            "layers": [{"s": jnp.asarray(_rand(51, 2))}, {"i": jnp.arange(3)}]}
    np_tree = jax.tree_util.tree_map(np.asarray, tree)
    got = load_jax_params(np_tree, device="cpu")
    assert got["a"]["b"] is None and isinstance(got["layers"], list)
    assert got["a"]["w"].dtype == torch.bfloat16
    bits = np.asarray(tree["a"]["w"]).view(np.uint16)
    np.testing.assert_array_equal(got["a"]["w"].view(torch.int16).numpy().view(np.uint16), bits)
    np.testing.assert_array_equal(got["layers"][0]["s"].numpy(), np_tree["layers"][0]["s"])
    assert got["layers"][1]["i"].tolist() == [0, 1, 2]
