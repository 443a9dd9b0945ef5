"""PyTorch port, W4A16 ops (the int4 storage and matmuls of
stllm_tpu_torch/ops/quant.py, the weight-only int8 product, and the plain
versions of the weight-streaming kernels #12-#15 in ops/kernels.py) against
the JAX package and its probe scripts, on the same numpy inputs.

Tolerances: int4 codes, scales and K-padding bit for bit. Products within
rtol 1e-5 (atol 1e-5 on unit-scale outputs): the bf16 products are exact in
fp32 and only the order of the fp32 sums differs. The JAX side of each
Pallas kernel (#12 ``w4_matmul_pallas``, the probes #13 ``w4v3_matmul``, #14
``w8p_matmul`` and #15 ``kernel``) runs in interpret mode, as the JAX
package's own tests run its kernels on the CPU; the probes are imported from
``script/`` by path with ``pallas_call`` forced to interpret mode."""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stllm_tpu.ops import layers as jlayers
from stllm_tpu.ops import quant as jquant
from stllm_tpu_torch.convert.from_jax import load_jax_params
from stllm_tpu_torch.ops import kernels
from stllm_tpu_torch.ops import layers as tlayers
from stllm_tpu_torch.ops import quant as tquant

REPO = Path(__file__).resolve().parent.parent
RTOL = ATOL = 1e-5


def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=rtol, atol=atol)


def _weight(seed, k, n):
    w = _rand(seed, k, n, scale=0.05)
    w[:, 3] = 0.0                            # an all-zero channel: scale 1
    return w


@pytest.fixture(scope="module")
def probes():
    """The two probe scripts as modules, with every pallas_call in interpret
    mode while this file's tests run."""
    mods = {}
    for name in ("probe_decode_budget", "probe_w4_unpack"):
        spec = importlib.util.spec_from_file_location(name, REPO / "script" / f"{name}.py")
        mods[name] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mods[name])
    real = mods["probe_w4_unpack"].pl.pallas_call

    def interpret(*args, **kw):
        return real(*args, **{**kw, "interpret": True})

    with pytest.MonkeyPatch.context() as mp:
        for mod in mods.values():
            mp.setattr(mod.pl, "pallas_call", interpret)
        yield mods
    jax.clear_caches()


# --------------------------------------------------------------------------
# int4 storage
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kn", [(64, 40), (320, 384)])
@pytest.mark.parametrize("group", [None, 32])
def test_quantize_weights_int4_matches_jax(kn, group):
    w = _weight(0, *kn)
    jp, js = jquant.quantize_weights_int4(jnp.asarray(w), group)
    tp, ts = tquant.quantize_weights_int4(_t(w), group)
    assert tp.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    top, bottom = tquant._unpack_int4(tp)
    jt, jb = jquant._unpack_int4(jp)
    np.testing.assert_array_equal(top.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(bottom.numpy(), np.asarray(jb))
    assert int(top.abs().max()) <= 7 and int(bottom.abs().max()) <= 7


def test_w4_tiling_rule_and_k_padding_match_jax():
    """The storage rule carries over: the same tiles and padded half-K for
    the Vicuna-7B shapes, the 320 x 384 case and small ones."""
    for k2, n in [(2048, 12288), (2048, 4096), (2048, 22016), (5504, 4096), (160, 384),
                  (32, 192), (64, 64), (256, 256), (1408, 1024)]:
        assert tquant._w4_tiles(k2, n) == jquant._w4_tiles(k2, n), (k2, n)
        assert tquant._w4_padded_k2(k2, n) == jquant._w4_padded_k2(k2, n), (k2, n)
    assert tquant._w4_padded_k2(5504, 4096) == 5632


@pytest.mark.parametrize("group", [None, 32])
def test_quantize_linear_params_int4_matches_jax(group):
    """The 320 x 384 weight (k2 = 160 has no tiling): per-channel storage is
    K-padded to 512 rows of which the last 352 are zero, per-group storage
    is never padded; both bit-identical to JAX, bias carried, dense weight
    dropped under free_dense."""
    p = {"w": _weight(1, 320, 384), "b": _rand(2, 384, scale=0.1)}
    jp = jquant.quantize_linear_params_int4({k: jnp.asarray(v) for k, v in p.items()}, group)
    tin = {k: _t(v) for k, v in p.items()}
    tp = tquant.quantize_linear_params_int4(tin, group, free_dense=True)
    assert "w" not in tin and sorted(tp) == sorted(jp) == ["b", "w4", "w4_scale"]
    for key in tp:
        np.testing.assert_array_equal(tp[key].numpy(), np.asarray(jp[key]))
    assert tp["w4"].shape == ((512, 384) if group is None else (160, 384))
    if group is None:
        assert not tp["w4"][160:].any()


# --------------------------------------------------------------------------
# the matmuls
# --------------------------------------------------------------------------

@pytest.mark.parametrize("storage", ["tiles", "k_padded", "legacy_unpadded"])
def test_w4a16_plain_matches_jax_pallas_kernel(storage):
    """Kernel #12's plain version against w4_matmul_pallas in interpret
    mode: a shape that tiles (k2 = 256), K-padded storage (k2 = 160 stored
    as 512 rows) and legacy unpadded storage (160 rows, which the JAX
    kernel pads at run time)."""
    k, n = (512, 256) if storage == "tiles" else (320, 384)
    w = _weight(3, k, n)
    x = _rand(4, 3, k)
    if storage == "k_padded":
        jp = jquant.quantize_linear_params_int4({"w": jnp.asarray(w)})
        packed, scale = jp["w4"], jp["w4_scale"]
        assert packed.shape[0] == 512
    else:
        packed, scale = jquant.quantize_weights_int4(jnp.asarray(w))
    want = jquant.w4_matmul_pallas(jnp.asarray(x), packed, scale)
    assert want is not None
    got = kernels.w4a16_matmul(_t(x), _t(packed), _t(scale))
    assert got.dtype == torch.float32 and got.shape == (3, n)
    _close(got, want)
    # the XLA path and the port's w4_matmul give the same product
    _close(tquant.w4_matmul(_t(x), _t(packed), _t(scale)),
           jquant.w4_matmul(jnp.asarray(x), packed, scale))


def test_w4a16_plain_casts_to_bf16_like_the_kernel():
    """A bf16 x gives a bf16 output, the fp32 product rounded once."""
    w = _weight(5, 512, 256)
    x = _rand(6, 2, 512)
    packed, scale = jquant.quantize_weights_int4(jnp.asarray(w))
    want = jquant.w4_matmul_pallas(jnp.asarray(x, jnp.bfloat16), packed, scale)
    got = kernels.w4a16_matmul(_t(x).bfloat16(), _t(packed), _t(scale))
    assert got.dtype == torch.bfloat16
    _close(got.float(), np.asarray(want, np.float32), rtol=8e-3, atol=1e-6)


def test_w4_matmul_per_group_matches_jax():
    w = _weight(7, 128, 96)
    x = _rand(8, 2, 5, 128)
    packed, scale = jquant.quantize_weights_int4(jnp.asarray(w), group=32)
    want = jquant.w4_matmul(jnp.asarray(x), packed, scale)
    got = tquant.w4_matmul(_t(x), _t(packed), _t(scale))
    assert got.shape == (2, 5, 96)
    _close(got, want)
    with pytest.raises(ValueError, match="per-group"):
        tquant.w4_matmul(_t(x[..., :64]), _t(packed), _t(scale))


@pytest.mark.parametrize("group", [None, 32])
def test_w4_linear_with_bias_matches_jax(group):
    p = {"w": _weight(9, 128, 64), "b": _rand(10, 64, scale=0.1)}
    jp = jquant.quantize_linear_params_int4({k: jnp.asarray(v) for k, v in p.items()}, group)
    tp = load_jax_params(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    x = _rand(11, 3, 4, 128)
    want = jquant.w4_linear(jp, jnp.asarray(x))
    _close(tquant.w4_linear(tp, _t(x)), want)
    np.testing.assert_array_equal(tlayers.linear(tp, _t(x)).numpy(),
                                  tquant.w4_linear(tp, _t(x)).numpy())


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_w8a16_matmul_matches_jax(dtype):
    w = _weight(12, 96, 48)
    x = _rand(13, 2, 7, 96)
    jq, js = jquant.quantize_weights(jnp.asarray(w))
    jx, tx = jnp.asarray(x), _t(x)
    if dtype == "bf16":
        jx, tx = jx.astype(jnp.bfloat16), tx.bfloat16()
    want = jquant.w8a16_matmul(jx, jq, js)
    got = tquant.w8a16_matmul(tx, _t(jq), _t(js))
    assert str(got.dtype).replace("torch.", "") == np.dtype(want.dtype).name
    _close(got.float(), np.asarray(want, np.float32), rtol=RTOL if dtype == "fp32" else 8e-3)


# --------------------------------------------------------------------------
# the probes' kernels #13-#15
# --------------------------------------------------------------------------

def test_w4v3_plain_matches_probe_kernel(probes):
    """Kernel #13's plain version against probe_decode_budget.w4v3_matmul
    (interpret mode) on arithmetic-packed codes."""
    mod = probes["probe_decode_budget"]
    rng = np.random.default_rng(14)
    k, n = 512, 256
    top = rng.integers(-7, 8, (k // 2, n)).astype(np.int8)
    bottom = rng.integers(-7, 8, (k // 2, n)).astype(np.int8)
    packed = mod.pack_arith(top, bottom)
    scale = rng.uniform(0.5, 2.0, n).astype(np.float32)
    x = _rand(15, 3, k)
    want = mod.w4v3_matmul(jnp.asarray(x), jnp.asarray(packed), jnp.asarray(scale))
    got = kernels.w4v3_matmul(_t(x), _t(packed), _t(scale))
    _close(got, want)
    np.testing.assert_array_equal(
        kernels.pack_int4_arith(_t(top), _t(bottom)).numpy(), packed)


def test_w8p_plain_matches_probe_kernel(probes):
    """Kernel #14's plain version against probe_decode_budget.w8p_matmul
    (interpret mode)."""
    mod = probes["probe_decode_budget"]
    rng = np.random.default_rng(16)
    k, n = 512, 256
    w = rng.integers(-127, 128, (k, n)).astype(np.int8)
    scale = rng.uniform(0.001, 0.01, n).astype(np.float32)
    x = _rand(17, 2, k)
    want = mod.w8p_matmul(jnp.asarray(x), jnp.asarray(w), jnp.asarray(scale))
    _close(kernels.w8p_matmul(_t(x), _t(w), _t(scale)), want)


@pytest.mark.parametrize("variant", kernels.W4_UNPACK_VARIANTS)
def test_w4_unpack_plain_matches_probe(probes, variant, monkeypatch):
    """Kernel #15's plain version, on the layout the variant takes, against
    the probe's own XLA reference and its kernel (interpret mode) at a cut
    shape: x (16, 512), packed (256, 512)."""
    mod = probes["probe_w4_unpack"]
    monkeypatch.setattr(mod, "K", 512)
    monkeypatch.setattr(mod, "N", 512)
    rng = np.random.default_rng(18)
    t = jnp.asarray(rng.integers(-7, 8, (256, 512)), jnp.int8)
    b = jnp.asarray(rng.integers(-7, 8, (256, 512)), jnp.int8)
    x = jnp.asarray(rng.normal(size=(16, 512)) * 0.1, jnp.bfloat16)
    ref = (x[:, :256].astype(jnp.float32) @ t.astype(jnp.float32)
           + x[:, 256:].astype(jnp.float32) @ b.astype(jnp.float32))
    biased = variant in kernels.BIASED_VARIANTS
    packed = (mod.pack_biased if biased else mod.pack_plain)(t, b)
    tpack = (kernels.pack_int4_biased if biased else kernels.pack_int4_nibbles)(_t(t), _t(b))
    np.testing.assert_array_equal(tpack.numpy(), np.asarray(packed))
    tx = _t(np.asarray(x.astype(jnp.float32))).bfloat16()
    got = kernels.w4_unpack_matmul(tx, _t(packed), variant)
    assert got.dtype == torch.float32 and got.shape == (16, 512)
    _close(got, ref)
    one, _ = mod.build(variant, 256, 256)
    _close(got, one(x, packed))


# --------------------------------------------------------------------------
# converter
# --------------------------------------------------------------------------

def test_load_jax_params_carries_int4_and_w_q16_trees():
    """int4 and weight-only int8 trees convert without requantizing: int8
    leaves copy as they are, K-padded packed arrays keep their padding."""
    w = jnp.asarray(_weight(19, 320, 384))
    h = jquant.quantize_linear_params({"w": jnp.asarray(_weight(20, 64, 32))})
    tree = {"down": jquant.quantize_linear_params_int4({"w": w}),
            "gq": jquant.quantize_linear_params_int4({"w": w}, group=32),
            "head": {"w_q16": h["w_q"], "w_scale": h["w_scale"]}}
    np_tree = jax.tree_util.tree_map(np.asarray, tree)
    got = load_jax_params(np_tree, device="cpu")
    for path in (("down", "w4"), ("down", "w4_scale"), ("gq", "w4"), ("gq", "w4_scale"),
                 ("head", "w_q16"), ("head", "w_scale")):
        a, b = np_tree[path[0]][path[1]], got[path[0]][path[1]]
        assert str(b.dtype).replace("torch.", "") == a.dtype.name, path
        np.testing.assert_array_equal(b.numpy(), a)
    assert got["down"]["w4"].shape == (512, 384) and got["gq"]["w4_scale"].shape == (10, 384)
    x = _rand(21, 3, 64)
    _close(tlayers.linear(got["head"], _t(x)), jlayers.linear(tree["head"], jnp.asarray(x)))
