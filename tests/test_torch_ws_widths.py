"""PyTorch port, the weight-streaming kernels (#12 W4A16 and the probes #13,
#14) at every width the reference takes: their plain versions against the
Pallas kernels in interpret mode at widths no multiple of 8 (and no
multiple of 128), #13 on every byte value, and the padding helper
(``kernels.weight_stream_operands``) that gives the CUDA kernels those
widths.

The JAX side: ``stllm_tpu.ops.quant.w4_matmul_pallas`` (which K-pads an
untiled half-K itself), and the probes ``w4v3_matmul`` and ``w8p_matmul``
imported from ``script/probe_decode_budget.py`` by path with
``pallas_call`` forced to interpret mode, as ``tests/test_torch_w4.py``
imports them. Numpy inputs from a seed.

Tolerances as ``tests/test_torch_w4.py`` states them: products within rtol
1e-5 (atol 1e-5), the bf16 products being exact in fp32 and only the order
of the fp32 sums differing; #13's unpack of each byte exactly."""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from stllm_tpu.ops import quant as jquant
from stllm_tpu_torch.ops import kernels

REPO = Path(__file__).resolve().parent.parent
RTOL = ATOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def probe():
    """script/probe_decode_budget.py as a module, with its pallas_call in
    interpret mode while this file's tests run."""
    spec = importlib.util.spec_from_file_location(
        "probe_decode_budget", REPO / "script" / "probe_decode_budget.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    real = mod.pl.pallas_call

    def interpret(*args, **kw):
        return real(*args, **{**kw, "interpret": True})

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mod.pl, "pallas_call", interpret)
        yield mod
    jax.clear_caches()


def _padded_product(plain, x, w, scale, halves):
    """``plain`` on the operands the card's wrapper launches with, sliced
    back to the unpadded N."""
    xp, wp, sp, kp = kernels.weight_stream_operands(x, w, scale, x.shape[-1] // halves, halves)
    assert kp % 8 == 0 and wp.shape[1] % 8 == 0 and xp.shape[-1] == halves * kp
    return plain(xp, wp, sp)[:, :w.shape[1]]


# (K/2, N): no tiling at K/2 = 100 and 4 (the reference pads them to 512
# rows), N = 20, 12 and 100 below one 128-column tile, none a multiple of 8
# in both
@pytest.mark.parametrize("k2n", [(100, 20), (4, 12), (256, 100)])
@pytest.mark.parametrize("storage", ["k_padded", "unpadded"])
def test_w4a16_plain_matches_pallas_at_odd_widths(k2n, storage):
    """#12's plain version against w4_matmul_pallas (interpret mode) with
    the packed weight stored K-padded as quantize_linear_params_int4 stores
    it (_w4_padded_k2 rows) and unpadded (the reference pads it at run
    time), and the same product from the padded operands the card takes."""
    k2, n = k2n
    rng = np.random.default_rng(20)
    w = (rng.standard_normal((2 * k2, n)) * 0.05).astype(np.float32)
    x = rng.standard_normal((3, 2 * k2)).astype(np.float32)
    if storage == "k_padded":
        jp = jquant.quantize_linear_params_int4({"w": jnp.asarray(w)})
        packed, scale = jp["w4"], jp["w4_scale"]
        assert packed.shape[0] == jquant._w4_padded_k2(k2, n)
    else:
        packed, scale = jquant.quantize_weights_int4(jnp.asarray(w))
        assert packed.shape[0] == k2
    want = jquant.w4_matmul_pallas(jnp.asarray(x), packed, scale)
    assert want is not None
    tx, tp, ts = _t(x), _t(packed), _t(scale)
    got = kernels.w4a16_matmul(tx, tp, ts)
    assert got.shape == (3, n)
    _close(got, want)
    _close(_padded_product(kernels.w4a16_matmul_plain, tx, tp, ts, 2), want)


# (K, N) of the probes: N = 20, 100, 500 and 12, no multiple of 128 (500 and
# 20, 100 no multiple of 8 either); the probes tile N whole up to 512
PROBE_WIDTHS = [(512, 20), (512, 100), (512, 500), (1024, 12)]


@pytest.mark.parametrize("kn", PROBE_WIDTHS)
def test_w4v3_plain_matches_probe_at_odd_widths(probe, kn):
    """#13's plain version against probe_decode_budget.w4v3_matmul
    (interpret mode) on packed bytes drawn from all of -128..127, and from
    the card's padded operands."""
    k, n = kn
    rng = np.random.default_rng(21)
    packed = rng.integers(-128, 128, (k // 2, n)).astype(np.int8)
    scale = rng.uniform(0.5, 2.0, n).astype(np.float32)
    x = rng.standard_normal((3, k)).astype(np.float32)
    want = probe.w4v3_matmul(jnp.asarray(x), jnp.asarray(packed), jnp.asarray(scale))
    tx, tp, ts = _t(x), _t(packed), _t(scale)
    _close(kernels.w4v3_matmul(tx, tp, ts), want)
    _close(_padded_product(kernels.w4v3_matmul_plain, tx, tp, ts, 2), want)


@pytest.mark.parametrize("kn", PROBE_WIDTHS)
def test_w8p_plain_matches_probe_at_odd_widths(probe, kn):
    """#14's plain version against probe_decode_budget.w8p_matmul
    (interpret mode) on codes over the full int8 range, and from the
    card's padded operands."""
    k, n = kn
    rng = np.random.default_rng(22)
    w = rng.integers(-128, 128, (k, n)).astype(np.int8)
    scale = rng.uniform(0.001, 0.01, n).astype(np.float32)
    x = rng.standard_normal((2, k)).astype(np.float32)
    want = probe.w8p_matmul(jnp.asarray(x), jnp.asarray(w), jnp.asarray(scale))
    tx, tw, ts = _t(x), _t(w), _t(scale)
    _close(kernels.w8p_matmul(tx, tw, ts), want)
    _close(_padded_product(kernels.w8p_matmul_plain, tx, tw, ts, 1), want)


def test_w4v3_plain_is_exact_on_every_byte(probe):
    """Every byte value p of the arithmetic layout, picked out by one-hot
    rows of x at unit scale: #13's plain version gives the Pallas kernel's
    top and bottom codes exactly, bottom = p / 16 rounded half to even (the
    ties p = 16 b + 8 included) and top = p - 16 * bottom."""
    k2, n = 256, 16
    p = ((np.arange(k2 * n) % 256) - 128).astype(np.int8).reshape(k2, n)
    x = np.eye(2 * k2, dtype=np.float32)
    scale = np.ones(n, np.float32)
    want = np.asarray(probe.w4v3_matmul(jnp.asarray(x), jnp.asarray(p), jnp.asarray(scale)))
    got = kernels.w4v3_matmul(_t(x), _t(p), _t(scale)).numpy()
    np.testing.assert_array_equal(got, want)
    bottom = np.round(p.astype(np.float32) / 16)
    np.testing.assert_array_equal(got[k2:], bottom)
    np.testing.assert_array_equal(got[:k2], p - 16 * bottom)
    assert set(np.unique(p)) == set(range(-128, 128))


@settings(max_examples=200, deadline=None)
@given(m=st.integers(1, 20), kw=st.integers(1, 80), n=st.integers(1, 70),
       stored=st.integers(0, 9), halves=st.sampled_from([1, 2]), seed=st.integers(0, 2 ** 16))
def test_weight_stream_operands_keep_the_product(m, kw, n, stored, halves, seed):
    """The padding helper's operands, run through the plain versions (#12
    and #13 on two halves, #14 on one), give the unpadded plain product in
    their first N columns; N and the weight rows in use come out multiples
    of 8, the stored rows past kw serve as padding where there are enough
    (whatever they hold), and aligned operands come back as they are."""
    rng = np.random.default_rng(seed)
    x = _t(rng.standard_normal((m, halves * kw)).astype(np.float32))
    w = _t(rng.integers(-128, 128, (kw + stored, n)).astype(np.int8))
    scale = _t(rng.uniform(0.5, 2.0, n).astype(np.float32))
    xp, wp, sp, kp = kernels.weight_stream_operands(x, w, scale, kw, halves)
    assert kp == -(-kw // 8) * 8 and wp.shape[1] == -(-n // 8) * 8 == sp.shape[0]
    assert xp.shape == (m, halves * kp) and wp.shape[0] >= kp
    if kp == kw and n % 8 == 0:
        assert xp is x and wp is w and sp is scale
    elif n % 8 == 0 and w.shape[0] >= kp:
        assert wp is w                       # the stored rows pad, no copy
    plains = ([kernels.w4a16_matmul_plain, kernels.w4v3_matmul_plain] if halves == 2
              else [kernels.w8p_matmul_plain])
    for plain in plains:
        _close(plain(xp, wp, sp)[:, :n], plain(x, w, scale))
