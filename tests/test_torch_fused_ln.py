"""PyTorch port, the plain-ViT static-int8 pipeline-serving stack against the
JAX package on tiny fp32 configs: the epilogue-carried LayerNorm (kernel
#11, ``quant_matmul_res_ln_static``) and its dispatch rule, the blockwise
dynamic-quant matmul (kernel #8, ``quant_matmul_pallas``), the ViT under
``FUSED_LN`` and ``INT8_QKT``, and the video-QA server on the whole stack
(static-int8 EVA-ViT-g without the BTAdapter, dense Q-Former, fused int4
LLaMA with the int8 head) under ``FUSED_LN="both"``. The JAX kernels run in
interpret mode, as the JAX package's own tests run them on the CPU; both
packages' settings are module attributes, monkeypatched side by side.

Tolerances:
  - #11 against the Pallas kernel: int8 codes at most one step apart (the
    statistics are fp32 sums in another order, and a value at a rounding
    boundary may round either way); x_new within 1e-5 relative, since both
    add the same fp32 terms in the same order and round the sum once.
  - #8 against the Pallas kernel: within atol = rtol = 1e-4, the bound of
    tests/test_ops.py's own check of that kernel, in fp32. A bf16 x is held
    to the port's own fp32 path bit for bit: on bf16 inputs x / s often lands
    exactly on a rounding tie, and the two packages' CPU divides (IEEE here)
    then round some codes apart.
  - the ViT and the server: encode outputs and prefill logits within 1e-2
    mean relative error, the bound tests/test_ops.py sets between two
    static-int8 encodes, and the first greedy token of every request
    identical, as for the static server of tests/test_torch_models_int8.py.
    That file's 1e-3 holds only while no int8 code flips: the packages'
    exp2 differ by an ulp, which now and then moves a bf16 P or a row's
    attention scale across a rounding boundary, and through three
    static-int8 blocks one such flip moves this 17-token trunk's output by
    about 2.5e-3 (over six input seeds the port-vs-JAX error of this trunk
    was either 2e-7 or 2.5e-3, with INT8_QKT "1" and "0" alike). A fused
    trunk stays within the same 1e-2 of the port's own unfused one.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stllm_tpu import pipeline_serving as jps
from stllm_tpu import serving as jserving
from stllm_tpu.models import generation as jgen
from stllm_tpu.models import llama as jllama
from stllm_tpu.models import qformer as jqf
from stllm_tpu.models import stllm as jst
from stllm_tpu.models import vit as jvit
from stllm_tpu.ops import attention as jattn
from stllm_tpu.ops import quant as jquant
from stllm_tpu_torch import pipeline_serving as tps
from stllm_tpu_torch import serving as tserving
from stllm_tpu_torch.convert.from_jax import load_jax_params
from stllm_tpu_torch.models import generation as tgen
from stllm_tpu_torch.models import llama as tllama
from stllm_tpu_torch.models import qformer as tqf
from stllm_tpu_torch.models import stllm as tst
from stllm_tpu_torch.models import vit as tvit
from stllm_tpu_torch.ops import quant as tquant


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Tiny eager models: one intra-op thread, so parallel test processes
    do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


MEAN_REL = 1e-2
X_RTOL = 1e-5
MM_TOL = 1e-4

# the ViT of tests/test_ops.py's fused-LN check (17 tokens, width 256: the
# fused kernel takes N % 128 == 0), with the serving stack's tanh GELU
VIT = dict(image_size=56, patch_size=14, width=256, depth=3, heads=4, mlp_hidden=512,
           use_flash=None, gelu_approx=True)
QF = dict(hidden=32, num_layers=2, heads=4, intermediate=64, encoder_width=256,
          num_query=4, vocab_size=50)
LL = dict(vocab_size=61, hidden=64, num_layers=2, heads=4, intermediate=128,
          max_positions=128)
JVIT, TVIT = jvit.ViTConfig(dtype=jnp.float32, **VIT), tvit.ViTConfig(dtype=torch.float32, **VIT)
JCFG = jst.STLLMConfig(vit=JVIT, qformer=jqf.QFormerConfig(dtype=jnp.float32, **QF),
                       llama=jllama.LlamaConfig(dtype=jnp.float32, **LL), video_input="all")
TCFG = tst.STLLMConfig(vit=TVIT, qformer=tqf.QFormerConfig(dtype=torch.float32, **QF),
                       llama=tllama.LlamaConfig(dtype=torch.float32, **LL), video_input="all")
FRAMES = 4
# fused-kernel calls per trunk of depth 3 under each setting
FUSED_CALLS = {"both": 5, "proj": 3, "fc2": 2, False: 0}


@pytest.fixture(scope="module", autouse=True)
def jax_kernels():
    """The JAX ViT's int8 attention through its Pallas kernels in interpret
    mode (tests/test_torch_models_int8.py); its #11 and #8 take interpret
    mode on the CPU by themselves."""
    interp = {"fused_qkv_attention": jattn.fused_qkv_attention,
              "fused_qkv_attention_quant": jattn.fused_qkv_attention_quant,
              "fused_qkv_attention_quant_static": jattn.fused_qkv_attention_quant_static}
    with pytest.MonkeyPatch.context() as mp:
        for name, fn in interp.items():
            mp.setattr(jvit, name, functools.partial(fn, interpret=True))
        yield
    jax.clear_caches()


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(tree):
    return load_jax_params(_np(tree), device="cpu")


def _mean_rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).mean() / np.abs(want).mean())


def _perturb(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: a + jnp.asarray(rng.standard_normal(a.shape) * 0.02, a.dtype), tree)


def _frames(seed):
    return np.random.default_rng(seed).integers(0, 256, (FRAMES, 56, 56, 3)).astype(np.uint8)


# ---------------------------------------------------------------------------
# kernel #11 and its dispatch rule
# ---------------------------------------------------------------------------

def _res_ln_case(b, s, k, n, seed=50):
    """tests/test_ops.py's inputs for the fused kernel, as numpy."""
    rng = np.random.RandomState(seed)
    return {"hq": rng.randint(-127, 128, (b, s, k)).astype(np.int8),
            "w_q": rng.randint(-127, 128, (k, n)).astype(np.int8),
            "w_scale": (rng.rand(n) * 0.002).astype(np.float32),
            "b": (rng.randn(n) * 0.02).astype(np.float32),
            "x": rng.randn(b, s, n).astype(np.float32),
            "ln_scale": rng.randn(n).astype(np.float32),
            "ln_bias": (rng.randn(n) * 0.1).astype(np.float32),
            "hs_row": (rng.rand(b, s, 1) * 0.01 + 1e-3).astype(np.float32)}


def _res_ln_both(c, hs, x_dtype):
    """The same call in both packages: (jax result, port result)."""
    jdt, tdt = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[x_dtype]
    jparams = {"w_q": jnp.asarray(c["w_q"]), "w_scale": jnp.asarray(c["w_scale"]),
               "b": jnp.asarray(c["b"])}
    tparams = {k: torch.from_numpy(c[k]) for k in ("w_q", "w_scale", "b")}
    jln = {"scale": jnp.asarray(c["ln_scale"]), "bias": jnp.asarray(c["ln_bias"])}
    tln = {"scale": torch.from_numpy(c["ln_scale"]), "bias": torch.from_numpy(c["ln_bias"])}
    jhs = jnp.asarray(hs) if np.ndim(hs) else jnp.float32(hs)
    ths = torch.from_numpy(np.asarray(hs, np.float32))
    want = jquant.quant_matmul_res_ln_static(jnp.asarray(c["hq"]), jhs, jparams,
                                             jnp.asarray(c["x"], jdt), jln, 0.05)
    got = tquant.quant_matmul_res_ln_static(torch.from_numpy(c["hq"]), ths, tparams,
                                            torch.from_numpy(c["x"]).to(tdt), tln,
                                            torch.tensor(0.05))
    return want, got


@pytest.mark.parametrize("x_dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("hs_kind", ["per_row", "scalar"])
def test_res_ln_plain_matches_pallas_kernel(hs_kind, x_dtype):
    """The port's #11 (its plain version on the CPU) against the Pallas
    kernel in interpret mode at tests/test_ops.py's shape (2, 17, 384) .
    (384, 256): x_new close, codes at most one step apart; and against the
    port's own XLA-style reference, which divides by out_scale."""
    c = _res_ln_case(2, 17, 384, 256)
    hs = c["hs_row"] if hs_kind == "per_row" else np.float32(0.004)
    want, got = _res_ln_both(c, hs, x_dtype)
    assert want is not None and got is not None
    x_new, yq = got
    assert x_new.dtype == (torch.float32 if x_dtype == "fp32" else torch.bfloat16)
    assert yq.dtype == torch.int8 and tuple(yq.shape) == (2, 17, 256)
    np.testing.assert_allclose(x_new.float().numpy(), np.asarray(want[0], np.float32),
                               rtol=X_RTOL, atol=X_RTOL)
    assert int(np.abs(yq.numpy().astype(np.int32) - np.asarray(want[1], np.int32)).max()) <= 1
    ref = tquant.quant_matmul_res_ln_static_reference(
        torch.from_numpy(c["hq"]), torch.from_numpy(np.asarray(hs, np.float32)),
        {k: torch.from_numpy(c[k]) for k in ("w_q", "w_scale", "b")}, x_new.new_tensor(c["x"]),
        {"scale": torch.from_numpy(c["ln_scale"]), "bias": torch.from_numpy(c["ln_bias"])}, 0.05)
    assert int((ref[1].int() - yq.int()).abs().max()) <= 1


# (B, S, K, N, fused): N % 128, a K above 2048 with no 128-multiple tile, and
# S * N * 4 above 4 MiB decline; K = 4096 takes two k-tiles
@pytest.mark.parametrize("shape", [(2, 17, 384, 256, True), (2, 17, 384, 200, False),
                                   (1, 4, 2100, 128, False), (1, 1100, 128, 1024, False),
                                   (1, 2, 4096, 128, True)],
                         ids=lambda s: "x".join(map(str, s[:4])))
def test_res_ln_dispatch_rule_matches_jax(shape):
    """The reference's decline predicate is the port's dispatch rule: the
    same shapes fuse, and the same return None, in both packages."""
    b, s, k, n, fused = shape
    want, got = _res_ln_both(_res_ln_case(b, s, k, n), np.float32(0.004), "fp32")
    assert (want is not None) == (got is not None) == fused
    if fused:
        assert int(np.abs(got[1].numpy().astype(np.int32)
                          - np.asarray(want[1], np.int32)).max()) <= 1


# ---------------------------------------------------------------------------
# kernel #8
# ---------------------------------------------------------------------------

def _mm_inputs(b, s, k, n):
    rng = np.random.default_rng(20)
    x = rng.standard_normal((b, s, k)).astype(np.float32)
    w_q, ws = jquant.quantize_weights(jnp.asarray(rng.standard_normal((k, n)), jnp.float32))
    return x, w_q, ws, torch.from_numpy(np.array(w_q)), torch.from_numpy(np.array(ws))


@pytest.mark.parametrize("shape", [(2, 64, 256, 384), (1, 8, 4096, 256),
                                   (1, 5, 40, 20), (1, 5, 1000, 100), (1, 5, 13, 1536),
                                   (1, 5, 2048, 1500)],
                         ids=lambda s: "x".join(map(str, s)))
def test_blockwise_quant_matmul_matches_pallas_kernel(shape):
    """The port's #8 (its plain version on the CPU) against
    quant_matmul_pallas(interpret=True) at tests/test_ops.py's shape, at
    one with K > 2048 (two k-blocks of 2048), and at widths the reference's
    tile rule takes whole that are no multiple of 16 (K) or 8 (N), and the
    two packages' references against each other."""
    x, w_q, ws, tw, tws = _mm_inputs(*shape)
    want = jquant.quant_matmul_pallas(jnp.asarray(x), w_q, ws, interpret=True)
    got = tquant.quant_matmul_pallas(torch.from_numpy(x), tw, tws)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape[:2] + shape[3:]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=MM_TOL, rtol=MM_TOL)
    np.testing.assert_allclose(
        tquant.quant_matmul_pallas_reference(torch.from_numpy(x), tw, tws).numpy(),
        np.asarray(jquant.quant_matmul_pallas_reference(jnp.asarray(x), w_q, ws)),
        atol=MM_TOL, rtol=MM_TOL)


def test_blockwise_quant_matmul_bf16_is_its_fp32_product_rounded():
    """A bf16 x quantizes exactly as its fp32 upcast (the codes come from
    the same fp32 values) and the product rounds once to bf16, at two
    k-blocks and at an odd width (K 1000, N 100)."""
    for shape in ((2, 16, 4096, 256), (1, 5, 1000, 100)):
        x, _, _, tw, tws = _mm_inputs(*shape)
        xb = torch.from_numpy(x).bfloat16()
        got = tquant.quant_matmul_pallas(xb, tw, tws)
        assert got.dtype == torch.bfloat16 and tuple(got.shape) == shape[:2] + shape[3:]
        assert torch.equal(got, tquant.quant_matmul_pallas(xb.float(), tw, tws).bfloat16())


@pytest.mark.parametrize("kn", [(2100, 128), (256, 1600)], ids=["k2100", "n1600"])
def test_blockwise_quant_matmul_declines_as_jax_does(kn):
    k, n = kn
    x = np.zeros((1, 2, k), np.float32)
    w_q = np.zeros((k, n), np.int8)
    ws = np.ones((n,), np.float32)
    assert jquant.quant_matmul_pallas(jnp.asarray(x), jnp.asarray(w_q), jnp.asarray(ws)) is None
    assert tquant.quant_matmul_pallas(torch.from_numpy(x), torch.from_numpy(w_q),
                                      torch.from_numpy(ws)) is None


# ---------------------------------------------------------------------------
# the ViT under FUSED_LN and INT8_QKT
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def stllm_params():
    return _perturb(jst.init_stllm(jax.random.PRNGKey(0), JCFG), 1)


@pytest.fixture(scope="module")
def vit_static(stllm_params):
    """The plain ViT, W8A8 and calibrated on one clip by JAX."""
    return jvit.calibrate_vit_scales(jvit.quantize_vit_params(stllm_params["vit"]),
                                     jnp.asarray(_frames(2)), JVIT)


def _count_fused(mp):
    """Count the fused-kernel calls of both packages' ViTs."""
    calls = {"jax": 0, "port": 0}

    def counted(fn, key):
        def wrap(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return wrap

    mp.setattr(jquant, "quant_matmul_res_ln_static",
               counted(jquant.quant_matmul_res_ln_static, "jax"))
    mp.setattr(tvit, "quant_matmul_res_ln_static",
               counted(tvit.quant_matmul_res_ln_static, "port"))
    return calls


def _settings(mp, fused, qkt):
    for mod in (jvit, tvit):
        mp.setattr(mod, "FUSED_LN", fused)
        mp.setattr(mod, "INT8_QKT", qkt)


@pytest.mark.parametrize("fused,qkt", [("both", "1"), ("proj", "1"), ("fc2", "1"),
                                       (False, "0"), (False, "bf16"), ("both", "0")])
def test_vit_forward_static_settings_match_jax(vit_static, fused, qkt):
    """The tiny static-int8 plain ViT under each setting, port against JAX:
    the fused kernel runs at the same sites as many times in both, and the
    outputs agree within 1e-2 mean relative error; a fused trunk also stays
    within 1e-2 of the port's own unfused one."""
    x = np.random.default_rng(3).standard_normal((2, 56, 56, 3)).astype(np.float32)
    tp = _t(vit_static)
    with pytest.MonkeyPatch.context() as mp:
        _settings(mp, fused, qkt)
        calls = _count_fused(mp)
        want = jvit.vit_forward(vit_static, jnp.asarray(x), JVIT)
        got = tvit.vit_forward(tp, torch.from_numpy(x), TVIT)
    assert calls == {"jax": FUSED_CALLS[fused], "port": FUSED_CALLS[fused]}
    assert _mean_rel(got.numpy(), want) < MEAN_REL
    if fused:
        with pytest.MonkeyPatch.context() as mp:
            _settings(mp, False, qkt)
            plain = tvit.vit_forward(tp, torch.from_numpy(x), TVIT)
        assert _mean_rel(got.numpy(), plain.numpy()) < MEAN_REL


def test_int8_qkt_off_takes_the_dynamic_epilogue_attention(vit_static, monkeypatch):
    """INT8_QKT "0" sends the bf16 qkv to the dynamic-epilogue attention
    (#2) and never to the static one (#3), as in the reference."""
    calls = []
    for name in ("fused_qkv_attention_quant", "fused_qkv_attention_quant_static"):
        fn = getattr(tvit, name)
        monkeypatch.setattr(tvit, name, lambda *a, _n=name, _f=fn, **kw:
                            calls.append(_n) or _f(*a, **kw))
    monkeypatch.setattr(tvit, "INT8_QKT", "0")
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((1, 56, 56, 3)).astype(np.float32))
    tvit.vit_forward(_t(vit_static), x, TVIT)
    assert calls == ["fused_qkv_attention_quant"] * 3


# ---------------------------------------------------------------------------
# the pipeline-serving stack
# ---------------------------------------------------------------------------

def _gen(cls, n):
    return cls(max_new_tokens=n, pad_to_multiple=8, eos_token_id=-1, stop_sequences=())


def test_video_qa_server_on_the_fused_ln_stack_matches_jax(stllm_params, vit_static):
    """The tiny pipeline-serving stack (static-int8 plain ViT calibrated by
    JAX, dense Q-Former, fused int4 LLaMA with the int8 head) under
    FUSED_LN="both", each server on a batcher it is handed: encode and
    prefill logits within 1e-2 mean relative error, the first token of every
    request identical."""
    jp = dict(stllm_params)
    jp["vit"] = vit_static
    jp["llama"] = jllama.quantize_llama_params_int4(stllm_params["llama"], group=None,
                                                    fuse=True, quant_head=True)
    tp = _t(jp)
    rng = np.random.default_rng(6)
    reqs = [(f"r{i}", _frames(10 + i)[None], rng.integers(3, 61, (1, npre)),
             rng.integers(3, 61, (1, 3)), n)
            for i, (npre, n) in enumerate([(5, 4), (7, 3), (4, 5)])]
    q = rng.integers(0, 50, (1, 6)).astype(np.int32)
    qm = np.ones_like(q)
    with pytest.MonkeyPatch.context() as mp:
        _settings(mp, "both", "1")
        calls = _count_fused(mp)
        _, fr, pre, suf, _ = reqs[0]
        jemb = jps._encode_assemble(jp, jnp.asarray(fr), jnp.asarray(pre), jnp.asarray(suf),
                                    jnp.asarray(q), jnp.asarray(qm), JCFG)
        temb = tps._encode_assemble(tp, torch.from_numpy(fr), torch.from_numpy(pre).int(),
                                    torch.from_numpy(suf).int(), torch.from_numpy(q),
                                    torch.from_numpy(qm), TCFG)
        assert calls == {"jax": FUSED_CALLS["both"], "port": FUSED_CALLS["both"]}
        assert _mean_rel(temb.numpy(), jemb) < MEAN_REL
        mask = np.ones(jemb.shape[:2], np.int32)
        jl, _ = jgen._prefill(jp["llama"], jemb, jnp.asarray(mask), JCFG.llama, 64)
        tl, _ = tgen._prefill(tp["llama"], temb, torch.from_numpy(mask), TCFG.llama, 64)
        assert _mean_rel(tl.numpy(), jl) < MEAN_REL

        js = jps.VideoQAServer(jp, JCFG, batcher=jserving.ContinuousBatcher(
            jp["llama"], JCFG.llama, slots=2, max_len=128, chunk=4))
        ts = tps.VideoQAServer(tp, TCFG, batcher=tserving.ContinuousBatcher(
            tp["llama"], TCFG.llama, slots=2, max_len=128, chunk=4))
        assert ts.batcher.slots == 2 and ts.batcher.max_len == 128
        for rid, fr, pre, suf, n in reqs:
            js.submit(rid, jnp.asarray(fr), pre, suf, _gen(jgen.GenerationConfig, n),
                      qformer_text_ids=q)
            ts.submit(rid, fr, pre, suf, _gen(tgen.GenerationConfig, n), qformer_text_ids=q)
        want, got = js.run(), ts.run()
    assert set(got) == set(want) == {r[0] for r in reqs}
    assert [len(got[r[0]]) for r in reqs] == [r[4] for r in reqs]
    assert {k: v[0] for k, v in got.items()} == {k: v[0] for k, v in want.items()}
    assert calls["port"] == FUSED_CALLS["both"] * (1 + len(reqs))
