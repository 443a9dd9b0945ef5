"""PyTorch port, the int8 video-QA path (quant_int8: dynamic W8A8, then
static int8 after calibrate_btadapter_scales) against the JAX package on
tiny fp32 configs: JAX params from the reference's own init and quantizers,
converted with load_jax_params, and the same numpy inputs through both.

Tolerances: int8 trees are compared code for code; model outputs within
1e-3 mean relative error (mean |port - jax| / mean |jax|). The two packages
compute fp32 values before each rounding in another order, so a code that
lands on a rounding boundary may flip, and a flipped code moves one element
by one step (about 1/127 of its row's or tensor's range). Greedy decoding
is compared on the first token, whose argmax such a step does not move;
later tokens of random tiny weights may diverge after a near tie. The
calibrated activation scales agree within 1e-5 relative.

Without ``interpret`` the JAX package's CPU path never runs its int8
kernels' math: fused_qkv_attention_quant_static returns None and the other
packed attentions take the plain-softmax reference. The ``jax_kernels``
fixture therefore routes the JAX models through the Pallas kernels in
interpret mode, as the JAX package's own tests run them; no JAX file
changes."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stllm_tpu import pipeline_serving as jps
from stllm_tpu.models import btadapter as jbt
from stllm_tpu.models import generation as jgen
from stllm_tpu.models import llama as jllama
from stllm_tpu.models import qformer as jqf
from stllm_tpu.models import stllm as jst
from stllm_tpu.models import vit as jvit
from stllm_tpu.models import zoo as jzoo
from stllm_tpu.ops import attention as jattn
from stllm_tpu.ops import quant as jquant
from stllm_tpu_torch import pipeline_serving as tps
from stllm_tpu_torch.convert.from_jax import load_jax_params
from stllm_tpu_torch.models import btadapter as tbt
from stllm_tpu_torch.models import generation as tgen
from stllm_tpu_torch.models import llama as tllama
from stllm_tpu_torch.models import qformer as tqf
from stllm_tpu_torch.models import stllm as tst
from stllm_tpu_torch.models import vit as tvit
from stllm_tpu_torch.models import zoo as tzoo


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Tiny eager models: one intra-op thread, so parallel test processes
    do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


MEAN_REL = 1e-3
SCALE_RTOL = 1e-5

VIT = dict(image_size=28, patch_size=14, width=64, depth=3, heads=4, mlp_hidden=128,
           use_flash=None)
QF = dict(hidden=32, num_layers=2, heads=4, intermediate=64, encoder_width=64,
          num_query=4, vocab_size=50)
LL = dict(vocab_size=61, hidden=64, num_layers=2, heads=4, intermediate=128,
          max_positions=128)
TOP = dict(video_input="all", vit_model="eva_btadapter_g", btadapter_depth=2)
JVIT, TVIT = jvit.ViTConfig(dtype=jnp.float32, **VIT), tvit.ViTConfig(dtype=torch.float32, **VIT)
JCFG = jst.STLLMConfig(vit=JVIT, qformer=jqf.QFormerConfig(dtype=jnp.float32, **QF),
                       llama=jllama.LlamaConfig(dtype=jnp.float32, **LL), **TOP)
TCFG = tst.STLLMConfig(vit=TVIT, qformer=tqf.QFormerConfig(dtype=torch.float32, **QF),
                       llama=tllama.LlamaConfig(dtype=torch.float32, **LL), **TOP)
FRAMES = 4


@pytest.fixture(scope="module", autouse=True)
def jax_kernels():
    interp = {
        (jvit, "fused_qkv_attention"): jattn.fused_qkv_attention,
        (jvit, "fused_qkv_attention_quant"): jattn.fused_qkv_attention_quant,
        (jvit, "fused_qkv_attention_quant_static"): jattn.fused_qkv_attention_quant_static,
        (jbt, "fused_qkv_attention_quant"): jattn.fused_qkv_attention_quant,
    }
    with pytest.MonkeyPatch.context() as mp:
        for (mod, name), fn in interp.items():
            mp.setattr(mod, name, functools.partial(fn, interpret=True))
        yield
    jax.clear_caches()    # drop traces made with the interpret-mode kernels


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


def _frames(seed, n=1):
    return np.random.default_rng(seed).integers(0, 256, (n * FRAMES, 28, 28, 3)).astype(np.uint8)


@pytest.fixture(scope="module")
def stllm_params():
    return _perturb(jst.init_stllm(jax.random.PRNGKey(0), JCFG), 1)


@pytest.fixture(scope="module")
def vit_q(stllm_params):
    """The BTAdapter ViT, W8A8 (dynamic) and calibrated (static), by JAX."""
    dyn = jvit.quantize_vit_params(stllm_params["vit"])
    static = jbt.calibrate_btadapter_scales(dyn, jnp.asarray(_frames(2)), JVIT, FRAMES)
    return {"dynamic": dyn, "static": static}


def _trees_match(jt, tt, values=True):
    jl, jdef = jax.tree_util.tree_flatten_with_path(jt)
    tl, tdef = jax.tree_util.tree_flatten_with_path(tt)
    assert jdef == tdef
    for (path, a), (_, b) in zip(jl, tl):
        assert tuple(a.shape) == tuple(b.shape), path
        assert np.dtype(a.dtype).name == str(b.dtype).replace("torch.", ""), path
        if values:
            np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=str(path))


def test_quantize_vit_params_matches_jax(stllm_params, vit_q):
    """Trunk blocks and the whole BTAdapter branch (temporal qkv, proj,
    temporal_fc; spatial qkv, proj, fc1, fc2) quantize code for code."""
    got = tvit.quantize_vit_params(_t(stllm_params["vit"]), free_dense=True)
    _trees_match(vit_q["dynamic"], got)
    assert "w_q" in got["btadapter"]["temp"][0]["temporal_fc"]
    assert "w_q" in got["btadapter"]["spatial"][1]["fc2"]


@pytest.mark.parametrize("mode", ["dynamic", "static"])
def test_vit_forward_int8_matches_jax(stllm_params, mode):
    p = {k: v for k, v in stllm_params["vit"].items() if k != "btadapter"}
    jq = jvit.quantize_vit_params(p)
    x = np.random.default_rng(3).standard_normal((2, 28, 28, 3)).astype(np.float32)
    if mode == "static":
        jq = jvit.calibrate_vit_scales(jq, jnp.asarray(x), JVIT)
    want = jvit.vit_forward(jq, jnp.asarray(x), JVIT)
    got = tvit.vit_forward(_t(jq), torch.from_numpy(x), TVIT)
    assert _mean_rel(got.numpy(), want) < MEAN_REL


@pytest.mark.parametrize("mode", ["dynamic", "static"])
def test_btadapter_forward_int8_matches_jax(vit_q, mode):
    x = np.random.default_rng(4).standard_normal((2 * FRAMES, 28, 28, 3)).astype(np.float32)
    want = jbt.btadapter_forward(vit_q[mode], jnp.asarray(x), JVIT, num_frames=FRAMES)
    got = tbt.btadapter_forward(_t(vit_q[mode]), torch.from_numpy(x), TVIT, num_frames=FRAMES)
    assert _mean_rel(got.numpy(), want) < MEAN_REL


def test_calibrate_btadapter_scales_matches_jax(vit_q):
    """The port calibrates the JAX W8A8 tree on the same uint8 clip: every
    trunk block and branch layer gets the JAX package's act_scales."""
    got = tbt.calibrate_btadapter_scales(_t(vit_q["dynamic"]), torch.from_numpy(_frames(2)),
                                         TVIT, FRAMES)
    want = vit_q["static"]
    layers = [(w, g) for w, g in zip(want["blocks"], got["blocks"])]
    for part in ("temp", "spatial"):
        layers += list(zip(want["btadapter"][part], got["btadapter"][part]))
    assert len(layers) == 3 + 2 + 2
    for w, g in layers:
        assert sorted(g["act_scales"]) == sorted(w["act_scales"])
        for k, v in w["act_scales"].items():
            assert g["act_scales"][k].dtype == torch.float32
            assert tuple(g["act_scales"][k].shape) == np.shape(v)
            np.testing.assert_allclose(g["act_scales"][k].numpy(), np.asarray(v),
                                       rtol=SCALE_RTOL, err_msg=k)


def test_quantize_llama_params_prefill_matches_jax(stllm_params):
    jc, tc = JCFG.llama, TCFG.llama
    jq = jllama.quantize_llama_params(stllm_params["llama"])
    tq = tllama.quantize_llama_params(_t(stllm_params["llama"]))
    _trees_match(jq, tq)
    assert "w" in tq["lm_head"] and "w_q" in tq["layers"][1]["down"]
    # the weight-only a16 form: w_q renamed w_q16, the same codes
    ta = tllama.quantize_llama_params(_t(stllm_params["llama"]), a16=True)
    assert "w_q16" in ta["layers"][1]["down"] and "w_q" not in ta["layers"][1]["down"]
    _trees_match(jllama.quantize_llama_params(stllm_params["llama"], a16=True), ta)
    emb = np.random.default_rng(5).standard_normal((2, 8, 64)).astype(np.float32) * 0.3
    mask = np.ones((2, 8), np.int32)
    mask[1, 5:] = 0
    jl, _ = jgen._prefill(jq, jnp.asarray(emb), jnp.asarray(mask), jc, 16)
    tl, _ = tgen._prefill(tq, torch.from_numpy(emb), torch.from_numpy(mask), tc, 16)
    assert _mean_rel(tl.numpy(), jl) < MEAN_REL
    np.testing.assert_array_equal(tl.argmax(-1).numpy(), np.asarray(jnp.argmax(jl, -1)))


def _model_cfg():
    return {"arch": "st_llm_hf", "model_type": "instructblip_vicuna0_btadapter",
            "video_input": "all", "dtype": "fp32", "btadapter_depth": 2,
            "quant_int8": True, "vit": dict(VIT), "qformer": dict(QF), "llama": dict(LL)}


def test_from_config_quant_int8_tree_matches_jax():
    """Same key paths, shapes and dtypes as the JAX package's quant_int8
    tree: int8 linears in the ViT with its branch, the Q-Former and the
    LLaMA layers; llama_proj, patch embed, embeddings, lm_head and norms
    dense."""
    want = jzoo.STLLM.from_config(_model_cfg(), seed=0).params
    got = tzoo.STLLM.from_config(_model_cfg(), seed=0, device="cpu").params
    _trees_match(want, got, values=False)
    assert "w" in got["llama_proj"] and "w" in got["vit"]["patch_embed"]
    assert "w_q" in got["qformer"]["layers"][0]["attention"]["q"]
    # llama.kv_int8 flows into the LLaMA config beside quant_int8, as in JAX
    cfg = {**_model_cfg(), "llama": {**LL, "kv_int8": True}}
    model = tzoo.STLLM.from_config(cfg, device="cpu")
    assert model.cfg.llama.kv_int8 and jzoo.STLLM.from_config(cfg).cfg.llama.kv_int8
    _trees_match(want, model.params, values=False)


def _quantized_stllm(stllm_params, vit_q, mode):
    p = dict(stllm_params)
    p["vit"] = vit_q[mode]
    p["qformer"] = jquant.quantize_tree_linears(stllm_params["qformer"])
    p["llama"] = jllama.quantize_llama_params(stllm_params["llama"])
    return p


def _gen(cls, n):
    return cls(max_new_tokens=n, pad_to_multiple=8, eos_token_id=-1, stop_sequences=())


@pytest.mark.parametrize("mode", ["dynamic", "static"])
def test_int8_video_qa_server_matches_jax(stllm_params, vit_q, mode):
    """The tiny int8 QA server in both modes: encode outputs and prefill
    logits within 1e-3 mean relative error, and the same first token for
    every request."""
    jp = _quantized_stllm(stllm_params, vit_q, mode)
    tp = _t(jp)
    rng = np.random.default_rng(6)
    reqs = [(f"r{i}", _frames(10 + i)[None], rng.integers(3, 61, (1, npre)),
             rng.integers(3, 61, (1, 3)), n)
            for i, (npre, n) in enumerate([(5, 4), (7, 3), (4, 5)])]
    q = rng.integers(0, 50, (1, 6)).astype(np.int32)
    qm = np.ones_like(q)

    rid, fr, pre, suf, _ = reqs[0]
    jemb = jps._encode_assemble(jp, jnp.asarray(fr), jnp.asarray(pre), jnp.asarray(suf),
                                jnp.asarray(q), jnp.asarray(qm), JCFG)
    temb = tps._encode_assemble(tp, torch.from_numpy(fr), torch.from_numpy(pre).int(),
                                torch.from_numpy(suf).int(), torch.from_numpy(q),
                                torch.from_numpy(qm), TCFG)
    assert _mean_rel(temb.numpy(), jemb) < MEAN_REL
    mask = np.ones(jemb.shape[:2], np.int32)
    jl, _ = jgen._prefill(jp["llama"], jemb, jnp.asarray(mask), JCFG.llama, 64)
    tl, _ = tgen._prefill(tp["llama"], temb, torch.from_numpy(mask), TCFG.llama, 64)
    assert _mean_rel(tl.numpy(), jl) < MEAN_REL

    js = jps.VideoQAServer(jp, JCFG, slots=2, max_len=128, chunk=4)
    ts = tps.VideoQAServer(tp, TCFG, slots=2, max_len=128, chunk=4)
    for rid, fr, pre, suf, n in reqs:
        js.submit(rid, jnp.asarray(fr), pre, suf, _gen(jgen.GenerationConfig, n),
                  qformer_text_ids=q)
        ts.submit(rid, fr, pre, suf, _gen(tgen.GenerationConfig, n), qformer_text_ids=q)
    want, got = js.run(), ts.run()
    assert set(got) == set(want) == {r[0] for r in reqs}
    assert [len(got[r[0]]) for r in reqs] == [r[4] for r in reqs]
    assert {k: v[0] for k, v in got.items()} == {k: v[0] for k, v in want.items()}


def test_static_encode_runs_the_static_layers(vit_q):
    """After calibration every trunk block and branch layer carries fp32
    act_scales (0-d, and (3,) for attn), and the quantized tree keeps its
    W8A8 linears."""
    tq = tbt.calibrate_btadapter_scales(_t(vit_q["dynamic"]), torch.from_numpy(_frames(2)),
                                        TVIT, FRAMES)
    for layer in tq["blocks"] + tq["btadapter"]["spatial"]:
        sc = layer["act_scales"]
        assert sc["attn"].shape == (3,) and sc["qkv"].shape == ()
        assert all(bool(torch.isfinite(v).all() and (v > 0).all()) for v in sc.values())
    assert sorted(tq["btadapter"]["temp"][0]["act_scales"]) == ["proj", "qkv", "temporal_fc"]
