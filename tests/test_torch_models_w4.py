"""PyTorch port, the W4A16 serving stack against the JAX package on tiny
fp32 configs: int4 LLaMA trees (fused and unfused, per-channel and
per-group), the weight-only int8 forms (``a16`` layers, the ``w_q16``
lm_head), the int8 KV cache, the continuous batcher and the video-QA server
on the whole stack (static-int8 ViT, int4 LLaMA, int8 head, int8 KV cache).
JAX params come from the reference's own init and quantizers, converted
with load_jax_params; the same numpy inputs go through both packages.

Tolerances: quantized trees bit for bit; logits within 1e-4 absolute (a few
fp32 ulps per op over the layers); greedy tokens identical. The int8 KV
cache codes may move by one step where the two packages' fp32 k/v straddle
a rounding boundary (at most 1% of the codes), and the scales agree within
1e-5 relative. The JAX ViT runs its int8 Pallas kernels in interpret mode,
as in tests/test_torch_models_int8.py; the QA server's encode then agrees
within 1e-3 mean relative error, as there."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stllm_tpu import pipeline_serving as jps
from stllm_tpu import serving as jserving
from stllm_tpu.models import btadapter as jbt
from stllm_tpu.models import generation as jgen
from stllm_tpu.models import llama as jllama
from stllm_tpu.models import qformer as jqf
from stllm_tpu.models import stllm as jst
from stllm_tpu.models import vit as jvit
from stllm_tpu.ops import attention as jattn
from stllm_tpu_torch import pipeline_serving as tps
from stllm_tpu_torch import serving as tserving
from stllm_tpu_torch.convert.from_jax import load_jax_params
from stllm_tpu_torch.models import generation as tgen
from stllm_tpu_torch.models import llama as tllama
from stllm_tpu_torch.models import qformer as tqf
from stllm_tpu_torch.models import stllm as tst
from stllm_tpu_torch.models import vit as tvit


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Tiny eager models: one intra-op thread, so parallel test processes
    do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


ATOL = 1e-4
MEAN_REL = 1e-3

LL = dict(vocab_size=61, hidden=64, num_layers=2, heads=4, intermediate=128,
          max_positions=128)
JC, TC = jllama.LlamaConfig(dtype=jnp.float32, **LL), tllama.LlamaConfig(dtype=torch.float32, **LL)
JQ, TQ = dataclasses.replace(JC, kv_int8=True), dataclasses.replace(TC, kv_int8=True)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(tree):
    return load_jax_params(_np(tree), device="cpu")


def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               atol=atol, rtol=0)


def _perturb(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: a + jnp.asarray(rng.standard_normal(a.shape) * 0.02, a.dtype), tree)


def _trees_match(jt, tt):
    jl, jdef = jax.tree_util.tree_flatten_with_path(jt)
    tl, tdef = jax.tree_util.tree_flatten_with_path(tt)
    assert jdef == tdef
    for (path, a), (_, b) in zip(jl, tl):
        assert np.dtype(a.dtype).name == str(b.dtype).replace("torch.", ""), path
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=str(path))


def _gen(cls, n):
    return cls(max_new_tokens=n, pad_to_multiple=8, eos_token_id=-1, stop_sequences=())


@pytest.fixture(scope="module")
def llama_params():
    return _perturb(jllama.init_llama(jax.random.PRNGKey(0), JC), 1)


def _prompt(seed):
    emb = _rand(seed, 2, 8, 64, scale=0.3)
    mask = np.ones((2, 8), np.int32)
    mask[1, 5:] = 0
    return emb, mask


# --------------------------------------------------------------------------
# int4 and weight-only int8 trees
# --------------------------------------------------------------------------

@pytest.mark.parametrize("fuse,group", [(True, None), (False, None), (False, 32)],
                         ids=["fused", "unfused", "group32"])
def test_int4_llama_prefill_and_greedy_match_jax(llama_params, fuse, group):
    """The port quantizes the converted dense tree into JAX's int4 tree bit
    for bit; prefill hidden states and logits agree and greedy tokens are
    identical."""
    jq = jllama.quantize_llama_params_int4(llama_params, group=group, fuse=fuse,
                                           quant_head=True)
    tq = tllama.quantize_llama_params_int4(_t(llama_params), group=group, fuse=fuse,
                                           quant_head=True, free_dense=True)
    _trees_match(jq, tq)
    layer = tq["layers"][0]
    assert ("qkv" in layer and "gateup" in layer and "q" not in layer) == fuse
    emb, mask = _prompt(2)
    jh, _ = jllama.prefill_with_cache(jq, jnp.asarray(emb), jnp.asarray(mask), 16, JC)
    cache = tllama.init_kv_cache(TC, 2, 16)
    th, _ = tllama.llama_forward(tq, inputs_embeds=torch.from_numpy(emb),
                                 attention_mask=torch.from_numpy(mask), cache=cache, cfg=TC)
    _close(th.numpy(), jh)
    jl, _ = jgen._prefill(jq, jnp.asarray(emb), jnp.asarray(mask), JC, 16)
    tl, _ = tgen._prefill(tq, torch.from_numpy(emb), torch.from_numpy(mask), TC, 16)
    _close(tl.numpy(), jl)
    want = jgen.generate(jq, jnp.asarray(emb), llama_cfg=JC, gen=_gen(jgen.GenerationConfig, 10))
    got = tgen.generate(tq, torch.from_numpy(emb), llama_cfg=TC,
                        gen=_gen(tgen.GenerationConfig, 10))
    assert got == want


def test_fused_equals_unfused_int4(llama_params):
    """Per-channel scales make the fused q|k|v and gate|up exactly the
    unfused math: the same hidden states."""
    emb, mask = _prompt(3)
    outs = []
    for fuse in (True, False):
        tq = tllama.quantize_llama_params_int4(_t(llama_params), group=None, fuse=fuse)
        h, _ = tllama.llama_forward(tq, inputs_embeds=torch.from_numpy(emb),
                                    attention_mask=torch.from_numpy(mask),
                                    cache=tllama.init_kv_cache(TC, 2, 16), cfg=TC)
        outs.append(h.numpy())
    np.testing.assert_array_equal(outs[0], outs[1])


def test_w_q16_head_logits_match_jax(llama_params):
    """The int8 weight-only head: bf16 hidden states (even in an fp32
    model) times the codes, fp32 accumulation and scale."""
    jq = jllama.quantize_llama_params_int4(llama_params, group=None, quant_head=True)
    tq = _t(jq)
    assert sorted(tq["lm_head"]) == ["w_q16", "w_scale"]
    hidden = _rand(4, 2, 3, 64)
    want = jllama.lm_head(jq, jnp.asarray(hidden))
    got = tllama.lm_head(tq, torch.from_numpy(hidden))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_a16_matches_jax(llama_params):
    """quantize_llama_params(a16=True): the w_q16 key on every decoder
    linear, the same tree as JAX, the same logits and greedy tokens."""
    jq = jllama.quantize_llama_params(llama_params, a16=True)
    tq = tllama.quantize_llama_params(_t(llama_params), a16=True, free_dense=True)
    _trees_match(jq, tq)
    assert "w_q16" in tq["layers"][1]["down"] and "w_q" not in tq["layers"][1]["down"]
    emb, mask = _prompt(5)
    jl, _ = jgen._prefill(jq, jnp.asarray(emb), jnp.asarray(mask), JC, 16)
    tl, _ = tgen._prefill(tq, torch.from_numpy(emb), torch.from_numpy(mask), TC, 16)
    _close(tl.numpy(), jl)
    want = jgen.generate(jq, jnp.asarray(emb), llama_cfg=JC, gen=_gen(jgen.GenerationConfig, 8))
    got = tgen.generate(tq, torch.from_numpy(emb), llama_cfg=TC,
                        gen=_gen(tgen.GenerationConfig, 8))
    assert got == want


# --------------------------------------------------------------------------
# the int8 KV cache
# --------------------------------------------------------------------------

def _codes_close(got, want):
    diff = np.abs(got.numpy().astype(np.int32) - np.asarray(want).astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() <= 0.01, (diff.max(), (diff > 0).mean())


def test_kv_int8_prefill_and_decode_match_jax(llama_params):
    """Prefill into a fresh int8 cache, then two decode steps: int8 codes
    with fp32 scales (ones where nothing was written), the same logits and
    cache contents as JAX."""
    tp = _t(llama_params)
    cache = tllama.init_kv_cache(TQ, 2, 16)
    assert cache.k[0].dtype == torch.int8 and cache.k_scale[0].shape == (2, 16, 4)
    assert bool((cache.v_scale[1] == 1).all())
    emb, mask = _prompt(6)
    jl, jcache = jgen._prefill(llama_params, jnp.asarray(emb), jnp.asarray(mask), JQ, 16)
    tl, tcache = tgen._prefill(tp, torch.from_numpy(emb), torch.from_numpy(mask), TQ, 16)
    _close(tl.numpy(), jl)
    tok = np.array([3, 60], np.int32)
    for _ in range(2):
        jl, jcache = jgen._decode_step_impl(llama_params, jnp.asarray(tok), jcache, JQ)
        tl, tcache = tgen._decode_step_impl(tp, torch.from_numpy(tok), tcache, TQ)
        _close(tl.numpy(), jl)
        tok = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
    assert tcache.k[0].dtype == torch.int8
    for a, b in zip(tcache.k + tcache.v, jcache.k + jcache.v):
        _codes_close(a, b)
    for a, b in zip(tcache.k_scale + tcache.v_scale, jcache.k_scale + jcache.v_scale):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5)
    np.testing.assert_array_equal(tcache.length.numpy(), np.asarray(jcache.length))


def test_kv_int8_generate_matches_jax(llama_params):
    emb = _rand(7, 2, 6, 64, scale=0.3)
    for kw in [dict(max_new_tokens=12, eos_token_id=-1, stop_sequences=()),
               dict(max_new_tokens=16, eos_token_id=5, stop_sequences=((7,), (8, 9)))]:
        want = jgen.generate(llama_params, jnp.asarray(emb), llama_cfg=JQ,
                             gen=jgen.GenerationConfig(pad_to_multiple=8, **kw))
        got = tgen.generate(_t(llama_params), torch.from_numpy(emb), llama_cfg=TQ,
                            gen=tgen.GenerationConfig(pad_to_multiple=8, **kw))
        assert got == want


def test_batcher_on_the_quantized_serving_tree_matches_jax(llama_params):
    """The serving form (fused W4A16, int8 head, int8 KV cache) through the
    port's ContinuousBatcher, over 2 slots with slot reuse, against JAX's
    solo generate and JAX's batcher on the same tree."""
    jq = jllama.quantize_llama_params_int4(llama_params, group=None, fuse=True,
                                           quant_head=True)
    tq = _t(jq)
    reqs = [(f"r{i}", _rand(10 + i, 1, s, 64, scale=0.3), n)
            for i, (s, n) in enumerate([(5, 10), (9, 4), (3, 7)])]
    want = {rid: jgen.generate(jq, jnp.asarray(e), llama_cfg=JQ,
                               gen=_gen(jgen.GenerationConfig, n))[0] for rid, e, n in reqs}
    jb = jserving.ContinuousBatcher(jq, JQ, slots=2, max_len=48, chunk=4)
    tb = tserving.ContinuousBatcher(tq, TQ, slots=2, max_len=48, chunk=4)
    assert tb.cache.k_scale is not None and tb.cache.k[0].dtype == torch.int8
    for rid, e, n in reqs:
        jb.submit(rid, jnp.asarray(e), _gen(jgen.GenerationConfig, n))
        tb.submit(rid, torch.from_numpy(e), _gen(tgen.GenerationConfig, n))
    got = tb.run()
    assert got == want == jb.run()


# --------------------------------------------------------------------------
# the whole stack behind the video-QA server
# --------------------------------------------------------------------------

VIT = dict(image_size=28, patch_size=14, width=64, depth=3, heads=4, mlp_hidden=128,
           use_flash=None)
QF = dict(hidden=32, num_layers=2, heads=4, intermediate=64, encoder_width=64,
          num_query=4, vocab_size=50)
TOP = dict(video_input="all", vit_model="eva_btadapter_g", btadapter_depth=2)
JVIT = jvit.ViTConfig(dtype=jnp.float32, **VIT)
JCFG = jst.STLLMConfig(vit=JVIT, qformer=jqf.QFormerConfig(dtype=jnp.float32, **QF),
                       llama=JQ, **TOP)
TCFG = tst.STLLMConfig(vit=tvit.ViTConfig(dtype=torch.float32, **VIT),
                       qformer=tqf.QFormerConfig(dtype=torch.float32, **QF), llama=TQ, **TOP)
FRAMES = 4


def _frames(seed):
    return np.random.default_rng(seed).integers(0, 256, (FRAMES, 28, 28, 3)).astype(np.uint8)


@pytest.fixture
def jax_kernels():
    """The JAX ViT's int8 attention through its Pallas kernels in interpret
    mode (tests/test_torch_models_int8.py)."""
    interp = {(jvit, "fused_qkv_attention"): jattn.fused_qkv_attention,
              (jvit, "fused_qkv_attention_quant"): jattn.fused_qkv_attention_quant,
              (jvit, "fused_qkv_attention_quant_static"): jattn.fused_qkv_attention_quant_static,
              (jbt, "fused_qkv_attention_quant"): jattn.fused_qkv_attention_quant}
    with pytest.MonkeyPatch.context() as mp:
        for (mod, name), fn in interp.items():
            mp.setattr(mod, name, functools.partial(fn, interpret=True))
        yield
    jax.clear_caches()


def test_video_qa_server_on_the_w4a16_stack_matches_jax(jax_kernels):
    """Static-int8 ViT with its BTAdapter branch (calibrated by JAX on one
    clip), dense Q-Former, fused int4 LLaMA with the int8 head and the
    int8 KV cache: encode within 1e-3 mean relative error, then greedy
    tokens identical to the JAX server for every request."""
    jp = _perturb(jst.init_stllm(jax.random.PRNGKey(0), JCFG), 1)
    jp["vit"] = jbt.calibrate_btadapter_scales(jvit.quantize_vit_params(jp["vit"]),
                                               jnp.asarray(_frames(2)), JVIT, FRAMES)
    jp["llama"] = jllama.quantize_llama_params_int4(jp["llama"], group=None, fuse=True,
                                                    quant_head=True)
    tp = _t(jp)
    rng = np.random.default_rng(6)
    reqs = [(f"r{i}", _frames(10 + i)[None], rng.integers(3, 61, (1, npre)),
             rng.integers(3, 61, (1, 3)), n)
            for i, (npre, n) in enumerate([(5, 6), (7, 3), (4, 8)])]
    q = rng.integers(0, 50, (1, 6)).astype(np.int32)
    _, fr, pre, suf, _ = reqs[0]
    jemb = jps._encode_assemble(jp, jnp.asarray(fr), jnp.asarray(pre), jnp.asarray(suf),
                                jnp.asarray(q), jnp.ones_like(jnp.asarray(q)), JCFG)
    temb = tps._encode_assemble(tp, torch.from_numpy(fr), torch.from_numpy(pre).int(),
                                torch.from_numpy(suf).int(), torch.from_numpy(q),
                                torch.ones((1, 6), dtype=torch.int32), TCFG)
    jemb, temb = np.asarray(jemb, np.float64), temb.numpy().astype(np.float64)
    assert np.abs(temb - jemb).mean() / np.abs(jemb).mean() < MEAN_REL
    js = jps.VideoQAServer(jp, JCFG, slots=2, max_len=128, chunk=4)
    ts = tps.VideoQAServer(tp, TCFG, slots=2, max_len=128, chunk=4)
    for rid, fr, pre, suf, n in reqs:
        js.submit(rid, jnp.asarray(fr), pre, suf, _gen(jgen.GenerationConfig, n),
                  qformer_text_ids=q)
        ts.submit(rid, fr, pre, suf, _gen(tgen.GenerationConfig, n), qformer_text_ids=q)
    want, got = js.run(), ts.run()
    assert set(got) == {r[0] for r in reqs}
    assert [len(got[r[0]]) for r in reqs] == [r[4] for r in reqs]
    assert got == want
