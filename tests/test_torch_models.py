"""PyTorch port, model layer (stllm_tpu_torch/models): JAX params from the
reference's own init, converted with load_jax_params, and the same numpy
inputs through both packages, in fp32.

The ViT and BTAdapter run with ``use_flash=None``: the JAX side goes through
``fused_qkv_attention`` (plain softmax on the CPU), the port through the
kernel's plain version (clamped exp2 softmax, exact below the clamp).
Tolerance 1e-4 absolute on activations of unit scale: a few fp32 ulps per
op, compounded over the layers."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stllm_tpu.models import btadapter as jbt
from stllm_tpu.models import generation as jgen
from stllm_tpu.models import llama as jllama
from stllm_tpu.models import qformer as jqf
from stllm_tpu.models import stllm as jst
from stllm_tpu.models import vit as jvit
from stllm_tpu_torch.convert.from_jax import load_jax_params
from stllm_tpu_torch.models import btadapter as tbt
from stllm_tpu_torch.models import generation as tgen
from stllm_tpu_torch.models import llama as tllama
from stllm_tpu_torch.models import qformer as tqf
from stllm_tpu_torch.models import stllm as tst
from stllm_tpu_torch.models import vit as tvit

ATOL = 1e-4

VIT = dict(image_size=28, patch_size=14, width=64, depth=3, heads=4, mlp_hidden=128,
           use_flash=None)
QF = dict(hidden=32, num_layers=3, heads=4, intermediate=64, encoder_width=64,
          num_query=4, vocab_size=50, max_positions=16)
LL = dict(vocab_size=61, hidden=64, num_layers=2, heads=4, intermediate=128,
          max_positions=64)


def _jcfg(video_input="all", vit_model="eva_btadapter_g"):
    return jst.STLLMConfig(
        vit=jvit.ViTConfig(dtype=jnp.float32, **VIT),
        qformer=jqf.QFormerConfig(dtype=jnp.float32, **QF),
        llama=jllama.LlamaConfig(dtype=jnp.float32, **LL),
        video_input=video_input, vit_model=vit_model, btadapter_depth=2, residual_size=2)


def _tcfg(video_input="all", vit_model="eva_btadapter_g"):
    return tst.STLLMConfig(
        vit=tvit.ViTConfig(dtype=torch.float32, **VIT),
        qformer=tqf.QFormerConfig(dtype=torch.float32, **QF),
        llama=tllama.LlamaConfig(dtype=torch.float32, **LL),
        video_input=video_input, vit_model=vit_model, btadapter_depth=2, residual_size=2)


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
    """Give zero-init leaves (biases, temporal_fc, cls) values so every
    parameter takes part in the comparison."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: a + jnp.asarray(rng.standard_normal(a.shape) * 0.02, a.dtype), tree)


@pytest.fixture(scope="module")
def stllm_params():
    return _perturb(jst.init_stllm(jax.random.PRNGKey(0), _jcfg("residual")), 1)


def test_init_trees_match_reference_layout():
    """The port's own init builds the reference's tree: same key paths,
    shapes and dtypes (so the converter is a copy by key path)."""
    for vi, vm in [("residual", "eva_btadapter_g"), ("all", "eva_clip_g")]:
        jcfg = dataclasses.replace(_jcfg(vi, vm), mvm_decode=True, qformer_text_input=False)
        tcfg = dataclasses.replace(_tcfg(vi, vm), mvm_decode=True, qformer_text_input=False)
        jp = jst.init_stllm(jax.random.PRNGKey(0), jcfg)
        tp = tst.init_stllm(torch.Generator().manual_seed(0), tcfg)
        jl, jdef = jax.tree_util.tree_flatten_with_path(jp)
        tl, tdef = jax.tree_util.tree_flatten_with_path(tp)
        assert [p for p, _ in jl] == [p for p, _ in tl]
        assert jdef == tdef       # None leaves in the same places
        for (path, a), (_, b) in zip(jl, tl):
            assert tuple(a.shape) == tuple(b.shape), path
            assert np.dtype(a.dtype).name == str(b.dtype).replace("torch.", ""), path


def test_patchify_matches_jax():
    x = _rand(2, 3, 28, 42, 3)
    _close(tvit.patchify(torch.from_numpy(x), 14).numpy(), jvit.patchify(jnp.asarray(x), 14), 0)


@pytest.mark.parametrize("use_flash", [None, False])
def test_vit_forward_matches_jax(stllm_params, use_flash):
    jc = jvit.ViTConfig(dtype=jnp.float32, **{**VIT, "use_flash": use_flash})
    tc = tvit.ViTConfig(dtype=torch.float32, **{**VIT, "use_flash": use_flash})
    p = {k: v for k, v in stllm_params["vit"].items() if k != "btadapter"}
    x = _rand(3, 2, 28, 28, 3)
    want = jvit.vit_forward(p, jnp.asarray(x), jc)
    got = tvit.vit_forward(_t(p), torch.from_numpy(x), tc)
    _close(got.numpy(), want)


def test_btadapter_forward_matches_jax(stllm_params):
    jc = jvit.ViTConfig(dtype=jnp.float32, **VIT)
    tc = tvit.ViTConfig(dtype=torch.float32, **VIT)
    x = _rand(4, 2 * 4, 28, 28, 3)        # 2 videos x 4 frames
    want = jbt.btadapter_forward(stllm_params["vit"], jnp.asarray(x), jc, num_frames=4)
    got = tbt.btadapter_forward(_t(stllm_params["vit"]), torch.from_numpy(x), tc, num_frames=4)
    _close(got.numpy(), want)


def test_qformer_forward_with_text_matches_jax(stllm_params):
    jc = jqf.QFormerConfig(dtype=jnp.float32, **QF)
    tc = tqf.QFormerConfig(dtype=torch.float32, **QF)
    enc = _rand(5, 3, 7, 64)
    ids = np.random.default_rng(6).integers(0, 50, (3, 5)).astype(np.int32)
    mask = np.ones((3, 5), np.int32)
    mask[1, 3:] = 0
    want = jqf.qformer_forward(stllm_params["qformer"], encoder_hidden_states=jnp.asarray(enc),
                               input_ids=jnp.asarray(ids), attention_mask=jnp.asarray(mask),
                               cfg=jc)
    got = tqf.qformer_forward(_t(stllm_params["qformer"]), encoder_hidden_states=torch.from_numpy(enc),
                              input_ids=torch.from_numpy(ids), attention_mask=torch.from_numpy(mask),
                              cfg=tc)
    assert got.shape == (3, 4 + 5, 32)
    _close(got.numpy(), want)


@pytest.mark.parametrize("video_input", ["all", "mean", "residual"])
def test_encode_and_video_input_match_jax(stllm_params, video_input):
    """uint8 frames normalized on the device, BTAdapter trunk, ln_vision,
    Q-Former with the question repeated per frame, llama_proj, video_input."""
    jc, tc = _jcfg(video_input), _tcfg(video_input)
    frames = np.random.default_rng(7).integers(0, 256, (1, 4, 28, 28, 3)).astype(np.uint8)
    q = np.random.default_rng(8).integers(0, 50, (1, 6)).astype(np.int32)
    want = jst.encode_video_for_inference(stllm_params, jnp.asarray(frames), jc, jnp.asarray(q))
    got = tst.encode_video_for_inference(_t(stllm_params), torch.from_numpy(frames), tc,
                                         torch.from_numpy(q))
    assert got.shape == tuple(want.shape)
    _close(got.numpy(), want)


def test_assemble_embeddings_matches_jax():
    table = _rand(9, 20, 8)
    ids = np.random.default_rng(10).integers(0, 20, (2, 9)).astype(np.int32)
    slot = np.full((2, 9), -1, np.int32)
    slot[0, 2:5] = [0, 1, 2]
    slot[1, 4:6] = [2, 0]
    vid = _rand(11, 2, 3, 8)
    want = jst.assemble_embeddings(jnp.asarray(table), jnp.asarray(ids), jnp.asarray(slot),
                                   jnp.asarray(vid))
    got = tst.assemble_embeddings(torch.from_numpy(table), torch.from_numpy(ids),
                                  torch.from_numpy(slot), torch.from_numpy(vid))
    _close(got.numpy(), want, 0)


def test_llama_prefill_into_cache_then_decode_matches_jax(stllm_params):
    """Right-padded prefill into a fresh cache, then two single-token decode
    steps: hidden states, fp32 logits and cache contents agree."""
    jc = jllama.LlamaConfig(dtype=jnp.float32, **LL)
    tc = tllama.LlamaConfig(dtype=torch.float32, **LL)
    jp, tp = stllm_params["llama"], _t(stllm_params["llama"])
    emb = _rand(12, 2, 8, 64, scale=0.3)
    mask = np.ones((2, 8), np.int32)
    mask[1, 5:] = 0
    jl, jcache = jgen._prefill(jp, jnp.asarray(emb), jnp.asarray(mask), jc, 16)
    tl, tcache = tgen._prefill(tp, torch.from_numpy(emb), torch.from_numpy(mask), tc, 16)
    assert tl.dtype == torch.float32
    _close(tl.numpy(), jl)
    np.testing.assert_array_equal(tcache.length.numpy(), np.asarray(jcache.length))
    tok = np.array([3, 60], np.int32)
    for _ in range(2):
        jl, jcache = jgen._decode_step_impl(jp, jnp.asarray(tok), jcache, jc)
        tl, tcache = tgen._decode_step_impl(tp, torch.from_numpy(tok), tcache, tc)
        _close(tl.numpy(), jl)
        tok = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
    for a, b in zip(tcache.k + tcache.v, jcache.k + jcache.v):
        _close(a.numpy(), b)
    np.testing.assert_array_equal(tcache.length.numpy(), np.asarray(jcache.length))


def test_generate_greedy_matches_jax(stllm_params):
    jc = jllama.LlamaConfig(dtype=jnp.float32, **LL)
    tc = tllama.LlamaConfig(dtype=torch.float32, **LL)
    emb = _rand(13, 2, 6, 64, scale=0.3)
    for kw in [dict(max_new_tokens=12, eos_token_id=-1, stop_sequences=()),
               dict(max_new_tokens=20, eos_token_id=5, stop_sequences=((7,), (8, 9)))]:
        want = jgen.generate(stllm_params["llama"], jnp.asarray(emb), llama_cfg=jc,
                             gen=jgen.GenerationConfig(pad_to_multiple=8, **kw))
        got = tgen.generate(_t(stllm_params["llama"]), torch.from_numpy(emb), llama_cfg=tc,
                            gen=tgen.GenerationConfig(pad_to_multiple=8, **kw))
        assert got == want


@pytest.mark.parametrize("kw", [dict(do_sample=True), dict(num_beams=3),
                                dict(repetition_penalty=1.2), dict(min_length=4)])
def test_generate_refuses_non_greedy(kw):
    """The batcher's guard refuses all four; generate itself now serves
    sampling, the repetition penalty and min_length
    (tests/test_torch_sampling.py) and still refuses beams."""
    with pytest.raises(tgen.UnsupportedRequest):
        tgen.check_greedy(tgen.GenerationConfig(**kw))
    if "num_beams" in kw:
        with pytest.raises(tgen.UnsupportedRequest):
            tgen.generate({}, torch.zeros((1, 2, 4)), llama_cfg=tllama.LlamaConfig(),
                          gen=tgen.GenerationConfig(**kw))
