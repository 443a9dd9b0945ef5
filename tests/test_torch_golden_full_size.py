"""PyTorch port, full-size golden fixtures on the CPU (the port's copy of
tests/test_golden_full_size.py): one Vicuna-7B-wide LLaMA layer plus
``lm_head`` (4096 / 11008 / 32 heads / vocab 32000) and one 1408-wide
EVA-ViT-g block, port against the JAX package in fp32 from one seeded
numpy tree, and against HF transformers (LLaMA) and the reference's block
written in torch (ViT), as the JAX file holds the JAX package. Random
weights, one layer each: the largest parity scale reachable without weights
on disk. Marked slow as that file is, so Tier-1 does not run it:
``python -m pytest -m slow tests/test_torch_golden_full_size.py``.

Tolerances, the JAX file's recorded ones (full-size fp32 accumulation
order): LLaMA layer + lm_head logits atol 2e-3 (rtol 1e-3), the argmax
equal; ViT-g block atol 1e-3 (rtol 1e-3)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stllm_tpu.models import llama as jllama
from stllm_tpu.models import vit as jvit
from stllm_tpu_torch.convert.from_jax import load_jax_params
from stllm_tpu_torch.convert.to_reference import hf_llama_state
from stllm_tpu_torch.models import llama as tllama
from stllm_tpu_torch.models import vit as tvit

LLAMA = dict(vocab_size=32000, hidden=4096, num_layers=1, heads=32, intermediate=11008,
             max_positions=2048)
LLAMA_ATOL, LLAMA_RTOL = 2e-3, 1e-3
VIT_ATOL, VIT_RTOL = 1e-3, 1e-3


def _seeded_tree(shapes, seed: int, std: float = 0.02):
    """numpy leaves of the JAX tree's shapes: N(0, std), but 1 + N(0, 0.1)
    for norm scales and N(0, 0.1) for every other 1-d leaf (norm shifts and
    biases), so no leaf is trivial."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = jax.tree_util.keystr(path)
        if "scale" in name:
            return (1 + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        if len(s.shape) == 1:
            return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        return (std * rng.standard_normal(s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.mark.slow
def test_full_size_llama_layer_and_lm_head_golden():
    jcfg = jllama.LlamaConfig(dtype=jnp.float32, **LLAMA)
    tcfg = tllama.LlamaConfig(dtype=torch.float32, **LLAMA)
    tree = _seeded_tree(jax.eval_shape(lambda: jllama.init_llama(jax.random.PRNGKey(0), jcfg)),
                        seed=7)
    ids = np.random.default_rng(3).integers(0, LLAMA["vocab_size"], (1, 9))
    hidden, _ = jllama.llama_forward(jax.tree_util.tree_map(jnp.asarray, tree),
                                     input_ids=jnp.asarray(ids), cfg=jcfg)
    want = np.asarray(jllama.lm_head(tree, hidden))
    del hidden
    params = load_jax_params(tree, device="cpu")
    del tree
    with torch.no_grad():
        th, _ = tllama.llama_forward(params, input_ids=torch.from_numpy(ids), cfg=tcfg)
        got = tllama.lm_head(params, th).numpy()
    assert got.shape == want.shape == (1, 9, 32000)
    assert (got.argmax(-1) == want.argmax(-1)).all()
    np.testing.assert_allclose(got, want, atol=LLAMA_ATOL, rtol=LLAMA_RTOL,
                               err_msg=f"max|diff|={float(np.abs(got - want).max())}")

    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.LlamaConfig(
        vocab_size=tcfg.vocab_size, hidden_size=tcfg.hidden, num_hidden_layers=tcfg.num_layers,
        num_attention_heads=tcfg.heads, num_key_value_heads=tcfg.heads,
        intermediate_size=tcfg.intermediate, max_position_embeddings=tcfg.max_positions,
        rms_norm_eps=tcfg.rms_eps, rope_theta=tcfg.rope_theta, attn_implementation="eager",
        tie_word_embeddings=False)
    hf = transformers.LlamaForCausalLM(hf_cfg).eval()
    hf.load_state_dict(hf_llama_state(params), strict=True)
    del params
    with torch.no_grad():
        hf_logits = hf(torch.from_numpy(ids)).logits.numpy()
    assert (got.argmax(-1) == hf_logits.argmax(-1)).all()
    np.testing.assert_allclose(got, hf_logits, atol=LLAMA_ATOL, rtol=LLAMA_RTOL,
                               err_msg=f"max|diff|={float(np.abs(got - hf_logits).max())}")


def _torch_block(blk, x: np.ndarray, cfg) -> np.ndarray:
    """The reference's EVA-ViT-g block (eva_vit.py:60-140: pre-norm, q/v-only
    bias, exact GELU) in torch, as tests/test_golden_full_size.py writes it."""
    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32))

    with torch.no_grad():
        xt = t(x)
        h = torch.nn.functional.layer_norm(xt, (cfg.width,), t(blk["norm1"]["scale"]),
                                           t(blk["norm1"]["bias"]), eps=cfg.ln_eps)
        qkv = h @ t(blk["qkv"]["w"]) + torch.cat([t(blk["q_bias"]), torch.zeros(cfg.width),
                                                  t(blk["v_bias"])])
        b, n, heads, d = 1, cfg.seq_len, cfg.heads, cfg.head_dim
        q, k, v = (z.view(b, n, heads, d).permute(0, 2, 1, 3) for z in qkv.chunk(3, dim=-1))
        attn = torch.softmax(q @ k.transpose(-2, -1) * d ** -0.5, dim=-1)
        o = (attn @ v).permute(0, 2, 1, 3).reshape(b, n, heads * d)
        x1 = xt + (o @ t(blk["proj"]["w"]) + t(blk["proj"]["b"]))
        h2 = torch.nn.functional.layer_norm(x1, (cfg.width,), t(blk["norm2"]["scale"]),
                                            t(blk["norm2"]["bias"]), eps=cfg.ln_eps)
        h2 = torch.nn.functional.gelu(h2 @ t(blk["fc1"]["w"]) + t(blk["fc1"]["b"]))
        return (x1 + (h2 @ t(blk["fc2"]["w"]) + t(blk["fc2"]["b"]))).numpy()


@pytest.mark.slow
def test_full_size_vit_g_block_golden():
    jcfg = dataclasses.replace(jvit.EVA_VIT_G, depth=1, dtype=jnp.float32)
    tcfg = dataclasses.replace(tvit.EVA_VIT_G, depth=1, dtype=torch.float32)
    assert (tcfg.width, tcfg.heads, tcfg.mlp_hidden, tcfg.seq_len) == (1408, 16, 6144, 257)
    shapes = jax.eval_shape(lambda: jvit.init_vit(jax.random.PRNGKey(11), jcfg))
    blk = _seeded_tree(shapes["blocks"][0], seed=5)
    x = (np.random.default_rng(6).standard_normal((1, jcfg.seq_len, jcfg.width)) * 0.5
         ).astype(np.float32)
    want = np.asarray(jvit.vit_block(jax.tree_util.tree_map(jnp.asarray, blk), jnp.asarray(x),
                                     jcfg))
    with torch.no_grad():
        got = tvit.vit_block(load_jax_params(blk, device="cpu"), torch.from_numpy(x),
                             tcfg).numpy()
    np.testing.assert_allclose(got, want, atol=VIT_ATOL, rtol=VIT_RTOL,
                               err_msg=f"max|diff|={float(np.abs(got - want).max())}")
    oracle = _torch_block(blk, x, tcfg)
    np.testing.assert_allclose(got, oracle, atol=VIT_ATOL, rtol=VIT_RTOL,
                               err_msg=f"max|diff|={float(np.abs(got - oracle).max())}")
