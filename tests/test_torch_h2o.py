"""PyTorch port, H2O KV-cache eviction (stllm_tpu_torch/models/h2o.py)
against the JAX package on a tiny fp32 LLaMA: the prefill's hidden states
and compressed cache (kept positions exactly, values and masses within
fp32 tolerance), the decode step and the greedy chunk with eviction taking
place, and the exactness contract (a budget that holds the prompt and every
new token evicts nothing, and the tokens and logits equal the dense
cache's)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stllm_tpu.models import h2o as jh2o
from stllm_tpu.models import llama as jllama
from stllm_tpu_torch.convert.from_jax import load_jax_params
from stllm_tpu_torch.models import generation as tgen
from stllm_tpu_torch.models import h2o as th2o
from stllm_tpu_torch.models import llama as tllama


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's side runs tiny eager models: one intra-op thread each. A
    full pool per test process oversubscribes the cores when the suite runs
    in parallel processes, and these many small ops then wait on it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


LL = dict(vocab_size=128, hidden=64, num_layers=2, heads=4, intermediate=128,
          max_positions=256)
ATOL, RTOL = 1e-5, 1e-4


@pytest.fixture(scope="module")
def setup():
    jc = jllama.LlamaConfig(dtype=jnp.float32, **LL)
    tc = tllama.LlamaConfig(dtype=torch.float32, **LL)
    jp = jax.jit(lambda key: jllama.init_llama(key, jc))(jax.random.PRNGKey(0))
    tp = load_jax_params(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    rs = np.random.RandomState(3)
    emb = (rs.randn(2, 12, LL["hidden"]) * 0.05).astype(np.float32)
    mask = np.stack([np.ones(12), np.r_[np.ones(9), np.zeros(3)]]).astype(np.int32)
    return jp, tp, jc, tc, emb, mask


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


def _same_cache(got, want):
    for name in ("pos", "filled"):
        for g, w in zip(getattr(got, name), getattr(want, name)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for name in ("k", "v", "mass"):
        for g, w in zip(getattr(got, name), getattr(want, name)):
            _close(g, w)
    np.testing.assert_array_equal(got.next_pos.numpy(), np.asarray(want.next_pos))
    assert got.recent == want.recent


@pytest.mark.parametrize("budget,recent", [(8, 3), (6, 3)])
def test_prefill_decode_and_chunk_match_jax(setup, budget, recent):
    """A budget below the prompt: the prefill compresses, every decode step
    evicts; hidden states, caches, step logits and chunk tokens equal
    JAX's."""
    jp, tp, jc, tc, emb, mask = setup
    wh, wc = jh2o.h2o_prefill(jp, jnp.asarray(emb), jnp.asarray(mask), jc, budget, recent)
    gh, gc = th2o.h2o_prefill(tp, torch.from_numpy(emb), torch.from_numpy(mask), tc, budget,
                              recent)
    _close(gh, wh)
    _same_cache(gc, wc)
    cur = np.asarray([5, 7], np.int32)
    for _ in range(3):
        wl, wc = jax.jit(jh2o.h2o_decode_step, static_argnames="cfg")(
            jp, jnp.asarray(cur), wc, cfg=jc)
        gl, gc = th2o.h2o_decode_step(tp, torch.from_numpy(cur), gc, tc)
        _close(gl, wl)
        _same_cache(gc, wc)
        cur = np.asarray(jnp.argmax(wl, -1)).astype(np.int32)
    wt, wc = jh2o.h2o_decode_chunk_greedy(jp, jnp.asarray(cur), wc, jc, 6)
    gt, gc = th2o.h2o_decode_chunk_greedy(tp, torch.from_numpy(cur), gc, tc, 6)
    np.testing.assert_array_equal(gt.numpy(), np.asarray(wt))
    _same_cache(gc, wc)
    assert all(int(f.min()) == budget for f in gc.filled)
    with pytest.raises(ValueError):
        th2o.h2o_prefill(tp, torch.from_numpy(emb), None, tc, budget=recent, recent=recent)


def test_full_budget_matches_the_dense_cache(setup):
    """budget >= prompt + new tokens: nothing is evicted, and the greedy
    tokens and every step's logits equal the port's dense-cache decode."""
    _, tp, _, tc, emb, mask = setup
    n_new = 6
    emb_t, mask_t = torch.from_numpy(emb), torch.from_numpy(mask)
    gen = tgen.GenerationConfig(max_new_tokens=n_new, stop_sequences=(), eos_token_id=-1,
                                pad_to_multiple=4)
    want = tgen.generate(tp, emb_t, mask_t, llama_cfg=tc, gen=gen)
    logits, dense = tgen._prefill(tp, emb_t, mask_t, tc, 12 + n_new)
    hidden, cache = th2o.h2o_prefill(tp, emb_t, mask_t, tc, budget=12 + n_new + 2, recent=4)
    last = (mask_t.sum(-1) - 1).long()
    h_logits = tllama.lm_head(tp, hidden[torch.arange(2), last][:, None])[:, 0]
    torch.testing.assert_close(h_logits, logits, atol=ATOL, rtol=RTOL)
    cur = torch.argmax(h_logits, -1).to(torch.int32)
    got = [cur]
    for _ in range(n_new - 1):
        h_logits, cache = th2o.h2o_decode_step(tp, cur, cache, tc)
        logits, dense = tgen._decode_step_impl(tp, cur, dense, tc)
        torch.testing.assert_close(h_logits, logits, atol=ATOL, rtol=RTOL)
        cur = torch.argmax(h_logits, -1).to(torch.int32)
        got.append(cur)
    assert torch.stack(got, 1).tolist() == want
    assert [int(f.max()) for f in cache.filled] == [12 + n_new - 1] * tc.num_layers
