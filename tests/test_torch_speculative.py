"""PyTorch port, greedy speculative decoding
(stllm_tpu_torch/models/speculative.py) and the batcher's speculative mode
against the JAX package, on a tiny fp32 LLaMA with two drafts: the target
itself (every proposal accepted) and a random shallow draft of the same
width (rejections and rollbacks). Tokens must be identical, to JAX and to
the port's own greedy ``generate``, and so must the round statistics."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stllm_tpu.models import generation as jgen
from stllm_tpu.models import llama as jllama
from stllm_tpu.models import speculative as jspec
from stllm_tpu.serving import ContinuousBatcher as JBatcher
from stllm_tpu_torch.convert.from_jax import load_jax_params
from stllm_tpu_torch.models import generation as tgen
from stllm_tpu_torch.models import llama as tllama
from stllm_tpu_torch.models import speculative as tspec
from stllm_tpu_torch.serving import ContinuousBatcher as TBatcher


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's side runs tiny eager models: one intra-op thread each. A
    full pool per test process oversubscribes the cores when the suite runs
    in parallel processes, and these many small ops then wait on it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


LL = dict(vocab_size=97, hidden=48, heads=4, intermediate=96, max_positions=256)


@pytest.fixture(scope="module")
def models():
    out = {}
    for name, layers, seed in (("target", 3, 0), ("random", 1, 1)):
        jc = jllama.LlamaConfig(dtype=jnp.float32, num_layers=layers, **LL)
        tc = tllama.LlamaConfig(dtype=torch.float32, num_layers=layers, **LL)
        jp = jax.jit(lambda key: jllama.init_llama(key, jc))(jax.random.PRNGKey(seed))
        out[name] = (jp, load_jax_params(jax.tree_util.tree_map(np.asarray, jp), device="cpu"),
                     jc, tc)
    out["self"] = out["target"]
    return out


def _gen(cls, n, **kw):
    return cls(max_new_tokens=n, pad_to_multiple=8, **{"eos_token_id": -1,
                                                      "stop_sequences": (), **kw})


def _prompt(seed, s):
    return (np.random.default_rng(seed).standard_normal((1, s, LL["hidden"])) * 0.3
            ).astype(np.float32)


@pytest.mark.parametrize("draft,k,stops", [("self", 2, False), ("random", 5, True)],
                         ids=["self", "random"])
def test_speculative_generate_matches_jax_and_greedy(models, draft, k, stops):
    """The target as its own draft at k = 2 with no stop, the random draft
    at k = 5 with a stop sequence that fires mid-answer: tokens equal JAX's
    speculative_generate and the port's greedy generate, and ``_stats``
    (rounds, mean accepted) equal JAX's."""
    jt, tt, jtc, ttc = models["target"]
    jd, td, jdc, tdc = models[draft]
    emb = _prompt(2, 7)
    free = tgen.generate(tt, torch.from_numpy(emb), llama_cfg=ttc, gen=_gen(tgen.GenerationConfig,
                                                                           26))[0]
    stop = ((free[11],),) if stops else ()
    jg, tg = _gen(jgen.GenerationConfig, 26, stop_sequences=stop), \
        _gen(tgen.GenerationConfig, 26, stop_sequences=stop)
    want, wstats = jspec.speculative_generate(jt, jd, jnp.asarray(emb), tgt_cfg=jtc,
                                              dft_cfg=jdc, gen=jg, k=k, return_stats=True)
    got, stats = tspec.speculative_generate(tt, td, torch.from_numpy(emb), tgt_cfg=ttc,
                                            dft_cfg=tdc, gen=tg, k=k, return_stats=True)
    assert got == want
    assert got == tgen.generate(tt, torch.from_numpy(emb), llama_cfg=ttc, gen=tg)
    assert stats == wstats
    if draft == "self":
        assert stats["mean_accepted"] == k
    assert (got[0][-1] == free[11] and len(got[0]) <= 12) if stop else len(got[0]) == 26
    with pytest.raises(ValueError):
        tspec.speculative_generate(tt, td, torch.from_numpy(emb), tgt_cfg=ttc, dft_cfg=tdc,
                                   gen=_gen(tgen.GenerationConfig, 4, do_sample=True))


@pytest.mark.parametrize("spec_k", [2, 4])
def test_batcher_spec_mode_matches_jax(models, spec_k):
    """Five requests over two slots (slot refill mid-flight, a stop and an
    eos among them) with the random draft: tokens equal the JAX batcher's
    and the port's greedy generate; one host pull per admit and per step,
    as the reference counts them."""
    jt, tt, jtc, ttc = models["target"]
    jd, td, jdc, tdc = models["random"]
    prompts = [_prompt(10 + i, s) for i, s in enumerate((5, 11, 7, 16, 3))]
    free = tgen.generate(tt, torch.from_numpy(prompts[0]), llama_cfg=ttc,
                         gen=_gen(tgen.GenerationConfig, 20))[0]
    kws = [dict(n=20), dict(n=6), dict(n=20, stop_sequences=((free[8],),)), dict(n=9),
           dict(n=20, eos_token_id=free[5])]
    jb = JBatcher(jt, jtc, slots=2, max_len=80, chunk=4, draft_params=jd, draft_cfg=jdc,
                  spec_k=spec_k, spec_rounds=3)
    tb = TBatcher(tt, ttc, slots=2, max_len=80, chunk=4, draft_params=td, draft_cfg=tdc,
                  spec_k=spec_k, spec_rounds=3)
    solo = {}
    for i, (emb, kw) in enumerate(zip(prompts, kws)):
        kw = dict(kw)
        n = kw.pop("n")
        if i == 2:
            emb = prompts[0]
        jb.submit(i, jnp.asarray(emb), _gen(jgen.GenerationConfig, n, **kw))
        tb.submit(i, torch.from_numpy(emb), _gen(tgen.GenerationConfig, n, **kw))
        solo[i] = tgen.generate(tt, torch.from_numpy(emb), llama_cfg=ttc,
                                gen=_gen(tgen.GenerationConfig, n, **kw))[0]
    want, got = jb.run(), tb.run()
    assert got == want == solo
    assert tb.host_pulls == jb.host_pulls
    assert tb.cache.k[0].shape[1] == 80 + spec_k + 1 == tb.draft_cache.k[0].shape[1]
