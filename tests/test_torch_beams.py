"""PyTorch port, beam search and the prefix-shared decode it runs on
(stllm_tpu_torch/models/{llama,generation}.py) against the JAX package:
the same JAX params converted by load_jax_params, the same numpy inputs.

``llama_decode_prefix`` hidden states and generated caches agree within
1e-5 in fp32 and within the bf16 attention tolerance of tests/test_ops.py
(3e-2) in bf16, for one and two shared prompts and for the bf16-width and
int8 caches. Beam tokens are identical to the JAX package's in fp32 through
the device form (plain and penalized, several chunks), min_length's step-0
eos exclusion, the host loop with a 3-token stop, and the batched form,
which also equals the port's solo beams."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stllm_tpu.models import generation as jgen
from stllm_tpu.models import llama as jllama
from stllm_tpu_torch.convert.from_jax import load_jax_params
from stllm_tpu_torch.models import generation as tgen
from stllm_tpu_torch.models import llama as tllama


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Tiny eager models: one intra-op thread, so parallel test processes
    do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


LL = dict(vocab_size=128, hidden=64, num_layers=3, heads=4, intermediate=128,
          max_positions=256)
BF16_TOL = 3e-2   # tests/test_ops.py's bf16 attention tolerance
_jprefill = jax.jit(jllama.prefill_with_cache, static_argnums=(3, 4))
_jdecode_prefix = jax.jit(jllama.llama_decode_prefix, static_argnums=(4,))
CONFIGS = [
    dict(max_new_tokens=9, num_beams=3, stop_sequences=()),
    dict(max_new_tokens=9, num_beams=4, stop_sequences=((35,), (22, 29))),
    dict(max_new_tokens=7, num_beams=2, stop_sequences=(), min_length=3, length_penalty=1.7),
]


def _cfgs(dtype="fp32", **kw):
    jd, td = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    return jllama.LlamaConfig(dtype=jd, **LL, **kw), tllama.LlamaConfig(dtype=td, **LL, **kw)


def _convert(jp):
    return load_jax_params(jax.tree_util.tree_map(np.asarray, jp), device="cpu")


@pytest.fixture(scope="module")
def llama():
    jc, tc = _cfgs()
    jp = jllama.init_llama(jax.random.PRNGKey(0), jc)
    return jp, _convert(jp), jc, tc


def _gens(**kw):
    kw = {"eos_token_id": 2, "pad_to_multiple": 8, **kw}
    return jgen.GenerationConfig(**kw), tgen.GenerationConfig(**kw)


def _prompt(rs, s, hidden=64):
    return (rs.randn(1, s, hidden) * 0.05).astype(np.float32)


def _padded(emb, gen):
    """Both packages' right-padded prompt and mask."""
    mask = np.ones(emb.shape[:2], np.int32)
    je, jm = jgen._pad_prompt(jnp.asarray(emb), jnp.asarray(mask), gen.pad_to_multiple)
    te, tm = tgen._pad_prompt(torch.from_numpy(emb), torch.from_numpy(mask), gen.pad_to_multiple)
    return (je, jm), (te, tm)


def _host_oracle(gen):
    """The config with a 3-token stop that never fires: the same search
    through beam_search's host loop."""
    return dataclasses.replace(gen, stop_sequences=tuple(gen.stop_sequences) + ((121, 122, 123),))


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("kv_int8", [False, True])
@pytest.mark.parametrize("p", [1, 2])
def test_decode_prefix_matches_jax(p, kv_int8, dtype):
    """Three decode steps of P prompts x 3 beams against the shared prompt
    caches: hidden states, the generated cache (codes and scales) and its
    length, step by step. Prompt 1 has a padded tail (length 5 of 8)."""
    jc, tc = _cfgs(dtype, kv_int8=kv_int8)
    jp = jllama.init_llama(jax.random.PRNGKey(1), jc)
    tp = _convert(jp)
    tol = 1e-5 if dtype == "fp32" else BF16_TOL
    rs = np.random.RandomState(2)
    k, s = 3, 8
    emb = (rs.randn(p, s, 64) * 0.3).astype(np.float32)
    mask = np.ones((p, s), np.int32)
    if p > 1:
        mask[1, 5:] = 0
    _, jpre = _jprefill(jp, jnp.asarray(emb, jc.dtype), jnp.asarray(mask), s, jc)
    _, tpre = tllama.prefill_with_cache(tp, torch.from_numpy(emb).to(tc.dtype),
                                        torch.from_numpy(mask), s, tc)
    jg = jllama.init_kv_cache(jc, p * k, 6)
    tg = tllama.init_kv_cache(tc, p * k, 6)
    for step in range(3):
        x = (rs.randn(p * k, 1, 64) * 0.3).astype(np.float32)
        jh, jg = _jdecode_prefix(jp, jnp.asarray(x, jc.dtype), jpre, jg, jc)
        th, tg = tllama.llama_decode_prefix(tp, torch.from_numpy(x).to(tc.dtype), tpre, tg, tc)
        np.testing.assert_allclose(th.float().numpy(), np.asarray(jh, np.float32),
                                   atol=tol, rtol=tol, err_msg=f"step {step}")
        assert tg.length.tolist() == np.asarray(jg.length).tolist() == [step + 1] * (p * k)
    if kv_int8:
        assert tg.k[0].dtype == torch.int8 and tg.k_scale is not None
        for a, b in zip(tg.k_scale + tg.v_scale, jg.k_scale + jg.v_scale):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=tol, rtol=tol)
        # a code is round(x * 127 / amax): an fp32 rounding tie moves it by
        # one step, a bf16 step or two of x (2^-8 relative each) by two
        codes = [np.abs(a.numpy().astype(np.int16) - np.asarray(b).astype(np.int16)).max()
                 for a, b in zip(tg.k + tg.v, jg.k + jg.v)]
        assert max(codes) <= (1 if dtype == "fp32" else 2), codes
    else:
        for a, b in zip(tg.k + tg.v, jg.k + jg.v):
            np.testing.assert_allclose(a.float().numpy(), np.asarray(b, np.float32),
                                       atol=tol, rtol=tol)


def test_prefill_with_cache_matches_jax(llama):
    jp, tp, jc, tc = llama
    emb = (np.random.RandomState(3).randn(2, 7, 64) * 0.3).astype(np.float32)
    mask = np.ones((2, 7), np.int32)
    mask[1, 4:] = 0
    jh, jcache = _jprefill(jp, jnp.asarray(emb), jnp.asarray(mask), 12, jc)
    th, tcache = tllama.prefill_with_cache(tp, torch.from_numpy(emb), torch.from_numpy(mask),
                                           12, tc)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-5, rtol=1e-5)
    assert tcache.length.tolist() == [7, 4] and tcache.k[0].shape[1] == 12


@pytest.mark.parametrize("cfg", CONFIGS, ids=["plain", "stops", "min_length"])
def test_device_beam_matches_jax_and_the_host_loop(llama, cfg):
    """The device form (chunk 3: several chunks) gives the JAX device form's
    tokens and the port's own host loop's."""
    jp, tp, jc, tc = llama
    jg, tg = _gens(**cfg)
    assert tgen.beam_device_supported(tg)
    (je, jm), (te, tm) = _padded(_prompt(np.random.RandomState(11), 5), tg)
    want = jgen._beam_search_ondevice(jp, je, jm, llama_cfg=jc, gen=jg, chunk=3)
    got = tgen._beam_search_ondevice(tp, te, tm, llama_cfg=tc, gen=tg, chunk=3)
    assert got == want
    assert tgen.beam_search(tp, te, tm, llama_cfg=tc, gen=_host_oracle(tg)) == got


def test_penalized_device_beam_matches_jax(llama):
    """repetition_penalty 1.5 on the log-softmaxed beam scores: the device
    form equals JAX's and the port's penalized host loop."""
    jp, tp, jc, tc = llama
    jg, tg = _gens(max_new_tokens=9, num_beams=3, stop_sequences=((35,),),
                   repetition_penalty=1.5)
    rs = np.random.RandomState(23)
    for s in (5, 9):
        (je, jm), (te, tm) = _padded(_prompt(rs, s), tg)
        want = jgen._beam_search_ondevice(jp, je, jm, llama_cfg=jc, gen=jg, chunk=3)
        got = tgen._beam_search_ondevice(tp, te, tm, llama_cfg=tc, gen=tg, chunk=3)
        assert got == want, (got, want)
        assert tgen.beam_search(tp, te, tm, llama_cfg=tc, gen=_host_oracle(tg)) == got


def test_step0_eos_is_excluded_under_min_length(llama):
    """With eos dominating every step-0 distribution, the default
    min_length 1 removes the eos candidates at step 0 (the host loop's
    rule): the device form equals JAX's and never returns bare eos."""
    jp, _, jc, tc = llama
    w = np.array(jp["lm_head"]["w"], np.float32)
    w[:, 2] = np.abs(w).max() * 50.0
    jb = dict(jp, lm_head={"w": jnp.asarray(w)})
    tb = _convert(jb)
    jg, tg = _gens(max_new_tokens=6, num_beams=3, stop_sequences=())
    rs = np.random.RandomState(7)
    for _ in range(2):
        (je, jm), (te, tm) = _padded(_prompt(rs, 5), tg)
        want = jgen._beam_search_ondevice(jb, je, jm, llama_cfg=jc, gen=jg, chunk=3)
        got = tgen._beam_search_ondevice(tb, te, tm, llama_cfg=tc, gen=tg, chunk=3)
        assert got == want and got != [2]


@pytest.mark.parametrize("penalty", [1.0, 1.5])
def test_host_loop_with_a_three_token_stop_matches_jax(llama, penalty):
    """A stop sequence of 3 tokens takes beam_search's host loop in both
    packages; the stop is the prefix of the unstopped answer, so it fires."""
    jp, tp, jc, tc = llama
    jg, tg = _gens(max_new_tokens=12, num_beams=3, stop_sequences=(),
                   repetition_penalty=penalty)
    emb = _prompt(np.random.RandomState(31), 6)
    free = tgen.beam_search(tp, torch.from_numpy(emb), None, llama_cfg=tc, gen=tg)
    stop = ((tuple(free[1:4]),))
    jg, tg = (dataclasses.replace(g, stop_sequences=stop) for g in (jg, tg))
    assert not tgen.beam_device_supported(tg)
    want = jgen.beam_search(jp, jnp.asarray(emb), None, llama_cfg=jc, gen=jg)
    got = tgen.beam_search(tp, torch.from_numpy(emb), None, llama_cfg=tc, gen=tg)
    assert got == want


@pytest.mark.parametrize("cfg", CONFIGS + [dict(max_new_tokens=9, num_beams=3,
                                                stop_sequences=((35,),),
                                                repetition_penalty=1.5)],
                         ids=["plain", "stops", "min_length", "penalty"])
def test_batched_beams_equal_solo_and_jax(llama, cfg):
    """Four prompts of lengths 5, 11, 3 and 8 (several pads in one bucket)
    in one program, chunk 3: each prompt's tokens equal the port's solo
    beam_search and JAX's batched form."""
    jp, tp, jc, tc = llama
    jg, tg = _gens(**cfg)
    rs = np.random.RandomState(5)
    prompts = [_prompt(rs, s) for s in (5, 11, 3, 8)]
    solo = [tgen.beam_search(tp, torch.from_numpy(e), None, llama_cfg=tc, gen=tg)
            for e in prompts]
    got = tgen.beam_search_batched(tp, [torch.from_numpy(e) for e in prompts], llama_cfg=tc,
                                   gen=tg, chunk=3)
    want = jgen.beam_search_batched(jp, [jnp.asarray(e) for e in prompts], llama_cfg=jc,
                                    gen=jg, chunk=3)
    assert got == solo
    assert got == want


def test_int8_kv_beams_match_jax(llama):
    """Beams over the int8 prefix and generated caches, solo and batched."""
    jp, tp, _, _ = llama
    jc, tc = _cfgs(kv_int8=True)
    jg, tg = _gens(max_new_tokens=8, num_beams=3, stop_sequences=())
    prompts = [_prompt(np.random.RandomState(41), s) for s in (6, 9)]
    want = jgen.beam_search_batched(jp, [jnp.asarray(e) for e in prompts], llama_cfg=jc,
                                    gen=jg)
    assert tgen.beam_search_batched(tp, [torch.from_numpy(e) for e in prompts],
                                    llama_cfg=tc, gen=tg) == want
    assert tgen.beam_search(tp, torch.from_numpy(prompts[0]), None, llama_cfg=tc,
                            gen=tg) == want[0]


def test_generate_host_loop_is_the_penalized_loops_oracle(llama):
    """The per-token host loop, greedy under the penalty and min_length,
    gives the chunked penalized loop's tokens and JAX's host loop's."""
    jp, tp, jc, tc = llama
    jg, tg = _gens(max_new_tokens=10, stop_sequences=((5,),), repetition_penalty=1.4,
                   min_length=3)
    emb = (np.random.RandomState(8).randn(2, 6, 64) * 0.3).astype(np.float32)
    (je, jm), (te, tm) = _padded(emb, tg)
    jl, jcache = jgen._prefill(jp, je, jm, jc, je.shape[1] + 10)
    want, _ = jgen._generate_host_loop(jp, jl, jcache, jc, jg, 2, 0)
    outs = []
    for run in (tgen._generate_host_loop, tgen._generate_penalized_ondevice):
        tl, tcache = tgen._prefill(tp, te, tm, tc, te.shape[1] + 10)
        outs.append(run(tp, tl, tcache, tc, tg, 2, 0)[0])
    assert outs[0] == outs[1] == want

