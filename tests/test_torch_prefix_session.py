"""PyTorch port, PrefixSession (stllm_tpu_torch/models/generation.py):
multi-turn KV reuse gives the tokens of the port's solo generate on the full
prompt (greedy, sampled, penalized, int8 KV cache) and, greedy, the JAX
package's session tokens and reuse counts on the same turns. Any prefix
mismatch, a turn that died mid-write and the max_len limits degrade to a
full re-prefill or a rejection, never a wrong answer. fp32, JAX params
converted by load_jax_params."""


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


LL = dict(vocab_size=97, hidden=48, num_layers=2, heads=4, intermediate=96, max_positions=256)


def _model(seed, **kw):
    jc = jllama.LlamaConfig(dtype=jnp.float32, **LL, **kw)
    tc = tllama.LlamaConfig(dtype=torch.float32, **LL, **kw)
    jp = jllama.init_llama(jax.random.PRNGKey(seed), jc)
    return jp, load_jax_params(jax.tree_util.tree_map(np.asarray, jp), device="cpu"), jc, tc


@pytest.fixture(scope="module")
def model():
    return _model(0)


def _gen(cls=tgen.GenerationConfig, **kw):
    return cls(**{"eos_token_id": -1, "stop_sequences": (), "pad_to_multiple": 8, **kw})


def _emb(seed, s):
    return (np.random.default_rng(seed).standard_normal((1, s, LL["hidden"])) * 0.1
            ).astype(np.float32)


def _titems(ids):
    return [("t", int(t)) for t in ids]


def _embed(params, ids):
    return params["embed_tokens"][torch.as_tensor(ids)][None].float()


def _run_turns(tp, tc, gen, seed=0, max_len=160):
    """Three growing turns, each prompt the previous one plus its answer
    plus a new question. Returns (session outputs, solo outputs, reuse
    counts, the prompts' embeddings and items)."""
    sess = tgen.PrefixSession(tp, tc, max_len=max_len)
    embs, items = torch.from_numpy(_emb(1, 14)), _titems(range(40, 54))
    got, want, reused, turns = [], [], [], []
    for turn in range(3):
        turns.append((embs, items))
        want.append(tgen.generate(tp, embs, llama_cfg=tc, gen=gen, seed=seed)[0])
        got.append(sess.generate(embs, items, gen, seed=seed))
        reused.append(sess.last_reused)
        q = list(range(60 + 10 * turn, 66 + 10 * turn))
        embs = torch.cat([embs, _embed(tp, got[-1]), _embed(tp, q)], dim=1)
        items = items + _titems(got[-1]) + _titems(q)
    return got, want, reused, turns


@pytest.mark.parametrize("kw", [dict(max_new_tokens=9),
                                dict(max_new_tokens=7, do_sample=True, top_p=0.85,
                                     temperature=0.9),
                                dict(max_new_tokens=7, repetition_penalty=1.5, min_length=2),
                                dict(max_new_tokens=8, kv_int8=True)],
                         ids=["greedy", "sampled", "penalized", "int8_kv"])
def test_multiturn_tokens_equal_solo_generate(kw):
    """Turns 2 and 3 reuse the previous prompt and all but the last answer
    token; every turn's tokens equal solo generate's. The int8 session's
    cache stays int8 with scales as it grows."""
    kv_int8 = kw.pop("kv_int8", False)
    _, tp, _, tc = _model(5 if kv_int8 else 3, kv_int8=kv_int8)
    got, want, reused, _ = _run_turns(tp, tc, _gen(**kw), seed=11)
    assert got == want
    assert reused[0] == 0 and reused[1] >= 14 + len(got[0]) - 1 and reused[2] > reused[1]


def test_reuse_and_tokens_equal_jax_session():
    """Greedy and penalized: the same turns through both packages' sessions
    give the same tokens and the same last_reused each turn, with stops
    that end answers early."""
    jp, tp, jc, tc = _model(21)
    for kw in (dict(max_new_tokens=9, stop_sequences=((5,), (7, 8))),
               dict(max_new_tokens=7, repetition_penalty=1.5, min_length=2)):
        got, _, reused, turns = _run_turns(tp, tc, _gen(**kw))
        jsess = jgen.PrefixSession(jp, jc, max_len=160)
        for (embs, items), tok, r in zip(turns, got, reused):
            assert jsess.generate(jnp.asarray(embs.numpy()), items,
                                  _gen(jgen.GenerationConfig, **kw)) == tok
            assert jsess.last_reused == r


def test_stop_sequences_and_eos(model):
    _, tp, _, tc = model
    emb = torch.from_numpy(_emb(8, 10))
    free = tgen.generate(tp, emb, llama_cfg=tc, gen=_gen(max_new_tokens=24))[0]
    gen = _gen(max_new_tokens=24, stop_sequences=((free[5],),))
    want = tgen.generate(tp, emb, llama_cfg=tc, gen=gen)[0]
    sess = tgen.PrefixSession(tp, tc, max_len=96)
    assert sess.generate(emb, _titems(range(40, 50)), gen) == want and len(want) <= 6


def test_prefix_mismatch_reprefills(model):
    """An edited mid-prompt token ends the match there; the answer still
    equals from-scratch generate."""
    _, tp, _, tc = model
    gen = _gen(max_new_tokens=6)
    sess = tgen.PrefixSession(tp, tc, max_len=96)
    emb1 = torch.from_numpy(_emb(10, 12))
    sess.generate(emb1, _titems(range(40, 52)), gen)
    emb2 = emb1.clone()
    emb2[:, 3] = torch.from_numpy(_emb(11, 12))[:, 3]
    items2 = _titems(range(40, 52))
    items2[3] = ("t", 99)
    want = tgen.generate(tp, emb2, llama_cfg=tc, gen=gen)[0]
    assert sess.generate(emb2, items2, gen) == want
    assert sess.last_reused == 3


def test_fully_cached_prompt_recomputes_last_token(model):
    _, tp, _, tc = model
    gen = _gen(max_new_tokens=5)
    sess = tgen.PrefixSession(tp, tc, max_len=96)
    emb, items = torch.from_numpy(_emb(14, 9)), _titems(range(40, 49))
    first = sess.generate(emb, items, gen)
    again = sess.generate(emb, items, gen)
    assert first == again == tgen.generate(tp, emb, llama_cfg=tc, gen=gen)[0]
    assert sess.last_reused == 8


def test_rejected_requests_raise_and_leave_the_session_usable(model):
    """Beams, prompt + budget past max_len, a padded prompt past max_len
    (pad(49) = 56 > 50) and an items/embeds mismatch raise before any
    write; the session still answers after them."""
    _, tp, _, tc = model
    sess = tgen.PrefixSession(tp, tc, max_len=64)
    emb, items = torch.from_numpy(_emb(16, 8)), _titems(range(40, 48))
    with pytest.raises(tgen.UnsupportedRequest):
        sess.generate(emb, items, _gen(max_new_tokens=4, num_beams=3))
    with pytest.raises(tgen.UnsupportedRequest):
        sess.generate(emb, items, _gen(max_new_tokens=60))
    with pytest.raises(ValueError):
        sess.generate(emb, items[:-1], _gen(max_new_tokens=4))
    with pytest.raises(tgen.UnsupportedRequest):
        tgen.PrefixSession(tp, tc, max_len=50).generate(
            torch.from_numpy(_emb(26, 49)), _titems(range(49)), _gen(max_new_tokens=1))
    assert sess.cache is None
    gen = _gen(max_new_tokens=5)
    assert sess.generate(emb, items, gen) == tgen.generate(tp, emb, llama_cfg=tc, gen=gen)[0]


def test_padded_delta_near_max_len_stays_exact(model):
    """A short delta at the cache's end pads past max_len; matched tokens
    are dropped until the padded write span fits, so the clamped write never
    lands on committed positions."""
    _, tp, _, tc = model
    gen = _gen(max_new_tokens=2)
    sess = tgen.PrefixSession(tp, tc, max_len=48)
    emb1, items1 = torch.from_numpy(_emb(24, 33)), _titems(range(33))
    ans1 = sess.generate(emb1, items1, gen)
    q = list(range(50, 61))
    emb2 = torch.cat([emb1, _embed(tp, ans1), _embed(tp, q)], dim=1)
    assert emb2.shape[1] == 46
    want = tgen.generate(tp, emb2, llama_cfg=tc, gen=gen)[0]
    assert sess.generate(emb2, items1 + _titems(ans1) + _titems(q), gen) == want
    assert 0 < sess.last_reused <= 32


def test_release_and_recovery_after_a_died_turn(model, monkeypatch):
    """release() drops the cache and the next turn re-prefills. A turn that
    dies inside the delta prefill (after dropping its cache handle) leaves
    no half-written cache: the next turn re-prefills from scratch."""
    _, tp, _, tc = model
    gen = _gen(max_new_tokens=5)
    sess = tgen.PrefixSession(tp, tc, max_len=64)
    emb, items = torch.from_numpy(_emb(18, 10)), _titems(range(40, 50))
    want = sess.generate(emb, items, gen)
    sess.release()
    assert sess.cache is None and sess.items == [] and sess.last_reused == 0
    assert sess.generate(emb, items, gen) == want and sess.last_reused == 0

    def dies(*args, **kw):
        raise RuntimeError("device fault mid-write")

    assert sess.generate(emb, items, gen) == want and sess.last_reused == 9
    with monkeypatch.context() as m:
        m.setattr(tgen, "_prefill_delta", dies)
        with pytest.raises(RuntimeError):
            sess.generate(emb, items, gen)
    assert sess.cache is None and sess.items
    assert sess.generate(emb, items, gen) == want and sess.last_reused == 0


def test_cache_grows_by_window_buckets(model):
    """The cache is sized to the history's bucket of 256 (capped at
    max_len), not to max_len, and grows with its scale planes when a turn
    needs more."""
    _, tp, _, _ = model
    tc = tllama.LlamaConfig(dtype=torch.float32, kv_int8=True, **{**LL, "max_positions": 1024})
    sess = tgen.PrefixSession(tp, tc, max_len=600)
    gen = _gen(max_new_tokens=4)
    emb = torch.from_numpy(_emb(30, 200))
    ans = sess.generate(emb, _titems(range(200)), gen)
    assert sess.cache.k[0].shape[1] == 256 and sess.cache.k_scale[0].shape[1] == 256
    emb2 = torch.cat([emb, _embed(tp, ans), torch.from_numpy(_emb(31, 100))], dim=1)
    items2 = _titems(range(200)) + _titems(ans) + [("t", 1000 + i) for i in range(100)]
    assert sess.generate(emb2, items2, gen) == tgen.generate(tp, emb2, llama_cfg=tc, gen=gen)[0]
    assert sess.cache.k[0].shape[1] == 512 and sess.cache.v_scale[0].shape[1] == 512
    assert sess.cache.k[0].dtype == torch.int8 and sess.last_reused == 200 + len(ans) - 1


def test_pad_kv_time_pads_every_buffer():
    tc = tllama.LlamaConfig(dtype=torch.float32, kv_int8=True, **LL)
    cache = tllama.init_kv_cache(tc, 2, 5)
    grown = tgen._pad_kv_time(cache, 12)
    for group in (grown.k, grown.v, grown.k_scale, grown.v_scale):
        assert all(t.shape[:2] == (2, 12) and not t[:, 5:].any() for t in group)
    assert grown.k[0].dtype == torch.int8 and torch.equal(grown.length, cache.length)


class TestItems:
    def test_video_identity_semantics(self):
        a, b = torch.zeros((1, 3, 8)), torch.zeros((1, 3, 8))  # equal values, two tensors
        ia = tgen.PrefixSession.items_for([[1, 2], [7]], [a])
        assert ia == tgen.PrefixSession.items_for([[1, 2], [7]], [a])
        assert ia != tgen.PrefixSession.items_for([[1, 2], [7]], [b])
        assert len(ia) == 2 + 3 + 1

    def test_text_tokens_compare_by_id(self):
        x = tgen.PrefixSession.items_for([[5, 6, 7]], [])
        y = tgen.PrefixSession.items_for([[5, 6, 8]], [])
        assert x[:2] == y[:2] and x[2] != y[2]
        assert x == jgen.PrefixSession.items_for([[5, 6, 7]], [])
