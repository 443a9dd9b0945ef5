"""PyTorch port, serving breadth (stllm_tpu_torch/serving.py,
stllm_tpu_torch/pipeline_serving.py) against the JAX package on tiny fp32
models: sampled streams beside greedy ones in the continuous batcher, the
shared-prefix admit, AnswerService, and VideoQAServer's ``prefix_key``
sharing and per-request "auto" merge level.

Greedy tokens are compared with the JAX package's, token for token. Sampled
streams draw from torch.Generator streams (JAX from its PRNG keys), so they
are held to the port's own solo ``generate(do_sample=True, seed)`` and to
themselves across co-tenants, slots and chunk sizes; the top-p keep sets
are held to JAX in tests/test_torch_sampling.py."""

import os
import sys
import threading
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stllm_tpu import pipeline_serving as jps
from stllm_tpu.models import generation as jgen
from stllm_tpu.models import llama as jllama
from stllm_tpu.models.qformer import QFormerConfig as JQF
from stllm_tpu.models.stllm import STLLMConfig as JST, init_stllm
from stllm_tpu.models.vit import ViTConfig as JViT
from stllm_tpu.serving import ContinuousBatcher as JBatcher
from stllm_tpu_torch import pipeline_serving as tps
from stllm_tpu_torch.convert.from_jax import load_jax_params
from stllm_tpu_torch.models import generation as tgen
from stllm_tpu_torch.models import llama as tllama
from stllm_tpu_torch.models.qformer import QFormerConfig as TQF
from stllm_tpu_torch.models.stllm import STLLMConfig as TST
from stllm_tpu_torch.models.vit import ViTConfig as TViT
from stllm_tpu_torch.serving import AnswerService, ContinuousBatcher as TBatcher


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's side runs tiny eager models: one intra-op thread each. A
    full pool per test process oversubscribes the cores when the suite runs
    in parallel processes, and these many small ops then wait on it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


LL = dict(vocab_size=97, hidden=64, num_layers=2, heads=4, intermediate=128,
          max_positions=256)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def llama():
    jc = jllama.LlamaConfig(dtype=jnp.float32, **LL)
    tc = tllama.LlamaConfig(dtype=torch.float32, **LL)
    # one jitted init (eager init compiles a program per parameter shape)
    jp = jax.jit(lambda key: jllama.init_llama(key, jc))(jax.random.PRNGKey(0))
    return jp, load_jax_params(_np(jp), device="cpu"), jc, tc


def _gen(cls, n, **kw):
    return cls(max_new_tokens=n, pad_to_multiple=8, **{"eos_token_id": -1,
                                                      "stop_sequences": (), **kw})


def _emb(seed, s, d=64):
    return (np.random.default_rng(seed).standard_normal((1, s, d)) * 0.3).astype(np.float32)


SAMPLED = dict(do_sample=True, top_p=0.85, temperature=0.9)
# (rid, prompt seed, prompt length, budget, sampled, seed)
MIXED = [("a", 1, 5, 12, False, 0), ("b", 2, 9, 10, True, 5), ("c", 3, 7, 7, False, 0),
         ("d", 4, 12, 14, True, 9), ("e", 5, 3, 9, True, 5)]


def _mixed_gen(cls, n, sampled):
    return _gen(cls, n, **SAMPLED) if sampled else _gen(cls, n)


@pytest.mark.parametrize("chunk", [3, 8])
def test_mixed_traffic(llama, chunk):
    """Two greedy and three sampled streams over three slots (two sampled
    requests share a seed on different prompts): the greedy rows equal the
    JAX batcher's tokens; each sampled row equals the port's solo
    generate(do_sample=True, seed) and the same request served alone, at
    either chunk size; host pulls are counted as the reference counts
    them (one an admit, one a chunk)."""
    jp, tp, jc, tc = llama
    jb = JBatcher(jp, jc, slots=3, max_len=64, chunk=chunk)
    tb = TBatcher(tp, tc, slots=3, max_len=64, chunk=chunk)
    solo, alone = {}, {}
    for rid, ps, s, n, sampled, seed in MIXED:
        emb = _emb(ps, s)
        jb.submit(rid, jnp.asarray(emb), _mixed_gen(jgen.GenerationConfig, n, sampled), seed=seed)
        tg = _mixed_gen(tgen.GenerationConfig, n, sampled)
        tb.submit(rid, torch.from_numpy(emb), tg, seed=seed)
        if sampled:
            solo[rid] = tgen.generate(tp, torch.from_numpy(emb), llama_cfg=tc, gen=tg,
                                      seed=seed)[0]
            idle = TBatcher(tp, tc, slots=3, max_len=64, chunk=chunk)
            idle.submit(rid, torch.from_numpy(emb), tg, seed=seed)
            alone[rid] = idle.run()[rid]
    want, got = jb.run(), tb.run()
    for rid, *_, sampled, _ in MIXED:
        assert len(got[rid]) == len(want[rid])
        if not sampled:
            assert got[rid] == want[rid], rid
    assert {r: got[r] for r in solo} == solo == alone
    assert got["b"] != got["e"]
    assert tb.host_pulls == jb.host_pulls


def _prefix(pkg, params, cfg, emb, width):
    gen = jgen if pkg == "jax" else tgen
    arr = jnp.asarray(emb) if pkg == "jax" else torch.from_numpy(emb)
    ones = (jnp.ones if pkg == "jax" else torch.ones)(emb.shape[:2], dtype=(
        jnp.int32 if pkg == "jax" else torch.int32))
    pemb, pmask = gen._pad_prompt(arr, ones, 8)
    return gen._prefill(params, pemb, pmask, cfg, width)[1]


@pytest.mark.parametrize("width", [16, 21])
def test_prefix_admit_matches_jax_and_keeps_the_prefix(llama, width):
    """Two suffixes (one sampled) on a shared 13-token prefix cache of
    width 16 (padded to 21 at admit) or 21 (the admit's own width): greedy
    tokens equal the JAX batcher's and solo generate on the whole prompt,
    the sampled one solo generate's; the stored prefix is bit for bit
    unchanged after both admits, and an admitted request holds neither the
    prefix nor its embeddings."""
    jp, tp, jc, tc = llama
    pre = _emb(20, 13)
    sufs = {"x": (_emb(21, 3), False), "y": (_emb(22, 5), True)}
    jpkv = _prefix("jax", jp, jc, pre, width)
    tpkv = _prefix("torch", tp, tc, pre, width)
    before = [t.clone() for t in tpkv.k + tpkv.v + (tpkv.length,)]
    jb = JBatcher(jp, jc, slots=2, max_len=64, chunk=4)
    tb = TBatcher(tp, tc, slots=2, max_len=64, chunk=4)
    for rid, (suf, sampled) in sufs.items():
        jb.submit(rid, jnp.asarray(suf), _mixed_gen(jgen.GenerationConfig, 9, sampled), seed=3,
                  prefix=jpkv, prefix_len=13)
        tb.submit(rid, torch.from_numpy(suf), _mixed_gen(tgen.GenerationConfig, 9, sampled),
                  seed=3, prefix=tpkv, prefix_len=13)
    tb.step()
    assert all(r.prefix is None and r.embeds is None for r in tb.active if r is not None)
    want, got = jb.run(), tb.run()
    assert got["x"] == want["x"]
    for rid, (suf, sampled) in sufs.items():
        full = torch.from_numpy(np.concatenate([pre, suf], axis=1))
        assert got[rid] == tgen.generate(tp, full, llama_cfg=tc, seed=3, gen=_mixed_gen(
            tgen.GenerationConfig, 9, sampled))[0]
    after = tpkv.k + tpkv.v + (tpkv.length,)
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    # the admit's copy is new storage even when it is no wider than the prefix
    padded = tgen._pad_kv_time(tpkv, width)
    assert not any(a.data_ptr() == b.data_ptr() for a, b in zip(padded.k + padded.v,
                                                                 tpkv.k + tpkv.v))
    with pytest.raises(tgen.UnsupportedRequest):
        tb.submit("long", torch.from_numpy(_emb(23, 3)), _gen(tgen.GenerationConfig, 44),
                  prefix=tpkv, prefix_len=13)


def _threads(fn, n):
    errs = []

    def call(i):
        try:
            fn(i)
        except Exception as e:  # surfaced to the assert below
            errs.append((i, e))

    threads = [threading.Thread(target=call, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not errs and not any(t.is_alive() for t in threads), errs


def test_answer_service_concurrent_callers_and_refusals(llama):
    """Four threads, two greedy and two sampled, over a two-slot batcher:
    each answer equals the request served alone (solo generate). The
    batcher's refusals raise in the caller without blocking, and the
    service keeps serving after them."""
    _, tp, _, tc = llama
    cases = [(_emb(31, 5), _gen(tgen.GenerationConfig, 11), 0),
             (_emb(32, 9), _gen(tgen.GenerationConfig, 7, **SAMPLED), 17),
             (_emb(33, 12), _gen(tgen.GenerationConfig, 8), 0),
             (_emb(34, 3), _gen(tgen.GenerationConfig, 10, **SAMPLED), 4)]
    want = [tgen.generate(tp, torch.from_numpy(e), llama_cfg=tc, gen=g, seed=s)[0]
            for e, g, s in cases]
    svc = AnswerService(TBatcher(tp, tc, slots=2, max_len=64, chunk=4))
    got = [None] * len(cases)

    def call(i):
        e, g, s = cases[i]
        got[i] = svc.answer(torch.from_numpy(e), g, seed=s)

    try:
        _threads(call, len(cases))
        assert got == want
        with pytest.raises(tgen.UnsupportedRequest):
            svc.answer(torch.from_numpy(_emb(35, 5)), _gen(tgen.GenerationConfig, 4, num_beams=3))
        with pytest.raises(ValueError) as err:
            svc.answer(torch.from_numpy(_emb(35, 5)),
                       _gen(tgen.GenerationConfig, 4, do_sample=True, top_p=0.0))
        assert not isinstance(err.value, tgen.UnsupportedRequest)
        assert svc.answer(torch.from_numpy(cases[0][0]), cases[0][1]) == want[0]
    finally:
        svc.close()


def test_answer_service_many_callers_get_their_own_answers():
    """More callers than cores and a short switch interval: each caller gets
    its own request's tokens (a lost or crossed update between the
    submitters and the service thread would break this)."""

    class Echo:
        """Finishes up to three queued requests a step; a request's tokens
        are its seed and its rid."""

        def __init__(self):
            self.queue, self.active = [], []

        def submit(self, rid, embeds, gen, *, seed=0):
            self.queue.append((rid, seed))

        def step(self):
            done, self.queue = self.queue[:3], self.queue[3:]
            return [types.SimpleNamespace(rid=rid, tokens=[seed, rid]) for rid, seed in done]

    n = (os.cpu_count() or 4) + 4
    svc = AnswerService(Echo())
    got = [None] * n

    def call(i):
        got[i] = svc.answer(torch.zeros((1, 2, 4)), _gen(tgen.GenerationConfig, 4), seed=i)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        _threads(call, n)
    finally:
        sys.setswitchinterval(interval)
        svc.close()
    assert [g[0] for g in got] == list(range(n))
    assert sorted(g[1] for g in got) == list(range(n))


def test_answer_service_step_failure_reaches_every_waiter():
    """A step that raises wakes every blocked caller with RuntimeError from
    it, and every later caller fails fast."""

    class Exploding:
        """Fails once three callers wait (steps before that do nothing)."""

        def __init__(self):
            self.queue, self.active = [], []

        def submit(self, rid, embeds, gen, *, seed=0):
            self.queue.append(rid)

        def step(self):
            if len(self.queue) < 3:
                return []
            raise RuntimeError("the card fell over")

    svc = AnswerService(Exploding())
    causes = []

    def call(i):
        with pytest.raises(RuntimeError, match="AnswerService") as err:
            svc.answer(torch.zeros((1, 2, 4)), _gen(tgen.GenerationConfig, 4))
        causes.append(str(err.value.__cause__))

    _threads(call, 3)
    assert causes == ["the card fell over"] * 3
    with pytest.raises(RuntimeError, match="dead"):
        svc.answer(torch.zeros((1, 2, 4)), _gen(tgen.GenerationConfig, 4))


VIT = dict(image_size=28, patch_size=14, width=32, depth=2, heads=2, mlp_hidden=64,
           use_flash=False)
QF = dict(hidden=16, num_layers=2, heads=2, intermediate=32, encoder_width=32, num_query=4,
          vocab_size=64)
QA_LL = dict(LL, hidden=32, heads=2, intermediate=64)
JCFG = JST(vit=JViT(dtype=jnp.float32, **VIT), qformer=JQF(dtype=jnp.float32, **QF),
           llama=jllama.LlamaConfig(dtype=jnp.float32, **QA_LL), video_input="all")
TCFG = TST(vit=TViT(dtype=torch.float32, **VIT), qformer=TQF(dtype=torch.float32, **QF),
           llama=tllama.LlamaConfig(dtype=torch.float32, **QA_LL), video_input="all")


@pytest.fixture(scope="module")
def stllm():
    jp = jax.jit(lambda key: init_stllm(key, JCFG))(jax.random.PRNGKey(1))
    return jp, load_jax_params(_np(jp), device="cpu")


def _frames(seed, t=4, size=28):
    return np.random.default_rng(seed).integers(0, 256, (1, t, size, size, 3)).astype(np.uint8)


def _ids(seed, n, vocab=97):
    return np.random.default_rng(100 + seed).integers(0, vocab, (1, n)).astype(np.int32)


@pytest.fixture
def encodes(monkeypatch):
    """Encode counts of both servers: JAX's _encode_assemble calls and the
    port's encode_img calls."""
    calls = {"jax": 0, "torch": 0}
    real_j, real_t = jps._encode_assemble, tps.encode_img

    def count(pkg, fn):
        def wrap(*a, **kw):
            calls[pkg] += 1
            return fn(*a, **kw)
        return wrap

    monkeypatch.setattr(jps, "_encode_assemble", count("jax", real_j))
    monkeypatch.setattr(tps, "encode_img", count("torch", real_t))
    return calls


def _serve_both(stllm, reqs, jcfg=JCFG, tcfg=TCFG, **server):
    """The same requests (rid, frames, pre, suf, budget, extra submit kw)
    through the JAX and the port's VideoQAServer; returns both answers."""
    jp, tp = stllm
    js, ts = jps.VideoQAServer(jp, jcfg, **server), tps.VideoQAServer(tp, tcfg, **server)
    for rid, fr, pre, suf, n, kw in reqs:
        js.submit(rid, jnp.asarray(fr), pre, suf, _gen(jgen.GenerationConfig, n), **kw)
        ts.submit(rid, fr, pre, suf, _gen(tgen.GenerationConfig, n), **kw)
    return js.run(), ts.run(), ts


def test_prefix_key_sharing_matches_jax(stllm, encodes):
    """Three questions on one key, one with another Q-Former text (a guard
    miss), then with prefix_cache_size=1 another key and the first key
    again (evicted): tokens equal the JAX server's, one encode a key and a
    guard miss, the same encode count as JAX's."""
    q, q2 = _ids(9, 6, 64), _ids(10, 6, 64)
    mask = np.ones_like(q2)
    mask[:, -2:] = 0
    fa, fb, pre = _frames(7), _frames(8), _ids(21, 5)
    reqs = [(f"a{i}", fa, pre, _ids(30 + i, 3), 6, dict(qformer_text_ids=q, prefix_key="A"))
            for i in range(3)]
    reqs += [("a_q2", fa, pre, _ids(40, 3), 5, dict(qformer_text_ids=q2, prefix_key="A")),
             ("a_mask", fa, pre, _ids(40, 3), 5,
              dict(qformer_text_ids=q2, qformer_text_mask=mask, prefix_key="A")),
             ("b", fb, pre, _ids(41, 4), 5, dict(qformer_text_ids=q, prefix_key="B")),
             ("a_again", fa, pre, _ids(30, 3), 6, dict(qformer_text_ids=q, prefix_key="A"))]
    want, got, ts = _serve_both(stllm, reqs, slots=2, max_len=128, chunk=4,
                                prefix_cache_size=1)
    assert got == want and set(got) == {r[0] for r in reqs}
    assert got["a_again"] == got["a0"]
    assert encodes["torch"] == encodes["jax"] == 5
    assert list(ts._prefix_lru) == ["A"]


def test_prefix_key_regressions(stllm, encodes):
    """The JAX package's pipeline-serving regressions: distinct keys
    admitted in one step while the LRU (size 1) evicts the prefixes their
    queued requests hold (tokens equal the JAX server's); the submit check
    uses the batcher's prefix-shared formula (plen + pad(suffix)), refusing
    a request that fits unshared; and a pair that lands exactly on the
    bound drains, with the unshared request's tokens."""
    q, pre, suf = _ids(9, 6, 64), _ids(26, 5), _ids(27, 3)
    reqs = [(f"{k}{i}", _frames(50 + i), pre, suf, 4, dict(qformer_text_ids=q, prefix_key=k))
            for i, k in enumerate("pqr")]
    want, got, _ = _serve_both(stllm, reqs, slots=4, max_len=128, chunk=4,
                               prefix_cache_size=1)
    assert got == want and encodes["torch"] == 3
    # plen = 5 + 16 video tokens = 21, slen = 3: pad(24) + 4 = 28 fits max_len
    # 28 unshared; 21 + pad(3) + 4 = 33 does not
    _, tp = stllm
    srv = tps.VideoQAServer(tp, TCFG, slots=2, max_len=28, chunk=4)
    fr = _frames(31)
    with pytest.raises(tgen.UnsupportedRequest):
        srv.submit("a", fr, pre, suf, _gen(tgen.GenerationConfig, 4), prefix_key="k")
    srv.submit("b", fr, pre, suf, _gen(tgen.GenerationConfig, 4))
    unshared = srv.run()["b"]
    srv = tps.VideoQAServer(tp, TCFG, slots=2, max_len=33, chunk=4)
    for rid in "ab":
        srv.submit(rid, fr, pre, suf, _gen(tgen.GenerationConfig, 4), prefix_key="k")
    assert srv.run() == {"a": unshared, "b": unshared}
    assert encodes["torch"] == 3 + 1 + 1


def test_auto_merge_level_per_request(stllm):
    """vit.merge_level "auto" on a plain ViT at the 257-token geometry
    resolves per request at submit: a static clip takes a fold level, an
    iid-noise clip none; tokens equal the JAX server's."""
    geom = dict(image_size=224, patch_size=14, width=32, depth=4, heads=2, mlp_hidden=64,
                use_flash=False, merge_level="auto")
    jcfg = JST(vit=JViT(dtype=jnp.float32, **geom), qformer=JCFG.qformer, llama=JCFG.llama,
               video_input="all")
    tcfg = TST(vit=TViT(dtype=torch.float32, **geom), qformer=TCFG.qformer,
               llama=TCFG.llama, video_input="all")
    jp, _ = stllm
    from stllm_tpu.models.vit import init_vit

    jp = dict(jp, vit=jax.jit(lambda key: init_vit(key, jcfg.vit))(jax.random.PRNGKey(2)))
    params = (jp, load_jax_params(_np(jp), device="cpu"))
    static = np.repeat(np.random.default_rng(3).integers(0, 256, (1, 1, 224, 224, 3)), 4,
                       axis=1).astype(np.uint8)
    noise = np.random.default_rng(4).integers(0, 256, (1, 4, 224, 224, 3)).astype(np.uint8)
    pre, suf = _ids(60, 4), _ids(61, 3)
    reqs = [("static", static, pre, suf, 5, {}), ("noise", noise, pre, suf, 5, {})]
    ts = tps.VideoQAServer(params[1], tcfg, slots=2, max_len=128, chunk=4)
    for rid, fr, p, s, n, _ in reqs:
        ts.submit(rid, fr, p, s, _gen(tgen.GenerationConfig, n))
    levels = [r.cfg.vit for r in ts.encode_queue]
    assert levels[0].temporal_schedule and not levels[1].temporal_schedule
    assert levels[1].merge_schedule == () and levels[0].merge_level == ""
    want, got, _ = _serve_both(params, reqs, jcfg, tcfg, slots=2, max_len=128, chunk=4)
    assert got == want
