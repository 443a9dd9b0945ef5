"""PyTorch port, sampled and penalized decoding
(stllm_tpu_torch/models/generation.py) against the JAX package.

The port draws from torch.Generator streams, the JAX package from its PRNG
keys, so sampled tokens are not compared across packages. What is compared
is the kept set and its order: both packages' draw functions
(``jax.random.categorical``, the port's ``_pick``) are replaced by one that
returns the i-th kept position, so every kept token, in order, comes out of
each ``_topp_next``, in both branches (top-128 prefilter, full sort), with
ties and the crossing token. Greedy decoding under the repetition penalty
and min_length is token-identical in fp32; sampled decoding is
reproducible from its seed within the port."""

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

LL = dict(vocab_size=97, hidden=64, num_layers=2, heads=4, intermediate=128,
          max_positions=256)


@pytest.fixture(scope="module")
def llama():
    jc = jllama.LlamaConfig(dtype=jnp.float32, **LL)
    tc = tllama.LlamaConfig(dtype=torch.float32, **LL)
    jp = jllama.init_llama(jax.random.PRNGKey(0), jc)
    return jp, load_jax_params(jax.tree_util.tree_map(np.asarray, jp), device="cpu"), jc, tc


def _logits(kind: str, b: int = 4, v: int = 200) -> np.ndarray:
    rng = np.random.default_rng(len(kind))
    if kind == "peaked":      # top-128 mass covers top_p: the prefilter branch
        return (rng.standard_normal((b, v)) * 4.0).astype(np.float32)
    if kind == "flat":        # top-128 mass falls short: the full-sort branch
        return (rng.standard_normal((b, v)) * 0.05).astype(np.float32)
    if kind == "ties":        # few distinct values: ties at the crossing and at 128
        x = np.round(rng.standard_normal((b, v)) * 2.0) * 0.5
        x[1] = np.round(rng.standard_normal(v) * 0.3) * 0.25      # flat and tied
        # + 0.0 turns -0.0 into 0.0: JAX's top-k orders -0.0 below 0.0 at
        # some shapes and not at others, where every sort here ties them
        return (x + 0.0).astype(np.float32)
    if kind == "mixed":       # one covered row beside rows that need the full sort
        x = (rng.standard_normal((b, v)) * 0.05).astype(np.float32)
        x[0] = rng.standard_normal(v) * 5.0
        return x
    raise ValueError(kind)


def _kept_in_order(monkeypatch, logits, temperature, top_p, sample_mask):
    """Every kept token of each row, in the order each package keeps them:
    each row is repeated V times, and copy i draws the i-th kept position
    (or the last), the position riding in its JAX key and its uniform."""
    b, v = logits.shape

    def jax_pick(key, lg, axis=-1, shape=None):
        n = jnp.sum(jnp.isfinite(lg), axis=-1)
        return jnp.minimum(key[0].astype(jnp.int32), n - 1)

    def torch_pick(weights, u):
        n = (weights > 0).sum(dim=-1)
        return torch.minimum(u.long(), n - 1)

    monkeypatch.setattr(jax.random, "categorical", jax_pick)
    monkeypatch.setattr(tgen, "_pick", torch_pick)
    rep = lambda a: np.repeat(a, v, axis=0)  # noqa: E731
    pos = np.tile(np.arange(v), b)
    keys = np.stack([pos, np.zeros_like(pos)], 1).astype(np.uint32)
    want = jgen._topp_next(jnp.asarray(rep(logits)), jnp.asarray(keys),
                           jnp.asarray(rep(temperature)), jnp.asarray(rep(top_p)),
                           jnp.asarray(rep(sample_mask)))
    got = tgen._topp_next(torch.from_numpy(rep(logits)), torch.from_numpy(pos).float(),
                          torch.from_numpy(rep(temperature)), torch.from_numpy(rep(top_p)),
                          torch.from_numpy(rep(sample_mask)))
    return np.asarray(want).reshape(b, v), got.numpy().reshape(b, v)


@pytest.mark.parametrize("kind", ["peaked", "flat", "ties", "mixed"])
def test_topp_keep_set_and_order_match_jax(monkeypatch, kind):
    logits = _logits(kind)
    b = logits.shape[0]
    temperature = np.array([1.0, 0.7, 1.3, 1.0], np.float32)[:b]
    top_p = np.array([0.9, 0.85, 0.95, 0.8], np.float32)[:b]
    sample_mask = np.ones(b, bool)
    want, got = _kept_in_order(monkeypatch, logits, temperature, top_p, sample_mask)
    np.testing.assert_array_equal(got, want)
    n_kept = np.array([len(set(r)) for r in got])
    assert (n_kept >= 1).all()
    if kind in ("flat", "mixed"):
        assert (n_kept[1:] > 128).all()        # these rows ran the full sort
    if kind == "mixed":
        assert n_kept[0] < 128


def test_topp_crossing_token_is_kept():
    """Masses 0.5, 0.3, 0.2 at top_p 0.6: the token that crosses (the
    second) is kept and the third is not; every draw lands in the kept set."""
    logits = torch.log(torch.tensor([[0.2, 0.5, 0.3]]))
    seen = set()
    for u in np.linspace(0.0, 0.999, 50):
        tok = tgen._topp_next(logits, torch.tensor([u], dtype=torch.float32),
                              torch.ones(1), torch.tensor([0.6]), torch.ones(1, dtype=torch.bool))
        seen.add(int(tok))
    assert seen == {1, 2}


@pytest.mark.parametrize("kind", ["peaked", "ties", "mixed"])
def test_rows_without_sample_mask_take_the_argmax(kind):
    """Unmasked rows equal the JAX package's greedy choice (first index on
    ties) whatever the uniforms; masked rows draw from their kept set."""
    logits = _logits(kind)
    mask = np.array([False, True, False, True])
    want = np.asarray(jnp.argmax(jnp.asarray(logits), axis=-1))
    for u in (0.0, 0.5, 0.999):
        got = tgen._topp_next(torch.from_numpy(logits), torch.full((4,), u),
                              torch.ones(4), torch.full((4,), 0.9),
                              torch.from_numpy(mask)).numpy()
        np.testing.assert_array_equal(got[~mask], want[~mask])


def test_penalty_and_min_length_rules_match_jax():
    rng = np.random.default_rng(0)
    lg = rng.standard_normal((3, 50)).astype(np.float32) * 3
    seen = rng.random((3, 50)) < 0.3
    pen = np.array([1.0, 1.5, 0.8], np.float32)
    want = jgen._penalize_logits(jnp.asarray(lg), jnp.asarray(seen), jnp.asarray(pen))
    got = tgen._penalize_logits(torch.from_numpy(lg), torch.from_numpy(seen),
                                torch.from_numpy(pen))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    step = np.array([0, 3, 5], np.int32)
    min_len = np.array([1, 4, 4], np.int32)
    eos = np.array([2, 7, -1], np.int32)
    want = jgen._mask_min_length(jnp.asarray(lg), jnp.asarray(step), jnp.asarray(min_len),
                                 jnp.asarray(eos))
    got = tgen._mask_min_length(torch.from_numpy(lg), torch.from_numpy(step),
                                torch.from_numpy(min_len), torch.from_numpy(eos))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _gen(cls, **kw):
    return cls(pad_to_multiple=8, **{"max_new_tokens": 24, "eos_token_id": -1,
                                     "stop_sequences": (), **kw})


@pytest.mark.parametrize("kw", [dict(repetition_penalty=1.5),
                                dict(repetition_penalty=0.7),
                                dict(min_length=6, eos_token_id="first"),
                                dict(repetition_penalty=1.3, min_length=4, eos_token_id="first",
                                     stop_sequences=((5,), (11, 12)))])
def test_penalized_greedy_generate_matches_jax(llama, kw):
    """Greedy decoding under the repetition penalty and min_length: tokens
    identical to the JAX package's in fp32. ``eos_token_id="first"`` makes
    eos the token the unmasked model emits first, so min_length bites."""
    jp, tp, jc, tc = llama
    emb = (np.random.default_rng(1).standard_normal((2, 7, 64)) * 0.3).astype(np.float32)
    mask = np.ones((2, 7), np.int32)
    mask[1, 5:] = 0
    if kw.get("eos_token_id") == "first":
        plain = tgen.generate(tp, torch.from_numpy(emb), torch.from_numpy(mask), llama_cfg=tc,
                              gen=_gen(tgen.GenerationConfig, max_new_tokens=1))
        kw = {**kw, "eos_token_id": plain[0][0]}
    want = jgen.generate(jp, jnp.asarray(emb), jnp.asarray(mask), llama_cfg=jc,
                         gen=_gen(jgen.GenerationConfig, **kw))
    got = tgen.generate(tp, torch.from_numpy(emb), torch.from_numpy(mask), llama_cfg=tc,
                        gen=_gen(tgen.GenerationConfig, **kw))
    assert got == want
    if "min_length" in kw:
        assert all(kw["eos_token_id"] not in row[:kw["min_length"]] for row in got)


@pytest.mark.parametrize("kw", [dict(), dict(repetition_penalty=1.5, min_length=3),
                                dict(top_p=0.3, temperature=0.5)])
def test_sampled_generate_is_reproducible_from_its_seed(llama, kw):
    """The same seed gives the same tokens, whatever the chunk size; another
    seed gives others; every token is in the vocabulary."""
    _, tp, _, tc = llama
    emb = torch.from_numpy(
        (np.random.default_rng(2).standard_normal((3, 6, 64)) * 0.3).astype(np.float32))
    gen = _gen(tgen.GenerationConfig, do_sample=True, max_new_tokens=30, **kw)
    a = tgen.generate(tp, emb, llama_cfg=tc, gen=gen, seed=5)
    assert a == tgen.generate(tp, emb, llama_cfg=tc, gen=gen, seed=5)
    assert a != tgen.generate(tp, emb, llama_cfg=tc, gen=gen, seed=6)
    assert all(len(r) == 30 and all(0 <= t < 97 for t in r) for r in a)
    embeds, mask = tgen._pad_prompt(emb, torch.ones((3, 6), dtype=torch.int32), 8)
    logits, cache = tgen._prefill(tp, embeds, mask, tc, embeds.shape[1] + 30)
    if gen.repetition_penalty == 1.0:
        run = tgen._generate_sample_ondevice
    else:
        run = tgen._generate_penalized_ondevice
    assert run(tp, logits, cache, tc, gen, 3, 5, chunk=7)[0] == a


def test_first_token_sampled_is_the_streams_first_draw():
    logits = torch.from_numpy(_logits("peaked", b=1))
    tok, g = tgen._first_token_sampled(logits, 11, 1.0, 0.9)
    u = tgen._row_uniforms(11, 1, 2, "cpu")
    want = tgen._first_token_mixed(logits, u[:, 0], torch.ones(1), torch.full((1,), 0.9),
                                   torch.ones(1, dtype=torch.bool))
    assert int(tok) == int(want)
    assert float(torch.rand((1,), generator=g)) == float(u[0, 1])


def test_sampled_rows_draw_from_the_kept_set(llama):
    """A sampled greedy-identical check: with top_p tiny the kept set is the
    argmax alone, so sampled decoding equals greedy decoding."""
    jp, tp, jc, tc = llama
    emb = (np.random.default_rng(3).standard_normal((2, 6, 64)) * 0.3).astype(np.float32)
    want = jgen.generate(jp, jnp.asarray(emb), llama_cfg=jc, gen=_gen(jgen.GenerationConfig))
    got = tgen.generate(tp, torch.from_numpy(emb), llama_cfg=tc,
                        gen=_gen(tgen.GenerationConfig, do_sample=True, top_p=1e-6), seed=9)
    assert got == want


def test_beams_still_raise():
    with pytest.raises(tgen.UnsupportedRequest, match="beam"):
        tgen.generate({}, torch.zeros((1, 2, 4)), llama_cfg=tllama.LlamaConfig(),
                      gen=tgen.GenerationConfig(num_beams=2))
