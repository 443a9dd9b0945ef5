"""PyTorch port, the Q-Former's UniLM decoder path (stllm_tpu_torch/models/
qformer.py: unilm_attention_mask, the masked qformer_forward, init_qformer_lm,
qformer_lm_logits, qformer_lm_forward, qformer_lm_generate) against
stllm_tpu.models.qformer: JAX params from the reference's own init,
converted with load_jax_params (the ``cls`` head leaves included), and the
same numpy inputs through both packages in fp32. Masks are held bit for
bit, hidden states, logits and losses within 2e-5 (a few fp32 ulps a layer
over two layers and the vocabulary product), greedy tokens exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stllm_tpu.models import qformer as jqf
from stllm_tpu_torch.convert.from_jax import load_jax_params
from stllm_tpu_torch.models import qformer as tqf

QF = dict(hidden=32, num_layers=2, heads=4, intermediate=64, encoder_width=24,
          num_query=4, vocab_size=50, max_positions=16)
JCFG = jqf.QFormerConfig(dtype=jnp.float32, **QF)
TCFG = tqf.QFormerConfig(dtype=torch.float32, **QF)
TOL = 2e-5


def _jit(fn, *static):
    """JAX's function jitted: one compile a shape, not one an op."""
    return jax.jit(fn, static_argnames=static)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def lm_params():
    """JAX's init_qformer_lm with its weights scaled up 15 times (at the
    init's 0.02 every row would decode the same tokens) and a nonzero head
    bias (its init is zeros)."""
    params = jax.tree_util.tree_map(np.asarray, _jit(jqf.init_qformer_lm, "cfg")(
        jax.random.PRNGKey(5), cfg=JCFG))

    def scale(node, key=None):
        if isinstance(node, dict):
            return {k: scale(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return [scale(v) for v in node]
        return node * 15 if key in ("w", "word", "position", "query_tokens") else node

    params = scale(params)
    params["cls"]["bias"] = np.random.default_rng(1).normal(
        size=QF["vocab_size"]).astype(np.float32) * 0.1
    return params, load_jax_params(params, device="cpu")


def _inputs(seed, b=2, t=6, s_img=10):
    rs = np.random.default_rng(seed)
    ids = rs.integers(0, QF["vocab_size"], (b, t)).astype(np.int32)
    enc = rs.normal(size=(b, s_img, QF["encoder_width"])).astype(np.float32)
    return ids, enc


def test_init_lm_tree_matches_jax_and_converts_the_head(lm_params):
    jp, tp = lm_params
    mine = tqf.init_qformer_lm(torch.Generator().manual_seed(0), TCFG)

    def shapes(tree):
        return jax.tree_util.tree_map(lambda x: tuple(x.shape), tree,
                                      is_leaf=lambda x: hasattr(x, "shape"))

    assert shapes(mine) == shapes(tp) == shapes(jp)
    assert mine["cls"]["bias"].dtype == torch.float32 and not mine["cls"]["bias"].any()
    for path in (("transform", "w"), ("transform", "b"), ("transform_norm", "scale")):
        np.testing.assert_array_equal(tp["cls"][path[0]][path[1]].numpy(),
                                      jp["cls"][path[0]][path[1]])
    np.testing.assert_array_equal(tp["cls"]["bias"].numpy(), jp["cls"]["bias"])


@pytest.mark.parametrize("pads", [(0, 0, 0), (0, 3, 1), (2, 5, 6)])
def test_unilm_mask_equals_jax(pads):
    q, t = 4, 6
    pad = np.ones((3, q + t), np.int32)
    for row, n in enumerate(pads):
        if n:
            pad[row, -n:] = 0
    want = np.asarray(jqf.unilm_attention_mask(jnp.asarray(pad), q))
    got = tqf.unilm_attention_mask(torch.from_numpy(pad), q)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)


def test_masked_forward_equals_jax(lm_params):
    jp, tp = lm_params
    ids, enc = _inputs(3)
    pad = np.ones((2, QF["num_query"] + ids.shape[1]), np.int32)
    pad[1, -2:] = 0
    mask3 = np.asarray(jqf.unilm_attention_mask(jnp.asarray(pad), QF["num_query"]))
    emask = np.ones((2, enc.shape[1]), np.int32)
    emask[0, -3:] = 0
    want = _jit(jqf.qformer_forward, "cfg")(
        jp, encoder_hidden_states=jnp.asarray(enc), input_ids=jnp.asarray(ids),
        attention_mask=jnp.asarray(pad[:, QF["num_query"]:]), encoder_mask=jnp.asarray(emask),
        cfg=JCFG, self_attn_mask=jnp.asarray(mask3))
    got = tqf.qformer_forward(tp, encoder_hidden_states=torch.from_numpy(enc),
                              input_ids=torch.from_numpy(ids),
                              attention_mask=torch.from_numpy(pad[:, QF["num_query"]:]),
                              encoder_mask=torch.from_numpy(emask), cfg=TCFG,
                              self_attn_mask=torch.from_numpy(mask3.copy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)
    # the mask changes the answer: the text rows no longer see later text
    plain = tqf.qformer_forward(tp, encoder_hidden_states=torch.from_numpy(enc),
                                input_ids=torch.from_numpy(ids), cfg=TCFG)
    assert (plain[:, QF["num_query"]:] - got[:, QF["num_query"]:]).abs().max() > 1e-3


@pytest.mark.parametrize("smoothing", [0.1, 0.0])
def test_lm_logits_and_smoothed_loss_equal_jax(lm_params, smoothing):
    jp, tp = lm_params
    ids, enc = _inputs(6)
    labels = ids.copy()
    labels[0, :2] = -100
    att = np.ones_like(ids)
    att[1, -1] = 0
    hidden = np.random.default_rng(7).normal(size=(2, 5, QF["hidden"])).astype(np.float32)
    np.testing.assert_allclose(
        tqf.qformer_lm_logits(tp, torch.from_numpy(hidden), TCFG).numpy(),
        np.asarray(_jit(jqf.qformer_lm_logits, "cfg")(jp, jnp.asarray(hidden), cfg=JCFG)),
        atol=TOL, rtol=TOL)
    jloss, jlogits = _jit(jqf.qformer_lm_forward, "cfg", "label_smoothing")(
        jp, input_ids=jnp.asarray(ids), encoder_hidden_states=jnp.asarray(enc),
        attention_mask=jnp.asarray(att), labels=jnp.asarray(labels),
        label_smoothing=smoothing, cfg=JCFG)
    tloss, tlogits = tqf.qformer_lm_forward(
        tp, input_ids=torch.from_numpy(ids), encoder_hidden_states=torch.from_numpy(enc),
        attention_mask=torch.from_numpy(att), labels=torch.from_numpy(labels),
        label_smoothing=smoothing, cfg=TCFG)
    assert tlogits.dtype == torch.float32 and tlogits.shape == (2, ids.shape[1], QF["vocab_size"])
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), atol=TOL, rtol=TOL)
    assert float(tloss) == pytest.approx(float(jloss), rel=TOL)
    # torch's own smoothed CE over the valid shifted positions, as the reference computes it
    want = torch.nn.CrossEntropyLoss(label_smoothing=smoothing)(
        tlogits[:, :-1].reshape(-1, QF["vocab_size"]),
        torch.from_numpy(labels[:, 1:]).reshape(-1).long())
    assert float(tloss) == pytest.approx(float(want), rel=1e-6)
    assert torch.equal(tqf.qformer_lm_forward(
        tp, input_ids=torch.from_numpy(ids), encoder_hidden_states=torch.from_numpy(enc),
        attention_mask=torch.from_numpy(att), cfg=TCFG), tlogits)


def test_greedy_generate_equals_jax(lm_params, monkeypatch):
    """Without eos, then with eos set to a token the rows emit: finished rows
    pad with it and decoding stops when every row has emitted it. JAX's
    forward is jitted for the test."""
    jp, tp = lm_params
    monkeypatch.setattr(jqf, "qformer_lm_forward",
                        _jit(jqf.qformer_lm_forward, "cfg", "label_smoothing"))
    _, enc = _inputs(8, b=3)
    emask = np.ones(enc.shape[:2], np.int32)
    emask[2, -4:] = 0
    runs = []
    for eos in (None, "from the first run"):
        kw = dict(bos_token_id=1, eos_token_id=eos, max_new_tokens=5)
        if eos is not None:
            kw["eos_token_id"] = eos = runs[0][0][1]
        want = jqf.qformer_lm_generate(jp, jnp.asarray(enc), encoder_mask=jnp.asarray(emask),
                                       cfg=JCFG, **kw)
        got = tqf.qformer_lm_generate(tp, torch.from_numpy(enc),
                                      encoder_mask=torch.from_numpy(emask), cfg=TCFG, **kw)
        assert got == want and all(1 <= len(r) <= 5 for r in got)
        runs.append(got)
    assert len({tuple(r) for r in runs[0]}) > 1, runs[0]      # the rows differ
    assert runs[1] != runs[0] and runs[1][0][:2] == runs[0][0][:2]
    # greedy: one forward over the emitted prefix picks each token again
    row = [1] + runs[0][1]
    logits = tqf.qformer_lm_forward(tp, input_ids=torch.tensor([row]),
                                    encoder_hidden_states=torch.from_numpy(enc[1:2]),
                                    encoder_mask=torch.from_numpy(emask[1:2]), cfg=TCFG)
    assert logits[0, :len(runs[0][1])].argmax(-1).tolist() == runs[0][1]
