"""PyTorch port, draft distillation (stllm_tpu_torch/models/distill.py)
against the JAX package on tiny fp32 LLaMAs: the same converted target and
draft and the same (prompt embeds, continuation ids) batches through three
steps of each package's distill step, with a W4A16 (fused per-channel
int4) teacher, the serving target's form.

Tolerances: per-step losses and every draft leaf after three steps (1-D
norms included, which optax.adamw decays too) within 1e-4 absolute plus
1e-3 relative, as tests/test_torch_train.py holds AdamW steps; the
argmax-match fractions equal. The optimizer alone is held to optax.adamw
within 1e-5 absolute over three steps of 0.1: a ten-thousandth of a step,
as the port folds Adam's two bias corrections into two scalars where optax
divides by them."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from stllm_tpu.models import distill as jdistill
from stllm_tpu.models import llama as jllama
from stllm_tpu_torch.convert.from_jax import load_jax_params
from stllm_tpu_torch.models import distill as tdistill
from stllm_tpu_torch.models import llama as tllama
from stllm_tpu_torch.train.step import tree_paths

ATOL, RTOL = 1e-4, 1e-3
LL = dict(vocab_size=61, hidden=64, num_layers=2, heads=4, intermediate=128, max_positions=64)
JT, TT = jllama.LlamaConfig(dtype=jnp.float32, **LL), tllama.LlamaConfig(dtype=torch.float32, **LL)
JD, TD = dataclasses.replace(JT, num_layers=1), dataclasses.replace(TT, num_layers=1)
LR, STEPS = 1e-2, 3


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _perturb(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: a + jnp.asarray(rng.standard_normal(a.shape) * 0.02, a.dtype), tree)


def _batches():
    rng = np.random.default_rng(4)
    return [((rng.standard_normal((2, 6, 64)) * 0.3).astype(np.float32),
             rng.integers(0, LL["vocab_size"], (2, 6)).astype(np.int32)) for _ in range(STEPS)]


def test_three_distill_steps_match_jax():
    """The W4A16 teacher (the serving target's form) and a dense draft."""
    target = jllama.quantize_llama_params_int4(
        _perturb(jllama.init_llama(jax.random.PRNGKey(0), JT), 1), group=None, fuse=True)
    draft = _perturb(jllama.init_llama(jax.random.PRNGKey(2), JD), 3)
    batches = _batches()

    opt = optax.adamw(LR)
    jd, state, jlog = draft, optax.adamw(LR).init(draft), []
    for embeds, ids in batches:
        jd, state, loss, acc = jdistill._distill_step(
            target, jd, state, jnp.asarray(embeds), jnp.asarray(ids), tgt_cfg=JT, dft_cfg=JD,
            opt=opt, kl_mix=0.1)
        jlog.append((float(loss), float(acc)))

    tt, td, tlog = load_jax_params(_np(target), "cpu"), load_jax_params(_np(draft), "cpu"), []
    out = tdistill.distill_draft(
        tt, td, lambda i: tuple(torch.from_numpy(a) for a in batches[i]), tgt_cfg=TT, dft_cfg=TD,
        steps=STEPS, learning_rate=LR, metrics=tlog)
    assert out is td
    for i, (got, want) in enumerate(zip(tlog, jlog)):
        np.testing.assert_allclose(got["loss"], want[0], atol=ATOL, rtol=RTOL, err_msg=f"step {i}")
        assert got["argmax_match"] == pytest.approx(want[1], abs=1e-6)
    want = {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in p): np.asarray(a)
            for p, a in jax.tree_util.tree_flatten_with_path(jd)[0]}
    got = dict(tree_paths(td))
    assert set(got) == set(want) and "norm/scale" in got
    start = dict(tree_paths(load_jax_params(_np(draft), "cpu")))
    for path, p in got.items():
        assert not p.requires_grad
        assert not torch.equal(p, start[path]), path          # every leaf trained
        np.testing.assert_allclose(p.numpy(), want[path], atol=ATOL, rtol=RTOL, err_msg=path)


def test_distill_optimizer_is_optax_adamw():
    """Weight decay 1e-4 on every leaf (a 1-D leaf with a zero gradient
    decays), no clipping of a gradient far above 1, eps 1e-8."""
    rng = np.random.default_rng(0)
    params = {"w": rng.standard_normal((3, 4)).astype(np.float32),
              "scale": np.ones(4, np.float32)}
    grads = [{"w": (rng.standard_normal((3, 4)) * 50).astype(np.float32),
              "scale": np.zeros(4, np.float32)} for _ in range(3)]
    opt = optax.adamw(0.1)
    jp, st = {k: jnp.asarray(v) for k, v in params.items()}, None
    st = opt.init(jp)
    topt = tdistill.distill_optimizer(0.1)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    tst = topt.init(tp)
    for g in grads:
        upd, st = opt.update({k: jnp.asarray(v) for k, v in g.items()}, st, jp)
        jp = optax.apply_updates(jp, upd)
        topt.update({k: torch.from_numpy(v.copy()) for k, v in g.items()}, tst, tp)
    for k in params:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=0, atol=1e-5)
    assert float(tp["scale"][0]) < 1.0


def test_draft_of_another_width_raises():
    with pytest.raises(ValueError):
        tdistill.distill_draft({}, {}, None, tgt_cfg=TT,
                               dft_cfg=dataclasses.replace(TD, hidden=32), steps=1)
