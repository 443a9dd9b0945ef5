"""PyTorch port, the optimizers of the library surface against the JAX
package and optax, on tiny fp32 trees on the CPU: ``common.optim``'s
name-based ``weight_decay_mask`` and ``make_optimizer`` (freezing through
``trainable_mask``), ``train.step.Adafactor`` against optax.adafactor behind
optax.clip_by_global_norm, as the reference's ``make_probe_optimizer``
chains them, that function's threshold, and an Adafactor state through
``CheckpointManager`` and ``Trainer``.

Tolerances: parameters after each step within 2e-6 (AdamW, as
tests/test_torch_train_ops.py); Adafactor's parameters within 1e-6 relative
to each leaf's largest value (a parameter near zero after its step keeps
the absolute error of its leaf's scale) and its statistics within 1e-6
relative: both sides are fp32 and differ in the order of their sums."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from stllm_tpu.common import optim as joptim
from stllm_tpu.models import stllm as jst
from stllm_tpu.models import llama as jllama
from stllm_tpu.models import qformer as jqf
from stllm_tpu.models import vit as jvit
from stllm_tpu.train import step as jstep
from stllm_tpu_torch.common import optim as toptim
from stllm_tpu_torch.convert.from_jax import load_jax_params
from stllm_tpu_torch.data.collate import TrainCollator
from stllm_tpu_torch.models import zoo as tzoo
from stllm_tpu_torch.train import checkpoint as tckpt
from stllm_tpu_torch.train import step as tstep
from stllm_tpu_torch.train.trainer import Trainer


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Tiny eager trees: one intra-op thread, so parallel test processes do
    not oversubscribe the cores, and CPU sums run in one fixed order."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


ADAMW_TOL = 2e-6
ADAFACTOR_RTOL = 1e-6


def _flat(jtree):
    return {jstep.path_str(p): np.asarray(a)
            for p, a in jax.tree_util.tree_flatten_with_path(jtree)[0]}


def _tree(seed, shapes, scale=1.0):
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal(s) * scale).astype(np.float32) for k, s in shapes.items()}


def test_weight_decay_mask_matches_jax_on_the_stllm_tree():
    """Leaf for leaf over the tiny STLLM tree, by the port's paths."""
    cfg = jst.STLLMConfig(
        vit=jvit.ViTConfig(image_size=28, patch_size=14, width=32, depth=2, heads=2,
                           mlp_hidden=64, dtype=jnp.float32),
        qformer=jqf.QFormerConfig(hidden=16, num_layers=1, heads=2, intermediate=32,
                                  encoder_width=32, num_query=4, vocab_size=50,
                                  dtype=jnp.float32),
        llama=jllama.LlamaConfig(vocab_size=61, hidden=32, num_layers=2, heads=2,
                                 intermediate=64, max_positions=64, dtype=jnp.float32),
        video_input="all", vit_model="eva_btadapter_g", btadapter_depth=1)
    jtree = jax.jit(jst.init_stllm, static_argnums=1)(jax.random.PRNGKey(0), cfg)
    want = {k: bool(v) for k, v in _flat(joptim.weight_decay_mask(jtree)).items()}
    ttree = load_jax_params(jax.tree_util.tree_map(np.asarray, jtree), device="cpu")
    got = toptim.weight_decay_mask(ttree)
    assert got == want
    # both rules occur: by rank and by name
    assert got["llama/layers/0/q/w"] and not got["llama/embed_tokens"]
    assert not got["llama/layers/0/input_norm/scale"] and not got["vit/blocks/0/fc1/b"]
    assert not any(v for k, v in got.items() if "norm" in k.lower())


TOY = {"proj/kernel": (8, 6), "proj/bias": (6,), "ln_f/scale": (6, 6),
       "embed_tokens/weight": (16, 8), "head/w": (8, 5), "head/b": (5,)}


def _nested(flat):
    out = {}
    for path, v in flat.items():
        a, b = path.split("/")
        out.setdefault(a, {})[b] = v
    return out


@pytest.mark.parametrize("case", ["frozen_clipped", "frozen_unclipped", "no_decay", "eps"])
def test_make_optimizer_matches_optax(case):
    """Three steps against stllm_tpu.common.optim.make_optimizer, with
    ``head`` and the embedding frozen (but for "eps"): frozen leaves do not
    move, and the clip's norm covers the trained leaves only (their
    gradients are large, so "frozen_clipped" would clip another amount if
    they counted)."""
    kw = dict(weight_decay=0.05, max_grad_norm=1.0, eps=1e-8)
    frozen = {"head/w", "head/b", "embed_tokens/weight"}
    gscale = {"frozen_unclipped": 0.001}.get(case, 1.0)
    if case == "no_decay":
        kw["weight_decay"] = 0.0
    if case == "eps":
        kw["eps"], frozen = 1e-3, set()
    mask = {k: k not in frozen for k in TOY}
    jopt = joptim.make_optimizer(1e-2, trainable_mask=_nested(mask), **kw)
    topt = toptim.make_optimizer(1e-2, trainable_mask=_nested(mask), **kw)
    params = _tree(0, TOY)
    jp = jax.tree_util.tree_map(jnp.asarray, _nested(params))
    jstate = jopt.init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    tstate = topt.init(tp)
    assert set(tstate["mu"]) == {k for k in TOY if mask[k]}
    for step in range(3):
        g = _tree(10 + step, TOY, gscale)
        for k in frozen:
            g[k] = g[k] * 1e3
        upd, jstate = jopt.update(jax.tree_util.tree_map(jnp.asarray, _nested(g)), jstate, jp)
        jp = optax.apply_updates(jp, upd)
        topt.update({k: torch.from_numpy(v.copy()) for k, v in g.items()}, tstate, tp)
        want = _flat(jp)
        for k, p in tp.items():
            np.testing.assert_allclose(p.numpy(), want[k], atol=ADAMW_TOL, rtol=ADAMW_TOL,
                                       err_msg=f"{k} step {step}")
    for k in frozen:
        np.testing.assert_array_equal(tp[k].numpy(), params[k])
    assert tstate["count"] == 3


ADAFACTOR_LEAVES = {"wide/w": (256, 384), "stack/w": (2, 128, 256), "narrow/w": (64, 300),
                    "norm/scale": (64,), "gate/s": ()}


@pytest.mark.parametrize("case", ["clipped", "unclipped", "schedule"])
def test_adafactor_matches_optax(case):
    """Three steps of optax.chain(clip_by_global_norm(1.0),
    adafactor(lr * 10, min_dim_size_to_factor=128)), the reference's probe
    chain, on factored (256, 384) and (2, 128, 256), unfactored (64, 300),
    1-d and 0-d leaves; the statistics compared too."""
    lr = 2e-3
    gscale = {"unclipped": 1e-4}.get(case, 1.0)
    rate = lr * 10
    if case == "schedule":
        rate = toptim.warmup_cosine_decay(0.0, lr * 10, 1, 3)
        jrate = optax.warmup_cosine_decay_schedule(0.0, lr * 10, 1, 3)
    jopt = optax.chain(optax.clip_by_global_norm(1.0),
                       optax.adafactor(learning_rate=jrate if case == "schedule" else rate,
                                       min_dim_size_to_factor=128))
    topt = tstep.Adafactor(rate, min_dim_size_to_factor=128, max_grad_norm=1.0)
    params = _tree(0, ADAFACTOR_LEAVES)
    params["gate/s"] = np.float32(0.5).reshape(())
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jopt.init(jp)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in params.items()}
    tstate = topt.init(tp)
    assert set(tstate["v_row"]) == set(tstate["v_col"]) == {"wide/w", "stack/w"}
    assert tuple(tstate["v_row"]["stack/w"].shape) == (2, 128)
    assert tuple(tstate["v_col"]["stack/w"].shape) == (2, 256)
    assert set(tstate["v"]) == {"narrow/w", "norm/scale", "gate/s"}
    for step in range(3):
        g = _tree(10 + step, ADAFACTOR_LEAVES, gscale)
        g["gate/s"] = np.float32(0.3 * gscale).reshape(())
        jg = {k: jnp.asarray(v) for k, v in g.items()}
        upd, jstate = jopt.update(jg, jstate, jp)
        jp = optax.apply_updates(jp, upd)
        # the clip scale from JAX's own norm: XLA's CPU sum of 98,304 squares
        # is host-dependent by a few ulps (test_global_norm_within_one_ulp
        # holds the port's norm)
        jnorm = torch.tensor(np.asarray(optax.global_norm(jg)))
        topt.update({k: torch.from_numpy(np.array(v)) for k, v in g.items()}, tstate, tp,
                    grad_norm=jnorm)
        for k, p in tp.items():
            want = np.asarray(jp[k])
            np.testing.assert_allclose(p.numpy(), want, rtol=ADAFACTOR_RTOL,
                                       atol=ADAFACTOR_RTOL * np.abs(want).max(),
                                       err_msg=f"{k} step {step}")
        fstate = jstate[1][0]
        for name in ("v_row", "v_col", "v"):
            for k, v in tstate[name].items():
                np.testing.assert_allclose(v.numpy(), np.asarray(getattr(fstate, name)[k]),
                                           rtol=ADAFACTOR_RTOL, err_msg=f"{name} {k}")
    assert tstate["count"] == 3 == int(jstate[1][0].count)


U32 = 2.0 ** -24      # fp32's unit roundoff


@pytest.mark.parametrize("t", [1, 2, 3, 1000])
def test_adamw_step_within_ulps(t):
    """One AdamW step of make_optimizer (weight decay, as the trained proxy
    runs it) from a shared state at step ``t``: the same parameters,
    moments and gradients, whose magnitudes span 1e-12 to 1 (a gradient at
    AdamW's eps moves its update by a share of the rate, so a
    backward's rounding noise there shows in the trained weights). Both
    sides take the bias corrections in fp32 and differ in the order of
    their roundings: the normalized update u = m_hat / (sqrt(v_hat) + eps)
    by at most 9 roundings on optax's side and 7 on the port's (the second
    moment's halved by the root), so lr * u by 16 * 2^-24 * lr * |u|; the
    decay term by 2 * 2^-24 * lr * wd * |p|; and the parameter by two
    halves of its ulp (the port's decay product and the last add, against
    optax's add): within 2 ulp(p) + 2^-24 * lr * (16 |u| + 2 wd |p|). Each
    moment's blend rounds at most 4 times a side."""
    lr, wd, b1, b2 = 2e-4, 0.05, 0.9, 0.999
    shapes = {"a/w": (64, 300), "b/w": (256, 128), "a/b": (300,)}
    jopt = joptim.make_optimizer(lr, weight_decay=wd, max_grad_norm=None)
    topt = toptim.make_optimizer(lr, weight_decay=wd, max_grad_norm=None)
    rng = np.random.default_rng(t)
    params = _tree(t, shapes, 0.05)
    g = {k: (rng.standard_normal(v) * 10.0 ** rng.uniform(-12, 0, v)).astype(np.float32)
         for k, v in shapes.items()}
    mu = {k: (rng.standard_normal(v) * 1e-3).astype(np.float32) for k, v in shapes.items()}
    nu = {k: (rng.uniform(0, 1, v) * 1e-6).astype(np.float32) for k, v in shapes.items()}
    jp = jax.tree_util.tree_map(jnp.asarray, _nested(params))
    (adam, *rest), = jopt.init(jp)          # the chain's state: (adam, decay, lr)
    adam = adam._replace(count=jnp.int32(t - 1),
                         mu=jax.tree_util.tree_map(jnp.asarray, _nested(mu)),
                         nu=jax.tree_util.tree_map(jnp.asarray, _nested(nu)))
    upd, jstate = jopt.update(jax.tree_util.tree_map(jnp.asarray, _nested(g)), ((adam, *rest),), jp)
    want = _flat(optax.apply_updates(jp, upd))
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    tstate = {"count": t - 1, "mu": {k: torch.from_numpy(v.copy()) for k, v in mu.items()},
              "nu": {k: torch.from_numpy(v.copy()) for k, v in nu.items()}}
    topt.update({k: torch.from_numpy(v.copy()) for k, v in g.items()}, tstate, tp)
    decay = toptim.weight_decay_mask(tp)
    for k, p in tp.items():
        p0, p1 = params[k].astype(np.float64), want[k].astype(np.float64)
        u = np.abs(p1 - p0 * (1 - lr * wd * decay[k])) / lr
        big = np.maximum(np.abs(p0), np.abs(p1)).astype(np.float32)
        bound = 2 * np.spacing(big) + U32 * lr * (16 * u + 2 * wd * np.abs(p0))
        gap = np.abs(p.numpy().astype(np.float64) - p1)
        assert (gap <= bound).all(), (k, float((gap / bound).max()))
        for name, m, x, b in (("mu", mu, g[k], b1), ("nu", nu, g[k] ** 2, b2)):
            mag = np.abs((1 - b) * x.astype(np.float64)) + np.abs(b * m[k])
            jm = _flat(getattr(jstate[0][0], name))[k].astype(np.float64)
            tm = tstate[name][k].numpy().astype(np.float64)
            assert (np.abs(tm - jm) <= 8 * U32 * mag + 1e-45).all(), (name, k)
    assert tstate["count"] == t


@pytest.mark.parametrize("scale", [1.0, 1e-4])
def test_global_norm_within_one_ulp(scale):
    """train.step.global_norm against the exact norm (fp64 of the same fp32
    leaves): each fp32 square rounds by at most half an ulp of itself, so
    the sum by at most 2^-24 of itself and its root by 2^-25 (a quarter
    ulp); the fp64 sum adds about n * 2^-53 (1e-11) and the last rounding to
    fp32 half an ulp: within one ulp, on any host and thread count."""
    g = _tree(10, ADAFACTOR_LEAVES, scale)
    exact = np.sqrt(sum(np.sum(v.astype(np.float64) ** 2) for v in g.values()))
    got = tstep.global_norm([torch.from_numpy(np.asarray(v)) for v in g.values()])
    assert got.dtype == torch.float32 and got.dim() == 0
    assert abs(float(got) - exact) <= np.spacing(np.float32(exact))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_square_sum_of_16_bit_leaf_accumulates_in_fp32(dtype):
    """train.step.square_sum of a 16-bit leaf (the full-width trainer's
    bf16 gradients): its squares are exact in fp32 and summed there, so the
    sum lies within n * 2^-24 of the exact one (n non-negative terms in any
    order), and the norm's root and square add two roundings."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((300, 257)).astype(np.float32) * 0.01).to(dtype)
    exact = float((x.double() ** 2).sum())
    got = tstep.square_sum(x)
    assert got.dtype == torch.float64 and got.dim() == 0
    assert abs(float(got) - exact) <= (x.numel() + 2) * U32 * exact


@pytest.mark.parametrize("n_params, adafactor", [(1_500_000_000, False),
                                                  (1_500_000_001, True)])
def test_make_probe_optimizer_threshold(n_params, adafactor, capsys):
    """The choice and the printed line equal the reference's, counting every
    leaf (meta tensors here, shape structs there)."""
    shapes = {"a": (1000, 1000), "b": (n_params - 1_000_000,)}
    jopt = jstep.make_probe_optimizer(
        {k: jax.ShapeDtypeStruct(s, jnp.float32) for k, s in shapes.items()}, 2e-4)
    want = capsys.readouterr().out
    topt = tstep.make_probe_optimizer(
        {"x": {k: torch.empty(s, device="meta") for k, s in shapes.items()}}, 2e-4)
    assert capsys.readouterr().out == want
    assert isinstance(topt, tstep.Adafactor if adafactor else tstep.AdamW)
    assert (want == "1.50B params: adafactor\n") == adafactor
    assert isinstance(jopt, optax.GradientTransformation)
    if adafactor:
        assert topt.learning_rate == pytest.approx(2e-3) and topt.max_grad_norm == 1.0
        assert topt.min_dim_size_to_factor == 128
    else:
        assert topt.max_grad_norm == 1.0 and topt.weight_decay == 0.05


MODEL_CFG = {
    "arch": "st_llm_hf", "model_type": "instructblip_vicuna0_btadapter", "dtype": "fp32",
    "video_input": "all", "btadapter_depth": 1, "use_mask": True, "mvm_decode": True,
    "max_txt_len": 8, "freeze_LLM": False,
    "vit": {"image_size": 28, "width": 32, "depth": 2, "heads": 2, "mlp_hidden": 64},
    "qformer": {"hidden": 16, "num_layers": 1, "heads": 2, "intermediate": 32,
                "encoder_width": 32, "num_query": 4, "vocab_size": 64},
    "llama": {"vocab_size": 97, "hidden": 32, "num_layers": 2, "heads": 2,
              "intermediate": 64, "max_positions": 128}}


def _adafactor_trainer(out):
    model = tzoo.STLLM.from_config(MODEL_CFG, seed=0, device="cpu")
    # factor leaves of 16 and more on both axes, so the tiny tree has both kinds
    opt = tstep.Adafactor(1e-2, min_dim_size_to_factor=16, max_grad_norm=1.0)
    return Trainer(model.cfg, model.params, opt, output_dir=str(out), device="cpu",
                   trainable_fn=model.trainable_fn(), log_freq=1, save_freq=100)


def _batches():
    col = TrainCollator(tzoo.STLLM.from_config(MODEL_CFG, seed=0, device="cpu").cfg,
                        tzoo.ToyHashTokenizer(97), tzoo.ToyHashTokenizer(64, reserve=2),
                        seq_multiple=16, seed=0)
    rng = np.random.default_rng(3)
    return [col([{"image": rng.integers(0, 256, (2, 28, 28, 3), dtype=np.uint8),
                  "instruction_input": f"###Human: <Video><ImageHere></Video> what {i} "
                                       "###Assistant:",
                  "answer": "a cat on the mat"[:6 + 2 * j]} for j in range(2)])
            for i in range(4)]


def _opt_snapshot(state):
    return {name: ({k: v.clone() for k, v in leaves.items()} if name != "count" else leaves)
            for name, leaves in state.opt_state.items()}


def test_adafactor_checkpoint_round_trip_and_resume(tmp_path):
    """Trainer takes Adafactor as it is. Two steps saved and restored into
    another run's state give back every leaf of v_row, v_col, v and count
    bit for bit; two more steps from there equal four straight steps bit
    for bit; an AdamW checkpoint does not restore into an Adafactor state."""
    batches = _batches()
    straight = _adafactor_trainer(tmp_path / "a")
    straight.train(iter(batches), 4)
    first = _adafactor_trainer(tmp_path / "b")
    first.train(iter(batches[:2]), 2)
    saved = _opt_snapshot(first.state)
    assert saved["v_row"] and saved["v_col"] and saved["v"] and saved["count"] == 2
    assert not {"mu", "nu"} & set(saved)
    second = _adafactor_trainer(tmp_path / "b")
    assert second.resume_if_available() == 2
    got = _opt_snapshot(second.state)
    assert got.keys() == saved.keys() and got["count"] == 2
    for name in ("v_row", "v_col", "v"):
        assert got[name].keys() == saved[name].keys()
        for k in saved[name]:
            assert torch.equal(got[name][k], saved[name][k]), (name, k)
    second.train(iter(batches[2:]), 4)
    for k, v in straight.state.params.items():
        assert torch.equal(second.state.params[k], v), k
    for name, leaves in _opt_snapshot(straight.state).items():
        if name != "count":
            for k, v in leaves.items():
                assert torch.equal(second.state.opt_state[name][k], v), (name, k)
    model = tzoo.STLLM.from_config(MODEL_CFG, seed=0, device="cpu")
    adamw = Trainer(model.cfg, model.params, output_dir=str(tmp_path / "c"), device="cpu",
                    trainable_fn=model.trainable_fn(), save_freq=100)
    adamw.train(iter(batches[:1]), 1)
    with pytest.raises(KeyError, match="another optimizer"):
        tckpt.CheckpointManager(str(tmp_path / "c")).restore(second.state)
