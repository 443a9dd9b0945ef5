"""PyTorch port, the training slice as a whole (models' cache-less forward,
stllm_forward, train/step, train/trainer): JAX params from the reference's
own init, converted with load_jax_params, and the same packed batch (from
the collator, seeded) through both packages, in fp32 on the CPU.

Both sides run ``use_flash=None``: on the CPU the JAX package takes plain
``mha_reference`` there, the port the plain version of the kernel the card
would run (the fused short attention, whose backward recomputes through
``mha_reference``). Tolerances: 1e-4 absolute on losses and unit-scale
activations (a few fp32 ulps per op, compounded over the layers), and for
gradients and updated weights 1e-4 absolute plus 1e-3 relative."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stllm_tpu.models import llama as jllama
from stllm_tpu.models import qformer as jqf
from stllm_tpu.models import stllm as jst
from stllm_tpu.models import vit as jvit
from stllm_tpu.train import step as jstep
from stllm_tpu_torch.convert.from_jax import load_jax_params, load_jax_partition
from stllm_tpu_torch.data.collate import TrainCollator
from stllm_tpu_torch.models import btadapter as tbt
from stllm_tpu_torch.models import llama as tllama
from stllm_tpu_torch.models import qformer as tqf
from stllm_tpu_torch.models import stllm as tst
from stllm_tpu_torch.models import vit as tvit
from stllm_tpu_torch.models import zoo as tzoo
from stllm_tpu_torch.train import step as tstep
from stllm_tpu_torch.train.trainer import Trainer

ATOL, RTOL = 1e-4, 1e-3

VIT = dict(image_size=28, patch_size=14, width=64, depth=3, heads=4, mlp_hidden=128,
           use_flash=None)
QF = dict(hidden=32, num_layers=2, heads=4, intermediate=64, encoder_width=64,
          num_query=4, vocab_size=50, max_positions=16)
LL = dict(vocab_size=61, hidden=64, num_layers=2, heads=4, intermediate=128,
          max_positions=64)
FRAMES = 4


def _cfgs(remat=False, **kw):
    base = dict(video_input="all", vit_model="eva_btadapter_g", btadapter_depth=2,
                use_mask=True, mvm_decode=True, max_txt_len=8)
    base.update(kw)
    jcfg = jst.STLLMConfig(
        vit=jvit.ViTConfig(dtype=jnp.float32, remat=remat, **VIT),
        qformer=jqf.QFormerConfig(dtype=jnp.float32, **QF),
        llama=jllama.LlamaConfig(dtype=jnp.float32, remat=remat, **LL), **base)
    tcfg = tst.STLLMConfig(
        vit=tvit.ViTConfig(dtype=torch.float32, remat=remat, **VIT),
        qformer=tqf.QFormerConfig(dtype=torch.float32, **QF),
        llama=tllama.LlamaConfig(dtype=torch.float32, remat=remat, **LL), **base)
    return jcfg, tcfg


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, atol=ATOL, rtol=0.0, msg=""):
    got, want = (a.detach().numpy() if isinstance(a, torch.Tensor) else a for a in (got, want))
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               atol=atol, rtol=rtol, err_msg=msg)


@pytest.fixture(scope="module")
def jparams():
    """The reference's init, with noise on the zero-init leaves (biases,
    temporal_fc, cls) so every parameter takes part."""
    jcfg, _ = _cfgs()
    rng = np.random.default_rng(1)
    return jax.tree_util.tree_map(
        lambda a: a + jnp.asarray(rng.standard_normal(a.shape) * 0.02, a.dtype),
        jst.init_stllm(jax.random.PRNGKey(0), jcfg))


def _batches(n, rows, use_mask=True, seed=0):
    """n packed batches of ``rows`` rows from the port's collator (held
    byte-identical to the reference's in test_torch_train_ops)."""
    _, tcfg = _cfgs(use_mask=use_mask)
    col = TrainCollator(tcfg, tzoo.ToyHashTokenizer(LL["vocab_size"]),
                        tzoo.ToyHashTokenizer(QF["vocab_size"], reserve=2),
                        seq_multiple=16, seed=seed)
    rng = np.random.default_rng(seed + 10)
    out = []
    for _ in range(n):
        samples = [{"image": rng.integers(0, 256, (FRAMES, 28, 28, 3), dtype=np.uint8),
                    "instruction_input": "###Human: <Video><ImageHere></Video> what is "
                                         f"shown {int(rng.integers(0, 9))} ###Assistant:",
                    "answer": " ".join(["it", "is", "a", "cat", "on", "mat"][:3 + i % 4])}
                   for i in range(rows)]
        out.append(col(samples))
    return out


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _jpaths(tree):
    return {jstep.path_str(p): np.asarray(a)
            for p, a in jax.tree_util.tree_flatten_with_path(tree)[0]}


# ---------------------------------------------------------------------------
# the cache-less LLaMA forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_flash", [None, False, True])
def test_llama_forward_without_cache_matches_jax(jparams, use_flash):
    """Hidden states and the gradient with respect to the input embeddings.
    use_flash=True runs the flash tier's plain versions in the port and is
    held to the reference's plain attention (the Pallas tier does not run on
    a CPU without interpret mode)."""
    jc = jllama.LlamaConfig(dtype=jnp.float32, **{**LL, "use_flash": None if use_flash else
                                                  use_flash})
    tc = tllama.LlamaConfig(dtype=torch.float32, **{**LL, "use_flash": use_flash})
    rng = np.random.default_rng(2)
    emb = rng.standard_normal((2, 24, LL["hidden"])).astype(np.float32) * 0.5
    w = rng.standard_normal((2, 24, LL["hidden"])).astype(np.float32)
    mask = np.ones((2, 24), np.int32)
    mask[1, 17:] = 0
    # padded rows see keys 0..16 like any other row, so they compare too

    def jloss(e):
        h, cache = jllama.llama_forward(jparams["llama"], inputs_embeds=e,
                                        attention_mask=jnp.asarray(mask), cfg=jc)
        assert cache is None
        return jnp.sum(h * w), h

    (_, want), jg = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(emb))
    te = torch.from_numpy(emb).requires_grad_()
    got, cache = tllama.llama_forward(load_jax_params(_np(jparams["llama"]), "cpu"),
                                      inputs_embeds=te, attention_mask=torch.from_numpy(mask),
                                      cfg=tc)
    assert cache is None
    _close(got, want)
    _close(torch.autograd.grad((got * torch.from_numpy(w)).sum(), te)[0], jg, rtol=RTOL)


def test_llama_forward_from_input_ids(jparams):
    jc = jllama.LlamaConfig(dtype=jnp.float32, **LL)
    tc = tllama.LlamaConfig(dtype=torch.float32, **LL)
    ids = np.random.default_rng(3).integers(0, LL["vocab_size"], (2, 9))
    want, _ = jllama.llama_forward(jparams["llama"], input_ids=jnp.asarray(ids), cfg=jc)
    got, _ = tllama.llama_forward(load_jax_params(_np(jparams["llama"]), "cpu"),
                                  input_ids=torch.from_numpy(ids), cfg=tc)
    _close(got, want)


# ---------------------------------------------------------------------------
# stllm_forward: losses and every trainable gradient leaf
# ---------------------------------------------------------------------------

POLICIES = {"full": dict(freeze_llm=False), "default": dict(),
            "vit": dict(freeze_vit=False, freeze_qformer=False)}


@pytest.mark.parametrize("policy,use_mask", [("full", True), ("default", True), ("vit", True),
                                             ("full", False)])
def test_stllm_forward_losses_and_gradients(jparams, policy, use_mask):
    jcfg, tcfg = _cfgs(use_mask=use_mask)
    batch = _batches(1, 2, use_mask)[0]
    assert ("mvm_weight" in batch) == use_mask
    train_p, frozen_p = jstep.partition_params(jparams, jstep.default_trainable(**POLICIES[policy]))

    def jloss(tp):
        out = jst.stllm_forward(jstep.merge_params(tp, frozen_p), _jb(batch), jcfg)
        return out["loss"], out

    (_, jout), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(train_p)

    params = load_jax_params(_np(jparams), "cpu")
    train, frozen = tstep.partition_params(params, tstep.default_trainable(**POLICIES[policy]))
    out = tst.stllm_forward(params, _tb(batch), tcfg)
    names = ["loss_ce", "loss"] + (["loss_mvm"] if use_mask else [])
    assert sorted(k for k in out if k.startswith("loss")) == sorted(names)
    for k in names:
        _close(out[k], jout[k], msg=k)
    _close(out["logits"], jout["logits"])
    grads = torch.autograd.grad(out["loss"], list(train.values()), allow_unused=True)
    want = _jpaths(jgrads)
    assert set(train) == set(want)
    # the converter carries the gradient tree across: same paths, None elsewhere
    carried = dict(tstep.tree_paths(load_jax_params(_np(jgrads), "cpu")))
    assert set(carried) == set(train)
    for path, g in zip(train, grads):
        g = torch.zeros_like(train[path]) if g is None else g
        _close(g, want[path], rtol=RTOL, msg=path)
        assert np.array_equal(carried[path].numpy(), want[path])
    assert not any(p.requires_grad for p in frozen.values())


def test_teacher_pass_records_no_graph(jparams):
    """The MVM target comes from a pass under no_grad on detached embeddings."""
    _, tcfg = _cfgs()
    params = load_jax_params(_np(jparams), "cpu")
    tstep.partition_params(params, tstep.default_trainable(freeze_llm=False))
    calls = []
    real = tst.llama_forward

    def spy(p, **kw):
        calls.append((torch.is_grad_enabled(), kw["inputs_embeds"].requires_grad))
        return real(p, **kw)

    tst.llama_forward = spy
    try:
        tst.stllm_forward(params, _tb(_batches(1, 2)[0]), tcfg)
    finally:
        tst.llama_forward = real
    assert calls == [(True, True), (False, False)]


# ---------------------------------------------------------------------------
# remat, use_flash through the ViT
# ---------------------------------------------------------------------------

def test_remat_on_equals_off(jparams):
    _, plain_cfg = _cfgs(remat=False)
    _, remat_cfg = _cfgs(remat=True)
    batch = _tb(_batches(1, 2)[0])
    results = []
    for cfg in (plain_cfg, remat_cfg):
        params = load_jax_params(_np(jparams), "cpu")
        train, _ = tstep.partition_params(
            params, tstep.default_trainable(freeze_llm=False, freeze_vit=False))
        out = tst.stllm_forward(params, batch, cfg)
        results.append((out["loss"].detach(),
                        torch.autograd.grad(out["loss"], list(train.values()))))
    (l0, g0), (l1, g1) = results
    assert torch.equal(l0, l1)
    for a, b in zip(g0, g1):
        assert torch.equal(a, b)


@pytest.mark.parametrize("use_flash", [True, False])
def test_btadapter_use_flash_runs_flash_attention(jparams, use_flash):
    """use_flash True (the flash tier) and False (mha_reference) agree with
    the packed kernel's path, forward and in the branch's gradients over a
    frozen trunk."""
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (FRAMES, 28, 28, 3)).astype(np.float32))
    outs = []
    for uf in (None, use_flash):
        cfg = tvit.ViTConfig(dtype=torch.float32, **{**VIT, "use_flash": uf, "remat": True})
        params = load_jax_params(_np(jparams["vit"]), "cpu")
        train, frozen = tstep.partition_params({"vit": params}, tstep.default_trainable())
        assert train and all("btadapter" in p for p in train)
        y = tbt.btadapter_forward(params, x, cfg, num_frames=FRAMES)
        outs.append((y.detach(), torch.autograd.grad(y.square().sum(), list(train.values()))))
    _close(outs[1][0], outs[0][0])
    for a, b in zip(outs[1][1], outs[0][1]):
        _close(a, b, rtol=RTOL)


# ---------------------------------------------------------------------------
# the train step and the trainer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("accum_steps", [1, 2])
def test_three_train_steps_match_jax(jparams, accum_steps):
    """Loss sequence, grad_norm and every updated weight after three steps
    of AdamW with clipping (the clip is active: grad_norm > max_grad_norm)."""
    jcfg, tcfg = _cfgs()
    batches = _batches(3, 2 * accum_steps)
    policy = jstep.default_trainable(freeze_llm=False)
    kw = dict(learning_rate=1e-3, weight_decay=0.05, max_grad_norm=0.5)
    jopt = jstep.make_optimizer(**kw)
    jstate = jstep.create_train_state(jparams, jopt, policy)
    jfn = jax.jit(jstep.make_train_step(jcfg, jopt, accum_steps))

    params = load_jax_params(_np(jparams), "cpu")
    topt = tstep.make_optimizer(**kw)
    tstate = tstep.create_train_state(params, topt, tstep.default_trainable(freeze_llm=False))
    tfn = tstep.make_train_step(tcfg, topt, accum_steps)
    frozen_before = {k: v.clone() for k, v in tstate.frozen.items()}

    for i, batch in enumerate(batches):
        jstate, jm = jfn(jstate, _jb(batch))
        tstate, tm = tfn(tstate, _tb(batch))
        assert sorted(tm) == sorted(jm) == ["grad_norm", "loss", "loss_ce", "loss_mvm"]
        for k in jm:
            _close(tm[k], jm[k], rtol=RTOL, msg=f"{k} step {i}")
        assert float(tm["grad_norm"]) > kw["max_grad_norm"]
    assert tstate.step == int(jstate.step) == 3 and tstate.opt_state["count"] == 3
    want = _jpaths(jstate.params)
    assert set(want) == set(tstate.params)
    for path, p in tstate.params.items():
        _close(p, want[path], rtol=RTOL, msg=path)
        assert p.grad is None
    for path, p in tstate.frozen.items():
        assert torch.equal(p, frozen_before[path]), path
    # the state's two partitions carry across as one tree
    whole = dict(tstep.tree_paths(load_jax_partition(_np(jstate.params), _np(jstate.frozen),
                                                     "cpu")))
    assert set(whole) == set(tstate.params) | set(tstate.frozen)
    for path, p in tstate.frozen.items():
        assert torch.equal(whole[path], p), path


def test_unreached_leaf_gets_zero_gradient_and_decays():
    """A trainable leaf the loss does not reach has a zero gradient, as in
    the reference: only its weight decay moves it."""
    w = torch.ones(3, 3)
    tree = {"llama_proj": {"w": w.clone(), "unused": w.clone()}}
    opt = tstep.make_optimizer(0.1, weight_decay=0.5, max_grad_norm=None)
    state = tstep.create_train_state(tree, opt, lambda path: True)
    step = tstep.make_train_step(None, opt, loss_fn=lambda p, b, c: {
        "loss": (p["llama_proj"]["w"] * b["x"]).sum()})
    state, metrics = step(state, {"x": torch.full((3, 3), 2.0)})
    np.testing.assert_allclose(float(metrics["grad_norm"]), 6.0, rtol=1e-6)
    np.testing.assert_allclose(tree["llama_proj"]["unused"].detach().numpy(), 0.95, rtol=1e-6)
    assert float(tree["llama_proj"]["w"].detach().max()) < 0.95


def test_trainer_trains_and_writes_log(tmp_path, jparams):
    _, tcfg = _cfgs()
    model_cfg = {"freeze_LLM": False}
    model = tzoo.STLLM(tcfg, load_jax_params(_np(jparams), "cpu"), torch.device("cpu"), model_cfg)
    batches = _batches(4, 2)
    trainer = Trainer(model.cfg, model.params, output_dir=str(tmp_path), device="cpu",
                      trainable_fn=model.trainable_fn(), learning_rate=2e-3, log_freq=2)
    assert any(p.startswith("llama/") for p in trainer.state.params)
    assert not any(p.startswith("qformer") for p in trainer.state.params)
    fixed = _tb(batches[0])
    with torch.no_grad():
        before = float(tst.stllm_forward(model.params, fixed, tcfg)["loss"])
    evals = []
    avg = trainer.train(iter(batches), 4, eval_fn=lambda: evals.append(1) or float(len(evals)),
                        eval_freq=2)
    with torch.no_grad():
        after = float(tst.stllm_forward(model.params, fixed, tcfg)["loss"])
    assert after < before
    lines = [json.loads(line) for line in (tmp_path / "log.txt").read_text().splitlines()]
    steps = [rec for rec in lines if "loss" in rec]
    assert [rec["step"] for rec in steps] == [2, 4]
    assert all(np.isfinite(rec[k]) for rec in steps
               for k in ("loss", "loss_ce", "loss_mvm", "grad_norm"))
    assert [rec["eval_metric"] for rec in lines if "eval_metric" in rec] == [1.0, 2.0]
    assert json.loads((tmp_path / "best.json").read_text()) == {"step": 4, "metric": 2.0}
    assert set(avg) >= {"loss", "loss_ce", "loss_mvm", "grad_norm", "data_time"}
    assert trainer.state.step == 4
    with pytest.raises(NotImplementedError):
        trainer.resume_if_available()
    with pytest.raises(ValueError):
        Trainer(model.cfg, model.params, output_dir=str(tmp_path), device="meta")


def test_from_config_trainable_fn_and_dtype():
    cfg = {"arch": "st_llm_hf", "model_type": "instructblip_vicuna0_btadapter",
           "dtype": "bf16", "use_grad_checkpoint": True, "freeze_LLM": False, "freeze_vit": True,
           "mvm_decode": True, "use_mask": True, "btadapter_depth": 1,
           "vit": {"image_size": 28, "width": 32, "depth": 2, "heads": 2, "mlp_hidden": 64},
           "qformer": {"hidden": 32, "num_layers": 2, "heads": 2, "intermediate": 64,
                       "encoder_width": 32, "num_query": 4, "vocab_size": 50},
           "llama": {"vocab_size": 61, "hidden": 32, "num_layers": 1, "heads": 2,
                     "intermediate": 64}}
    model = tzoo.STLLM.from_config(cfg, seed=0, device="cpu")
    assert model.cfg.llama.remat and model.cfg.vit.remat
    assert model.params["llama"]["embed_tokens"].dtype == torch.bfloat16
    fn = model.trainable_fn()
    assert fn("llama/layers/0/q/w") and fn("vit/btadapter/cls") and fn("mvm_decoder/head/w")
    assert not fn("vit/blocks/0/fc1/w") and not fn("qformer/query_tokens")
    frozen = tzoo.STLLM.from_config({**cfg, "freeze_LLM": True, "dtype": "fp32"}, device="cpu")
    assert not frozen.trainable_fn()("llama/layers/0/q/w")
    assert frozen.params["llama"]["embed_tokens"].dtype == torch.float32
    assert dataclasses.replace(frozen.cfg.llama, remat=False) != frozen.cfg.llama
