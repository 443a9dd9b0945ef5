"""PyTorch port, LoRA (stllm_tpu_torch/models/lora.py and its hooks in
llama._qkv_proj, zoo.STLLM.from_config and the trainer's freezing policy)
against the JAX package on tiny fp32 configs. JAX trees come from the
init layout with numpy weights, the reference's own quantizers and
add_lora (with B made nonzero), and are converted with load_jax_params; the
same numpy inputs go through both.

The port's adapters come from a torch.Generator, so add_lora itself is held
to JAX's by structure (shapes, dtypes, alpha, B zero, A within the
kaiming-uniform bound) and by the identity at init. Tolerances: logits over
dense and int4 bases within 1e-4 absolute (a few fp32 ulps per op over the
layers); over the dynamic W8A8 base within 1e-3 mean relative error with
equal argmax (an activation code may round the other way, as in
tests/test_torch_models_int8.py); greedy tokens identical; train steps as
tests/test_torch_train.py holds them (1e-4 absolute plus 1e-3 relative;
over the weight-only int8 base, whose activations are rounded to bf16, each
factor's update within 1e-2 relative L2 of JAX's), frozen base leaves bit
for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stllm_tpu.models import generation as jgen
from stllm_tpu.models import llama as jllama
from stllm_tpu.models import lora as jlora
from stllm_tpu.models import zoo as jzoo
from stllm_tpu.train import step as jstep
from stllm_tpu_torch.convert.from_jax import load_jax_params
from stllm_tpu_torch.models import generation as tgen
from stllm_tpu_torch.models import llama as tllama
from stllm_tpu_torch.models import lora as tlora
from stllm_tpu_torch.models import zoo as tzoo
from stllm_tpu_torch.train import step as tstep

ATOL, RTOL, MEAN_REL = 1e-4, 1e-3, 1e-3
LL = dict(vocab_size=61, hidden=64, num_layers=2, heads=4, intermediate=172,
          max_positions=64)
JC, TC = jllama.LlamaConfig(dtype=jnp.float32, **LL), tllama.LlamaConfig(dtype=torch.float32, **LL)
BASES = ("dense", "int8", "int4", "fused")
TARGETS = {"dense": ("q", "v"), "int8": ("q", "v"), "int4": ("q", "v", "down"),
           "fused": ("q", "v")}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Tiny eager models: one intra-op thread, so parallel test processes
    do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(tree):
    return load_jax_params(_np(tree), device="cpu")


def _gen(cls, n):
    return cls(max_new_tokens=n, pad_to_multiple=8, eos_token_id=-1, stop_sequences=())


@pytest.fixture(scope="module")
def dense():
    """A dense LLaMA tree for JAX: the init's layout with numpy normal
    weights (JAX's eager init would compile an op per leaf shape)."""
    rng = np.random.default_rng(1)
    tree = tllama.init_llama(torch.Generator().manual_seed(0), TC)
    return jax.tree_util.tree_map(
        lambda t: jnp.asarray((rng.standard_normal(tuple(t.shape)) * 0.05).astype(np.float32)
                              + t.numpy()), tree)


@pytest.fixture(scope="module")
def bases(dense):
    """JAX's quantized trees of ``dense``, one each (the quantizers run
    eagerly: built once for the module)."""
    return {"dense": dense, "int8": jllama.quantize_llama_params(dense),
            "int4": jllama.quantize_llama_params_int4(dense, group=None),
            "fused": jllama.quantize_llama_params_int4(dense, group=None, fuse=True)}


def _with_b(jl, seed, scale=0.05):
    """JAX add_lora's tree with every B drawn nonzero."""
    rng = np.random.default_rng(seed)
    layers = []
    for layer in jl["layers"]:
        layer = dict(layer)
        for k in [k for k in layer if k.endswith("_lora")]:
            b = layer[k]["b"]
            layer[k] = {**layer[k], "b": jnp.asarray(rng.standard_normal(b.shape) * scale,
                                                     b.dtype)}
        layers.append(layer)
    return {**jl, "layers": layers}


def _prompt(seed):
    emb = (np.random.default_rng(seed).standard_normal((2, 8, 64)) * 0.3).astype(np.float32)
    mask = np.ones((2, 8), np.int32)
    mask[1, 5:] = 0
    return emb, mask


def _logits_pair(jl, tl, cfg_j=JC, cfg_t=TC):
    emb, mask = _prompt(2)
    want, _ = jgen._prefill(jl, jnp.asarray(emb), jnp.asarray(mask), cfg_j, 16)
    got, _ = tgen._prefill(tl, torch.from_numpy(emb), torch.from_numpy(mask), cfg_t, 16)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("kind", BASES)
def test_add_lora_structure_and_identity_at_init(bases, kind):
    """The port's add_lora over each base gives JAX's adapter shapes and
    dtypes (the true fan-in over K-pre-padded int4 storage, the split
    widths over the fused qkv, bf16 over quantized bases), B zero, A within
    sqrt(6 / d_in), alpha 32; at init the logits are the base's exactly."""
    base = bases[kind]
    targets = TARGETS[kind]
    jl = jlora.add_lora({"llama": base}, jax.random.PRNGKey(1), 4, targets=targets)["llama"]
    tbase = _t(base)
    tl = tlora.add_lora({"llama": tbase}, torch.Generator().manual_seed(1), 4,
                        targets=targets)["llama"]
    for jlay, tlay in zip(jl["layers"], tl["layers"]):
        assert sorted(k for k in tlay if k.endswith("_lora")) == sorted(f"{t}_lora"
                                                                        for t in targets)
        for t in targets:
            ja, ta = jlay[f"{t}_lora"], tlay[f"{t}_lora"]
            for leaf in ("a", "b"):
                assert tuple(ta[leaf].shape) == ja[leaf].shape, (t, leaf)
                assert str(ta[leaf].dtype).replace("torch.", "") == np.dtype(ja[leaf].dtype).name
            assert ta["alpha"].dim() == 0 and float(ta["alpha"]) == float(ja["alpha"]) == 32.0
            assert not ta["b"].any()
            # the bound, and one bf16 rounding step above it for bf16 factors
            bound = (6.0 / ta["a"].shape[0]) ** 0.5 * (1 + torch.finfo(ta["a"].dtype).eps)
            assert 0 < float(ta["a"].float().abs().max()) <= bound
            assert tlora.lora_scale(ta) == jlora.lora_scale(ja) == 8.0
    if kind == "int4":
        assert tl["layers"][0]["q_lora"]["a"].shape == (64, 4)
        assert tl["layers"][0]["down_lora"]["a"].shape == (172, 4)   # true K, not padded
    emb, mask = _prompt(2)
    got, _ = tgen._prefill(tl, torch.from_numpy(emb), torch.from_numpy(mask), TC, 16)
    plain, _ = tgen._prefill(tbase, torch.from_numpy(emb), torch.from_numpy(mask), TC, 16)
    assert torch.equal(got, plain)


@pytest.mark.parametrize("kind", BASES)
def test_lora_forward_matches_jax(bases, kind):
    """With B nonzero, prefill logits through the adapters (split outputs of
    the fused qkv included) equal JAX's; over the K-pre-padded int4 tree
    (adapters on q, v and down) greedy tokens too."""
    jl = _with_b(jlora.add_lora({"llama": bases[kind]}, jax.random.PRNGKey(1), 4,
                                targets=TARGETS[kind])["llama"], 3)
    tl = _t(jl)
    assert tl["layers"][0]["q_lora"]["alpha"].dim() == 0
    got, want = _logits_pair(jl, tl)
    emb, mask = _prompt(2)
    plain, _ = tgen._prefill(_t(bases[kind]), torch.from_numpy(emb), torch.from_numpy(mask),
                             TC, 16)
    assert np.abs(got - plain.numpy()).max() > 1e-3          # the adapters act
    if kind == "int8":
        assert np.abs(got - want).mean() / np.abs(want).mean() < MEAN_REL
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    else:
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    if kind == "int4":
        emb, _ = _prompt(4)
        want_tok = jgen.generate(jl, jnp.asarray(emb), llama_cfg=JC,
                                 gen=_gen(jgen.GenerationConfig, 6))
        got_tok = tgen.generate(tl, torch.from_numpy(emb), llama_cfg=TC,
                                gen=_gen(tgen.GenerationConfig, 6))
        assert got_tok == want_tok


def test_merge_lora_equals_adapter_forward_and_jax(dense):
    jl = _with_b(jlora.add_lora({"llama": dense}, jax.random.PRNGKey(1), 4)["llama"], 5)
    tl = _t(jl)
    merged = tlora.merge_lora({"llama": tl})["llama"]
    assert not any(k.endswith("_lora") for k in merged["layers"][0])
    assert "q_lora" in tl["layers"][0]       # the input tree keeps its adapters
    jm = jlora.merge_lora({"llama": jl})["llama"]
    for i in range(LL["num_layers"]):
        for t in ("q", "v"):
            np.testing.assert_allclose(merged["layers"][i][t]["w"].numpy(),
                                       np.asarray(jm["layers"][i][t]["w"]), atol=1e-6, rtol=0)
    with_adapters, _ = _logits_pair(jl, tl)
    emb, mask = _prompt(2)
    folded, _ = tgen._prefill(merged, torch.from_numpy(emb), torch.from_numpy(mask), TC, 16)
    np.testing.assert_allclose(folded.numpy(), with_adapters, atol=2e-5, rtol=2e-4)


def test_convert_peft_lora_matches_jax(dense):
    rng = np.random.default_rng(0)
    pre = "base_model.model.model.layers"
    state = {f"{pre}.0.self_attn.q_proj.lora_A.weight": rng.normal(size=(4, 64)).astype(np.float32),
             f"{pre}.0.self_attn.q_proj.lora_B.weight":
                 rng.normal(size=(64, 4)).astype(np.float32) * 0.1,
             f"{pre}.1.self_attn.v_proj.lora_A.weight": rng.normal(size=(4, 64)).astype(np.float32),
             f"{pre}.1.self_attn.v_proj.lora_B.weight":
                 rng.normal(size=(64, 4)).astype(np.float32) * 0.1,
             f"{pre}.1.self_attn.v_proj.weight": np.zeros((64, 64), np.float32)}
    jout = jlora.convert_peft_lora(state, {"llama": dense})["llama"]
    for src in (state, {k: torch.from_numpy(v) for k, v in state.items()}):
        tout = tlora.convert_peft_lora(src, {"llama": _t(dense)})["llama"]
        for i, t in ((0, "q"), (1, "v")):
            for leaf in ("a", "b", "alpha"):
                got = tout["layers"][i][f"{t}_lora"][leaf]
                want = np.asarray(jout["layers"][i][f"{t}_lora"][leaf])
                assert got.dtype == torch.float32
                np.testing.assert_array_equal(got.numpy(), want)
        assert "v_lora" not in tout["layers"][0] and "q_lora" not in tout["layers"][1]
        got, want = _logits_pair(jout, tout)
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def _zoo_cfg(**extra):
    return {"arch": "st_llm_hf", "model_type": "instructblip_vicuna0", "dtype": "fp32",
            "lora_r": 4, "lora_alpha": 16, "video_input": "residual", "residual_size": 2,
            "vit": {"image_size": 28, "patch_size": 14, "width": 32, "depth": 2, "heads": 2,
                    "mlp_hidden": 64, "use_flash": False},
            "qformer": {"hidden": 16, "num_layers": 2, "heads": 2, "intermediate": 32,
                        "encoder_width": 32, "num_query": 4, "vocab_size": 64},
            "llama": {"vocab_size": 97, "hidden": 32, "num_layers": 2, "heads": 2,
                      "intermediate": 64, "max_positions": 128}, **extra}


def _structure(tree, jax_side):
    if jax_side:
        return {jstep.path_str(p): (tuple(a.shape), np.dtype(a.dtype).name)
                for p, a in jax.tree_util.tree_flatten_with_path(tree)[0]}
    return {p: (tuple(t.shape), str(t.dtype).replace("torch.", ""))
            for p, t in tstep.tree_paths(tree)}


def test_from_config_lora_over_int8_matches_jax():
    """``lora_r`` with quant_int8 and the int8 KV cache in from_config gives
    JAX's tree (every path, shape and dtype: the adapters dense, added before
    the int8 conversion), the freezing policy trains only their factors in
    the LLaMA, and the converted JAX tree, B made nonzero, serves greedy
    tokens equal to JAX's."""
    extra = {"quant_int8": True, "llama": {**_zoo_cfg()["llama"], "kv_int8": True}}
    jm = jzoo.STLLM.from_config(_zoo_cfg(**extra))
    tm = tzoo.STLLM.from_config(_zoo_cfg(**extra), device="cpu")
    assert _structure(tm.params, False) == _structure(jm.params, True)
    layer = tm.params["llama"]["layers"][0]
    assert layer["q_lora"]["a"].dtype == torch.float32 and float(layer["q_lora"]["alpha"]) == 16
    assert "w_q" in layer["q"] and "w" not in layer["q"]
    train = {p for p, leaf in tstep.tree_paths(tm.params)
             if tm.trainable_fn()(p) and leaf.is_floating_point()}
    assert {p for p in train if p.startswith("llama/")} == {
        f"llama/layers/{i}/{t}_lora/{ab}" for i in range(2) for t in "qv" for ab in "ab"}
    jl = _with_b(jm.params["llama"], 7, scale=0.2)
    emb, _ = _prompt(6)
    emb = emb[..., :32]
    want = jgen.generate(jl, jnp.asarray(emb), llama_cfg=jm.cfg.llama,
                         gen=_gen(jgen.GenerationConfig, 6))
    got = tgen.generate(_t(jl), torch.from_numpy(emb), llama_cfg=tm.cfg.llama,
                        gen=_gen(tgen.GenerationConfig, 6))
    assert tm.cfg.llama.kv_int8 and got == want


def _lm_loss_j(params, batch, cfg):
    hidden, _ = jllama.llama_forward(params["llama"], input_ids=batch["ids"], cfg=JC)
    lp = jax.nn.log_softmax(jllama.lm_head(params["llama"], hidden)[:, :-1], -1)
    return {"loss": -jnp.take_along_axis(lp, batch["ids"][:, 1:, None], -1).mean()}


def _lm_loss_t(params, batch, cfg):
    hidden, _ = tllama.llama_forward(params["llama"], input_ids=batch["ids"], cfg=TC)
    lp = torch.log_softmax(tllama.lm_head(params["llama"], hidden)[:, :-1], -1)
    return {"loss": -torch.gather(lp, -1, batch["ids"][:, 1:, None].long()).mean()}


@pytest.mark.parametrize("base", ["dense", "w_q16"])
def test_lora_train_steps_match_jax(dense, base):
    """Two AdamW steps of a language-model loss under a frozen LLM, over the
    dense base and over the weight-only int8 base (QLoRA), from adapters
    with B nonzero: only the A and B factors train; losses, grad_norm and
    the updated factors equal JAX's; every base leaf and alpha stay bit for
    bit."""
    # B drawn nonzero (a trained adapter), so A takes a gradient from step 0
    jp = {"llama": _with_b(jlora.add_lora({"llama": dense}, jax.random.PRNGKey(2), 4)["llama"],
                           4)}
    if base == "w_q16":
        jp = {"llama": jllama.quantize_llama_params(jp["llama"], a16=True)}
        assert "w_q16" in jp["llama"]["layers"][0]["q"]
    kw = dict(learning_rate=1e-2, weight_decay=0.05, max_grad_norm=1.0)
    jopt = jstep.make_optimizer(**kw)
    jstate = jstep.create_train_state(jp, jopt, jstep.default_trainable())
    jfn = jax.jit(jstep.make_train_step(None, jopt, loss_fn=_lm_loss_j))
    tp = _t(jp)
    topt = tstep.make_optimizer(**kw)
    tstate = tstep.create_train_state(tp, topt, tstep.default_trainable())
    assert set(tstate.params) == {f"llama/layers/{i}/{t}_lora/{ab}"
                                  for i in range(2) for t in "qv" for ab in "ab"}
    frozen = {k: v.clone() for k, v in tstate.frozen.items()}
    init = {k: v.detach().clone().numpy() for k, v in tstate.params.items()}
    tfn = tstep.make_train_step(None, topt, loss_fn=_lm_loss_t)
    rng = np.random.default_rng(9)
    for i in range(2):
        ids = rng.integers(0, LL["vocab_size"], (2, 12)).astype(np.int32)
        jstate, jm = jfn(jstate, {"ids": jnp.asarray(ids)})
        tstate, tm = tfn(tstate, {"ids": torch.from_numpy(ids)})
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), atol=ATOL, rtol=RTOL,
                                       err_msg=f"{k} step {i}")
        assert float(tm["grad_norm"]) > 0
    want = {jstep.path_str(p): np.asarray(a)
            for p, a in jax.tree_util.tree_flatten_with_path(jstate.params)[0]}
    assert set(want) == set(tstate.params)
    for path, p in tstate.params.items():
        got = p.detach().numpy()
        if base == "dense":
            np.testing.assert_allclose(got, want[path], atol=ATOL, rtol=RTOL, err_msg=path)
            continue
        # the w_q16 base rounds its activations to bf16, where an fp32 sum in
        # another order can land a value one bf16 step away, and Adam's
        # first steps move an element by about lr times its gradient's sign:
        # each factor's update is held to JAX's within 1e-2 relative L2
        start = init[path]
        rel = np.linalg.norm((got - start) - (want[path] - start)) / np.linalg.norm(
            want[path] - start)
        assert rel <= 1e-2, (path, rel)
    assert tstate.params["llama/layers/0/q_lora/b"].abs().max() > 0
    for path, p in tstate.frozen.items():
        assert torch.equal(p, frozen[path]), path


def test_quantize_keeps_adapters_dense_and_unfused(dense):
    """Quantizing a tree with adapters leaves them dense, and the fusing
    rule keeps a layer with adapters unfused, as in the reference."""
    jl = jlora.add_lora({"llama": dense}, jax.random.PRNGKey(1), 4)["llama"]
    tl = _t(jl)
    for tq, jq in ((tllama.quantize_llama_params(tl), jllama.quantize_llama_params(jl)),
                   (tllama.quantize_llama_params_int4(tl, group=None, fuse=True),
                    jllama.quantize_llama_params_int4(jl, group=None, fuse=True))):
        assert _structure(tq, False) == _structure(jq, True)
        layer = tq["layers"][0]
        assert "qkv" not in layer and "q" in layer
        assert torch.equal(layer["q_lora"]["a"], tl["layers"][0]["q_lora"]["a"])
