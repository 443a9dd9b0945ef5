"""PyTorch port, the multi-device layer on four gloo ranks: one spawn for
the module (``stllm_tpu_torch.dryrun.start``), whose ranks run every check
of the port and send the results back; each test below compares one of them
with the reference, built in this process while the ranks run.

The ranks import this module by name, so JAX is imported only inside the
fixtures. The references are the unsharded JAX functions, which GSPMD
preserves on a mesh, except the ring attention, which is held to the JAX
ring on a 4-device mesh. Tolerances are fp32: 1e-5 on activations and
losses, 1e-4 on gradients, updated weights 1e-4 absolute plus 1e-3
relative, the sharded encode 2e-4 relative and 2e-5 absolute as the JAX
package's own test."""

import datetime
import json

import numpy as np
import pytest
import torch

from stllm_tpu_torch.dryrun import dryrun_rank, start

N = 4
RING = (2, 64, 2, 16)
LLAMA = dict(vocab_size=64, hidden=32, num_layers=1, heads=2, intermediate=64,
             max_positions=128)
VIT = dict(image_size=28, patch_size=14, width=32, depth=1, heads=2, mlp_hidden=64,
           use_flash=False)
QF = dict(hidden=16, num_layers=1, heads=2, intermediate=32, encoder_width=32, num_query=4,
          vocab_size=64)
STLLM = dict(video_input="residual", residual_size=2)
FRAMES, SEQ, MIN_SIZE = 4, 48, 64
TIMEOUT_S = 60.0
GEN = dict(max_new_tokens=12, eos_token_id=-1, stop_sequences=(), pad_to_multiple=8)
TRAIN_ARGS = ["--cfg-path", "config/tiny_debug.yaml", "--synthetic-data", "4", "--cpu",
              "--max-steps", "2"]


def _port_cfg():
    from stllm_tpu_torch.models.llama import LlamaConfig
    from stllm_tpu_torch.models.qformer import QFormerConfig
    from stllm_tpu_torch.models.stllm import STLLMConfig
    from stllm_tpu_torch.models.vit import ViTConfig

    return STLLMConfig(vit=ViTConfig(dtype=torch.float32, **VIT),
                       qformer=QFormerConfig(dtype=torch.float32, **QF),
                       llama=LlamaConfig(dtype=torch.float32, **LLAMA), **STLLM)


def _trainable():
    from stllm_tpu_torch.train.step import default_trainable

    return default_trainable(freeze_vit=False, freeze_qformer=False, freeze_llm=False)


def _tree(np_tree):
    from stllm_tpu_torch.parallel.mesh import map_tree

    return map_tree(lambda _, a: torch.tensor(a), np_tree)


def _np(tree):
    from stllm_tpu_torch.parallel.mesh import map_tree

    return map_tree(lambda _, t: t.detach().numpy().copy(), tree)


def _inputs(tmp) -> dict:
    """Seeded numpy inputs: the ranks and the references share them."""
    from stllm_tpu_torch.data.packing import pack_training_batch, sample_video_mask
    from stllm_tpu_torch.models.stllm import init_stllm

    rng = np.random.default_rng(0)
    cfg = _port_cfg()
    params = _np(init_stllm(torch.Generator().manual_seed(0), cfg))
    # noise on every leaf, so that zero-init leaves (biases, residual up) take part
    from stllm_tpu_torch.parallel.mesh import map_tree

    params = map_tree(lambda _, a: (a + rng.standard_normal(a.shape) * 0.02).astype(a.dtype),
                      params)
    rows = 4                                  # 2 micro-batches of 2 rows, 1 row a data rank
    v = cfg.num_video_tokens(FRAMES)
    keep = sample_video_mask(rng, rows, v)
    keep[1, :] = True                         # unequal kept MVM positions per rank
    batch = pack_training_batch(
        [[5, 6, 7]] * rows, [[8, 9]] * rows,
        [list(rng.integers(10, LLAMA["vocab_size"] - 1, n)) for n in (2, 9, 5, 1)],
        num_video=v, seq_len=SEQ, pad_id=0, keep=keep)
    batch["frames"] = rng.normal(size=(rows, FRAMES, 28, 28, 3)).astype(np.float32)
    batch["qformer_input_ids"] = rng.integers(0, QF["vocab_size"], (rows, 6)).astype(np.int32)
    batch["qformer_attention_mask"] = np.ones((rows, 6), np.int32)
    ring = {k: rng.standard_normal(RING).astype(np.float32) for k in ("q", "k", "v", "cot")}
    ring["mask"] = rng.integers(0, 2, RING[:2]).astype(np.int32)
    ring["mask"][:, 0] = 1
    cp_mask = np.ones((2, 64), np.int32)
    cp_mask[0, 50:] = 0
    cp_mask[1, 30:] = 0
    return {
        "params": params, "batch": batch, "ring": ring,
        "cp_embeds": (rng.normal(size=(2, 64, LLAMA["hidden"])) * 0.1).astype(np.float32),
        "cp_mask": cp_mask,
        "gen_embeds": (rng.normal(size=(1, 7, LLAMA["hidden"])) * 0.1).astype(np.float32),
        "frames": rng.integers(0, 256, (8, FRAMES, 28, 28, 3)).astype(np.uint8),
        "ids": rng.integers(0, QF["vocab_size"], (8, 5)).astype(np.int32),
        "ckpt_dir": str(tmp / "ckpt"), "train_dir": str(tmp / "train_dp"),
    }


# ---------------------------------------------------------------------------
# the ranks' side: no JAX here
# ---------------------------------------------------------------------------

def _rank_checks(rank: int, device, inp: dict) -> dict:
    from stllm_tpu_torch.models.generation import GenerationConfig, generate
    from stllm_tpu_torch.models.stllm import encode_img
    from stllm_tpu_torch.ops.ring_attention import ring_attention
    from stllm_tpu_torch.parallel import collectives as coll
    from stllm_tpu_torch.parallel.context import context_parallel_forward
    from stllm_tpu_torch.parallel.mesh import by_path, make_mesh
    from stllm_tpu_torch.parallel.sharding import (
        gather_tree, llama_tp_plan, local_batch, shard_tree, stllm_param_shardings)
    from stllm_tpu_torch.train.checkpoint import CheckpointManager
    from stllm_tpu_torch.train.step import create_train_state, make_optimizer, make_train_step

    out, ring = {}, {}
    cfg = _port_cfg()
    wait = datetime.timedelta(seconds=TIMEOUT_S)     # a dead rank fails the others
    line = make_mesh(data=N, model=1, timeout=wait)
    grid = make_mesh(data=2, model=2, timeout=wait)

    # the reference's GatherLayer: the backward sums over ranks, keeps the rank's rows
    x = torch.full((2, 3), float(rank + 1), requires_grad=True)
    y = coll.all_gather_with_grad(x, line.groups["data"])
    w = (rank + 1) * torch.arange(N * 6, dtype=torch.float32).reshape(N * 2, 3)
    (y * w).sum().backward()
    out["gather"] = {"y": y.detach().numpy(), "grad": x.grad.numpy(),
                     "psum": float(coll.psum_scalar(torch.tensor(rank + 1.0), line.world)),
                     "nograd": coll.concat_all_gather(x, line.groups["data"]).requires_grad}

    # ring attention over the 4 ranks, each holding 16 of the 64 positions
    r = inp["ring"]
    s = slice(rank * 16, (rank + 1) * 16)
    for name, causal, masked in (("plain", False, False), ("causal", True, False),
                                 ("masked", False, True)):
        q, k, v = (torch.tensor(r[n][:, s], requires_grad=True) for n in ("q", "k", "v"))
        o = ring_attention(q, k, v, group=line.groups["data"], causal=causal,
                           kv_mask=torch.tensor(r["mask"][:, s]) if masked else None)
        (o * torch.tensor(r["cot"][:, s])).sum().backward()
        ring[name] = [o.detach().numpy()] + [t.grad.numpy() for t in (q, k, v)]

    # the context-parallel forward and its gradients (whole on every rank)
    llama = _tree(inp["params"]["llama"])
    for p in by_path(llama, llama).values():
        p.requires_grad_(True)
    emb = torch.tensor(inp["cp_embeds"], requires_grad=True)
    h = context_parallel_forward(llama, emb, line, cfg.llama, axis_name="data")
    (h ** 2).sum().backward()
    grads = {k: p.grad.numpy() for k, p in by_path(llama, llama).items() if p.grad is not None}
    with torch.no_grad():
        hm = context_parallel_forward(llama, emb, line, cfg.llama, axis_name="data",
                                      attention_mask=torch.tensor(inp["cp_mask"]))
    out["cp"] = {"h": h.detach().numpy(), "h_masked": hm.numpy(), "grads": grads,
                 "d_emb": emb.grad.numpy()}

    # the FSDP x TP step on (2, 2), two micro-batches of one row a data rank
    opt = make_optimizer(1e-2)
    state = create_train_state(_tree(inp["params"]), opt, _trainable(), mesh=grid,
                               min_size=MIN_SIZE)
    plan = llama_tp_plan(grid, state.tree["llama"], state.specs["llama"], cfg.llama.heads)
    glob = {k: torch.as_tensor(v) for k, v in inp["batch"].items()}
    batch, split = local_batch(grid, glob, accum_steps=2)    # the rows the step takes
    step = make_train_step(cfg, opt, accum_steps=2, mesh=grid)
    state, metrics = step(state, glob)
    whole = gather_tree(grid, state.tree, state.specs)
    out["step"] = {"metrics": {k: float(v) for k, v in metrics.items()},
                   "params": {k: v.detach().numpy() for k, v in by_path(whole, whole).items()
                              if k in state.params},
                   "plan": tuple(plan), "split": split,
                   "labels": int((batch["labels"][:, 1:] != -100).sum()),
                   "kept": float(batch["mvm_weight"].sum()),
                   "sliced": sum(t.numel() for t in state.params.values())}

    # three rows do not split over 'data': every rank runs them whole
    rows3 = {k: torch.as_tensor(v[:3]) for k, v in inp["batch"].items()}
    lone = create_train_state(_tree(inp["params"]), opt, _trainable(), mesh=grid,
                              min_size=MIN_SIZE)
    _, split3 = local_batch(grid, rows3)
    lone, m3 = make_train_step(cfg, opt, mesh=grid)(lone, rows3)
    whole3 = gather_tree(grid, lone.tree, lone.specs)
    out["replicated"] = {"split": split3, "metrics": {k: float(v) for k, v in m3.items()},
                         "params": {k: v.detach().numpy() for k, v in
                                    by_path(whole3, whole3).items() if k in lone.params}}
    del lone

    # a checkpoint saved on (2, 2) restores onto (4, 1) bit for bit
    CheckpointManager(inp["ckpt_dir"], mesh=grid).save(state)
    other = create_train_state(_tree(inp["params"]), opt, _trainable(), mesh=line,
                               min_size=MIN_SIZE)
    CheckpointManager(inp["ckpt_dir"], mesh=line).restore(other)
    back = gather_tree(line, other.tree, other.specs)
    back = by_path(back, back)
    mu = {k: coll.gather_dim(v, None) for k, v in other.opt_state["mu"].items()}
    out["ckpt"] = {"params_equal": all(torch.equal(back[k].detach(), torch.tensor(
        out["step"]["params"][k])) for k in state.params),
        "count": other.opt_state["count"], "step": other.step, "mu_keys": sorted(mu)}

    # TP greedy decode on (2, 2): this rank's heads in the cache
    specs = stllm_param_shardings(grid, {"llama": llama}, min_size=MIN_SIZE)["llama"]
    local = shard_tree(grid, llama, specs)
    toks = generate(local, torch.tensor(inp["gen_embeds"]), llama_cfg=cfg.llama,
                    gen=GenerationConfig(**GEN), mesh=grid, specs=specs)
    out["generate"] = {"tokens": toks, "plan": tuple(llama_tp_plan(grid, local, specs, 2))}

    # the sharded encode, split (8 rows) and replicated (3 rows) over 'data'
    params = _tree(inp["params"])
    specs = stllm_param_shardings(grid, params, min_size=MIN_SIZE)
    local = shard_tree(grid, params, specs)
    ids = torch.tensor(inp["ids"])
    frames = torch.tensor(inp["frames"])
    with torch.no_grad():
        out["encode"] = [encode_img(local, frames[:b], cfg, ids[:b], torch.ones_like(ids[:b]),
                                    mesh=grid, specs=specs).numpy() for b in (8, 3)]

    # the train CLI on a (2, 2) mesh
    from stllm_tpu_torch.common.config import Config
    from stllm_tpu_torch.train import train as ttrain

    args = ttrain.parse_args(TRAIN_ARGS + ["--data-parallel", "2", "--model-parallel", "2"])
    ttrain.run(Config(args.cfg_path, options=_train_options(inp["train_dir"], 1)), args)
    out["dryrun"] = dryrun_rank(rank, device, N)
    if rank:      # the other ranks' shards of the ring, and what must equal rank 0's
        return {"ring": ring, "step": out["step"]["metrics"], "generate": toks,
                "cp_grads": grads}
    return {"ring": ring, **out}


def _train_options(out_dir: str, per_device: int):
    return [f"run.output_dir={out_dir}", "run.dataloader_num_workers=1",
            "run.logging_steps=1", f"run.per_device_train_batch_size={per_device}"]


# ---------------------------------------------------------------------------
# this process: start the ranks, build the references meanwhile
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    torch.set_num_threads(1)
    inp = _inputs(tmp_path_factory.mktemp("ranks"))
    wait = start(_rank_checks, N, inp, device="cpu", timeout_s=TIMEOUT_S)
    return inp, wait


@pytest.fixture(scope="module")
def compile_pool():
    """Each JAX reference is traced in this thread and compiled and run on
    one of these (XLA's compiler releases the interpreter), beside the ranks."""
    import concurrent.futures

    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        yield pool


def _later(pool, jax, fn, *args, post=lambda out: out):
    """A future of ``post(jit(fn)(*args))``: traced now, compiled on ``pool``."""
    lowered = jax.jit(fn).lower(*args)
    return pool.submit(lambda: post(lowered.compile()(*args)))


@pytest.fixture(scope="module")
def jax_side(setup):
    import jax
    import jax.numpy as jnp

    from stllm_tpu.models import llama as jllama
    from stllm_tpu.models import qformer as jqf
    from stllm_tpu.models import stllm as jst
    from stllm_tpu.models import vit as jvit

    inp, _ = setup
    jcfg = jst.STLLMConfig(vit=jvit.ViTConfig(dtype=jnp.float32, **VIT),
                           qformer=jqf.QFormerConfig(dtype=jnp.float32, **QF),
                           llama=jllama.LlamaConfig(dtype=jnp.float32, **LLAMA), **STLLM)
    params = jax.tree_util.tree_map(jnp.asarray, inp["params"])
    return jax, jnp, jcfg, params


@pytest.fixture(scope="module")
def ranks(setup, jax_ring, jax_step, jax_cp, jax_generate, jax_encode):
    """The ranks' results, waited for after every reference is built."""
    return setup[1]()


def _close(got, want, atol, rtol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=rtol)


def test_all_gather_with_grad_sums_over_ranks(ranks):
    g = ranks[0]["gather"]
    assert g["y"].tolist() == np.repeat(np.arange(1.0, N + 1), 2)[:, None].repeat(3, 1).tolist()
    # d/dx of sum_r (r + 1) * <y, arange>: 10 times rank 0's rows of arange
    _close(g["grad"], 10 * np.arange(6.0).reshape(2, 3), 0)
    assert g["psum"] == 10.0 and not g["nograd"]


@pytest.fixture(scope="module")
def jax_ring(setup, jax_side, compile_pool):
    import functools

    from jax.sharding import Mesh, PartitionSpec as P

    from stllm_tpu.ops.ring_attention import ring_attention

    jax, jnp, _, _ = jax_side
    r = setup[0]["ring"]
    mesh = Mesh(np.array(jax.devices()[:N]), ("sp",))

    def cases(q, k, v):
        """Each case's output and the gradients of its own loss, one program."""
        out = {}
        for name, causal, masked in (("plain", False, False), ("causal", True, False),
                                     ("masked", False, True)):
            fn = functools.partial(ring_attention, axis_name="sp", causal=causal)
            sharded = jax.shard_map(
                lambda q, k, v, m, fn=fn, masked=masked: fn(q, k, v,
                                                            kv_mask=m if masked else None),
                mesh=mesh, in_specs=(P(None, "sp"),) * 4, out_specs=P(None, "sp"))

            def loss(q, k, v, sharded=sharded):
                o = sharded(q, k, v, jnp.asarray(r["mask"]))
                return (o * r["cot"]).sum(), o

            (_, o), g = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(q, k, v)
            out[name] = [o, *g]
        return out

    return _later(compile_pool, jax, cases, r["q"], r["k"], r["v"])


@pytest.mark.parametrize("name", ["plain", "causal", "masked"])
def test_ring_attention_matches_jax_ring(ranks, jax_ring, name):
    want = jax_ring.result()[name]
    got = [np.concatenate([rk["ring"][name][i] for rk in ranks], axis=1) for i in range(4)]
    _close(got[0], want[0], 1e-5)
    for g, w in zip(got[1:], want[1:]):
        _close(g, w, 1e-4)


@pytest.fixture(scope="module")
def jax_cp(setup, jax_side, compile_pool):
    from stllm_tpu.models.llama import llama_forward
    from stllm_tpu.train.step import path_str

    jax, jnp, jcfg, params = jax_side
    inp = setup[0]

    def both(p, e, m):
        def loss(p, e):
            h, _ = llama_forward(p, inputs_embeds=e, cfg=jcfg.llama)
            return (h ** 2).sum(), h

        (_, h), grads = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(p, e)
        hm, _ = llama_forward(p, inputs_embeds=e, attention_mask=m, cfg=jcfg.llama)
        return h, hm, grads

    def post(out):
        h, hm, (gp, ge) = out
        return np.asarray(h), np.asarray(hm), np.asarray(ge), {
            path_str(p): np.asarray(g) for p, g in jax.tree_util.tree_flatten_with_path(gp)[0]}

    return _later(compile_pool, jax, both, params["llama"], jnp.asarray(inp["cp_embeds"]),
                  jnp.asarray(inp["cp_mask"]), post=post)


def test_context_parallel_forward_and_gradients_match_jax(setup, jax_cp, ranks):
    h, hm, ge, want = jax_cp.result()
    cp = ranks[0]["cp"]
    _close(cp["h"], h, 1e-5)
    valid = setup[0]["cp_mask"].astype(bool)
    _close(cp["h_masked"][valid], hm[valid], 1e-5)
    _close(cp["d_emb"], ge, 1e-4)
    assert set(cp["grads"]) == {k for k in want if not k.startswith(("embed_tokens", "lm_head"))}
    for k, g in cp["grads"].items():
        _close(g, want[k], 1e-4)
        for other in ranks[1:]:
            assert np.array_equal(other["cp_grads"][k], g), k


@pytest.fixture(scope="module")
def jax_step(setup, jax_side, compile_pool):
    from stllm_tpu.train import step as jstep

    jax, jnp, jcfg, params = jax_side
    opt = jstep.make_optimizer(1e-2)
    state = jstep.create_train_state(params, opt, jstep.default_trainable(
        freeze_vit=False, freeze_qformer=False, freeze_llm=False))
    batch = {k: jnp.asarray(v) for k, v in setup[0]["batch"].items()}

    def post(out):
        state, metrics = out
        return ({k: float(v) for k, v in metrics.items()},
                {jstep.path_str(p): np.asarray(a) for p, a in
                 jax.tree_util.tree_flatten_with_path(state.params)[0]})

    return _later(compile_pool, jax, jstep.make_train_step(jcfg, opt, accum_steps=2), state,
                  batch, post=post)


def test_sharded_train_step_matches_jax(setup, jax_step, ranks):
    """FSDP x TP on (2, 2) with two micro-batches: the data ranks hold
    unequal label and kept-MVM counts, yet the losses are the global means."""
    want_m, want_p = jax_step.result()
    got = ranks[0]["step"]
    assert got["plan"] == (True, True) and got["split"]
    assert got["sliced"] < sum(a.size for a in want_p.values())
    labels = [int((m[:, 1:] != -100).sum()) for m in setup[0]["batch"]["labels"][:, None]]
    assert len(set(labels[0::2])) == 2 and got["labels"] == labels[0] + labels[2]
    assert got["kept"] != float(setup[0]["batch"]["mvm_weight"].sum()) / 2
    for k in ("loss", "loss_ce", "loss_mvm"):
        _close(got["metrics"][k], want_m[k], 1e-5)
    _close(got["metrics"]["grad_norm"], want_m["grad_norm"], 1e-4, 1e-4)
    assert set(got["params"]) == set(want_p)
    for k, w in want_p.items():
        _close(got["params"][k], w, 1e-4, 1e-3)
    for other in ranks[1:]:
        assert other["step"] == got["metrics"]


def test_replicated_batch_step_matches_one_device(setup, ranks):
    """A batch whose rows do not divide over 'data' runs whole on every rank
    (the reference replicates it) and gives the one-device step."""
    from stllm_tpu_torch.train.step import create_train_state, make_optimizer, make_train_step

    opt = make_optimizer(1e-2)
    state = create_train_state(_tree(setup[0]["params"]), opt, _trainable())
    state, metrics = make_train_step(_port_cfg(), opt)(
        state, {k: torch.as_tensor(v[:3]) for k, v in setup[0]["batch"].items()})
    got = ranks[0]["replicated"]
    assert not got["split"]
    for k, v in metrics.items():
        _close(got["metrics"][k], float(v), 1e-5, 1e-5)
    for k, p in state.params.items():
        _close(got["params"][k], p.detach().numpy(), 1e-4, 1e-3)


def test_checkpoint_from_2x2_restores_on_4x1_and_one_device(setup, ranks):
    from stllm_tpu_torch.train.checkpoint import CheckpointManager
    from stllm_tpu_torch.train.step import create_train_state, make_optimizer

    ck = ranks[0]["ckpt"]
    assert ck["params_equal"] and ck["count"] == 1 and ck["step"] == 1
    state = create_train_state(_tree(setup[0]["params"]), make_optimizer(1e-2), _trainable())
    CheckpointManager(setup[0]["ckpt_dir"]).restore(state)
    saved = ranks[0]["step"]["params"]
    assert state.step == 1 and set(saved) == set(state.params)
    for k, p in state.params.items():
        assert np.array_equal(p.detach().numpy(), saved[k]), k


@pytest.fixture(scope="module")
def jax_generate(setup, jax_side):
    from stllm_tpu.models.generation import GenerationConfig, generate

    jax, jnp, jcfg, params = jax_side
    return generate(params["llama"], jnp.asarray(setup[0]["gen_embeds"]), llama_cfg=jcfg.llama,
                    gen=GenerationConfig(**GEN))


def test_tp_greedy_decode_matches_jax(jax_generate, ranks):
    got = ranks[0]["generate"]
    assert got["plan"] == (True, True)
    assert got["tokens"] == jax_generate and all(r["generate"] == jax_generate
                                                  for r in ranks[1:])


@pytest.fixture(scope="module")
def jax_encode(setup, jax_side, compile_pool):
    from stllm_tpu.models.stllm import encode_img

    jax, jnp, jcfg, params = jax_side
    inp = setup[0]
    return _later(compile_pool, jax, lambda p, f, i: encode_img(p, f, jcfg, i, jnp.ones_like(i)),
                  params, jnp.asarray(inp["frames"]), jnp.asarray(inp["ids"]), post=np.asarray)


def test_sharded_encode_matches_single_device(jax_encode, ranks):
    jax_encode = jax_encode.result()
    split, replicated = ranks[0]["encode"]
    _close(split, jax_encode, 2e-5, 2e-4)
    _close(replicated, jax_encode[:3], 2e-5, 2e-4)


def test_train_cli_on_a_mesh_matches_one_device(setup, ranks, tmp_path):
    """--data-parallel 2 --model-parallel 2 on four ranks against one device
    fed the same global batches (per-device batch times the data axis)."""
    from stllm_tpu_torch.common.config import Config
    from stllm_tpu_torch.train import train as ttrain

    args = ttrain.parse_args(TRAIN_ARGS)
    ttrain.run(Config(args.cfg_path, options=_train_options(str(tmp_path), 2)), args)

    def losses(d):
        return [json.loads(x)["loss"] for x in (d / "log.txt").read_text().splitlines()]

    import pathlib

    got, want = losses(pathlib.Path(setup[0]["train_dir"])), losses(tmp_path)
    assert len(got) == len(want) == 2
    _close(got, want, 1e-5)


def test_dryrun_multichip_on_four_cpu_ranks(ranks):
    d = ranks[0]["dryrun"]
    assert d["mesh"] == {"data": 2, "model": 2} and np.isfinite(d["loss"])
    assert d["cp_err"] < 1e-3 and d["line"].startswith("dryrun_multichip(4): ")
