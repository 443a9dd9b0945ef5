"""The port's 7B scale checks (stllm_tpu_torch/evidence/mem7b.py,
tp7b_check.py, tp7b_serve_check.py) against the JAX scripts they come from
(script/mem7b_v5e8.py, tp7b_check.py, tp7b_serve_check.py), on the CPU.

The JAX scripts compile against a TPU topology; the port runs one rank on
torch's fake process group. Held here: the port's spec of every leaf of the
7B ST-LLM trees (on meta tensors shaped by ``jax.eval_shape`` of the JAX
init) equals the JAX rule tables' ``PartitionSpec`` on the same mesh, for
the TP rules and for mem7b's FSDP rule; and at a tiny config each program's
counted collectives equal their derivation call for call and byte for byte,
and its document carries the JAX report's keys less the TPU-only ones
(``DROPPED``), plus the port's own (``ADDED``). The attention launches are
held on the card (chip_smoke.py's ``scale`` phase): the plain versions run
here."""

import ast
import concurrent.futures
import dataclasses
import importlib.util
from pathlib import Path

import jax
import pytest
import torch

from stllm_tpu.models import llama as jllama
from stllm_tpu.models import stllm as jst
from stllm_tpu.models import vit as jvit
from stllm_tpu.parallel import mesh as jmesh
from stllm_tpu.parallel import sharding as jsharding
from stllm_tpu.train.step import path_str
from stllm_tpu_torch.evidence import mem7b, tp7b_check, tp7b_serve_check
from stllm_tpu_torch.evidence._fake_group import collectives_match, fake_group
from stllm_tpu_torch.models.llama import LlamaConfig, init_llama, llama_forward
from stllm_tpu_torch.models.qformer import QFormerConfig
from stllm_tpu_torch.models.stllm import STLLMConfig
from stllm_tpu_torch.models.vit import ViTConfig
from stllm_tpu_torch.ops.spmd import model_parallel
from stllm_tpu_torch.parallel.collectives import record_collectives
from stllm_tpu_torch.parallel.mesh import MODEL_AXIS, by_path, make_mesh
from stllm_tpu_torch.parallel.sharding import (
    compute_tree, llama_tp_plan, shard_tree, stllm_param_shardings)

REPO = Path(__file__).resolve().parent.parent
SCRIPTS = {"mem7b": "mem7b_v5e8", "tp7b_check": "tp7b_check",
           "tp7b_serve_check": "tp7b_serve_check"}
# the JAX reports' keys that carry the TPU topology or XLA's memory analysis
DROPPED = {"mem7b": {"topology", "per_device", "hbm_per_chip_gib"},
           "tp7b_check": {"per_device_peak_gib", "fits_16gib"},
           "tp7b_serve_check": {"per_chip_peak_gib", "fits_16gib"}}
STAMP = {"device", "harness", "failed", "mesh", "card_memory_gib", "collectives_expected"}
ADDED = {"mem7b": STAMP | {"per_rank", "collectives", "launches", "launches_expected"},
         "tp7b_check": STAMP | {"tp_plan", "launches", "launches_expected", "per_rank_peak_gib",
                                "fits", "micro_batch"},
         "tp7b_serve_check": STAMP | {"per_rank_peak_gib", "fits", "tp_plan",
                                      "kv_heads_per_rank", "launches",
                                      "tp_reductions_per_layer"}}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _script(name):
    spec = importlib.util.spec_from_file_location(f"jax_scale_{name}",
                                                  REPO / "script" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _report_keys(name):
    """The keys of the document the JAX script's main writes: its dict
    literal and the string keys it assigns into that name afterwards."""
    tree = ast.parse((REPO / "script" / f"{name}.py").read_text())
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    keys, target = set(), "out" if name == "tp7b_serve_check" else "report"
    for node in ast.walk(main):
        if isinstance(node, ast.Assign):
            t = node.targets[0]
            if isinstance(t, ast.Name) and t.id == target and isinstance(node.value, ast.Dict):
                keys |= {k.value for k in node.value.keys}
            if (isinstance(t, ast.Subscript) and isinstance(t.value, ast.Name)
                    and t.value.id == target and isinstance(t.slice, ast.Constant)):
                keys.add(t.slice.value)
    return keys


def _meta(tree):
    """A JAX shape tree as meta tensors of the same shapes and dtypes, in
    the port's tree layout (the same dicts and lists)."""
    return jax.tree_util.tree_map(
        lambda s: torch.empty(s.shape, dtype=getattr(torch, str(s.dtype)), device="meta"), tree)


def _jax_specs(shardings):
    return {path_str(p): tuple(s.spec)
            for p, s in jax.tree_util.tree_flatten_with_path(shardings)[0]}


@pytest.fixture(scope="module")
def trees_7b():
    """The 7B trees of the two train checks, as JAX shapes (no array)."""
    out = {}
    for name, jcfg in (
            ("mem7b", jst.STLLMConfig(vit=dataclasses.replace(jvit.EVA_VIT_G, remat=True),
                                      llama=dataclasses.replace(jllama.VICUNA_7B, remat=True),
                                      vit_model="eva_btadapter_g", video_input="all",
                                      use_mask=True, mvm_decode=True, max_txt_len=256)),
            ("tp7b_check", jst.STLLMConfig(vit=dataclasses.replace(jvit.EVA_VIT_G, remat=True),
                                           llama=dataclasses.replace(jllama.VICUNA_7B,
                                                                     remat=True),
                                           video_input="all", use_mask=True,
                                           max_txt_len=256))):
        out[name] = jax.eval_shape(lambda k, c=jcfg: jst.init_stllm(k, c),
                                   jax.random.PRNGKey(0))
    return out


def test_tp_rules_at_7b_equal_jax(trees_7b):
    """(data 2, model 4), rank 5 of a fake group of 8: every leaf's spec of
    the 7B tree equals JAX's, and the seven LLaMA matmul families land
    'model' on the column- and row-parallel dims."""
    jparams = trees_7b["tp7b_check"]
    want = _jax_specs(jsharding.stllm_param_shardings(
        jmesh.make_mesh(2, 4, devices=jax.devices()[:8]), jparams, min_size=2 ** 14))
    meta = _meta(jparams)
    with fake_group(5, 8):
        mesh = make_mesh(2, 4)
        got = by_path(meta, stllm_param_shardings(mesh, meta, 2 ** 14))
    assert got == want
    checks = tp7b_check.rule_checks(got)
    assert checks == {f"{f}_{k}_parallel": True for f, k, _ in tp7b_check.FAMILIES}
    llama = {p: s for p, s in got.items() if p.startswith("llama/layers/")}
    assert len(llama) == 32 * 9


def test_mem7b_fsdp_rule_equals_the_script(trees_7b):
    """The state mem7b builds its step on, ``stllm_param_shardings`` at
    min_size 2**15 on a (data 8, model 1) mesh, equals the JAX script's own
    ``fsdp_state_shardings`` on the 7B MVM tree, leaf for leaf."""
    jmod = _script("mem7b_v5e8")
    jparams = trees_7b["mem7b"]
    want = _jax_specs(jmod.fsdp_state_shardings(
        jmesh.make_mesh(8, 1, devices=jax.devices()[:8]), jparams))
    meta = _meta(jparams)
    with fake_group(3, 8):
        mesh = make_mesh(8, 1)
        got = by_path(meta, stllm_param_shardings(mesh, meta, mem7b.MIN_SIZE))
    assert got == want
    assert sum(1 for s in got.values() if s) > 500


def _tiny_cfg(**top):
    ll = LlamaConfig(vocab_size=96, hidden=32, num_layers=2, heads=4, intermediate=64,
                     max_positions=256, dtype=torch.float32, remat=True)
    return STLLMConfig(
        vit=ViTConfig(image_size=28, patch_size=14, width=32, depth=2, heads=2, mlp_hidden=64,
                      dtype=torch.float32, remat=True),
        qformer=QFormerConfig(hidden=16, num_layers=1, heads=2, intermediate=32,
                              encoder_width=32, num_query=4, vocab_size=64,
                              dtype=torch.float32),
        llama=ll, video_input="all", use_mask=True, max_txt_len=160, **top)


def _held(name, doc):
    assert set(doc) == (_report_keys(SCRIPTS[name]) - DROPPED[name]) | ADDED[name]
    assert doc["failed"] == []


@pytest.mark.parametrize("accum", [1, 2])
def test_mem7b_tiny_step_collectives_match_derivation(accum):
    """Rank 3 of (data 8, model 1), the MVM step with the BTAdapter branch
    and the MVM decoder: one all-gather of the tree, the loss counts' and
    metrics' all-reduces, one reduce-scatter and one all-reduce of the
    gradients, as ``train_step_collectives`` derives them."""
    cfg = _tiny_cfg(vit_model="eva_btadapter_g", btadapter_depth=1, mvm_decode=True)
    r = mem7b.run(cfg, "cpu", rank=3, global_batch=32, frames=2, accum_steps=accum,
                  min_size=64)
    assert collectives_match(r["collectives"], r["collectives_expected"])
    assert r["collectives"]["recompute"] == {"calls": 0, "bytes": 0}
    assert r["collectives"]["all_gather"]["calls"] == 1
    assert r["collectives"]["reduce_scatter"]["calls"] == 1
    assert r["micro_batch"] == 32 // accum // 8 and r["seq_len"] == 168
    assert r["opt_state_bytes"] == 2 * r["trainable_params_bytes"]
    doc = mem7b.report(r, 32, accum, 2)
    doc.update(device="cpu", harness=mem7b.HARNESS)
    _held("mem7b", doc)
    assert doc["micro_batch_per_device"] == 32 // accum // 8


def test_tp7b_check_tiny_step_collectives_match_derivation():
    """Rank 5 of (data 2, model 4): the rule checks, a plan with the layers
    and the head tensor-parallel, and the step's all-gathers (the tree over
    'data' and over 'model', the logits), all-reduces (a layer's activations
    in the forward, the teacher, the recompute and the backward; the loss
    counts and metrics; the norm) and reduce-scatter, as derived."""
    r = tp7b_check.run(_tiny_cfg(), "cpu", rank=5, global_batch=4, frames=2, min_size=64)
    assert r["tp_plan"] == {"layers": True, "head": True}
    got, want = r["collectives"], r["collectives_expected"]
    assert collectives_match(got, want) and got == want
    # the recompute re-runs o's sum a layer, not down's
    assert got["recompute"]["calls"] == 2
    assert got["all_gather"]["calls"] == 3
    doc = tp7b_check.report(r, 4)
    doc.update(device="cpu", harness=tp7b_check.HARNESS)
    _held("tp7b_check", doc)
    assert doc["tp_rules_ok"] and doc["collectives_ok"]


@pytest.mark.parametrize("thread", ["forward", "other"])
def test_tp_layer_recompute_reruns_o_sum_on_any_thread(thread):
    """A tensor-parallel LLaMA under recompute, its backward run after the
    tensor-parallel context has closed, on the forward's thread or on
    another one (the autograd engine runs a CUDA backward on a device
    thread of its own, where the context is empty): the recompute re-enters the
    forward's context (``spmd.recompute_context``), so each layer's
    recompute re-runs o's sum over the model group, and not down's, which
    comes after the layer's last saved tensor (down's input). Without the
    forward's context the recompute ran without the group: no sum, and the
    backward got this rank's partial activations."""
    cfg = LlamaConfig(vocab_size=96, hidden=32, num_layers=2, heads=4, intermediate=64,
                      max_positions=64, dtype=torch.float32, remat=True)
    b, s = 2, 8
    with fake_group(1, 2):
        mesh = make_mesh(1, 2)
        params = init_llama(torch.Generator().manual_seed(0), cfg)
        specs = stllm_param_shardings(mesh, {"llama": params}, 64)["llama"]
        local = shard_tree(mesh, params, specs)
        plan = llama_tp_plan(mesh, local, specs, cfg.heads)
        assert plan.layers
        tree = torch.utils._pytree.tree_map(lambda t: t.detach().requires_grad_(),
                                            compute_tree(mesh, local, specs, plan))
        emb = torch.randn(b, s, cfg.hidden, generator=torch.Generator().manual_seed(1),
                          requires_grad=True)
        with record_collectives() as rec:
            with model_parallel(mesh.groups[MODEL_AXIS], plan):
                h, _ = llama_forward(tree, inputs_embeds=emb, cfg=cfg)
            loss = h.square().sum()
            if thread == "forward":
                loss.backward()
            else:
                with concurrent.futures.ThreadPoolExecutor(1) as pool:
                    pool.submit(loss.backward).result()
    act = b * s * cfg.hidden * 4
    layers = cfg.num_layers
    assert rec["recompute"] == {"calls": layers, "bytes": layers * act}
    # forward: o's and down's sums; backward: copy_to's in front of q|k|v and gate|up
    assert rec["all_reduce"] == {"calls": 4 * layers, "bytes": 4 * layers * act}
    assert emb.grad is not None and torch.isfinite(emb.grad).all()


def test_tp7b_serve_check_tiny_programs_match_derivation():
    """Rank 2 of (data 1, model 4): a cache of this rank's heads, two
    all-reduces a layer and one all-gather of the logits a forward, in the
    prefill and in each step of the decode chunk."""
    cfg = LlamaConfig(vocab_size=96, hidden=32, num_layers=2, heads=4, intermediate=64,
                      max_positions=64, dtype=torch.float32)
    r = tp7b_serve_check.run(cfg, "cpu", rank=2, prompt=16, new=8, chunk=4, min_size=64)
    for p in ("setup", "prefill", "decode_chunk"):
        assert collectives_match(r[p]["collectives"], r[p]["collectives_expected"]), p
        assert r[p]["collectives"]["recompute"]["calls"] == 0
    assert r["decode_chunk"]["collectives"]["all_reduce"]["calls"] == 2 * 2 * 4
    assert r["kv_heads_per_rank"] == 1 and r["tokens_shape"] == [1, 4]
    doc = tp7b_serve_check.report(r, cfg)
    doc.update(device="cpu", harness=tp7b_serve_check.HARNESS)
    _held("tp7b_serve_check", doc)
    assert doc["ok"] and doc["tp_reductions_ok"]
    assert doc["tp_reductions_per_layer"] == {"prefill": 2.0, "decode_chunk": 2.0}


def test_fake_group_refuses_a_second_group_and_closes():
    with fake_group(0, 2):
        with pytest.raises(RuntimeError, match="already initialized"):
            with fake_group(1, 2):
                pass
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_cli_help_and_no_card(monkeypatch, capsys, tmp_path, name):
    """Each program's --help names --cpu and --out-dir (evidence_out/); with
    no card and no --cpu, main returns 1 with a message before any work."""
    mod = {"mem7b": mem7b, "tp7b_check": tp7b_check, "tp7b_serve_check": tp7b_serve_check}[name]
    with pytest.raises(SystemExit) as e:
        mod.main(["--help"])
    assert e.value.code == 0
    out = capsys.readouterr().out
    assert f"python -m stllm_tpu_torch.evidence.{name}" in out
    assert "--cpu" in out and "evidence_out" in out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert mod.main(["--out-dir", str(tmp_path / "out")]) == 1
    assert "no CUDA device is available; pass --cpu" in capsys.readouterr().err
    assert not (tmp_path / "out").exists()
