"""PyTorch port, the multi-device layer in one process: the FSDP x TP spec
rules against the reference's ``NamedSharding.spec`` (JAX computes them
without compiling, on the 8-device CPU mesh of conftest.py), the batch
rule, the mesh's size check, and the dispatchers under a kernel mesh of two
shards: the reference declines a kernel whose global batch does not divide
over the shards (its shard_map needs that), the port launches it on the
rank's rows whatever the global batch. The ranks themselves run in
tests/test_torch_parallel_ranks.py."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stllm_tpu.models import llama as jllama
from stllm_tpu.models import qformer as jqf
from stllm_tpu.models import stllm as jst
from stllm_tpu.models import vit as jvit
from stllm_tpu.ops import attention as jattn
from stllm_tpu.ops import quant as jquant
from stllm_tpu.ops import spmd as jspmd
from stllm_tpu.parallel import mesh as jmesh
from stllm_tpu.parallel import sharding as jsharding
from stllm_tpu.train.step import path_str
from stllm_tpu_torch.dryrun import dryrun_multichip
from stllm_tpu_torch.models import llama as tllama
from stllm_tpu_torch.models import qformer as tqf
from stllm_tpu_torch.models import stllm as tst
from stllm_tpu_torch.models import vit as tvit
from stllm_tpu_torch.ops import attention as tattn
from stllm_tpu_torch.ops import kernels
from stllm_tpu_torch.ops import quant as tquant
from stllm_tpu_torch.ops import spmd as tspmd
from stllm_tpu_torch.parallel import mesh as tmesh
from stllm_tpu_torch.parallel.mesh import by_path
from stllm_tpu_torch.parallel import sharding as tsharding


MESHES = [(4, 2), (8, 1), (2, 4), (1, 8)]


def _shape_mesh(data: int, model: int) -> tmesh.Mesh:
    """A port mesh of the given shape for rules that read only its shape."""
    return tmesh.Mesh(data, model, 0, {tmesh.DATA_AXIS: None, tmesh.MODEL_AXIS: None}, None)


@pytest.fixture(scope="module")
def trees():
    """The tiny ST-LLM tree (BTAdapter branch, MVM decoder, residual
    module), JAX's and the port's."""
    cfg = jst.STLLMConfig(
        vit=jvit.ViTConfig(image_size=28, patch_size=14, width=32, depth=2, heads=2,
                           mlp_hidden=64, dtype=jnp.float32, use_flash=False),
        qformer=jqf.QFormerConfig(hidden=16, num_layers=2, heads=2, intermediate=32,
                                  encoder_width=32, num_query=4, vocab_size=64,
                                  dtype=jnp.float32),
        llama=jllama.LlamaConfig(vocab_size=96, hidden=32, num_layers=2, heads=2,
                                 intermediate=64, max_positions=64, dtype=jnp.float32),
        vit_model="eva_btadapter_g", btadapter_depth=1, video_input="residual",
        residual_size=2, mvm_decode=True)
    # the rules read shapes only: JAX's tree as shapes, the port's from its own init
    jparams = jax.eval_shape(lambda k: jst.init_stllm(k, cfg), jax.random.PRNGKey(0))
    tcfg = tst.STLLMConfig(
        vit=tvit.ViTConfig(**{f.name: getattr(cfg.vit, f.name) for f in
                              dataclasses.fields(cfg.vit) if f.name != "dtype"}),
        qformer=tqf.QFormerConfig(**{f.name: getattr(cfg.qformer, f.name) for f in
                                     dataclasses.fields(cfg.qformer) if f.name != "dtype"}),
        llama=tllama.LlamaConfig(**{f.name: getattr(cfg.llama, f.name) for f in
                                    dataclasses.fields(cfg.llama) if f.name != "dtype"}),
        vit_model="eva_btadapter_g", btadapter_depth=1, video_input="residual",
        residual_size=2, mvm_decode=True)
    tparams = tst.init_stllm(torch.Generator().manual_seed(0), tcfg)
    return jparams, tparams


@pytest.mark.parametrize("min_size", [64, 2 ** 14])
@pytest.mark.parametrize("shape", MESHES)
def test_param_specs_equal_jax(trees, shape, min_size):
    jparams, tparams = trees
    jm = jmesh.make_mesh(*shape, devices=jax.devices()[:8])
    want = {path_str(p): tuple(s.spec) for p, s in jax.tree_util.tree_flatten_with_path(
        jsharding.stllm_param_shardings(jm, jparams, min_size=min_size))[0]}
    got = by_path(tparams, tsharding.stllm_param_shardings(_shape_mesh(*shape), tparams,
                                                           min_size=min_size))
    assert got == want
    assert any(tmesh.MODEL_AXIS in s for s in got.values()) == (shape[1] > 1 and min_size == 64)


@pytest.mark.parametrize("shape", MESHES)
def test_fsdp_and_batch_specs_equal_jax(trees, shape):
    jparams, tparams = trees
    jm = jmesh.make_mesh(*shape, devices=jax.devices()[:8])
    want = {path_str(p): tuple(s.spec) for p, s in jax.tree_util.tree_flatten_with_path(
        jmesh.fsdp_param_sharding(jm, jparams, min_size=64))[0]}
    tm = _shape_mesh(*shape)
    got = by_path(tparams, tmesh.fsdp_param_sharding(tm, tparams, min_size=64))
    assert got == want
    assert tmesh.replicated(tm) == tuple(jmesh.replicated(jm).spec)
    assert tmesh.data_sharded(tm, 3) == tuple(jmesh.data_sharded(jm, 3).spec)


def test_tp_rules_hit_expected_paths():
    cases = {"llama/layers/0/q/w": 1, "llama/layers/31/down/w": 0, "vit/blocks/3/qkv/w": 1,
             "qformer/layers/1/attention/q/w": 1, "qformer/layers/0/intermediate_query/w": 1,
             "qformer/layers/0/output_query/dense/w": 0, "llama/layers/0/input_norm": None,
             "vit/btadapter/t_blocks/0/fc2/w": 0, "llama/lm_head/w": 1}
    for path, dim in cases.items():
        assert tsharding.tp_dim_for(path) == jsharding.tp_dim_for(path) == dim, path


@pytest.mark.parametrize("rows", [8, 6])
def test_batch_shardings_equal_jax(rows):
    batch = {"frames": np.zeros((rows, 2, 4, 4, 3), np.float32),
             "labels": np.zeros((rows, 5), np.int32), "step": np.zeros((), np.int32)}
    jm = jmesh.make_mesh(4, 2, devices=jax.devices()[:8])
    want = {k: tuple(s.spec) for k, s in jsharding.batch_shardings(jm, batch).items()}
    got = tsharding.batch_shardings(_shape_mesh(4, 2), batch)
    assert got == want
    assert (got["frames"][0] == tmesh.DATA_AXIS) == (rows % 4 == 0)
    local, split = tsharding.local_batch(_shape_mesh(4, 2), {k: torch.as_tensor(v)
                                                             for k, v in batch.items()
                                                             if v.ndim})
    assert split == (rows % 4 == 0)
    assert local["labels"].shape[0] == (rows // 4 if split else rows)


def test_make_mesh_larger_than_world_raises():
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 4"):
        tmesh.make_mesh(data=2, model=2)
    m = tmesh.make_mesh()
    assert m.shape == {"data": 1, "model": 1} and m.groups == {"data": None, "model": None}
    # the dry run takes the cards unless told "cpu", and needs one a rank
    with pytest.raises(RuntimeError, match="needs 4 cards"):
        dryrun_multichip(4)


def test_shard_tree_gathers_back_whole(trees):
    """One rank's slices at each grid position join into the whole leaf, and
    a column-major int8 leaf keeps its layout."""
    _, tparams = trees
    leaf = tparams["llama"]["layers"][0]["gate"]["w"]
    spec = (tmesh.MODEL_AXIS, tmesh.DATA_AXIS)
    parts = [[tmesh.local_slice(tmesh.Mesh(2, 4, i * 4 + j, {}, None), leaf, spec)
              for i in range(2)] for j in range(4)]
    whole = torch.cat([torch.cat(col, dim=1) for col in parts], dim=0)
    assert torch.equal(whole, leaf)
    w_q = torch.arange(64, dtype=torch.int8).reshape(8, 8).t().contiguous().t()
    part = tmesh.local_slice(tmesh.Mesh(2, 1, 1, {}, None), w_q, (tmesh.DATA_AXIS, None))
    assert part.stride(0) == 1 and torch.equal(part, w_q[4:])


# ---------------------------------------------------------------------------
# the dispatchers under a 2-shard kernel mesh: JAX's routes, counted around its
# kernels, against the port's, counted around the kernel wrappers of
# ops/kernels.py. The reference declines where the global batch does not
# divide over the shards; the port runs the kernel on the rank's rows
# ---------------------------------------------------------------------------


def _counting(module, name, counts, result=None):
    real = getattr(module, name)

    def wrapped(*args, **kw):
        counts[name] = counts.get(name, 0) + 1
        return real(*args, **kw) if result is None else result(*args, **kw)
    return wrapped


def _local_rows(rows: int, shards: int = 2) -> int:
    """A rank's rows of a global batch under ``shards`` shards (all of them
    where they do not divide: ``batch_shardings`` replicates the batch)."""
    return rows // shards if rows % shards == 0 else rows


@pytest.mark.parametrize("b,h", [(2, 2), (1, 1), (1, 2), (3, 1)])
def test_flash_clause_routes_as_jax(monkeypatch, b, h):
    """use_pallas=True under a 2-shard kernel mesh: JAX runs the flash
    kernels where the global folded batch B * H divides over the shards,
    else plain attention; the port runs them on the rank's rows always."""
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal((b, 16, h, 8)).astype(np.float32) for _ in range(3))
    jcount, tcount = {}, {}
    monkeypatch.setattr(jattn, "_flash_attention_core", _counting(
        jattn, "_flash_attention_core", jcount,
        lambda q, k, v, qm, km, causal, scale, *a: jattn.mha_reference(
            q, k, v, causal=causal, scale=scale)))
    jm = jmesh.make_mesh(2, 1, devices=jax.devices()[:2])
    with jspmd.kernel_sharding(jm):
        jax.eval_shape(lambda *t: jattn.flash_attention(*t, causal=True, use_pallas=True),
                       q, k, v)
    monkeypatch.setattr(kernels, "flash_attention_fwd", _counting(
        kernels, "flash_attention_fwd", tcount))
    rows = _local_rows(b)
    with tspmd.kernel_sharding(_shape_mesh(2, 1)):
        out = tattn.flash_attention(*(torch.from_numpy(t[:rows]) for t in (q, k, v)),
                                    causal=True, use_pallas=True)
    assert jcount.get("_flash_attention_core", 0) == int((b * h) % 2 == 0)
    assert tcount == {"flash_attention_fwd": 1} and out.shape == (rows, 16, h, 8)


@pytest.mark.parametrize("b", [2, 3])
def test_row_quant_clause_routes_as_jax(monkeypatch, b):
    """LayerNorm -> int8 under a 2-shard kernel mesh: JAX runs the fused
    kernel where the global batch divides over the shards, else the unfused
    composition; the port runs the fused kernel on the rank's rows always."""
    x = np.random.default_rng(1).standard_normal((b, 8, 32)).astype(np.float32)
    ln = {"scale": np.ones(32, np.float32), "bias": np.zeros(32, np.float32)}
    fused = []
    real = jquant._rowwise_pallas

    def spy(*args):
        out = real(*args)
        fused.append(out is not None)
        return out
    monkeypatch.setattr(jquant, "_rowwise_pallas", spy)
    jm = jmesh.make_mesh(2, 1, devices=jax.devices()[:2])
    with jspmd.kernel_sharding(jm):
        jax.eval_shape(lambda x: jquant.layer_norm_quant(ln, x, interpret=True), x)
    tcount = {}
    monkeypatch.setattr(kernels, "layer_norm_quant", _counting(kernels, "layer_norm_quant",
                                                               tcount))
    rows = _local_rows(b)
    with tspmd.kernel_sharding(_shape_mesh(2, 1)):
        tquant.layer_norm_quant({k: torch.from_numpy(v) for k, v in ln.items()},
                                torch.from_numpy(x[:rows]))
    assert fused == [b % 2 == 0]
    assert tcount == {"layer_norm_quant": 1}


def test_qmm_res_ln_declines_under_a_mesh(monkeypatch):
    """The fused s8 matmul + residual + LayerNorm: JAX declines it under any
    kernel mesh of more than one shard and runs it without one; the port
    runs it in both cases."""
    rng = np.random.default_rng(2)
    hq = rng.integers(-127, 128, (2, 8, 128)).astype(np.int8)
    w_q = rng.integers(-127, 128, (128, 128)).astype(np.int8)
    pq = {"w_q": w_q, "w_scale": np.full(128, 0.01, np.float32)}
    x_prev = rng.standard_normal((2, 8, 128)).astype(np.float32)
    ln = {"scale": np.ones(128, np.float32), "bias": np.zeros(128, np.float32)}

    def jax_route(mesh):
        with jspmd.kernel_sharding(mesh):
            return jax.eval_shape(lambda *a: jquant.quant_matmul_res_ln_static(
                a[0], 0.02, {**pq, "w_q": a[1]}, a[2], ln, 0.05), hq, w_q, x_prev) is not None

    tcount = {}
    monkeypatch.setattr(kernels, "qmm_res_ln", _counting(kernels, "qmm_res_ln", tcount))
    tq = {k: torch.from_numpy(v) for k, v in pq.items()}
    tln = {k: torch.from_numpy(v) for k, v in ln.items()}

    def port_route(mesh):
        with tspmd.kernel_sharding(mesh):
            return tquant.quant_matmul_res_ln_static(
                torch.from_numpy(hq), 0.02, tq, torch.from_numpy(x_prev), tln, 0.05) is not None

    assert jax_route(None) and port_route(None) and tcount == {"qmm_res_ln": 1}
    assert not jax_route(jmesh.make_mesh(2, 1, devices=jax.devices()[:2]))
    assert port_route(_shape_mesh(2, 1)) and tcount == {"qmm_res_ln": 2}


def test_spmd_context_nests_and_resets():
    assert tspmd.kernel_shard_count() == 1 and tspmd.batch_group() is None
    with tspmd.kernel_sharding(_shape_mesh(4, 2)):
        assert tspmd.kernel_shard_count() == 4
        with tspmd.kernel_sharding(_shape_mesh(2, 4)):
            assert tspmd.kernel_shard_count() == 2
        with tspmd.kernel_sharding(None):
            assert tspmd.kernel_shard_count() == 1 and tspmd.batch_group() is None
        assert tspmd.kernel_shard_count() == 4
    assert tspmd.kernel_shard_count() == 1
    x = torch.ones(3)
    assert tspmd.constrain_batched(x) is x and tspmd.shard_batched(torch.neg, x).sum() == -3
