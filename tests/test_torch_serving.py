"""PyTorch port, the whole slice (stllm_tpu_torch): the video-QA server
against the JAX one on a tiny fp32 BTAdapter config with the packed-qkv
attention path (``use_flash=None``), build_stllm_config against the JAX one
on the reference QA YAML, the batcher's host edge cases, and the package
boundary (no JAX, no stllm_tpu, CUDA unless asked)."""

import ast
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stllm_tpu.common.config import Config as JConfig
from stllm_tpu.models import zoo as jzoo
from stllm_tpu.models.generation import GenerationConfig as JGen
from stllm_tpu.models.llama import LlamaConfig as JLlama
from stllm_tpu.models.qformer import QFormerConfig as JQF
from stllm_tpu.models.stllm import STLLMConfig as JST, init_stllm as jinit
from stllm_tpu.models.vit import ViTConfig as JViT
from stllm_tpu.pipeline_serving import VideoQAServer as JServer
from stllm_tpu.serving import ContinuousBatcher as JBatcher
from stllm_tpu_torch.common.config import Config as TConfig
from stllm_tpu_torch.convert.from_jax import load_jax_params
from stllm_tpu_torch.models import zoo as tzoo
from stllm_tpu_torch.models.generation import GenerationConfig as TGen, UnsupportedRequest
from stllm_tpu_torch.models.llama import LlamaConfig as TLlama
from stllm_tpu_torch.models.qformer import QFormerConfig as TQF
from stllm_tpu_torch.models.stllm import STLLMConfig as TST
from stllm_tpu_torch.models.vit import ViTConfig as TViT
from stllm_tpu_torch.pipeline_serving import VideoQAServer as TServer
from stllm_tpu_torch.serving import ContinuousBatcher as TBatcher


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Tiny eager models: one intra-op thread, so parallel test processes
    do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


REPO = Path(__file__).resolve().parent.parent
QA_YAML = REPO / "config" / "instructblipbase_stllm_qa.yaml"

VIT = dict(image_size=28, patch_size=14, width=64, depth=3, heads=4, mlp_hidden=128,
           use_flash=None)
QF = dict(hidden=32, num_layers=2, heads=4, intermediate=64, encoder_width=64,
          num_query=4, vocab_size=128)
LL = dict(vocab_size=97, hidden=64, num_layers=2, heads=4, intermediate=128,
          max_positions=256)
TOP = dict(video_input="all", vit_model="eva_btadapter_g", btadapter_depth=2)
JCFG = JST(vit=JViT(dtype=jnp.float32, **VIT), qformer=JQF(dtype=jnp.float32, **QF),
           llama=JLlama(dtype=jnp.float32, **LL), **TOP)
TCFG = TST(vit=TViT(dtype=torch.float32, **VIT), qformer=TQF(dtype=torch.float32, **QF),
           llama=TLlama(dtype=torch.float32, **LL), **TOP)


def _params(seed):
    jp = jinit(jax.random.PRNGKey(seed), JCFG)
    rng = np.random.default_rng(seed)
    # zero-init leaves (temporal_fc, biases) get values so the branch counts
    jp = jax.tree_util.tree_map(
        lambda a: a + jnp.asarray(rng.standard_normal(a.shape) * 0.02, a.dtype), jp)
    return jp, load_jax_params(jax.tree_util.tree_map(np.asarray, jp), device="cpu")


def _gen(cls, n, **kw):
    return cls(max_new_tokens=n, pad_to_multiple=8, **{"eos_token_id": -1,
                                                      "stop_sequences": (), **kw})


def test_video_qa_server_matches_jax_server():
    """5 requests over 2 slots with mixed prompt lengths and budgets (slot
    reuse, several pad buckets): greedy tokens identical to the JAX server."""
    jp, tp = _params(0)
    rng = np.random.default_rng(0)
    reqs = []
    for i, (npre, nsuf, n) in enumerate([(5, 3, 9), (7, 2, 3), (5, 4, 12), (3, 3, 5), (6, 3, 7)]):
        reqs.append((f"r{i}", rng.integers(0, 256, (1, 4, 28, 28, 3)).astype(np.uint8),
                     rng.integers(0, 97, (1, npre)), rng.integers(0, 97, (1, nsuf)), n))
    q = rng.integers(0, 128, (1, 6))
    js = JServer(jp, JCFG, slots=2, max_len=128, chunk=4)
    ts = TServer(tp, TCFG, slots=2, max_len=128, chunk=4)
    for rid, fr, pre, suf, n in reqs:
        js.submit(rid, jnp.asarray(fr), pre, suf, _gen(JGen, n), qformer_text_ids=q)
        ts.submit(rid, fr, pre, suf, _gen(TGen, n), qformer_text_ids=q)
    want, got = js.run(), ts.run()
    assert set(got) == {r[0] for r in reqs}
    assert got == want
    assert [len(got[r[0]]) for r in reqs] == [r[4] for r in reqs]


def test_batcher_idle_rows_past_max_len_and_stops_match_jax():
    """An idle slot keeps advancing by ``chunk`` past max_len and past the
    RoPE table while the other slot decodes: the port clamps its cache writes
    and position gathers as JAX does, and stop sequences cut the same way."""
    jp, tp = _params(1)
    jc = JLlama(dtype=jnp.float32, **{**LL, "max_positions": 40})
    tc = TLlama(dtype=torch.float32, **{**LL, "max_positions": 40})
    emb = np.random.default_rng(2).standard_normal((1, 6, 64)).astype(np.float32) * 0.3
    gens = [dict(n=40), dict(n=30, stop_sequences=((5,), (11, 12)), eos_token_id=3)]
    jb = JBatcher(jp["llama"], jc, slots=2, max_len=48, chunk=8)
    tb = TBatcher(tp["llama"], tc, slots=2, max_len=48, chunk=8)
    for i, g in enumerate(gens):
        n = g.pop("n")
        jb.submit(i, jnp.asarray(emb * (i + 1)), _gen(JGen, n, **g))
        tb.submit(i, torch.from_numpy(emb * (i + 1)), _gen(TGen, n, **g))
    want, got = jb.run(), tb.run()
    assert got == want
    assert len(got[0]) == 40


def test_build_stllm_config_matches_jax_on_qa_yaml():
    """The port loads the reference QA YAML unmodified and builds the same
    config, field by field (dtypes compared by name)."""
    jm, tm = JConfig(QA_YAML).model_cfg, TConfig(QA_YAML).model_cfg
    assert dict(tm) == dict(jm)
    jc, tc = jzoo.build_stllm_config(jm), tzoo.build_stllm_config(tm)

    def fields(c):
        out = {}
        for f in dataclasses.fields(c):
            v = getattr(c, f.name)
            if dataclasses.is_dataclass(v):
                out[f.name] = fields(v)
            elif f.name == "dtype":
                out[f.name] = str(getattr(v, "__name__", v)).replace("torch.", "")
            else:
                out[f.name] = v
        return out

    assert fields(tc) == fields(jc)
    assert tc.vit_model == "eva_btadapter_g" and tc.video_input == "all"
    assert tc.vit.width == 1408 and tc.llama.hidden == 4096 and tc.llama.dtype == torch.bfloat16


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_stllm_tpu():
    files = sorted((REPO / "stllm_tpu_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py", REPO / "script" / "profile_torch_slice.py",
        REPO / "script" / "gloo_cuda_check.py"]
    assert len(files) > 15
    names = {str(f.relative_to(REPO / "stllm_tpu_torch")) for f in files[:-3]}
    assert {"train/step.py", "train/trainer.py", "data/packing.py", "data/collate.py",
            "common/optim.py", "common/logging.py", "ops/tome.py", "models/speculative.py",
            "models/h2o.py", "serving.py", "pipeline_serving.py", "demo_core.py", "demo.py",
            "demo_web.py", "demo_gradio.py", "train/checkpoint.py", "train/train.py",
            "models/lora.py", "models/distill.py", "data/datasets.py", "data/loaders.py",
            "data/instruction_data.py", "convert/from_torch.py", "convert/to_reference.py",
            "models/__init__.py", "tasks/__init__.py", "tasks/base_task.py",
            "tasks/video_text_it.py", "runners/__init__.py", "runners/runner_base.py",
            "data/builders.py", "data/wds.py", "data/randaugment.py",
            "data/samplers_grouped.py", "data/synth.py", "common/gradcam.py",
            "common/io_utils.py", "common/registry.py", "common/config.py",
            "parallel/mesh.py", "parallel/sharding.py", "parallel/collectives.py",
            "parallel/context.py", "ops/ring_attention.py", "ops/spmd.py", "dryrun.py",
            "models/generation.py", "models/stllm.py", "models/llama.py",
            "models/qformer.py", "ops/attention.py", "ops/quant.py"} <= names
    bad = [(str(f.relative_to(REPO)), m) for f in files for m in _imports(f)
           if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "stllm_tpu")]
    assert not bad, bad


def _tiny_model_cfg(**extra):
    return {"arch": "st_llm_hf", "model_type": "instructblip_vicuna0_btadapter",
            "video_input": "all", "dtype": "fp32", "btadapter_depth": 1,
            "vit": {"image_size": 28, "width": 32, "depth": 2, "heads": 2, "mlp_hidden": 64},
            "qformer": {"hidden": 16, "num_layers": 2, "heads": 2, "intermediate": 32,
                        "encoder_width": 32, "num_query": 4, "vocab_size": 64},
            "llama": {"vocab_size": 97, "hidden": 32, "num_layers": 2, "heads": 2,
                      "intermediate": 64}, **extra}


def test_from_config_without_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tzoo.STLLM.from_config(_tiny_model_cfg(), seed=0)
    with pytest.raises(RuntimeError):
        load_jax_params({"w": np.zeros(2)})


@pytest.mark.parametrize("quant_int8", [False, True])
def test_from_config_kv_int8_serves_a_request(quant_int8):
    """``llama: {kv_int8: true}`` builds, with and without quant_int8, and
    the server runs on the int8 cache."""
    cfg = _tiny_model_cfg(quant_int8=quant_int8,
                          llama={**_tiny_model_cfg()["llama"], "kv_int8": True})
    model = tzoo.STLLM.from_config(cfg, seed=3, device="cpu")
    assert model.cfg.llama.kv_int8
    srv = TServer(model.params, model.cfg, slots=2, max_len=64, chunk=4)
    assert srv.batcher.cache.k[0].dtype == torch.int8 and srv.batcher.cache.k_scale is not None
    frames = np.random.default_rng(4).integers(0, 256, (1, 2, 28, 28, 3)).astype(np.uint8)
    srv.submit("a", frames, [[5, 6, 7]], [[8, 9]], _gen(TGen, 6), qformer_text_ids=[[1, 2, 3]])
    out = srv.run()
    assert len(out["a"]) == 6 and all(0 <= t < 97 for t in out["a"])


def test_from_config_on_cpu_serves_a_request():
    model = tzoo.STLLM.from_config(_tiny_model_cfg(), seed=3, device="cpu")
    assert model.device.type == "cpu"
    assert model.params["llama"]["embed_tokens"].dtype == torch.float32
    srv = TServer(model.params, model.cfg, slots=2, max_len=64, chunk=4)
    frames = np.random.default_rng(4).integers(0, 256, (1, 2, 28, 28, 3)).astype(np.uint8)
    srv.submit("a", frames, [[5, 6, 7]], [[8, 9]], _gen(TGen, 6), qformer_text_ids=[[1, 2, 3]])
    out = srv.run()
    assert len(out["a"]) == 6 and all(0 <= t < 97 for t in out["a"])
    tok = tzoo.ToyHashTokenizer(model.cfg.llama.vocab_size)
    ids = tok.encode("video question")
    assert all(10 <= t < 97 for t in ids) and tok.decode(ids) == "video question"


@pytest.mark.parametrize("kv_int8", [False, True])
def test_served_tokens_unchanged_when_params_require_grad(kv_int8):
    """Serving runs under no_grad: with every float parameter flagged for
    gradients (a trainer's tree) the server writes its KV cache in place,
    records no graph and answers with the same tokens."""
    cfg = _tiny_model_cfg(llama={**_tiny_model_cfg()["llama"], "kv_int8": kv_int8})
    frames = np.random.default_rng(4).integers(0, 256, (1, 2, 28, 28, 3)).astype(np.uint8)
    answers = []
    for flagged in (False, True):
        model = tzoo.STLLM.from_config(cfg, seed=3, device="cpu")
        if flagged:
            from stllm_tpu_torch.train.step import partition_params
            train, _ = partition_params(model.params, lambda path: True)
            assert train and all(p.requires_grad for p in train.values())
        srv = TServer(model.params, model.cfg, slots=2, max_len=64, chunk=4)
        for rid in ("a", "b", "c"):
            srv.submit(rid, frames, [[5, 6, 7]], [[8, 9]], _gen(TGen, 6),
                       qformer_text_ids=[[1, 2, 3]])
        answers.append(srv.run())
        assert not srv.batcher.cache.k[0].requires_grad
    assert answers[0] == answers[1] and sorted(answers[0]) == ["a", "b", "c"]


def test_calibration_runs_without_a_graph_on_flagged_params():
    from stllm_tpu_torch.models.btadapter import calibrate_btadapter_scales
    from stllm_tpu_torch.train.step import partition_params
    model = tzoo.STLLM.from_config(_tiny_model_cfg(quant_int8=True), seed=3, device="cpu")
    partition_params(model.params, lambda path: True)
    frames = torch.from_numpy(
        np.random.default_rng(4).integers(0, 256, (2, 28, 28, 3)).astype(np.uint8))
    vit = calibrate_btadapter_scales(model.params["vit"], frames, model.cfg.vit, 2)
    scales = [v for blk in vit["blocks"] for v in blk["act_scales"].values()]
    assert scales and not any(v.requires_grad for v in scales)


@pytest.mark.parametrize("case", ["penalty", "min_length", "beams", "top_p", "spec_sample",
                                  "spec_prefix", "t_mild", "overlong", "weights", "quant"])
def test_unported_requests_raise(case, tmp_path):
    """What the port refuses is what the reference refuses: beams, the
    repetition penalty and min_length in the batcher (UnsupportedRequest),
    a top_p outside (0, 1] (a plain ValueError), a sampled or prefix request
    in speculative mode, a post-trunk merge on the BTAdapter (the temporal
    levels carry one), an over-long prompt; and a weight file that cannot
    be read (an empty ckpt fails torch.load, as in the reference, rather
    than leave random weights). LoRA over quantized trees is ported: case
    ``quant`` builds and serves it (held to JAX in
    tests/test_torch_lora.py)."""
    if case == "weights":
        (tmp_path / "x.pth").write_bytes(b"")
        with pytest.raises(EOFError):
            tzoo.STLLM.from_config(_tiny_model_cfg(ckpt=str(tmp_path / "x.pth")), device="cpu")
        return
    if case == "quant":
        model = tzoo.STLLM.from_config(_tiny_model_cfg(
            quant_int8=True, lora_r=4, llama={**_tiny_model_cfg()["llama"], "kv_int8": True}),
            seed=0, device="cpu")
        layer = model.params["llama"]["layers"][0]
        assert "w_q" in layer["q"] and layer["q_lora"]["a"].dtype == torch.float32
        emb = torch.randn((1, 5, model.cfg.llama.hidden), generator=torch.Generator().manual_seed(0))
        srv = TBatcher(model.params["llama"], model.cfg.llama, slots=2, max_len=32, chunk=4)
        srv.submit("r", emb, _gen(TGen, 4))
        assert len(srv.run()["r"]) == 4
        return
    extra = {"vit": {**_tiny_model_cfg()["vit"], "merge_level": "t_mild"}} if case == "t_mild" \
        else {}
    model = tzoo.STLLM.from_config(_tiny_model_cfg(**extra), seed=0, device="cpu")
    cfg = model.cfg
    frames = np.zeros((1, 2, 28, 28, 3), np.uint8)
    gen = {"penalty": _gen(TGen, 4, repetition_penalty=1.5),
           "min_length": _gen(TGen, 4, min_length=3), "beams": _gen(TGen, 4, num_beams=2),
           "top_p": _gen(TGen, 4, do_sample=True, top_p=1.5),
           "spec_sample": _gen(TGen, 4, do_sample=True), "overlong": _gen(TGen, 60)
           }.get(case, _gen(TGen, 4))
    if case.startswith("spec"):
        cb = TBatcher(model.params["llama"], cfg.llama, slots=1, max_len=32,
                      draft_params=model.params["llama"], draft_cfg=cfg.llama)
        prefix = None
        if case == "spec_prefix":
            prefix = _tiny_prefix(model.params["llama"], cfg.llama)
        with pytest.raises(UnsupportedRequest):
            cb.submit("a", torch.zeros((1, 3, 32)), gen, prefix=prefix,
                      prefix_len=0 if prefix is None else 3)
        return
    srv = TServer(model.params, cfg, slots=1, max_len=32)
    if case == "t_mild":
        assert cfg.vit.merge_schedule == ((39, 128),) and cfg.vit.merge_level == ""
        srv.submit("a", frames, [[1]], [[2]], gen)
        with pytest.raises(ValueError, match="post-trunk"):
            srv.run()
        return
    with pytest.raises(ValueError) as err:
        srv.submit("a", frames, [[1]], [[2]], gen)
    assert isinstance(err.value, UnsupportedRequest) == (case != "top_p")


def _tiny_prefix(params, cfg):
    """A (1, 3) prefix KV cache of zero embeddings."""
    from stllm_tpu_torch.models.generation import _prefill

    return _prefill(params, torch.zeros((1, 3, cfg.hidden)), torch.ones((1, 3), dtype=torch.int32),
                    cfg, 3)[1]
