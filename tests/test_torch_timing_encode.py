"""The port's timing harnesses with an encoder (stllm_tpu_torch/timing/:
bench_pipeline_serving, bench_encode_static, bench_train_step,
bench_pipeline, bench_btadapter, bench_tome) against the JAX scripts they
come from, on tiny fp32 configs on the CPU (the LLaMA-only harnesses and
the command lines are in tests/test_torch_timing.py, whose conventions
this file keeps).

The JAX scripts' quantizers (quantize_vit_params, calibrate_*_scales,
quantize_llama_params_int4) are replaced by the identity on both sides
where the protocol is compared, so each arm runs in fp32 and answers
token for token; the quantized encode and LLaMA are held to JAX in
tests/test_torch_models_int8.py, test_torch_fused_ln.py and
test_torch_models_w4.py. The train step keeps its weight-only int8 base:
its losses and gradient norm are held to the JAX script's printed values.
The JAX ViT's packed attentions run their Pallas kernels in interpret mode,
as the JAX package's own tests run them."""

import dataclasses
import functools
import hashlib
import importlib.util
import json
import re
import shutil
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stllm_tpu.models import btadapter as jbt
from stllm_tpu.models import generation as jgen
from stllm_tpu.models import llama as jllama
from stllm_tpu.models import qformer as jqf
from stllm_tpu.models import stllm as jst
from stllm_tpu.models import vit as jvit
from stllm_tpu.ops import attention as jattn
from stllm_tpu.ops import tome as jtome
from stllm_tpu_torch.convert.from_jax import load_jax_params
from stllm_tpu_torch.models import generation as tgen
from stllm_tpu_torch.models import llama as tllama
from stllm_tpu_torch.models import qformer as tqf
from stllm_tpu_torch.models import stllm as tstl
from stllm_tpu_torch.models import vit as tvit
from stllm_tpu_torch.ops import tome as ttome
from stllm_tpu_torch.timing import bench_btadapter as tbb
from stllm_tpu_torch.timing import bench_encode_static as tes
from stllm_tpu_torch.timing import bench_pipeline as tpl
from stllm_tpu_torch.timing import bench_pipeline_serving as tps
from stllm_tpu_torch.timing import bench_tome as ttm
from stllm_tpu_torch.timing import bench_train_step as tts

REPO = Path(__file__).resolve().parent.parent
ENC_REL = 1e-5          # fp32 encodes: summation order only
# a merged fp32 encode: a merge stage keeps the r best of a few hundred
# near-equal similarity scores, and a 3e-7 gap between the packages' block
# outputs re-pairs a few tokens at that cutoff (3 of 2560 origins at the
# tiny BTAdapter's second fold); the port's merges equal JAX's on equal
# inputs (tests/test_torch_tome.py)
MERGE_REL = 2e-3
LOSS_REL = 1e-3         # the int8 base's losses against the JAX script's printed 3 decimals
STAMP = {"device", "harness"}
DROPPED = {"bench_pipeline_serving": {"note"}}
ADDED = {"bench_pipeline_serving": {"serve_drain_s", "serial_drain_s"},
         "bench_pipeline": {"raw_ms"},
         "bench_btadapter": {"encode_s"},
         "bench_tome": {"encode_s"}}

# 257 tokens a frame (as EVA-ViT-g), 4 blocks, so every merge level scales
VIT = dict(image_size=32, patch_size=2, width=32, depth=4, heads=2, mlp_hidden=64,
           gelu_approx=True, use_flash=None)
QF = dict(hidden=32, num_layers=2, heads=4, intermediate=64, encoder_width=32, num_query=4,
          vocab_size=50)
LL = dict(vocab_size=61, hidden=64, num_layers=2, heads=4, intermediate=128, max_positions=1024)


def _cfgs(vit=None, qf=None, ll=None, **top):
    vit, qf, ll = {**VIT, **(vit or {})}, {**QF, **(qf or {})}, {**LL, **(ll or {})}
    j = dict(vit=jvit.ViTConfig(dtype=jnp.float32, **vit),
             qformer=jqf.QFormerConfig(dtype=jnp.float32, **qf),
             llama=jllama.LlamaConfig(dtype=jnp.float32, **ll))
    t = dict(vit=tvit.ViTConfig(dtype=torch.float32, **vit),
             qformer=tqf.QFormerConfig(dtype=torch.float32, **qf),
             llama=tllama.LlamaConfig(dtype=torch.float32, **ll))
    return j, t


J, T = _cfgs()


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", autouse=True)
def _jax_kernels():
    """The JAX ViT's and BTAdapter's packed attentions through their Pallas
    kernels in interpret mode."""
    with pytest.MonkeyPatch.context() as mp:
        for owner in (jvit, jbt):
            for name in ("fused_qkv_attention", "fused_qkv_attention_quant",
                         "fused_qkv_attention_quant_static"):
                if hasattr(owner, name):
                    mp.setattr(owner, name, functools.partial(getattr(jattn, name),
                                                              interpret=True))
        yield
    jax.clear_caches()


@pytest.fixture(scope="module")
def root_docs():
    return _root_hashes()


def _root_hashes():
    return {p.name: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(REPO.glob("BENCH_*.json"))}


def _script(name, where):
    (where / "script").mkdir(exist_ok=True, parents=True)
    src = Path(shutil.copy(REPO / "script" / f"{name}.py", where / "script" / f"{name}.py"))
    saved = list(sys.path)
    spec = importlib.util.spec_from_file_location(f"jax_timing_{name}", src)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    sys.path[:] = saved
    return mod


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(tree):
    return load_jax_params(_np(tree), device="cpu")


def _fresh(tree):
    return jax.tree_util.tree_map(jnp.array, tree)


def _perturb(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: a + jnp.asarray(rng.standard_normal(a.shape) * 0.02, a.dtype), tree)


def _stllm(cfg, seed=0, llama=True):
    tree = jax.jit(functools.partial(jst.init_stllm, cfg=cfg, init_llama_params=llama))(
        jax.random.PRNGKey(seed))
    return _perturb(tree, seed + 1)


def _identity(p, *a, **kw):
    return p


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).mean() / np.abs(want).mean())


def _host(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _check_stamp(section, harness):
    assert section["device"] == "cpu" and section["harness"] == harness


def _keys(doc):
    return set(doc) - STAMP


def _printed(text):
    lines = [json.loads(ln) for ln in text.splitlines() if ln.startswith("{")]
    return [d for d in lines if "written" not in d][-1]


def _jit_recorder(log):
    """A stand-in for a JAX script's ``jax`` whose jit records each call's
    result."""
    def jit(fn, **kw):
        compiled = jax.jit(fn, **kw)

        def call(*a, **k):
            out = compiled(*a, **k)
            log.append(np.asarray(out))
            return out
        return call
    return types.SimpleNamespace(jit=jit, random=jax.random, block_until_ready=jax.block_until_ready)


def _scaled_levels(depth=4):
    return {k: ({} if k == "off" else ttome.scale_level_to_depth(k, depth))
            for k in ttome.MERGE_LEVELS}


# ---------------------------------------------------------------------------
# bench_pipeline_serving
# ---------------------------------------------------------------------------

def _recording_server(base, log):
    class Recorded(base):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self._log = {"submits": [], "kw": {k: kw[k] for k in ("slots", "max_len", "chunk")}}
            log.append(self._log)

        def submit(self, rid, frames, prefix_ids, suffix_ids, gen=None, **kw):
            self._log["submits"].append((rid, _host(frames), np.asarray(prefix_ids),
                                         np.asarray(suffix_ids),
                                         np.asarray(kw["qformer_text_ids"])))
            return super().submit(rid, frames, prefix_ids, suffix_ids, gen, **kw)

        def run(self, *a, **kw):
            out = super().run(*a, **kw)
            self._log["out"] = {k: list(v) for k, v in out.items()}
            return out
    return Recorded


@pytest.fixture(scope="module")
def qa_params():
    return _stllm(jst.STLLMConfig(video_input="all", **J))


@pytest.mark.parametrize("tome", [None, "auto"])
def test_pipeline_serving_main_matches_jax(tmp_path, monkeypatch, capsys, qa_params, root_docs,
                                           tome):
    """Both mains, 4 requests on 2 slots and 4 on 1 (the serial arm), 4
    frames, fp32: every drain's requests (frames, prompt and Q-Former ids)
    and answers equal, the auto arm's levels equal, and the document's
    keys but the JAX script's tunnel note."""
    from stllm_tpu import pipeline_serving as jps
    from stllm_tpu_torch import pipeline_serving as tpsrv

    jroot, out = tmp_path / "jax", tmp_path / "port"
    jmod = _script("bench_pipeline_serving", jroot)
    sizes = dict(FRAMES=4, PREFIX=8, SUFFIX=8, ANSWER=4, N_REQUESTS=4)
    for mod in (jmod, tps):
        for k, v in sizes.items():
            monkeypatch.setattr(mod, k, v)
    monkeypatch.setattr(jmod, "EVA_VIT_G", J["vit"])
    monkeypatch.setattr(jmod, "STLLMConfig", functools.partial(
        jst.STLLMConfig, qformer=J["qformer"], llama=J["llama"]))
    monkeypatch.setattr(jmod, "init_stllm", lambda key, cfg, **kw: _fresh(qa_params))
    for owner, name in ((jvit, "quantize_vit_params"), (jvit, "calibrate_vit_scales"),
                        (jllama, "quantize_llama_params_int4")):
        monkeypatch.setattr(owner, name, _identity)
    jlog, tlog = [], []
    monkeypatch.setattr(jmod, "VideoQAServer", _recording_server(jps.VideoQAServer, jlog))
    monkeypatch.setattr(sys, "argv", ["bench_pipeline_serving.py"] +
                        ([f"--tome={tome}"] if tome else []) + ["--slots=2"])
    jmod.main()
    monkeypatch.setattr(tps, "EVA_VIT_G", T["vit"])
    monkeypatch.setattr(tps, "STLLMConfig", functools.partial(
        tstl.STLLMConfig, qformer=T["qformer"], llama=T["llama"]))
    monkeypatch.setattr(tps, "init_stllm", lambda gen, cfg, **kw: _t(qa_params))
    for name in ("quantize_vit_params", "calibrate_vit_scales", "quantize_llama_params_int4"):
        monkeypatch.setattr(tps, name, _identity)
    monkeypatch.setattr(tps, "VideoQAServer", _recording_server(tpsrv.VideoQAServer, tlog))
    argv = ([f"--tome={tome}"] if tome else []) + ["--slots=2", "--cpu", "--out-dir", str(out)]
    assert tps.main(argv) == 0

    assert len(tlog) == len(jlog) == 8          # warm + 3, serving then serial
    for t, j in zip(tlog, jlog):
        assert t["kw"] == j["kw"]
        assert len(t["submits"]) == len(j["submits"]) == 4
        for ts, js in zip(t["submits"], j["submits"]):
            assert ts[0] == js[0]
            for a, b in zip(ts[1:], js[1:]):
                np.testing.assert_array_equal(a, b)
        assert t["out"] == j["out"]
    key = tome or "base"
    want = json.loads((jroot / "BENCH_PIPELINE_SERVING.json").read_text())[key]
    got = json.loads((out / "BENCH_PIPELINE_SERVING.json").read_text())[key]
    _check_stamp(got, tps.HARNESS)
    assert _keys(got) == (set(want) - DROPPED["bench_pipeline_serving"]) | \
        ADDED["bench_pipeline_serving"]
    if tome:
        assert got["auto_selected"] == want["auto_selected"]
        assert len(got["auto_selected"]) > 1                  # smooth and noise differ
    assert _root_hashes() == root_docs


# ---------------------------------------------------------------------------
# bench_encode_static and bench_tome
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def enc_params():
    tree = dict(_stllm(jst.STLLMConfig(**J), seed=2, llama=False))
    tree.pop("llama")
    return tree


def _encode_setup(monkeypatch, jmod, tmod, enc_params, frames):
    """The JAX script and the port's harness on the tiny fp32 encoder."""
    jenc = []
    monkeypatch.setattr(jmod, "FRAMES", frames)
    monkeypatch.setattr(tes, "FRAMES", frames)
    monkeypatch.setattr(jmod, "EVA_VIT_G", J["vit"])
    monkeypatch.setattr(jmod, "STLLMConfig", functools.partial(
        jst.STLLMConfig, qformer=J["qformer"], llama=J["llama"]))
    monkeypatch.setattr(jmod, "init_stllm",
                        lambda key, cfg, **kw: {**_fresh(enc_params), "llama": None})
    monkeypatch.setattr(jmod, "quantize_vit_params", _identity)
    monkeypatch.setattr(jmod, "calibrate_vit_scales", _identity)
    monkeypatch.setattr(jmod, "jax", _jit_recorder(jenc))
    monkeypatch.setattr(tes, "EVA_VIT_G", T["vit"])
    monkeypatch.setattr(tes, "STLLMConfig", functools.partial(
        tstl.STLLMConfig, qformer=T["qformer"], llama=T["llama"]))
    monkeypatch.setattr(tes, "init_stllm", lambda gen, cfg, **kw: {**_t(enc_params),
                                                                    "llama": None})
    monkeypatch.setattr(tes, "quantize_vit_params", _identity)
    monkeypatch.setattr(tes, "calibrate_vit_scales", _identity)
    tenc = []
    real = tmod.encode_img
    monkeypatch.setattr(tmod, "encode_img", lambda *a, **kw: tenc.append(
        real(*a, **kw).float().numpy()) or torch.from_numpy(tenc[-1]))
    return jenc, tenc


def test_encode_static_main_matches_jax(tmp_path, monkeypatch, capsys, enc_params):
    """Both mains on a 4-frame fp32 encode: the same frames and Q-Former
    ids (default_rng(0)), 2 warm + 8 timed encodes, each equal to JAX's;
    the port's printed line carries the setting, the frame count and the
    card line."""
    jmod = _script("bench_encode_static", tmp_path)
    jenc, tenc = _encode_setup(monkeypatch, jmod, tes, enc_params, 4)
    monkeypatch.setattr(sys, "argv", ["bench_encode_static.py"])
    jmod.main()
    capsys.readouterr()
    assert tes.main(["--fused-ln", "0", "--cpu"]) == 0
    got = _printed(capsys.readouterr().out)
    assert len(tenc) == len(jenc) == 10
    for a, b in zip(tenc, jenc):
        assert _rel(a, b) < ENC_REL
    assert got["device"] == "cpu" and got["harness"] == tes.HARNESS and got["frames"] == 4
    assert list(got["settings"]) == ["0"] and len(got["settings"]["0"]["encode_s"]) == 8


def test_encode_static_settings_restore_fused_ln(monkeypatch):
    """Every STLLM_FUSED_LN setting on the static-int8 tiny encoder (real
    quantization and calibration): each sets vit.FUSED_LN for its run,
    gives finite codes near the unfused encode, and the module's setting
    comes back after."""
    monkeypatch.setattr(tes, "FRAMES", 4)
    params, cfg, inputs = tes.build_encode_static("cpu", cfg=tstl.STLLMConfig(**T))
    before = tvit.FUSED_LN
    res = tes.run_encode_static(params, cfg, inputs, list(tes.SETTINGS), iters=1)
    assert tvit.FUSED_LN == before
    assert [r["fused_ln"] for r in res.values()] == [False, "proj", "fc2", "both"]
    base = res["0"]["out"].float().numpy()
    assert np.isfinite(base).all()
    for r in res.values():
        assert _rel(r["out"].float().numpy(), base) < 0.1


def test_tome_main_matches_jax(tmp_path, monkeypatch, capsys, enc_params, root_docs):
    """Both mains at every level scaled to the tiny 4-block trunk, 8
    frames, 1 timed encode a level (argv "1"), fp32: each level's encodes
    equal JAX's, and the document's keys (every level's)."""
    jroot, out = tmp_path / "jax", tmp_path / "port"
    jmod = _script("bench_tome", jroot)
    levels = _scaled_levels()
    spatial = {k: v.get("merge_schedule", ()) for k, v in levels.items()
               if "temporal_schedule" not in v}
    temporal = {k: (v["temporal_schedule"], v["merge_schedule"]) for k, v in levels.items()
                if "temporal_schedule" in v}
    for mod in (jmod, ttm):
        monkeypatch.setattr(mod, "LEVELS", spatial)
        monkeypatch.setattr(mod, "T_LEVELS", temporal)
    monkeypatch.setattr(ttm, "FRAMES", 8)
    jenc, tenc = _encode_setup(monkeypatch, jmod, ttm, enc_params, 8)
    monkeypatch.setattr(sys, "argv", ["bench_tome.py", "1"])
    jmod.main()
    assert ttm.main(["1", "--cpu", "--out-dir", str(out)]) == 0
    assert len(tenc) == len(jenc) == 3 * len(levels)
    for i, (a, b) in enumerate(zip(tenc, jenc)):
        assert _rel(a, b) < (ENC_REL if i < 3 else MERGE_REL)       # "off" first
    want = json.loads((jroot / "BENCH_TOME.json").read_text())
    got = json.loads((out / "BENCH_TOME.json").read_text())
    _check_stamp(got, ttm.HARNESS)
    assert _keys(got) == set(want) | ADDED["bench_tome"]
    assert set(got["encode_s"]) == set(levels) and got["frames"] == 8
    assert _root_hashes() == root_docs


# ---------------------------------------------------------------------------
# bench_pipeline
# ---------------------------------------------------------------------------

def _gen_recorder(fn, log):
    def wrap(params, embeds, *a, **kw):
        out = fn(params, embeds, *a, **kw)
        log.append((_host(embeds), out))
        return out
    return wrap


@pytest.mark.parametrize("flags", [[], ["--int4", "--tome=auto"]])
def test_pipeline_main_matches_jax(tmp_path, monkeypatch, capsys, qa_params, root_docs, flags):
    """Both mains, 8 frames, 3 timed QAs: every QA's assembled prompt
    (prefix | encode | suffix) equal within fp32 rounding and, on the fp32
    arm, every answer equal (the --int4 arm's int8 KV cache is quantized:
    its answers are held by length); the auto arm's level; the document's
    keys."""
    jroot, out = tmp_path / "jax", tmp_path / "port"
    jmod = _script("bench_pipeline", jroot)
    sizes = dict(FRAMES=8, PREFIX_TOKENS=8, SUFFIX_TOKENS=8, ANSWER_TOKENS=4, ITERS=3)
    for mod in (jmod, tpl):
        for k, v in sizes.items():
            monkeypatch.setattr(mod, k, v)
    monkeypatch.setattr(jmod, "EVA_VIT_G", J["vit"])
    monkeypatch.setattr(jmod, "STLLMConfig", functools.partial(
        jst.STLLMConfig, qformer=J["qformer"], llama=J["llama"]))
    monkeypatch.setattr(jmod, "init_stllm", lambda key, cfg, **kw: _fresh(qa_params))
    for owner, name in ((jvit, "quantize_vit_params"), (jvit, "calibrate_vit_scales"),
                        (jllama, "quantize_llama_params_int4"),
                        (jllama, "quantize_llama_params")):
        monkeypatch.setattr(owner, name, _identity)
    jcalls, tcalls = [], []
    monkeypatch.setattr(jmod, "generate", _gen_recorder(jgen.generate, jcalls))
    monkeypatch.setattr(sys, "argv", ["bench_pipeline.py", *flags])
    jmod.main()
    monkeypatch.setattr(tpl, "EVA_VIT_G", T["vit"])
    monkeypatch.setattr(tpl, "STLLMConfig", functools.partial(
        tstl.STLLMConfig, qformer=T["qformer"], llama=T["llama"]))
    monkeypatch.setattr(tpl, "init_stllm", lambda gen, cfg, **kw: _t(qa_params))
    for name in ("quantize_vit_params", "calibrate_vit_scales", "quantize_llama_params_int4",
                 "quantize_llama_params"):
        monkeypatch.setattr(tpl, name, _identity)
    monkeypatch.setattr(tpl, "generate", _gen_recorder(tgen.generate, tcalls))
    assert tpl.main([*flags, "--cpu", "--out-dir", str(out)]) == 0
    assert len(tcalls) == len(jcalls) == 5
    for (te, to), (je, jo) in zip(tcalls, jcalls):
        assert te.shape == je.shape == (1, 8 + 8 * 4 + 8, LL["hidden"])
        assert _rel(te, je) < ENC_REL
        assert len(to[0]) == len(jo[0]) == 4
        if not flags:
            assert to == jo
    key = "int4+tome=auto" if flags else "bf16"
    want = json.loads((jroot / "BENCH_PIPELINE.json").read_text())[key]
    got = json.loads((out / "BENCH_PIPELINE.json").read_text())[key]
    _check_stamp(got, tpl.HARNESS)
    assert _keys(got) == set(want) | ADDED["bench_pipeline"]
    assert got["metric"] == want["metric"].replace("one chip", "one card")
    if flags:
        assert got["auto_selected"] == want["auto_selected"]
    assert len(got["all_ms"]) == len(got["raw_ms"]) == 3
    assert _root_hashes() == root_docs


def test_from_video_matches_jax(tmp_path):
    """The --from-video pieces: the port's clips (cv2's writer) equal JAX's
    byte for byte, their 16-frame GroupScale + CenterCrop decode JAX's, and
    run_from_video's report has the JAX one's keys (a stand-in QA)."""
    jmod = _script("bench_pipeline", tmp_path)
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    jpaths = jmod.synth_videos(str(tmp_path / "j"), 2, frames=24, w=64, h=48)
    tpaths = tpl.synth_videos(str(tmp_path / "t"), 2, frames=24, w=64, h=48)
    for jp, tp in zip(jpaths, tpaths):
        assert Path(jp).read_bytes() == Path(tp).read_bytes()
        # the port resizes with F.interpolate: within one uint8 step of
        # cv2 on at most 0.5% of values (tests/test_torch_data.py)
        got = tpl.decode_sample(tp, 32, "cpu").astype(np.int16)
        want = jmod.decode_sample(jp, 32).astype(np.int16)
        assert got.shape == want.shape == (1, 16, 32, 32, 3)
        assert np.abs(got - want).max() <= 1 and (got != want).mean() <= 5e-3
    seen = []
    report = tpl.run_from_video(lambda fr: seen.append(tuple(fr.shape)), "cpu", n_samples=3,
                                image_size=32)
    want = jmod.run_from_video(lambda fr: None, None, n_samples=3)
    assert set(report) == (set(want) - {"note"}) | {"phase_s", "host_cpus"}
    assert seen == [(1, 16, 32, 32, 3)] * (2 + 3 + 3)
    assert report["n_samples"] == want["n_samples"] == 3


# ---------------------------------------------------------------------------
# bench_btadapter
# ---------------------------------------------------------------------------

BT_VIT = {**VIT, "image_size": 224, "patch_size": 14}        # 257 tokens at the script's 224


def test_btadapter_main_matches_jax(tmp_path, monkeypatch, capsys, root_docs):
    """Both mains on a tiny fp32 BTAdapter (4 trunk blocks, the branch of
    3), 32 frames as 2 x 16, every level scaled to the trunk: each encode
    (2 warm + 6 timed a level) equal to JAX's, and the document's keys and
    levels."""
    jroot, out = tmp_path / "jax", tmp_path / "port"
    jmod = _script("bench_btadapter", jroot)
    jv = jvit.ViTConfig(dtype=jnp.float32, **BT_VIT)
    tv = tvit.ViTConfig(dtype=torch.float32, **BT_VIT)
    jparams = _perturb(jax.jit(functools.partial(jbt.init_btadapter, cfg=jv, depth=3))(
        jax.random.PRNGKey(4)), 5)
    levels = _scaled_levels()
    for owner in (jtome, ttome, tbb):
        monkeypatch.setattr(owner, "MERGE_LEVELS", levels)
    for mod in (jmod, tbb):
        monkeypatch.setattr(mod, "F", 32)
    monkeypatch.setattr(jmod, "EVA_VIT_G", jv)
    monkeypatch.setattr(jmod, "init_btadapter", lambda key, cfg, depth: _fresh(jparams))
    monkeypatch.setattr(jmod, "quantize_vit_params", _identity)
    monkeypatch.setattr(jmod, "calibrate_btadapter_scales", _identity)
    jenc, tenc = [], []
    monkeypatch.setattr(jmod, "jax", _jit_recorder(jenc))
    monkeypatch.setattr(sys, "argv", ["bench_btadapter.py"])
    jmod.main()
    monkeypatch.setattr(tbb, "EVA_VIT_G", tv)
    monkeypatch.setattr(tbb, "init_btadapter", lambda gen, cfg, depth: _t(jparams))
    monkeypatch.setattr(tbb, "quantize_vit_params", _identity)
    monkeypatch.setattr(tbb, "calibrate_btadapter_scales", _identity)
    real = tbb.btadapter_forward
    monkeypatch.setattr(tbb, "btadapter_forward", lambda *a, **kw: tenc.append(
        real(*a, **kw).float().numpy()) or torch.from_numpy(tenc[-1]))
    assert tbb.main(["--cpu", "--out-dir", str(out)]) == 0
    n_levels = len(levels) - 1
    assert len(tenc) == len(jenc) == 8 * (1 + n_levels)
    for i, (a, b) in enumerate(zip(tenc, jenc)):
        assert _rel(a, b) < (ENC_REL if i < 8 else MERGE_REL)
    want = json.loads((jroot / "BENCH_BTADAPTER.json").read_text())
    got = json.loads((out / "BENCH_BTADAPTER.json").read_text())
    _check_stamp(got, tbb.HARNESS)
    assert _keys(got) == set(want) | ADDED["bench_btadapter"]
    assert list(got["tome_fps"]) == list(want["tome_fps"])
    assert _root_hashes() == root_docs


# ---------------------------------------------------------------------------
# bench_train_step
# ---------------------------------------------------------------------------

TRAIN_VIT = {**VIT, "image_size": 224, "patch_size": 56}     # the script's 224, 17 tokens
TRAIN_QF = {"vocab_size": 30522}                            # its Q-Former ids reach 30000
TRAIN_LL = {"vocab_size": 32000}                            # and its token ids


def test_train_step_batch_matches_jax(tmp_path):
    """build_batch: the packed sample, the MVM arrays, the frames and the
    Q-Former ids from default_rng(0), array for array (at sequence 256)."""
    jmod = _script("bench_train_step", tmp_path)
    j, t = _cfgs(vit=TRAIN_VIT, qf=TRAIN_QF, ll=TRAIN_LL)
    jcfg = jst.STLLMConfig(vit_model="eva_btadapter_g", **j)
    tcfg = tstl.STLLMConfig(vit_model="eva_btadapter_g", **t)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmod, "SEQ", 256)
        mp.setattr(tts, "SEQ", 256)
        want = jmod.build_batch(jcfg, np.random.default_rng(0))
        got = tts.build_batch(tcfg, np.random.default_rng(0), "cpu")
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(_host(got[k]) if got[k].is_floating_point()
                                      else got[k].numpy(), np.asarray(want[k], np.float32)
                                      if got[k].is_floating_point() else np.asarray(want[k]))


def test_train_step_main_matches_jax(tmp_path, monkeypatch, capsys):
    """Both mains from the same tree (the JAX script's: weight-only int8
    2-layer base, LoRA r 4, BTAdapter QA config with remat and MVM), one
    first step and one timed step at sequence 256: the first and last loss
    and the gradient norm equal to the JAX script's printed 3 decimals,
    and the port's line carries its keys."""
    jmod = _script("bench_train_step", tmp_path)
    j, t = _cfgs(vit=TRAIN_VIT, qf=TRAIN_QF, ll=TRAIN_LL)
    built = {}
    jllama_tree = _perturb(jax.jit(functools.partial(
        jllama.init_llama, cfg=dataclasses.replace(j["llama"], remat=True)))(
        jax.random.PRNGKey(2)), 3)
    jrest = _stllm(jst.STLLMConfig(vit_model="eva_btadapter_g", **j), seed=4, llama=False)
    real_lora = jmod.add_lora

    def add_lora(params, key, r):
        built["tree"] = _np(real_lora(params, key, r=r))
        return jax.tree_util.tree_map(jnp.asarray, built["tree"])

    for mod in (jmod, tts):
        monkeypatch.setattr(mod, "SEQ", 256)
    monkeypatch.setattr(jmod, "EVA_VIT_G", j["vit"])
    monkeypatch.setattr(jmod, "VICUNA_7B", j["llama"])
    monkeypatch.setattr(jmod, "STLLMConfig", functools.partial(jst.STLLMConfig,
                                                               qformer=j["qformer"]))
    monkeypatch.setattr(jllama, "init_llama", lambda key, cfg: _fresh(jllama_tree))
    monkeypatch.setattr(jmod, "init_stllm", lambda key, cfg, **kw: _fresh(jrest))
    monkeypatch.setattr(jmod, "add_lora", add_lora)
    monkeypatch.setattr(sys, "argv", ["bench_train_step.py", "--steps", "1", "--layers", "2",
                                      "--lora-r", "4"])
    jmod.main()
    text = capsys.readouterr().out
    first = float(re.search(r"compile\+first step: .*loss=([-\d.]+)", text).group(1))
    last, gnorm = map(float, re.search(r"\nloss=([-\d.]+) grad_norm=([-\d.]+)", text).groups())

    monkeypatch.setattr(tts, "EVA_VIT_G", t["vit"])
    monkeypatch.setattr(tts, "VICUNA_7B", t["llama"])
    monkeypatch.setattr(tts, "STLLMConfig", functools.partial(tstl.STLLMConfig,
                                                              qformer=t["qformer"]))
    monkeypatch.setattr(tts, "build_params", lambda cfg, device, bf16_base=False, lora_r=16:
                        load_jax_params(built["tree"], device="cpu"))
    assert tts.main(["--steps", "1", "--layers", "2", "--lora-r", "4", "--cpu"]) == 0
    got = _printed(capsys.readouterr().out)
    assert got["outcome"] == "fit" and got["device"] == "cpu" and got["layers"] == 2
    assert got["base"] == "int8 weight-only" and got["mvm"] and len(got["step_s"]) == 1
    for value, want in ((got["first_loss"], first), (got["loss"], last),
                        (got["grad_norm"], gnorm)):
        assert abs(value - want) <= 5e-4 + LOSS_REL * abs(want), (value, want)
