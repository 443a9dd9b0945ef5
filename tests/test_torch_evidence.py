"""The port's evidence harnesses (stllm_tpu_torch/evidence/) against the JAX
scripts they come from (script/int8_equivalence.py, tome_equivalence.py,
probe_spec_divergence.py, w4a16_depth.py, int8_equivalence_trained.py and
harvest_trained_levels.py), on tiny fp32 configs on the CPU.

Each JAX script is loaded by path (a copy under tmp_path where its main
writes beside itself) and its helpers, or its main with the model pieces
replaced, give the reference. JAX params reach the port through
load_jax_params, and the JAX ViT runs its Pallas kernels in interpret mode
(the kernels' clamped exp2 softmax, as the port's plain versions compute
it; tests/test_torch_models_int8.py).

Tolerances: fp32 arms give identical greedy tokens and first-token margins
within MARGIN_REL; quantized arms' first-position logits agree within
MEAN_REL mean relative error (a code on a rounding boundary may flip; token
equality is not asserted there); three training steps from the same
weights give losses within LOSS_ATOL + LOSS_RTOL relative, and identical
fp32 greedy answers after them. Data protocols and grades are equal."""

import dataclasses
import functools
import importlib.util
import json
import re
import shutil
import subprocess
import sys
from collections import deque
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stllm_tpu.models import generation as jgen
from stllm_tpu.models import llama as jllama
from stllm_tpu.models import qformer as jqf
from stllm_tpu.models import stllm as jst
from stllm_tpu.models import vit as jvit
from stllm_tpu.ops import attention as jattn
from stllm_tpu.ops import tome as jtome
from stllm_tpu.train import step as jstep
from stllm_tpu_torch.convert.from_jax import load_jax_params
from stllm_tpu_torch.evidence import _common
from stllm_tpu_torch.evidence import harvest_trained_levels as thv
from stllm_tpu_torch.evidence import int8_equivalence as tie
from stllm_tpu_torch.evidence import int8_equivalence_trained as tit
from stllm_tpu_torch.evidence import probe_spec_divergence as tps
from stllm_tpu_torch.evidence import tome_equivalence as tte
from stllm_tpu_torch.evidence import w4a16_depth as twd
from stllm_tpu_torch.models import generation as tgen
from stllm_tpu_torch.models import llama as tllama
from stllm_tpu_torch.models import qformer as tqf
from stllm_tpu_torch.models import stllm as tst
from stllm_tpu_torch.models import vit as tvit

REPO = Path(__file__).resolve().parent.parent
MODULES = ("int8_equivalence", "tome_equivalence", "probe_spec_divergence", "w4a16_depth",
           "int8_equivalence_trained", "harvest_trained_levels")
MARGIN_REL = 1e-4
MEAN_REL = 1e-3
LOSS_ATOL, LOSS_RTOL = 1e-4, 1e-3

# the QA harnesses' tiny model: 257 tokens a frame (32 x 32, patch 2), as
# EVA-ViT-g has, so the merge levels and the auto selector act; 4 blocks, so
# every level scales to distinct block indices
VIT = dict(image_size=32, patch_size=2, width=32, depth=4, heads=2, mlp_hidden=64,
           gelu_approx=True, use_flash=None)
QF = dict(hidden=32, num_layers=2, heads=4, intermediate=64, encoder_width=32, num_query=4,
          vocab_size=50)
LL = dict(vocab_size=61, hidden=64, num_layers=2, heads=4, intermediate=128, max_positions=256)
JCFG = jst.STLLMConfig(vit=jvit.ViTConfig(dtype=jnp.float32, **VIT),
                       qformer=jqf.QFormerConfig(dtype=jnp.float32, **QF),
                       llama=jllama.LlamaConfig(dtype=jnp.float32, **LL), video_input="all")
TCFG = tst.STLLMConfig(vit=tvit.ViTConfig(dtype=torch.float32, **VIT),
                       qformer=tqf.QFormerConfig(dtype=torch.float32, **QF),
                       llama=tllama.LlamaConfig(dtype=torch.float32, **LL), video_input="all")

# the trained harness's tiny proxy: token ids up to 30000, so both
# vocabularies hold them
T_QF = {**QF, "vocab_size": 30522}
T_LL = {**LL, "vocab_size": 32000, "max_positions": 128}
T_TOP = dict(use_mask=False, video_input="mean")


def _trained_cfgs(vit=None, **llama):
    ll = {**T_LL, **llama}
    vit = {**VIT, **(vit or {})}
    j = jst.STLLMConfig(vit=jvit.ViTConfig(dtype=jnp.float32, remat=True, **vit),
                        qformer=jqf.QFormerConfig(dtype=jnp.float32, **T_QF),
                        llama=jllama.LlamaConfig(dtype=jnp.float32, remat=True, **ll), **T_TOP)
    t = tst.STLLMConfig(vit=tvit.ViTConfig(dtype=torch.float32, remat=True, **vit),
                        qformer=tqf.QFormerConfig(dtype=torch.float32, **T_QF),
                        llama=tllama.LlamaConfig(dtype=torch.float32, remat=True, **ll), **T_TOP)
    return j, t


# the depth harness's tiny LLaMA: K = 256 and 512, which g=128 divides
DEPTH_LL = dict(vocab_size=97, hidden=256, num_layers=2, heads=4, intermediate=512,
                max_positions=128)
J_DEPTH = jllama.LlamaConfig(dtype=jnp.float32, **DEPTH_LL)
T_DEPTH = tllama.LlamaConfig(dtype=torch.float32, **DEPTH_LL)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Tiny eager models: one intra-op thread, so parallel test processes
    do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", autouse=True)
def _jax_kernels():
    """The JAX ViT's packed attentions through their Pallas kernels in
    interpret mode, as the JAX package's own tests run them."""
    interp = {"fused_qkv_attention": jattn.fused_qkv_attention,
              "fused_qkv_attention_quant": jattn.fused_qkv_attention_quant,
              "fused_qkv_attention_quant_static": jattn.fused_qkv_attention_quant_static}
    with pytest.MonkeyPatch.context() as mp:
        for name, fn in interp.items():
            mp.setattr(jvit, name, functools.partial(fn, interpret=True))
        yield
    jax.clear_caches()


def _script(name, where=None):
    """script/<name>.py as a module; from a copy under ``where`` (whose main
    then writes there), the repository's own file otherwise."""
    src = REPO / "script" / f"{name}.py"
    if where is not None:
        (where / "script").mkdir(exist_ok=True)
        src = Path(shutil.copy(src, where / "script" / src.name))
    saved = list(sys.path)
    spec = importlib.util.spec_from_file_location(f"jax_script_{name}", src)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    sys.path[:] = saved     # each script puts its root first on the path
    return mod


@pytest.fixture(scope="module")
def jscripts():
    return {name: _script(name) for name in MODULES}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(tree):
    return load_jax_params(_np(tree), device="cpu")


def _init_stllm(cfg, seed=0):
    """JAX's init_stllm, jitted (eager, its many small ops take seconds)."""
    return jax.jit(functools.partial(jst.init_stllm, cfg=cfg, init_llama_params=True))(
        jax.random.PRNGKey(seed))


def _perturb(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: a + jnp.asarray(rng.standard_normal(a.shape) * 0.02, a.dtype), tree)


def _mean_rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).mean() / np.abs(want).mean())


def _margins_close(got, want):
    np.testing.assert_allclose(got, want, rtol=MARGIN_REL, atol=1e-6)


@pytest.fixture(scope="module")
def qa_params():
    """The QA harnesses' tiny model (JAX's init, perturbed so the zero
    biases move)."""
    return _perturb(_init_stllm(JCFG), 1)


def _last_json(text):
    return json.loads([ln for ln in text.splitlines() if ln.startswith("{")][-1])


# ---------------------------------------------------------------------------
# grades and data protocols
# ---------------------------------------------------------------------------

def _flipped(base, case, vocab):
    """``base`` with no flip, every first token flipped, or a mix of
    first-token flips, later-token flips and exact matches."""
    if case == "no_flip":
        return [list(a) for a in base]
    if case == "all_flip":
        return [[(a[0] + 1) % vocab] + a[1:] for a in base]
    got = [list(a) for a in base]
    got[1][0] = (got[1][0] + 3) % vocab
    got[2][7] = (got[2][7] + 1) % vocab
    got[4] = [(t + 5) % vocab for t in got[4]]
    return got


def _answers(case, n=6, vocab=61, seed=0):
    """(base, got, margins) for a case of ``_flipped``."""
    rng = np.random.default_rng(seed)
    base = [list(map(int, rng.integers(0, vocab, 16))) for _ in range(n)]
    margins = [float(x) for x in rng.uniform(0.0, 2.0, n)]
    return base, _flipped(base, case, vocab), margins


CASES = ("no_flip", "all_flip", "mixed")


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("stack", ["int8", "w4a16"])
def test_int8_samples_and_grade_match_jax(tmp_path, monkeypatch, capsys, stack, case):
    """The JAX script's main on the tiny config with its model pieces
    replaced: the samples it makes equal the port's array for array, and its
    printed result equals the port's grade on the same answers and margins
    (the w4a16 stack's section of its EQUIV_INT8.json too)."""
    mod = _script("int8_equivalence", tmp_path)
    n = 6
    base, got, margins = _answers(case, n)
    seen = []

    def fake_run_samples(params, cfg, samples, label):
        seen.append(samples)
        return (base, margins) if len(seen) == 1 else (got, [0.0] * n)

    keep = lambda p, *a, **kw: p
    monkeypatch.setattr(mod, "STLLMConfig", lambda **kw: JCFG)
    monkeypatch.setattr(mod, "init_stllm", lambda *a, **kw: {"vit": {}, "llama": {}})
    monkeypatch.setattr(mod, "run_samples", fake_run_samples)
    for owner, name in ((jllama, "quantize_llama_params"), (jllama, "quantize_llama_params_int4"),
                        (jvit, "quantize_vit_params"), (jvit, "calibrate_vit_scales")):
        monkeypatch.setattr(owner, name, keep)
    monkeypatch.setattr(sys, "argv", ["int8_equivalence.py", str(n), stack])
    mod.main()
    want = _last_json(capsys.readouterr().out)
    assert tie.grade(base, margins, got, stack) == want
    ours = tie.make_samples(n, TCFG)
    assert seen[0] is seen[1] and len(seen[0]) == n
    for a, b in zip(seen[0], ours):
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    path = tie.write(want, stack, str(tmp_path / "port"))
    if stack == "w4a16":
        jdoc = json.loads((tmp_path / "EQUIV_INT8.json").read_text())
        assert jdoc == json.loads(Path(path).read_text())
    else:
        assert json.loads(Path(path).read_text()) == want


@pytest.mark.parametrize("case", CASES)
def test_tome_grade_matches_jax(jscripts, case):
    base, got, margins = _answers(case)
    assert tte.grade(base, margins, got) == jscripts["tome_equivalence"].grade(base, margins, got)


@pytest.mark.parametrize("video", [True, False], ids=["smooth", "noise"])
def test_tome_samples_and_levels_match_jax(jscripts, video):
    jmod = jscripts["tome_equivalence"]
    assert tte.LEVELS == jmod.LEVELS and tte.T_LEVELS == jmod.T_LEVELS
    want = jmod.make_samples(3, JCFG, video=video)
    got = tte.make_samples(3, TCFG, video=video)
    for a, b in zip(want, got):
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    # the full-depth table is the script's own; other depths take it scaled
    full = dataclasses.replace(TCFG, vit=dataclasses.replace(TCFG.vit, depth=39))
    for name, sched in jmod.LEVELS.items():
        assert tte.level_cfg(full, name).vit.merge_schedule == sched
    for name, (tsched, msched) in jmod.T_LEVELS.items():
        vit = tte.level_cfg(full, name).vit
        assert (vit.temporal_schedule, vit.merge_schedule) == (tsched, msched)


@pytest.mark.parametrize("margins", [True, False], ids=["margins", "no_margins"])
@pytest.mark.parametrize("case", CASES)
def test_trained_grade_matches_jax(jscripts, case, margins):
    base, got, m = _answers(case, n=8)
    m = m if margins else None
    assert tit.grade(base, got, m) == jscripts["int8_equivalence_trained"].grade(base, got, m)


def test_trained_dataset_matches_jax(jscripts):
    """build_dataset from default_rng(3): the same packed batches, frames,
    question ids, answers and kinds, and the generator left in the same
    state."""
    jcfg, tcfg = _trained_cfgs()
    jr, tr = np.random.default_rng(3), np.random.default_rng(3)
    want = jscripts["int8_equivalence_trained"].build_dataset(jr, 4, jcfg)
    got = tit.build_dataset(tr, 4, tcfg, "cpu")
    assert [s["kind"] for s in got] == ["smooth", "smooth", "noise", "noise"]
    for a, b in zip(want, got):
        assert a["kind"] == b["kind"]
        for k in ("before", "after", "answer"):
            assert list(map(int, a[k])) == list(map(int, b[k]))
        assert sorted(a["batch"]) == sorted(b["batch"])
        for k, v in a["batch"].items():
            w = np.asarray(v.astype(jnp.float32) if v.dtype == jnp.bfloat16 else v)
            g = b["batch"][k]
            assert str(g.dtype).replace("torch.", "") == str(v.dtype), k
            assert np.array_equal(g.float().numpy() if g.is_floating_point() else g.numpy(), w), k
    assert jr.integers(0, 2**31) == tr.integers(0, 2**31)


def test_depth_data_matches_jax(jscripts):
    """build_data at the full width, from default_rng(11) over two depths."""
    jmod = jscripts["w4a16_depth"]
    jr, tr = np.random.default_rng(11), np.random.default_rng(11)
    for depth in (4, 8):
        want = jmod.build_data(jr, 2, jmod.make_cfg(depth))
        got = twd.build_data(tr, 2, twd.make_cfg(depth))
        for a, b in zip(want, got):
            assert a["prompt"].dtype == b["prompt"].dtype == np.float32
            assert np.array_equal(a["prompt"], b["prompt"])
            assert list(map(int, a["answer"])) == list(map(int, b["answer"]))
    assert twd.make_cfg(16).hidden == jmod.make_cfg(16).hidden == 4096


@pytest.mark.parametrize("case", CASES)
def test_depth_grade_matches_jax(jscripts, monkeypatch, capsys, case):
    """The JAX script's run_depth with its greedy and first-position logits
    replaced by the same canned answers and logits as the port's evaluate:
    equal rows."""
    jmod = jscripts["w4a16_depth"]
    n, vocab = 6, 97
    rng = np.random.default_rng(5)
    data = twd.build_data(np.random.default_rng(11), n, T_DEPTH)
    base, _, _ = _answers("no_flip", n, vocab, seed=1)
    base[0] = list(map(int, data[0]["answer"]))     # one sample on its target
    bf16_lg = [rng.normal(size=vocab) for _ in range(n)]
    variants = {}
    for i, name in enumerate(twd.VARIANTS):
        got = _flipped(base, case, vocab)
        if case == "mixed":
            got[5][0] = (got[5][0] + i) % vocab     # a flip in some variants only
        variants[name] = (got, [lg + rng.normal(size=vocab) * 0.1 for lg in bf16_lg])

    def canned():
        ans, lgs = deque(base), deque(bf16_lg)
        queue = deque()
        for got, lg in variants.values():
            for a, l in zip(got, lg):
                queue.append((a, l))
        state = {"ans": ans, "lg": lgs, "q": queue, "pending": None}

        def greedy(params, cfg, prompt):
            if state["ans"]:
                return list(state["ans"].popleft())
            state["pending"] = state["q"].popleft()
            return list(state["pending"][0])

        def first_logits(params, cfg, prompt):
            return state["lg"].popleft() if state["lg"] else state["pending"][1]
        return greedy, first_logits

    keep = lambda p, *a, **kw: p
    for owner in (jmod, twd):
        g, f = canned()
        monkeypatch.setattr(owner, "greedy", g)
        monkeypatch.setattr(owner, "first_logits", f)
    for name in ("quantize_llama_params", "quantize_llama_params_int4"):
        monkeypatch.setattr(jmod, name, keep)
    monkeypatch.setattr(twd, "VARIANTS", {name: keep for name in twd.VARIANTS})
    monkeypatch.setattr(jmod, "make_cfg", lambda depth: J_DEPTH)
    monkeypatch.setattr(jmod, "build_data", lambda r, n_, cfg: data)
    row = jmod.run_depth(2, 0, n, np.random.default_rng(11))
    ev = twd.evaluate(None, T_DEPTH, data)
    capsys.readouterr()
    assert ev == {k: row[k] for k in ("bf16_targets_matched", "median_margin", "variants")}
    assert row["variants"] == {
        name: twd.grade(base, got, [float(np.sort(l)[-1] - np.sort(l)[-2]) for l in bf16_lg],
                        [float(np.abs(q - b).mean()) for q, b in zip(lg, bf16_lg)])
        for name, (got, lg) in variants.items()}


def test_probe_prompt_matches_jax(jscripts, monkeypatch, capsys):
    """The JAX probe's 512 x 4096 prompt embeddings (captured at its
    batcher's submit) equal the port's bit for bit."""
    jmod = jscripts["probe_spec_divergence"]
    seen = []

    class Capture:
        def __init__(self, *a, **kw):
            pass

        def submit(self, rid, emb, gen):
            seen.append(np.asarray(emb.astype(jnp.float32)))
            raise StopIteration

    monkeypatch.setattr(jmod, "init_llama", lambda key, cfg: {})
    monkeypatch.setattr(jmod, "quantize_llama_params_int4", lambda p, **kw: p)
    monkeypatch.setattr(jmod, "ContinuousBatcher", Capture)
    with pytest.raises(StopIteration):
        jmod.main()
    got = tps.prompt_embeds(tllama.VICUNA_7B, "cpu")
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (1, 512, 4096)
    assert np.array_equal(got.float().numpy(), seen[0])


# ---------------------------------------------------------------------------
# fp32 arms: identical greedy tokens, margins within MARGIN_REL
# ---------------------------------------------------------------------------

def test_int8_fp32_arm_matches_jax(jscripts, qa_params, capsys):
    """The bf16 arm's protocol (encode, 608-token-shaped prompt, 16 greedy
    tokens, first-token margin) on the fp32 tiny model."""
    samples = tie.make_samples(2, TCFG)
    want, want_m = jscripts["int8_equivalence"].run_samples(qa_params, JCFG, samples, "fp32")
    got, got_m = _common.run_samples(_t(qa_params), TCFG, samples, "fp32")
    assert [list(map(int, a)) for a in want] == got
    _margins_close(got_m, want_m)


@pytest.fixture(scope="module")
def tome_base(jscripts, qa_params):
    """The unmerged fp32 arm on two smooth videos, by JAX."""
    samples = tte.make_samples(2, TCFG, video=True)
    return samples, jscripts["tome_equivalence"].run_samples(qa_params, JCFG, samples,
                                                             "unmerged")


@pytest.mark.parametrize("level", ["medium", "t_medium", "auto"])
def test_tome_fp32_arms_match_jax(jscripts, qa_params, tome_base, level, capsys):
    """A spatial level, a temporal level and the auto arm on the fp32 tiny
    model (dense: the merge arms' comparison, without the int8 codes)."""
    jmod = jscripts["tome_equivalence"]
    samples, (jbase, jbase_m) = tome_base
    tp = _t(qa_params)
    if level == "auto":
        jauto = dataclasses.replace(JCFG, vit=dataclasses.replace(JCFG.vit, merge_level="auto"))
        jcfg = lambda s: jst.resolve_auto_merge(jauto, s["frames"])
        chosen = {jtome.select_merge_level(s["frames"]) for s in samples}
        assert chosen - {"off"}, chosen      # the smooth videos do merge
    else:
        jcfg = dataclasses.replace(JCFG, vit=dataclasses.replace(
            JCFG.vit, **jtome.scale_level_to_depth(level, JCFG.vit.depth)))
    want, want_m = jmod.run_samples(qa_params, jcfg, samples, level)
    doc = tte.run(tp, TCFG, samples, samples[:1], only=level)   # a smooth "noise" arm
    got, got_m = _common.run_samples(
        tp, tte.level_cfg(TCFG, level) if level != "auto" else
        (lambda s: tst.resolve_auto_merge(dataclasses.replace(
            TCFG, vit=dataclasses.replace(TCFG.vit, merge_level="auto")), s["frames"])),
        samples, level)
    assert [list(map(int, a)) for a in want] == got
    _margins_close(got_m, want_m)
    assert level in doc["levels"]
    assert doc["levels"][level] == {**doc["levels"][level],
                                    **jmod.grade(jbase, jbase_m, want)}


def _jax_llama_pair(seed, cfg):
    jp = _perturb(jllama.init_llama(jax.random.PRNGKey(seed), cfg), seed + 1)
    return jp, _t(jp)


PROBE_LL = dict(vocab_size=61, hidden=64, num_layers=2, heads=4, intermediate=128,
                max_positions=256)


@pytest.fixture(scope="module")
def probe_models():
    jcfg = jllama.LlamaConfig(dtype=jnp.float32, **PROBE_LL)
    tcfg = tllama.LlamaConfig(dtype=torch.float32, **PROBE_LL)
    jd = dataclasses.replace(jcfg, num_layers=tps.DRAFT_LAYERS)
    return {"jcfg": jcfg, "tcfg": tcfg, "target": _jax_llama_pair(0, jcfg),
            "draft": _jax_llama_pair(9, jd),
            "dcfg": dataclasses.replace(tcfg, num_layers=tps.DRAFT_LAYERS)}


def _run_jax_probe(jmod, models, monkeypatch, force=None):
    """The JAX probe's main on the tiny fp32 pair (a 64-token prompt, 12 new
    tokens); ``force`` = (index, token) overwrites the speculative drain's
    token there, so the replay runs."""
    from stllm_tpu import serving as jserving

    keys = iter([models["target"][0], models["draft"][0]])

    class Batcher(jserving.ContinuousBatcher):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self._spec = kw.get("draft_params") is not None

        def run(self):
            out = super().run()
            if self._spec and force is not None:
                out[0] = list(out[0])
                out[0][force[0]] = force[1]
            return out

    monkeypatch.setattr(jmod, "VICUNA_7B", models["jcfg"])
    monkeypatch.setattr(jmod, "PROMPT", 64)
    monkeypatch.setattr(jmod, "NEW", 12)
    monkeypatch.setattr(jmod, "init_llama", lambda key, cfg: next(keys))
    monkeypatch.setattr(jmod, "quantize_llama_params_int4", lambda p, **kw: p)
    monkeypatch.setattr(jmod, "ContinuousBatcher", Batcher)
    jmod.main()


def test_probe_fp32_drains_match_jax(jscripts, probe_models, monkeypatch, capsys):
    """Plain and speculative drains of the fp32 pair: the same tokens as the
    JAX probe's (and no divergence: fp32 verify equals plain decode)."""
    _run_jax_probe(jscripts["probe_spec_divergence"], probe_models, monkeypatch)
    text = capsys.readouterr().out
    want_plain = json.loads(re.search(r"plain\[:16\]=(\[.*\])", text).group(1))
    want_spec = json.loads(re.search(r"spec \[:16\]=(\[.*\])", text).group(1))
    assert "first divergence at index: None" in text
    m = probe_models
    emb = tps.prompt_embeds(m["tcfg"], "cpu", 64)
    out = tps.run(m["target"][1], m["tcfg"], m["draft"][1], m["dcfg"], emb, new=12)
    assert out["plain"] == want_plain and out["spec"] == want_spec
    assert out["first_divergence"] is None and "spec_rank" not in out


def test_probe_replay_matches_jax(jscripts, probe_models, monkeypatch, capsys):
    """A divergence forced at index 5 (the same token on both sides): the
    replayed plain logits give the same top-1, the same rank of the
    speculative token, and the same margin and gap (printed to 5 decimals)."""
    m = probe_models
    emb = tps.prompt_embeds(m["tcfg"], "cpu", 64)
    plain = tps.drain(m["target"][1], m["tcfg"], emb, tps.gen_config(12))
    token = (plain[5] + 7) % PROBE_LL["vocab_size"]
    _run_jax_probe(jscripts["probe_spec_divergence"], m, monkeypatch, force=(5, token))
    text = capsys.readouterr().out
    assert "first divergence at index: 5" in text
    j = re.search(r"plain top1=(\d+) \(=(\d+)\), spec tok=(\d+) rank=(\d+), top1-top2 "
                  r"margin=([-\d.]+), top1-spec gap=([-\d.]+)", text).groups()
    got = tps.replay(m["target"][1], m["tcfg"], emb, plain, token, 5, 12)
    assert (got["top1"], got["spec_token"], got["spec_rank"]) == (int(j[0]), int(j[2]),
                                                                   int(j[3]))
    assert got["top1"] == plain[5] == int(j[1])
    assert 0.0 <= got["cache_floor"] < 1e-4     # fp32: a longer cache moves nothing
    assert 0.0 <= got["verify_shape_floor"] < 1e-4
    assert abs(got["top1_top2_margin"] - float(j[4])) <= 1e-5 + MARGIN_REL * float(j[4])
    assert abs(got["top1_spec_gap"] - float(j[5])) <= 1e-5 + MARGIN_REL * float(j[5])


# ---------------------------------------------------------------------------
# quantized arms: first-position logits within MEAN_REL
# ---------------------------------------------------------------------------

def _jax_convert(params, samples, stack):
    """The JAX script's conversion (script/int8_equivalence.py main), on a
    copy: free_dense=False, since JAX's deletes the shared fixture's
    buffers."""
    p = dict(params)
    p["vit"] = jvit.quantize_vit_params(p["vit"])
    calib = np.concatenate([s["frames"][0] for s in samples[:4]], axis=0)
    p["vit"] = jvit.calibrate_vit_scales(p["vit"], jnp.asarray(calib), JCFG.vit)
    if stack == "w4a16":
        p["llama"] = jllama.quantize_llama_params_int4(p["llama"], group=None,
                                                       quant_head=True, fuse=True)
    else:
        p["llama"] = jllama.quantize_llama_params(p["llama"])
    return p, dataclasses.replace(JCFG, llama=dataclasses.replace(JCFG.llama, kv_int8=True))


def _jax_video(params, cfg, sample):
    encode = jax.jit(functools.partial(jst.encode_img, cfg=cfg))
    return np.asarray(encode(params, jnp.asarray(sample["frames"]),
                             qformer_text_ids=jnp.asarray(sample["q_ids"]),
                             qformer_text_mask=jnp.asarray(sample["q_mask"])))


def _first_logits(gen, llama, cfg, embeds, mask):
    """The first answer position's logits: the 64-padded prompt's prefill."""
    e, m = gen._pad_prompt(embeds, mask, 64)
    return np.asarray(gen._prefill(llama, e, m, cfg, e.shape[1] + 16)[0][0])


@pytest.mark.parametrize("stack", ["int8", "w4a16"])
def test_quantized_first_logits_match_jax(qa_params, stack):
    """int8_equivalence's conversion (the static-int8 ViT calibrated on the
    first 4 samples, then the int8 or W4A16 LLaMA; tome_equivalence's
    baseline is the int8 one) against the JAX script's, on two samples: the
    static-int8 encode, and the quantized LLaMA's first-answer-position
    logits from the same prompt (prefix | JAX's video tokens | suffix).

    The whole chain is not compared: the two encodes differ by about 3e-6
    mean relative (summation order, exp2 ulps), and the int8 LLaMA's
    dynamic activation codes turn such a difference into flipped codes, so
    the same logits from each package's own encode differ by about 4e-3
    here. That is the int8 stack's sensitivity, which the encode and the
    LLaMA, held apart, each stay well inside of."""
    samples = tie.make_samples(4, TCFG)
    jp, jcfg = _jax_convert(qa_params, samples, stack)
    tp = _t(qa_params)
    tcfg = tie.convert(tp, TCFG, samples, stack)
    assert tcfg.llama.kv_int8 and "act_scales" in tp["vit"]["blocks"][0]
    d = TCFG.llama.hidden
    for s in samples[:2]:
        jv = _jax_video(jp, jcfg, s)
        tv = tst.encode_img(tp, torch.from_numpy(s["frames"]), tcfg, torch.from_numpy(s["q_ids"]),
                            torch.from_numpy(s["q_mask"]))
        assert _mean_rel(tv.numpy(), jv) < MEAN_REL
        embeds = np.concatenate([s["prefix"], jv.reshape(1, -1, d), s["suffix"]], 1)
        want = _first_logits(jgen, jp["llama"], jcfg.llama, jnp.asarray(embeds),
                             jnp.ones(embeds.shape[:2], jnp.int32))
        got = _first_logits(tgen, tp["llama"], tcfg.llama, torch.from_numpy(embeds),
                            torch.ones(embeds.shape[:2], dtype=torch.int32))
        assert _mean_rel(got, want) < MEAN_REL


def test_probe_w4_first_logits_match_jax(probe_models):
    """The probe's W4A16 conversion (fused, int8 head) against the JAX
    script's: prefill logits of the 64-token prompt."""
    m = probe_models
    jq = jllama.quantize_llama_params_int4(m["target"][0], group=None, quant_head=True,
                                           fuse=True)
    tq = tps.to_w4(_t(m["target"][0]))
    emb = tps.prompt_embeds(m["tcfg"], "cpu", 64)
    jemb = jnp.asarray(emb.float().numpy()).astype(jnp.bfloat16)
    want = jgen._prefill(jq, jemb, jnp.ones((1, 64), jnp.int32), m["jcfg"], 92)[0]
    got = tgen._prefill(tq, emb, torch.ones((1, 64), dtype=torch.int32), m["tcfg"], 92)[0]
    assert _mean_rel(got.numpy(), np.asarray(want)) < MEAN_REL


# ---------------------------------------------------------------------------
# training: three steps from the same weights
# ---------------------------------------------------------------------------

def test_depth_training_matches_jax(jscripts, capsys):
    """w4a16_depth's protocol: three steps of the answer CE with
    make_probe_optimizer (AdamW here) from the same weights and batches,
    then identical greedy answers; the port's evaluate grades every variant."""
    jmod = jscripts["w4a16_depth"]
    jp, tp = _jax_llama_pair(4, J_DEPTH)
    data = twd.build_data(np.random.default_rng(11), 4, T_DEPTH)
    tx = jstep.make_probe_optimizer(jp, lr=twd.LR)
    opt_state = tx.init(jp)
    step = jmod.make_step(J_DEPTH, tx)
    prompts = np.concatenate([d["prompt"] for d in data])
    answers = np.asarray([d["answer"] for d in data], np.int32)
    want = []
    for it in range(3):
        sel = np.arange(it * 4, (it + 1) * 4) % len(data)
        jp, opt_state, loss = step(jp, opt_state, jnp.asarray(prompts[sel]),
                                   jnp.asarray(answers[sel]))
        want.append(float(loss))
    got = twd.train(tp, T_DEPTH, data, 3)
    assert got["optimizer"] == "adamw"
    np.testing.assert_allclose(got["losses"], want, rtol=LOSS_RTOL, atol=LOSS_ATOL)
    for d in data:
        assert twd.greedy(tp, T_DEPTH, d["prompt"]) == list(
            map(int, jmod.greedy(jp, J_DEPTH, d["prompt"])))
    ev = twd.evaluate(tp, T_DEPTH, data)
    assert sorted(ev["variants"]) == sorted(twd.VARIANTS)
    for v in ev["variants"].values():
        assert sorted(v) == ["exact_16_match", "first_token_match",
                             "max_margin_flipped", "mean_abs_logit_err_first_pos"]
        assert all(np.isfinite(list(v.values())))


def test_trained_training_matches_jax(jscripts, capsys):
    """int8_equivalence_trained's protocol on the tiny proxy: three steps of
    the production train step, everything trainable, batches of 4 in the
    script's shuffled order, from the same weights; then identical greedy
    answers, and margins within MARGIN_REL from shared inputs: the port's
    forward on JAX's trained weights and prompt embeddings. The trained
    weights themselves part where AdamW normalizes a gradient near its eps
    (1e-8): there the fp32 backward's order of summation, which differs by
    host, moves the update by a visible share of the rate (1e-4 of the down
    projection's scale after three steps); an AdamW step from shared
    gradients is held in tests/test_torch_optim.py."""
    jmod = jscripts["int8_equivalence_trained"]
    # two blocks of 5 tokens: the training protocol, not the merge levels
    jcfg, tcfg = _trained_cfgs(vit=dict(image_size=28, patch_size=14, depth=2))
    jp = _perturb(_init_stllm(jcfg), 1)
    tp = _t(jp)
    jr, tr = np.random.default_rng(3), np.random.default_rng(3)
    jdata = jmod.build_dataset(jr, 4, jcfg)
    tdata = tit.build_dataset(tr, 4, tcfg, "cpu")
    opt = jstep.make_probe_optimizer(jp, lr=tit.LR)
    state = jstep.create_train_state(jp, opt, lambda path: True)
    step_fn = jax.jit(jstep.make_train_step(jcfg, opt))
    order, want = np.arange(4), []
    for _ in range(3):    # n = 4 is one batch an epoch: a reshuffle every step
        jr.shuffle(order)
        state, metrics = step_fn(state, jmod.stack_batches([jdata[i] for i in order[:4]]))
        want.append(float(metrics["loss"]))
    got = tit.train(tp, tcfg, tdata, 3, tr)
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL, atol=LOSS_ATOL)
    jp = jstep.merge_params(state.params, state.frozen)
    for js, ts in zip(jdata[:2], tdata[:2]):
        jans, jemb = jmod.greedy_answer(jp, js, jcfg)
        tans, temb = tit.greedy_answer(tp, ts, tcfg)
        assert tans == list(map(int, jans))
        assert _mean_rel(temb.numpy(), np.asarray(jemb)) < MEAN_REL
        _margins_close(tit.first_token_margin(_t(jp)["llama"], torch.from_numpy(np.array(jemb)),
                                              tcfg),
                       jmod.first_token_margin(jp["llama"], jemb, jcfg))


# ---------------------------------------------------------------------------
# whole harnesses through main, on the CPU at the tiny size
# ---------------------------------------------------------------------------

def _keys_and_finite(section, keys):
    assert set(keys) | {"device", "harness"} == set(section), sorted(section)
    for k in keys:
        if isinstance(section[k], (int, float)):
            assert np.isfinite(section[k]), k
    assert section["device"] == "cpu"


INT8_KEYS = ("metric", "n", "first_token_match", "exact_16_match", "mean_matched_prefix",
             "median_top2_margin_bf16", "max_margin_flipped",
             "first_token_match_above_median_margin", "quant_stack")


@pytest.mark.parametrize("stack", ["int8", "w4a16"])
def test_int8_main_writes_its_section(tmp_path, monkeypatch, capsys, stack):
    """main --cpu on the tiny model: the JAX result's keys plus device and
    harness, merged into an existing EQUIV_INT8.json."""
    out = tmp_path / "out"
    out.mkdir()
    (out / "EQUIV_INT8.json").write_text(json.dumps({"trained_model": {"n": 32}, "n": 100}))
    monkeypatch.setattr(tie, "make_cfg", lambda: TCFG)
    assert tie.main(["2", stack, "--cpu", "--out-dir", str(out)]) == 0
    doc = json.loads((out / "EQUIV_INT8.json").read_text())
    assert doc["trained_model"] == {"n": 32}
    if stack == "w4a16":
        assert doc["n"] == 100
        section = doc["w4a16_random_weights"]
    else:
        section = {k: v for k, v in doc.items() if k != "trained_model"}
    _keys_and_finite(section, INT8_KEYS)
    assert section["n"] == 2 and section["harness"] == tie.HARNESS


def test_tome_main_writes_its_document(tmp_path, monkeypatch, capsys):
    """main --cpu with a level filter: the baseline (2 smooth videos, 8
    noise ones) and the "mild" level, merged into an existing TOME_EQUIV.json
    whose other levels and trained section stay."""
    out = tmp_path / "out"
    out.mkdir()
    (out / "TOME_EQUIV.json").write_text(json.dumps(
        {"levels": {"t_mild": {"first_token_match": 0.5}}, "trained_levels": {"n": 1}}))
    monkeypatch.setattr(tte, "make_cfg", lambda: TCFG)
    assert tte.main(["2", "mild", "--cpu", "--out-dir", str(out)]) == 0
    doc = json.loads((out / "TOME_EQUIV.json").read_text())
    assert doc["trained_levels"] == {"n": 1}
    assert sorted(doc["levels"]) == ["mild", "t_mild"]
    _keys_and_finite({k: v for k, v in doc.items() if k not in ("levels", "trained_levels")},
                     ("metric", "n", "baseline_stack", "median_top2_margin_bf16_arm"))
    mild = doc["levels"]["mild"]
    assert sorted(mild) == ["exact_16_match", "first_token_match",
                            "first_token_match_above_median_margin", "max_margin_flipped",
                            "merge_schedule", "noise_frames"]
    assert mild["merge_schedule"] == [[1, 192], [3, 144]]


def test_depth_main_writes_its_section(tmp_path, monkeypatch, capsys):
    out = tmp_path / "out"
    monkeypatch.setattr(twd, "make_cfg", lambda depth: dataclasses.replace(
        T_DEPTH, num_layers=depth))
    assert twd.main(["2", "4", "1", "2", "--cpu", "--out-dir", str(out)]) == 0
    section = json.loads((out / "EQUIV_INT8.json").read_text())["w4a16_depth_scaling"]
    _keys_and_finite(section, ("model", "rows"))
    assert [r["depth"] for r in section["rows"]] == [1, 2]
    for r in section["rows"]:
        assert sorted(r) == ["bf16_targets_matched", "depth", "median_margin", "n",
                             "optimizer", "train_steps", "variants"]
        assert (r["n"], r["train_steps"], r["optimizer"]) == (4, 2, "adamw")
        assert sorted(r["variants"]) == sorted(twd.VARIANTS)


def test_trained_main_and_harvest(tmp_path, monkeypatch, capsys):
    """main --cpu on the tiny proxy (K = 256 and 512 for the g=128 arm):
    both documents' trained sections with the JAX keys, every level; the
    per-level lines of its output, harvested, give the same levels."""
    out = tmp_path / "out"
    _, tcfg = _trained_cfgs(hidden=256, intermediate=512)
    monkeypatch.setattr(tit, "build_cfg", lambda blocks, layers: dataclasses.replace(
        tcfg, vit=dataclasses.replace(tcfg.vit, depth=blocks),
        llama=dataclasses.replace(tcfg.llama, num_layers=layers)))
    assert tit.main(["2", "4", "4", "1", "--cpu", "--out-dir", str(out)]) == 0
    log = tmp_path / "trained.log"
    log.write_text(capsys.readouterr().out)
    equiv = json.loads((out / "EQUIV_INT8.json").read_text())
    assert sorted(equiv) == ["trained_model", "trained_model_w4a16", "trained_model_w4a16_g128",
                             "trained_model_w4a16_g64"]
    _keys_and_finite(equiv["trained_model"],
                     ("n", "first_token_match", "exact_16_match", "max_margin_flipped",
                      "train_steps", "bf16_answers_match_train_targets", "model", "int8_stack"))
    for name in ("w4a16", "w4a16_g128", "w4a16_g64"):
        _keys_and_finite(equiv["trained_model_" + name],
                         ("n", "first_token_match", "exact_16_match", "max_margin_flipped",
                          "w4_stack"))
    tome = json.loads((out / "TOME_EQUIV.json").read_text())["trained_levels"]
    _keys_and_finite(tome, ("model", "n_per_subset", "levels"))
    assert sorted(tome["levels"]) == sorted(k for k in jtome.MERGE_LEVELS if k != "off")
    for entry in tome["levels"].values():
        assert sorted(entry) == ["baseline", "iid_noise", "schedule_at_depth", "smooth_video"]
        assert entry["smooth_video"]["n"] == entry["iid_noise"]["n"] == 2
    harvested = tmp_path / "harvested"
    assert thv.main([str(log), "--cpu", "--out-dir", str(harvested)]) == 0
    again = json.loads((harvested / "TOME_EQUIV.json").read_text())["trained_levels"]
    assert again["levels"] == tome["levels"] and again["n_per_subset"] == 2
    assert again["device"] == "cpu" and "note" not in again


@pytest.mark.parametrize("pending", [True, False], ids=["pending", "complete"])
def test_harvest_matches_jax(tmp_path, monkeypatch, capsys, pending):
    """One synthetic log (junk lines, a half-written line, one level twice)
    through the JAX harvester (from a copy, writing its own TOME_EQUIV.json)
    and the port's, from the same existing document: the same document, the
    port's section adding device and harness."""
    levels = [k for k in jtome.MERGE_LEVELS if k != "off"]
    done = levels[:3] if pending else levels
    rng = np.random.default_rng(2)

    def entry(n):
        g = lambda: {"n": n, "first_token_match": float(rng.uniform()),
                     "exact_16_match": float(rng.uniform()), "max_margin_flipped": 0.0}
        return {"smooth_video": g(), "iid_noise": g(), "schedule_at_depth": {},
                "baseline": "trained int8 answers"}

    lines = ["training ...", json.dumps({"device": "cpu", "harness": tit.HARNESS}),
             json.dumps({"trained_model": {"n": 32}}), '{"mild": {"smooth_vi']
    lines += [json.dumps({k: entry(16 if i else 12)}) for i, k in enumerate(done)]
    lines += [json.dumps({done[0]: entry(16)}), "  step 50: loss 1.0"]
    log = tmp_path / "run.log"
    log.write_text("\n".join(lines) + "\n")
    seed = {"levels": {"mild": {}}, "trained_model_medium": {}, "trained_model_t_medium": {}}
    jroot, troot = tmp_path / "jax", tmp_path / "port"
    for root in (jroot, troot):
        root.mkdir()
        (root / "TOME_EQUIV.json").write_text(json.dumps(seed))
    jmod = _script("harvest_trained_levels", jroot)
    monkeypatch.setattr(sys, "argv", ["harvest_trained_levels.py", str(log)])
    assert jmod.main() == 0
    assert thv.main([str(log), "--cpu", "--out-dir", str(troot)]) == 0
    want = json.loads((jroot / "TOME_EQUIV.json").read_text())
    got = json.loads((troot / "TOME_EQUIV.json").read_text())
    assert got["trained_levels"].pop("device") == "cpu"
    assert got["trained_levels"].pop("harness") == thv.HARNESS
    assert got == want
    assert ("note" in got["trained_levels"]) == pending
    assert got["trained_levels"]["n_per_subset"] == 16


# ---------------------------------------------------------------------------
# the command lines
# ---------------------------------------------------------------------------

def test_every_cli_prints_its_help():
    """python -m for each module, as runpy runs it: --help exits 0 with the
    module's usage line."""
    code = ("import runpy, sys\n"
            f"for name in {list(MODULES)!r}:\n"
            "    sys.argv = [name, '--help']\n"
            "    try:\n"
            "        runpy.run_module('stllm_tpu_torch.evidence.' + name, run_name='__main__')\n"
            "    except SystemExit as e:\n"
            "        assert e.code == 0, (name, e.code)\n"
            "    else:\n"
            "        raise AssertionError(name + ' did not exit')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    for name in MODULES:
        assert f"usage: python -m stllm_tpu_torch.evidence.{name}" in r.stdout
    assert "--cpu" in r.stdout and "--out-dir" in r.stdout


@pytest.mark.parametrize("name", MODULES)
def test_cli_without_a_card_fails_with_a_message(monkeypatch, capsys, tmp_path, name):
    """No card and no --cpu: main returns 1 and says why, before any work
    (nothing is written)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = {"int8_equivalence": tie, "tome_equivalence": tte, "probe_spec_divergence": tps,
           "w4a16_depth": twd, "int8_equivalence_trained": tit,
           "harvest_trained_levels": thv}[name]
    argv = [] if name == "probe_spec_divergence" else ["--out-dir", str(tmp_path / "out")]
    assert mod.main(argv) == 1
    err = capsys.readouterr().err
    assert "no CUDA device is available; pass --cpu" in err
    assert not (tmp_path / "out").exists()
