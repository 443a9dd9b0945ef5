"""The port's probe harnesses and serving A/B (stllm_tpu_torch/timing/:
probe_decode_budget, probe_w4_unpack, probe_w4_call_fusion,
bench_serving_ab) against the JAX scripts they come from, on the CPU.

Each JAX script is loaded by path with every ``pallas_call`` in interpret
mode (as tests/test_torch_w4.py loads the probes), its module constants set
to tiny shapes beside the port's. Held: the decode skeleton's chunk output
of every variant from the same codes and input (a mean relative gap under
MEAN_REL: both round each matmul's input to bf16 and sum in fp32 in their
own order); every unpack variant bit for bit on exact inputs; each fusion
arm's step output; the documents' keys; the A/B's order and its two trees
with the runner replaced. The probes' times are the card's, in
chip_smoke.py's ``timing`` phase."""

import hashlib
import importlib.util
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stllm_tpu_torch.ops import kernels
from stllm_tpu_torch.timing import bench_serving_ab as tab
from stllm_tpu_torch.timing import probe_decode_budget as tpdb
from stllm_tpu_torch.timing import probe_w4_call_fusion as tpf
from stllm_tpu_torch.timing import probe_w4_unpack as tpu

REPO = Path(__file__).resolve().parent.parent
MEAN_REL = 1e-2
# the decode skeleton at a size every JAX tiling takes: K 1024 and 1536
HID, FFN = 1024, 1536


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def root_files():
    """SHA-256 of every JSON document at the repository root before the
    module runs (as tests/test_torch_timing.py's check): no harness of this
    file writes there."""
    return _root_hashes()


def _root_hashes():
    return {p.name: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(REPO.glob("*.json"))}


@pytest.fixture(scope="module")
def probes():
    """The three probe scripts as modules, every pallas_call in interpret
    mode while this file's tests run."""
    mods = {}
    for name in ("probe_decode_budget", "probe_w4_unpack", "probe_w4_call_fusion"):
        spec = importlib.util.spec_from_file_location(f"jax_probe_{name}",
                                                      REPO / "script" / f"{name}.py")
        mods[name] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mods[name])
    real = mods["probe_w4_unpack"].pl.pallas_call

    def interpret(*args, **kw):
        return real(*args, **{**kw, "interpret": True})

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mods["probe_w4_unpack"].pl, "pallas_call", interpret)
        yield mods
    jax.clear_caches()


def _mean_rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).mean() / np.abs(want).mean())


def _np(t):
    return t.contiguous().numpy()


# ---------------------------------------------------------------------------
# probe_decode_budget
# ---------------------------------------------------------------------------

@pytest.fixture
def tiny_budget(monkeypatch, probes):
    jmod = probes["probe_decode_budget"]
    shapes = [("q", HID, HID), ("k", HID, HID), ("v", HID, HID), ("o", HID, HID),
              ("gate", HID, FFN), ("up", HID, FFN), ("down", FFN, HID)]
    for mod in (jmod, tpdb):
        for name, value in (("HID", HID), ("FFN", FFN), ("LAYERS", 1), ("STEPS", 1),
                            ("SHAPES", shapes)):
            monkeypatch.setattr(mod, name, value)
    return jmod


def _jax_layers(variant, layers):
    """The port's weights in the JAX script's storage: the same codes."""
    def leaf(p):
        if "n" in p:
            return p
        return {k: jnp.asarray(_np(v)) for k, v in p.items()}
    return [{name: leaf(p) for name, p in layer.items()} for layer in layers]


@pytest.mark.parametrize("variant", tpdb.VARIANTS)
def test_decode_budget_chunk_matches_jax(tiny_budget, variant):
    """A one-step chunk of the one-layer skeleton, the JAX script's
    ``make_step`` under ``lax.scan`` (run op by op: jitted, XLA rounds the
    fused bf16 glue otherwise and the int8 arm's dynamic codes move) against
    the port's ``make_chunk``, from the same codes and the script's input
    draw."""
    jmod = tiny_budget
    layers = tpdb.build(variant, "cpu")
    x = np.random.default_rng(0).normal(size=(1, HID))
    got = tpdb.make_chunk(variant, layers)(torch.from_numpy(x).to(torch.bfloat16))
    with jax.disable_jit():       # op by op: a jitted step fuses the bf16 glue
        want, _ = jax.lax.scan(jmod.make_step(variant, _jax_layers(variant, layers)),
                               jnp.asarray(x, jnp.bfloat16), (), length=1)
    assert got.dtype == torch.bfloat16
    assert _mean_rel(got.float().numpy(), np.asarray(want.astype(jnp.float32))) < MEAN_REL
    assert float(got.float().abs().mean()) > 0


def test_check_w4v3_departs_from_the_script(probes):
    """The script's check holds a bf16-x product to an fp32-x one and fails
    on its own interpret-mode run (0.733 > 2e-2); the port's compares like
    with like and passes, and its #13 equals the script's on those inputs."""
    jmod = probes["probe_decode_budget"]
    with pytest.raises(AssertionError, match="0.73"):
        jmod.check_w4v3()
    assert tpdb.check_w4v3("cpu") < 2e-2
    rng = np.random.default_rng(1)
    top = rng.integers(-7, 8, size=(1024, 512)).astype(np.int8)
    bottom = rng.integers(-7, 8, size=(1024, 512)).astype(np.int8)
    scale = rng.uniform(0.5, 2.0, size=(512,)).astype(np.float32)
    x = rng.normal(size=(3, 2048)).astype(np.float32)
    packed = jmod.pack_arith(top, bottom)
    np.testing.assert_array_equal(
        _np(kernels.pack_int4_arith(torch.from_numpy(top), torch.from_numpy(bottom))), packed)
    want = np.asarray(jmod.w4v3_matmul(jnp.asarray(x), jnp.asarray(packed), jnp.asarray(scale)))
    got = kernels.w4v3_matmul(torch.from_numpy(x), torch.from_numpy(packed),
                              torch.from_numpy(scale)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def test_decode_budget_main_on_cpu(tiny_budget, tmp_path, capsys, root_files):
    """main over two variants: a document with every variant's eager times
    and counts (no graph on the CPU); nothing written at the root."""
    out = tmp_path / "out"
    assert tpdb.main(["null", "w4v3", "--cpu", "--out-dir", str(out)]) == 0
    doc = json.loads((out / tpdb.DOC).read_text())
    assert doc["device"] == "cpu" and doc["harness"] == tpdb.HARNESS
    assert sorted(doc["variants"]) == ["null", "w4v3"]
    for v in doc["variants"].values():
        assert len(v["eager_call_s"]) == tpdb.CALLS and v["eager_ms_per_token"] > 0
        assert "graph_ms_per_token" not in v
    assert doc["variants"]["w4v3"]["matmuls_per_step"] == 7
    assert doc["w4v3_check_max_rel_err"] < 2e-2
    assert tpdb.expected_launches(["w4v3"], 4, "cpu") == {}
    assert tpdb.expected_launches(list(tpdb.VARIANTS), 2, "cuda") == {
        "w4v3_matmul": 1 + 5 * 7, "w8p_matmul": 5 * 7, "w4a16_matmul": 5 * 11}
    assert _root_hashes() == root_files


# ---------------------------------------------------------------------------
# probe_w4_unpack
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", kernels.W4_UNPACK_VARIANTS)
def test_unpack_variant_bit_exact_against_jax(probes, monkeypatch, variant):
    """The script's layouts byte for byte, and its kernel (interpret mode,
    two K tiles) against the port's #15 bit for bit on the exact inputs."""
    jmod = probes["probe_w4_unpack"]
    m, k, n = 16, 1024, 256
    for name, value in (("M", m), ("K", k), ("N", n)):
        monkeypatch.setattr(jmod, name, value)
    t, b = tpu.codes(0, k, n)
    packed = kernels.pack_int4_variant(variant, t, b)
    jt, jb = jnp.asarray(_np(t)), jnp.asarray(_np(b))
    jpacked = (jmod.pack_biased if variant in kernels.BIASED_VARIANTS else jmod.pack_plain)(jt, jb)
    np.testing.assert_array_equal(_np(packed), np.asarray(jpacked))
    x = tpu.exact_x(m, k)
    one, _ = jmod.build(variant, 256, 256)
    want = np.asarray(one(jnp.asarray(x.float().numpy(), jnp.bfloat16), jpacked))
    got = kernels.w4_unpack_matmul(x, packed, variant)
    np.testing.assert_array_equal(got.numpy(), want)


def test_unpack_main_on_cpu(monkeypatch, tmp_path, root_files):
    for name, value in (("M", 16), ("K", 512), ("N", 256)):
        monkeypatch.setattr(tpu, name, value)
    out = tmp_path / "out"
    assert tpu.main(["--reps", "2", "--cpu", "--out-dir", str(out)]) == 0
    doc = json.loads((out / tpu.DOC).read_text())
    assert doc["all_bit_exact"] and doc["forms"] == ["plain"]
    assert sorted(doc["variants"]) == sorted(kernels.W4_UNPACK_VARIANTS)
    assert all(v["bit_exact"] and v["max_abs_err"] == 0.0 for v in doc["variants"].values())
    assert tpu.expected_launches(30, "cpu") == 0 and tpu.expected_launches(30, "cuda") == 121
    assert _root_hashes() == root_files


# ---------------------------------------------------------------------------
# probe_w4_call_fusion
# ---------------------------------------------------------------------------

def test_call_fusion_arms_match_jax(probes, monkeypatch, capsys):
    """The script's main with its timer replaced by one step of each arm:
    the same four arms, in order, and each arm's step output from the same
    draws (the input first, then the weights)."""
    jmod = probes["probe_w4_call_fusion"]
    for mod in (jmod, tpf):
        for name, value in (("D", HID), ("FFN", FFN), ("STEPS", 2)):
            monkeypatch.setattr(mod, name, value)
    seen = []
    monkeypatch.setattr(jmod, "bench", lambda name, step_fn, x0, iters=30: seen.append(
        (name, np.asarray(step_fn(x0).astype(jnp.float32)))))
    jmod.main()
    x0, w = tpf.inputs("cpu")
    arms = tpf.arms(w)
    assert [n for n, _ in seen] == list(arms) == list(tpf.CALLS)
    for name, want in seen:
        assert _mean_rel(arms[name](x0).float().numpy(), want) < MEAN_REL, name
    r = tpf.run("cpu", iters=1)
    assert sorted(r["arms"]) == sorted(tpf.CALLS) and r["launches"] == 0
    assert tpf.expected_launches(30, "cuda") == (1 + 33 * 2) * 9


# ---------------------------------------------------------------------------
# bench_serving_ab
# ---------------------------------------------------------------------------

def _fake_doc(tree, k):
    return {"tokens_per_s": 100.0 + k, "sampled_mix_tokens_per_s": 80.0 + k,
            "drain_s": [1.0, 1.1], "sampled_mix_drain_s": [1.2, 1.3], "tree": str(tree)}


def test_serving_ab_runs_parent_change_change_parent(tmp_path):
    """Four runs in the order P, C, C, P, each in its own tree and output
    directory with bench_serving's command line; the section keeps every
    run's document and both ratios of the arms' bests."""
    parent = tmp_path / "parent"
    (parent / "stllm_tpu_torch" / "timing").mkdir(parents=True)
    (parent / "stllm_tpu_torch" / "timing" / "bench_serving.py").write_text("")
    calls = []

    def runner(tree, cmd, out_dir):
        calls.append((tree, cmd, out_dir))
        return _fake_doc(tree, len(calls))

    sec = tab.ab(parent, 6, 3, cpu=True, runner=runner)
    assert [c[0] for c in calls] == [parent, tab.CHANGE, tab.CHANGE, parent]
    assert len({c[2] for c in calls}) == 4
    for _, cmd, out_dir in calls:
        assert cmd[1:] == ["-m", tab.BENCH, "6", "3", "--out-dir", str(out_dir), "--cpu"]
    assert sec["order"] == list(tab.ORDER)
    assert sec["parent_tokens_per_s"] == 104.0 and sec["change_tokens_per_s"] == 103.0
    assert sec["ratio_change_over_parent"] == 103.0 / 104.0
    assert sec["sampled_mix_ratio_change_over_parent"] == 83.0 / 84.0
    assert [r["tree"] for r in sec["parent_runs"]] == [str(parent)] * 2
    assert len(sec["change_runs"]) == 2
    with pytest.raises(FileNotFoundError):
        tab.ab(tmp_path, 6, 3, cpu=True, runner=runner)


def test_serving_ab_main_writes_its_section(monkeypatch, tmp_path, root_files):
    """main with a given parent tree and the runner replaced: the "ab"
    section merged beside the document's other keys, stamped."""
    parent = tmp_path / "parent"
    (parent / "stllm_tpu_torch" / "timing").mkdir(parents=True)
    (parent / "stllm_tpu_torch" / "timing" / "bench_serving.py").write_text("")
    out = tmp_path / "out"
    out.mkdir()
    (out / tab.DOC).write_text(json.dumps({"tokens_per_s": 1.0}))
    calls = []
    monkeypatch.setattr(tab, "run_bench", lambda tree, cmd, o: calls.append(tree) or _fake_doc(
        tree, len(calls)))
    assert tab.main(["4", "2", "--parent-tree", str(parent), "--cpu",
                     "--out-dir", str(out)]) == 0
    doc = json.loads((out / tab.DOC).read_text())
    assert doc["tokens_per_s"] == 1.0
    assert doc["ab"]["harness"] == tab.HARNESS and doc["ab"]["parent"] == str(parent)
    assert len(calls) == 4 and parent.exists()
    assert _root_hashes() == root_files


def test_probe_clis_help_and_no_card(monkeypatch, capsys, tmp_path):
    for mod in (tpdb, tpu, tpf, tab):
        with pytest.raises(SystemExit) as e:
            mod.main(["--help"])
        assert e.value.code == 0
        out = capsys.readouterr().out
        assert f"usage: python -m {mod.HARNESS}" in out and "timing_out" in out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for mod in (tpdb, tpu, tpf, tab):
        assert mod.main(["--out-dir", str(tmp_path / "out")]) == 1
        assert "no CUDA device is available; pass --cpu" in capsys.readouterr().err
    assert not (tmp_path / "out").exists()
