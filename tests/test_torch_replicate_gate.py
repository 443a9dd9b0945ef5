"""The port's MVBench replication gate (stllm_tpu_torch/replicate_mvbench.py):
its dry run on the CPU with the markers of tests/test_replicate_gate.py,
the same dry run with its clip read from memory where no cv2 writes one,
and the goldens of its parity stage shared with the JAX script's: on one
tiny LLaMA, goldens recorded by either package verify in the other, and
fail against another model."""

import importlib.util
import os
import subprocess
import sys
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from stllm_tpu.models import llama as jllama
from stllm_tpu_torch import replicate_mvbench as trep
from stllm_tpu_torch.convert.from_jax import load_jax_params
from stllm_tpu_torch.models import llama as tllama

REPO = Path(__file__).resolve().parent.parent
MARKERS = ("[replicate:convert] OK",
           "[replicate:parity] OK",
           "Total Acc",
           "arm 2/3: --tome auto",
           "arm 3/3: --serving-slots 2",
           "[replicate:done] all stages passed")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Tiny eager models: one intra-op thread, so parallel test processes
    do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_port_dryrun_all_arms(tmp_path):
    pytest.importorskip("cv2")
    env = dict(os.environ, TMPDIR=str(tmp_path), OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-m", "stllm_tpu_torch.replicate_mvbench",
                        "--dry-run", "--cpu"],
                       cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    out = r.stdout + r.stderr
    assert r.returncode == 0, out[-4000:]
    for marker in MARKERS:
        assert marker in out, (marker, out[-4000:])
    assert "recorded goldens: top1 agreement 1.000" in out
    assert "Scene Transition: " in out and "2 samples (task Scene Transition)" in out


def test_port_dryrun_reads_the_clip_from_memory_without_cv2(monkeypatch, capsys):
    """Where cv2 does not import (the card's machine), the dry run writes
    no mp4 and the harness reads the same frames from memory; every stage
    and arm still runs."""
    monkeypatch.setattr(trep, "cv2_available", lambda: False)
    assert trep.main(["--dry-run", "--cpu"]) == 0
    out = capsys.readouterr().out
    for marker in MARKERS:
        assert marker in out, marker
    assert "no mp4 is written, the harness reads the clip's frames from memory" in out


def _jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_replicate_mvbench", REPO / "script" / "replicate_mvbench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


LCFG = dict(vocab_size=97, hidden=32, num_layers=2, heads=2, intermediate=64, max_positions=64)


def _models(seed):
    jcfg = jllama.LlamaConfig(dtype=jax.numpy.float32, **LCFG)
    jparams = jllama.init_llama(jax.random.PRNGKey(seed), jcfg)
    tparams = load_jax_params(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    jmodel = types.SimpleNamespace(params={"llama": jparams},
                                   cfg=types.SimpleNamespace(llama=jcfg))
    tmodel = types.SimpleNamespace(params={"llama": tparams},
                                   cfg=types.SimpleNamespace(
                                       llama=tllama.LlamaConfig(dtype=torch.float32, **LCFG)))
    return jmodel, tmodel


def _args(**kw):
    base = dict(skip_golden_suite=True, record_golden=None, golden=None,
                parity_llama=False, llama=None)
    return types.SimpleNamespace(**{**base, **kw})


@pytest.mark.parametrize("recorder", ["jax", "port"])
def test_goldens_verify_across_the_packages(tmp_path, recorder, capsys):
    jrep = _jax_script()
    jmodel, tmodel = _models(0)
    stages = {"jax": (jrep.stage_parity, jmodel), "port": (trep.stage_parity, tmodel)}
    record, model = stages[recorder]
    verify, other = stages["port" if recorder == "jax" else "jax"]
    path = str(tmp_path / "goldens.npz")
    assert record(_args(record_golden=path), model)
    rec = np.load(path)
    assert sorted(rec.files) == ["input_ids", "logits"]
    assert rec["input_ids"].dtype == np.int32 and rec["input_ids"].shape == (4, 16)
    assert rec["logits"].dtype == np.float32 and rec["logits"].shape == (4, 97)
    capsys.readouterr()
    assert verify(_args(golden=path), other)
    assert "recorded goldens: top1 agreement 1.000" in capsys.readouterr().out
    # a model of another seed fails against them
    jbad, tbad = _models(1)
    assert not verify(_args(golden=path), tbad if recorder == "jax" else jbad)
    assert "FAIL — converted model diverges" in capsys.readouterr().out
