"""The port's launchers (stllm_tpu_torch/launch/, the 17 shell scripts that
mirror script/inference/{mvbench,qabench,vcgbench}/*.sh, script/train/
train.sh and script/replicate_mvbench.sh), on the CPU.

Each launcher is run by bash with ``python`` replaced by a stand-in that
records its arguments, beside its JAX counterpart run the same way. Held:
every JAX launcher has its port launcher and the other way round; the port
runs ``python -m stllm_tpu_torch.<module>`` with the JAX launcher's flags
and values (the port's qabench adds ``--batch-videos``); its command line
parses with the port module's own parser; and no launcher of the port names
the JAX package."""

import argparse
import os
import stat
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "stllm_tpu_torch" / "launch"
JAX = REPO / "script"
LAUNCHERS = sorted(str(p.relative_to(PORT)) for p in PORT.rglob("*.sh"))
# what the launchers read from the environment
ENV = {"CKPT": "/ckpt/stllm.pth", "MVBENCH_JSON": "/data/mvbench/json",
       "MVBENCH_DATA": "/data/mvbench/video", "GT_FILE": "/data/gt.json",
       "VIDEO_DIR": "/data/videos", "OPENAI_API_KEY": "sk-test", "BATCH_VIDEOS": "2"}


def _jax_counterpart(rel: str) -> Path:
    return JAX / rel


def _argv(script: Path, tmp_path: Path, *extra: str):
    """The arguments ``script`` passes to python, with a stand-in python
    first on PATH."""
    bindir = tmp_path / "bin"
    bindir.mkdir(exist_ok=True)
    fake = bindir / "python"
    out = tmp_path / "argv"
    fake.write_text(f"#!/bin/sh\nprintf '%s\\0' \"$@\" > {out}\n")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    env = dict(os.environ, **ENV, PATH=f"{bindir}:{os.environ['PATH']}")
    r = subprocess.run(["bash", str(script), *extra], cwd=REPO, env=env, capture_output=True,
                       text=True, timeout=60)
    assert r.returncode == 0, r.stderr
    return out.read_bytes().decode().split("\0")[:-1]


def test_every_launcher_has_its_counterpart():
    jax_side = sorted(str(p.relative_to(JAX)) for p in
                      list(JAX.glob("inference/*/*.sh")) + [JAX / "train" / "train.sh",
                                                           JAX / "replicate_mvbench.sh"])
    assert LAUNCHERS == jax_side and len(LAUNCHERS) == 17
    for rel in LAUNCHERS:
        assert os.access(PORT / rel, os.X_OK), rel


class _Parsed(Exception):
    pass


def _parse_with_port(module: str, args, monkeypatch):
    """``args`` through the port module's own argparse parser, its main
    stopped right after parsing."""
    import importlib

    mod = importlib.import_module(module)
    if hasattr(mod, "parse_args"):
        return mod.parse_args(args)
    real = argparse.ArgumentParser.parse_args

    def parse(self, a=None, namespace=None):
        raise _Parsed(real(self, a, namespace))

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", parse)
    monkeypatch.setattr(sys, "argv", [module, *args])
    with pytest.raises(_Parsed) as e:
        mod.main()
    return e.value.args[0]


@pytest.mark.parametrize("rel", LAUNCHERS)
def test_launcher_runs_the_port_with_the_jax_flags(rel, tmp_path, monkeypatch):
    port = _argv(PORT / rel, tmp_path, "--extra", "1")
    text = (PORT / rel).read_text()
    assert "stllm_tpu." not in text and "python -m stllm_tpu_torch." in text
    jax_argv = _argv(_jax_counterpart(rel), tmp_path, "--extra", "1")
    assert port[0] == "-m" and port[1].startswith("stllm_tpu_torch.")
    if rel == "replicate_mvbench.sh":        # the JAX gate runs its script by path
        assert jax_argv[0] == "script/replicate_mvbench.py"
        assert port[1] == "stllm_tpu_torch.replicate_mvbench" and port[2:] == jax_argv[1:]
        args = port[2:]
        args.remove("--extra")
        args.remove("1")
        ns = _parse_with_port(port[1], args + ["--dry-run"], monkeypatch)
        assert ns.dry_run
        return
    assert jax_argv[:2] == ["-m", port[1].replace("stllm_tpu_torch.", "stllm_tpu.", 1)]
    rest = port[2:]
    if port[1] == "stllm_tpu_torch.evalharness.qabench":
        i = rest.index("--batch-videos")
        assert rest[i + 1] == ENV["BATCH_VIDEOS"]
        rest = rest[:i] + rest[i + 2:]
    assert rest == jax_argv[2:]
    args = port[2:-2]                        # the launcher's own flags, without "$@"
    ns = _parse_with_port(port[1], args, monkeypatch)
    for flag, value in zip(args, args[1:]):
        if flag.startswith("--") and not value.startswith("--"):
            assert str(getattr(ns, flag[2:].replace("-", "_"))) == value, flag
    if port[1] == "stllm_tpu_torch.evalharness.qabench":
        assert ns.batch_videos == int(ENV["BATCH_VIDEOS"])
