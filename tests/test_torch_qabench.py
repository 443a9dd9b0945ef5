"""PyTorch port, the open-ended VideoQA / VCG-Bench harness and the GPT
judges (stllm_tpu_torch/evalharness/{qabench,gpt_eval}.py) against the JAX
package on one synthetic checkpoint: JAX params converted by
load_jax_params, fp32, the crc32 toy tokenizer, three clips written with
cv2 (tests/test_evalharness.py's). Beam 2, at most 12 new tokens an answer
(both packages' Chat capped by a subclass: the harnesses take no token
budget). Predictions equal the JAX harness's, sequential equals
``batch_videos=2``, and the judge harness gives JAX's prompts, files and
scores."""

import json
import os
import subprocess
import sys
import threading
import zlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stllm_tpu.conversation import CONV_instructblip_Vicuna0 as JCONV, Chat as JChat
from stllm_tpu.evalharness import gpt_eval as jgpt, qabench as jqa
from stllm_tpu.models import stllm as jst
from stllm_tpu.models.llama import LlamaConfig as JLlama
from stllm_tpu.models.qformer import QFormerConfig as JQF
from stllm_tpu.models.vit import ViTConfig as JViT
from stllm_tpu_torch.conversation import CONV_instructblip_Vicuna0 as TCONV, Chat as TChat
from stllm_tpu_torch.convert.from_jax import load_jax_params
from stllm_tpu_torch.evalharness import gpt_eval as tgpt, qabench as tqa
from stllm_tpu_torch.models import stllm as tst
from stllm_tpu_torch.models.llama import LlamaConfig as TLlama
from stllm_tpu_torch.models.qformer import QFormerConfig as TQF
from stllm_tpu_torch.models.vit import ViTConfig as TViT

REPO = Path(__file__).resolve().parent.parent
MAX_NEW = 12
VIT = dict(image_size=28, patch_size=14, width=32, depth=2, heads=2, mlp_hidden=64,
           use_flash=False)
QF = dict(hidden=16, num_layers=2, heads=2, intermediate=32, encoder_width=32, num_query=4,
          vocab_size=64)
LL = dict(vocab_size=4096, hidden=32, num_layers=2, heads=2, intermediate=64,
          max_positions=2048)
TOP = dict(video_input="residual", residual_size=2)
JCFG = jst.STLLMConfig(vit=JViT(dtype=jnp.float32, **VIT), qformer=JQF(dtype=jnp.float32, **QF),
                       llama=JLlama(dtype=jnp.float32, **LL), **TOP)
TCFG = tst.STLLMConfig(vit=TViT(dtype=torch.float32, **VIT),
                       qformer=TQF(dtype=torch.float32, **QF),
                       llama=TLlama(dtype=torch.float32, **LL), **TOP)


class ToyTokenizer:
    """The JAX harness tests' crc32 word tokenizer."""

    def __init__(self, vocab=4096):
        self.vocab = vocab
        self.rev = {}

    def encode(self, text, add_special_tokens=False):
        ids = [1] if add_special_tokens else []
        for w in text.split(" "):
            t = 10 + (zlib.crc32(w.encode()) % (self.vocab - 10))
            self.rev[t] = w
            ids.append(t)
        return ids

    def decode(self, ids):
        return " ".join(self.rev.get(int(t), "<unk>") for t in ids if t > 1)


def _capped(chat_cls):
    """``chat_cls`` with every answer capped at MAX_NEW tokens."""

    class Capped(chat_cls):
        def answer(self, *args, **kw):
            return super().answer(*args, **{**kw, "max_new_tokens": MAX_NEW})

        def answer_batched(self, *args, **kw):
            return super().answer_batched(*args, **{**kw, "max_new_tokens": MAX_NEW})

    return Capped


@pytest.fixture(scope="module")
def chats():
    jp = jst.init_stllm(jax.random.PRNGKey(0), JCFG)
    tp = load_jax_params(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return (_capped(JChat)(jp, JCFG, ToyTokenizer(), qformer_tokenizer=ToyTokenizer(64),
                           image_size=28),
            _capped(TChat)(tp, TCFG, ToyTokenizer(), qformer_tokenizer=ToyTokenizer(64),
                           image_size=28))


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    """Three 64x64 mp4 clips of 30 frames (gradients from 30, 90, 160) and
    the VideoQA, VCG-Bench general and consistency annotation files."""
    import cv2

    root = tmp_path_factory.mktemp("qa")
    vdir = root / "videos"
    vdir.mkdir()
    for n, base in (("v1", 30), ("v2", 90), ("v3", 160)):
        vw = cv2.VideoWriter(str(vdir / f"{n}.mp4"), cv2.VideoWriter_fourcc(*"mp4v"), 10,
                             (64, 64))
        for i in range(30):
            vw.write(np.full((64, 64, 3), base + 2 * i, np.uint8))
        vw.release()
    qs = ((1, "what is shown?"), (2, "what changes over time?"), (3, "describe the scene"))
    files = {
        "videoqa": [{"video_name": f"v{i}", "question_id": f"q{i}", "question": q,
                     "answer": "x"} for i, q in qs]
        + [{"video_name": "missing", "question_id": "q9", "question": "?", "answer": "x"}],
        "general": [{"video_name": f"v{i}.mp4", "Q": q, "A": "y"} for i, q in qs[:2]],
        "consistency": [{"video_name": "v3", "Q1": "what is it?", "Q2": "what is this?",
                         "A": "z"}],
    }
    for name, rows in files.items():
        (root / f"{name}.json").write_text(json.dumps(rows))
    return root


def test_find_video_matches_jax(bench):
    vdir = str(bench / "videos")
    for name in ("v1", "v1.mp4", "v1.avi", "missing"):
        assert tqa._find_video(vdir, name) == jqa._find_video(vdir, name)
    assert tqa.VIDEO_FORMATS == jqa.VIDEO_FORMATS


def test_run_videoqa_matches_jax_and_batched(chats, bench, tmp_path):
    """Sequential and batch_videos=2 (three samples: a full group and the
    final partial flush) give the same records as the JAX harness; the
    missing video is skipped; the JSON is written."""
    jchat, tchat = chats
    args = (str(bench / "videoqa.json"), str(bench / "videos"))
    want = jqa.run_videoqa(jchat, JCONV, *args, str(tmp_path / "j"), "msvd", num_frames=4,
                           num_beams=2, verbose=False)
    seq = tqa.run_videoqa(tchat, TCONV, *args, str(tmp_path / "s"), "msvd", num_frames=4,
                          num_beams=2, verbose=False)
    bat = tqa.run_videoqa(tchat, TCONV, *args, str(tmp_path / "b"), "msvd", num_frames=4,
                          num_beams=2, verbose=False, batch_videos=2)
    assert seq == want and bat == want
    assert [r["id"] for r in seq] == ["q1", "q2", "q3"] and any(r["pred"] for r in seq)
    assert json.loads((tmp_path / "b" / "msvd.json").read_text()) == want


def test_vcgbench_general_and_consistency_match_jax(chats, bench, tmp_path):
    jchat, tchat = chats
    for bench_name, jrun, trun in (("general", jqa.run_vcgbench_general,
                                    tqa.run_vcgbench_general),
                                   ("consistency", jqa.run_vcgbench_consistency,
                                    tqa.run_vcgbench_consistency)):
        args = (str(bench / f"{bench_name}.json"), str(bench / "videos"))
        want = jrun(jchat, JCONV, *args, str(tmp_path / "j"), bench_name, num_frames=4,
                    num_beams=2, verbose=False)
        got = trun(tchat, TCONV, *args, str(tmp_path / "t"), bench_name, num_frames=4,
                   num_beams=2, verbose=False)
        assert got == want
        assert json.loads((tmp_path / "t" / f"{bench_name}.json").read_text()) == want


def _qa_sets():
    return {"q": "Q", "a": "A", "pred": "P", "q1": "1", "q2": "2", "pred1": "x", "pred2": "y"}


def test_rubric_prompts_match_jax():
    assert sorted(tgpt.RUBRICS) == sorted(jgpt.RUBRICS) and len(tgpt.RUBRICS) == 6
    for name, r in tgpt.RUBRICS.items():
        j = jgpt.RUBRICS[name]
        assert (r.name, r.system, r.has_pred) == (j.name, j.system, j.has_pred)
        assert r.user_template(_qa_sets()) == j.user_template(_qa_sets())
    user = tgpt.RUBRICS["correctness"].user_template(_qa_sets())
    assert "Question: Q\n" in user and user.endswith("{''score': 4.8}.")


def _judge(calls, lock):
    def judge(messages):
        with lock:
            calls.append(messages)
        qa = messages[1]["content"]
        score = 2 + len(qa) % 4
        return f"{{'pred': '{'yes' if score > 3 else 'no'}', 'score': {score}}}"
    return judge


@pytest.mark.parametrize("rubric", ["activitynet_qa", "correctness", "consistency"])
def test_fake_judge_scores_match_jax(tmp_path, rubric):
    """The same fake judge through both harnesses: the same prompts, the
    same per-sample files and the same scores; a re-run judges nothing."""
    if rubric == "consistency":
        preds = [{"video_name": f"v{i}", "Q1": f"q{i}", "Q2": f"r{i}", "A": "a",
                  "pred1": "b" * i, "pred2": "c"} for i in range(4)]
    else:
        preds = [{"id": f"s{i}", "question": f"q{i}", "answer": "a", "pred": "p" * i}
                 for i in range(5)]
    pf = tmp_path / "preds.json"
    pf.write_text(json.dumps(preds))
    res, calls = {}, {}
    for pkg in (jgpt, tgpt):
        calls[pkg] = []
        out = tmp_path / pkg.__name__
        res[pkg] = pkg.evaluate(rubric, str(pf), str(out), _judge(calls[pkg], threading.Lock()),
                                output_json=str(tmp_path / f"{pkg.__name__}.json"), workers=1)
        assert sorted(os.listdir(out)) == [f"{k}.json" for k in sorted(
            pkg.build_prediction_set(str(pf), pkg.RUBRICS[rubric]))]
    assert res[tgpt] == res[jgpt] and res[tgpt]["count"] == len(preds)
    assert calls[tgpt] == calls[jgpt]
    assert (json.loads((tmp_path / f"{tgpt.__name__}.json").read_text())
            == json.loads((tmp_path / f"{jgpt.__name__}.json").read_text()))
    n = len(calls[tgpt])
    tgpt.evaluate(rubric, str(pf), str(tmp_path / tgpt.__name__),
                  _judge(calls[tgpt], threading.Lock()))
    assert len(calls[tgpt]) == n


def test_judge_retries_a_failed_sample_on_threads(tmp_path):
    """The thread pool keeps the resumable retry rounds: a judge call that
    fails once is retried next round, and no .tmp file is left."""
    preds = [{"id": f"s{i}", "question": "q", "answer": "a", "pred": "a"} for i in range(6)]
    pf = tmp_path / "preds.json"
    pf.write_text(json.dumps(preds))
    failed, lock = [], threading.Lock()

    def flaky(messages):
        with lock:
            if not failed:
                failed.append(True)
                raise RuntimeError("transient judge error")
        return "{'pred': 'yes', 'score': 5}"

    res = tgpt.evaluate("activitynet_qa", str(pf), str(tmp_path / "ann"), flaky, workers=4)
    assert res == {"count": 6, "average_score": 5.0, "accuracy": 1.0, "yes_count": 6,
                   "no_count": 0}
    assert not [f for f in os.listdir(tmp_path / "ann") if f.endswith(".tmp")]


def test_cli_runs_on_the_cpu(bench, tmp_path):
    """``python -m stllm_tpu_torch.evalharness.qabench --cpu`` on a tiny
    YAML (random weights, toy tokenizers) answers every present video with
    --batch-videos 2; a --ckpt-path that names a file which is no
    checkpoint fails the run (torch.load refuses it), as in the
    reference."""
    cfg = tmp_path / "tiny.yaml"
    cfg.write_text(json.dumps({"model": {
        "arch": "st_llm_hf", "model_type": "instructblip_vicuna0_btadapter", "dtype": "fp32",
        "video_input": "all", "btadapter_depth": 1,
        "vit": {"image_size": 28, "width": 32, "depth": 2, "heads": 2, "mlp_hidden": 64},
        "qformer": {"hidden": 16, "num_layers": 1, "heads": 2, "intermediate": 32,
                    "encoder_width": 32, "num_query": 4, "vocab_size": 64},
        "llama": {"vocab_size": 97, "hidden": 32, "num_layers": 1, "heads": 2,
                  "intermediate": 64}}}))
    base = [sys.executable, "-m", "stllm_tpu_torch.evalharness.qabench", "--cfg-path", str(cfg),
            "--gt_file", str(bench / "videoqa.json"), "--video_dir", str(bench / "videos"),
            "--output_dir", str(tmp_path / "out"), "--output_name", "r", "--num-frames", "4",
            "--num-beams", "2", "--batch-videos", "2", "--cpu"]
    proc = subprocess.run(base, cwd=REPO, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-2000:]
    result = json.loads((tmp_path / "out" / "r.json").read_text())
    assert [r["id"] for r in result] == ["q1", "q2", "q3"]
    assert all(isinstance(r["pred"], str) for r in result)
    proc = subprocess.run(base + ["--ckpt-path", str(cfg)], cwd=REPO, capture_output=True,
                          text=True, timeout=240)
    assert proc.returncode != 0 and "Weights only load failed" in proc.stderr


class _Built(Exception):
    """Raised in place of building the model: the CLI got as far as that."""


def _cli_model_cfg(monkeypatch, zoo_cls, main, argv) -> dict:
    """The model section ``main`` hands to ``from_config`` for ``argv``."""
    seen = {}

    def capture(model_cfg, *args, **kw):
        seen.update(model_cfg)
        raise _Built

    monkeypatch.setattr(zoo_cls, "from_config", capture)
    monkeypatch.setattr(sys, "argv", ["qabench", *argv])
    with pytest.raises(_Built):
        main()
    return seen


def test_cli_options_reach_model_cfg(tmp_path, monkeypatch):
    """``--options`` dotlist overrides reach the model section in the
    port's CLI as in the JAX CLI (the tiny YAML sets use_flash False and
    max_txt_len 32)."""
    from stllm_tpu.models import zoo as jzoo
    from stllm_tpu_torch.models import zoo as tzoo

    argv = ["--cfg-path", str(REPO / "config" / "tiny_debug.yaml"), "--gt_file",
            str(tmp_path / "gt.json"), "--video_dir", str(tmp_path), "--output_dir",
            str(tmp_path / "out"), "--output_name", "r", "--cpu",
            "--options", "model.vit.use_flash=True", "model.max_txt_len=64"]
    got = _cli_model_cfg(monkeypatch, tzoo.STLLM, tqa.main, argv)
    want = _cli_model_cfg(monkeypatch, jzoo.STLLM, jqa.main, argv)
    assert got["vit"]["use_flash"] is True and got["max_txt_len"] == 64
    assert got == want
