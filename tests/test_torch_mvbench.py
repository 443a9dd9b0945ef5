"""PyTorch port, the MVBench harness (stllm_tpu_torch/evalharness/mvbench.py)
and ``encode_img_mapped`` against the JAX package on one synthetic checkpoint:
JAX params from the reference's init converted by load_jax_params, the
synthetic two-task MVBench layout of tests/test_evalharness.py (an mp4 task
with bounds, a frame-directory task), fp32, toy tokenizers. Predictions and
the result JSON must be identical through all three routes (per sample,
batched, the continuous QA server, including its per-sample path for an
over-long prompt); encodes agree within 1e-5."""

import json
import subprocess
import sys
import zlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stllm_tpu.conversation import Chat as JChat
from stllm_tpu.evalharness import mvbench as jmv
from stllm_tpu.models import stllm as jst
from stllm_tpu.models.llama import LlamaConfig as JLlama
from stllm_tpu.models.qformer import QFormerConfig as JQF
from stllm_tpu.models.vit import ViTConfig as JViT
from stllm_tpu_torch.conversation import Chat as TChat
from stllm_tpu_torch.convert.from_jax import load_jax_params
from stllm_tpu_torch.evalharness import mvbench as tmv
from stllm_tpu_torch.models import stllm as tst
from stllm_tpu_torch.models.llama import LlamaConfig as TLlama
from stllm_tpu_torch.models.qformer import QFormerConfig as TQF
from stllm_tpu_torch.models.vit import ViTConfig as TViT


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Tiny eager models: one intra-op thread, so parallel test processes
    do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


REPO = Path(__file__).resolve().parent.parent

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


@pytest.fixture(scope="module")
def chats():
    jp = jst.init_stllm(jax.random.PRNGKey(0), JCFG)
    tp = load_jax_params(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    jchat = JChat(jp, JCFG, ToyTokenizer(), qformer_tokenizer=ToyTokenizer(64), image_size=28)
    tchat = TChat(tp, TCFG, ToyTokenizer(), qformer_tokenizer=ToyTokenizer(64), image_size=28)
    return jchat, tchat


@pytest.fixture(scope="module")
def bench_dir(tmp_path_factory):
    """tests/test_evalharness.py's layout: Task A, two bounded questions on
    one mp4 (64x64, 50 frames at 10 fps); Task B, one question on twelve
    jpg frames."""
    import cv2

    root = tmp_path_factory.mktemp("mvb")
    anno = root / "json"
    anno.mkdir()
    media = root / "media"
    (media / "vids").mkdir(parents=True)
    (media / "frames" / "clip1").mkdir(parents=True)
    vw = cv2.VideoWriter(str(media / "vids" / "a.mp4"), cv2.VideoWriter_fourcc(*"mp4v"), 10,
                         (64, 64))
    for i in range(50):
        vw.write(np.full((64, 64, 3), 20 + 4 * i, np.uint8))
    vw.release()
    for i in range(1, 13):
        cv2.imwrite(str(media / "frames" / "clip1" / f"{i:05d}.jpg"),
                    np.full((64, 64, 3), 10 * i, np.uint8))
    (anno / "taskA.json").write_text(json.dumps([
        {"video": "a.mp4", "question": "what color?", "candidates": ["red", "green", "blue"],
         "answer": "green", "start": 1.0, "end": 4.0},
        {"video": "a.mp4", "question": "how many?", "candidates": ["one", "two"],
         "answer": "one", "start": 0.0, "end": 5.0},
    ]))
    (anno / "taskB.json").write_text(json.dumps([
        {"video": "clip1", "question": "what moves?", "candidates": ["cat", "dog"],
         "answer": "dog"},
    ]))
    data_list = {"Task A": ("taskA.json", "vids/", "video", True),
                 "Task B": ("taskB.json", "frames/", "frame", False)}
    return str(anno), str(media), data_list


def _datasets(bench_dir):
    anno, media, data_list = bench_dir
    return (jmv.MVBenchDataset(anno, media, data_list, num_segments=4, resolution=28),
            tmv.MVBenchDataset(anno, media, data_list, num_segments=4, resolution=28,
                               device="cpu"))


@pytest.mark.parametrize("b,question", [(1, "ids"), (3, None), (3, "ids"), (3, "ids+mask")])
def test_encode_img_mapped_matches_jax(chats, b, question):
    """encode_img_mapped (videos one at a time) equals JAX's lax.map form and
    the port's own encode_img, with and without question ids (a ragged
    mask, or the default of ones)."""
    (jchat, tchat) = chats
    rng = np.random.default_rng(b)
    frames = rng.integers(0, 256, (b, 4, 28, 28, 3)).astype(np.uint8)
    ids = mask = None
    if question:
        ids = rng.integers(2, 64, (b, 5)).astype(np.int32)
        if question == "ids+mask":
            mask = np.ones((b, 5), np.int32)
            mask[1, 3:] = 0
    args = lambda f: [None if a is None else f(a) for a in (ids, mask)]  # noqa: E731
    want = jst.encode_img_mapped(jchat.params, jnp.asarray(frames), JCFG,
                                 *args(jnp.asarray))
    got = tst.encode_img_mapped(tchat.params, torch.from_numpy(frames), TCFG,
                                *args(torch.from_numpy))
    assert tuple(got.shape) == (b, 4, 4, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    whole = tst.encode_img(tchat.params, torch.from_numpy(frames), TCFG, *args(torch.from_numpy))
    np.testing.assert_allclose(got.numpy(), whole.numpy(), atol=1e-5, rtol=0)


def test_dataset_matches_jax(bench_dir):
    """The port's dataset gives the JAX one's items: questions, answers and
    tasks exactly, frames within one uint8 step, and the same summary."""
    jds, tds = _datasets(bench_dir)
    assert len(tds) == len(jds) == 3
    for i in range(3):
        j, t = jds[i], tds[i]
        assert {k: j[k] for k in ("question", "answer", "task_type", "video_path")} == \
            {k: t[k] for k in ("question", "answer", "task_type", "video_path")}
        assert t["video"].dtype == np.uint8 and t["video"].shape == j["video"].shape
        assert np.abs(t["video"].astype(int) - j["video"].astype(int)).max() <= 1
    assert str(tds) == str(jds)
    assert tds[0]["answer"] == "(B) green" and tds[0]["video"].shape == (4, 28, 28, 3)


def _samples(bench_dir):
    jds, _ = _datasets(bench_dir)
    return [jds[i] for i in range(3)]


@pytest.mark.parametrize("ask_simple", [False, True])
def test_infer_mvbench_matches_jax(bench_dir, chats, ask_simple):
    jchat, tchat = chats
    for s in _samples(bench_dir):
        want = jmv.infer_mvbench(jchat, s, ask_simple=ask_simple, max_new_tokens=6)
        got = tmv.infer_mvbench(tchat, s, ask_simple=ask_simple, max_new_tokens=6)
        assert got == want and got.startswith("(")


@pytest.mark.parametrize("ask_simple", [False, True])
def test_infer_mvbench_batch_matches_jax(bench_dir, chats, ask_simple):
    """Same-length Task A pair (different prompt lengths, right-padded) and
    the whole split: equal to JAX's batch and to the port's per-sample
    route."""
    jchat, tchat = chats
    samples = _samples(bench_dir)[:2]
    want = jmv.infer_mvbench_batch(jchat, samples, ask_simple=ask_simple, max_new_tokens=6)
    got = tmv.infer_mvbench_batch(tchat, samples, ask_simple=ask_simple, max_new_tokens=6)
    assert got == want
    assert got == [tmv.infer_mvbench(tchat, s, ask_simple=ask_simple, max_new_tokens=6)
                   for s in samples]


@pytest.mark.parametrize("ask_simple,max_len,overlong",
                         [(False, 256, 0), (True, 256, 0), (False, 32, 3)])
def test_infer_mvbench_serving_matches_jax(bench_dir, chats, ask_simple, max_len, overlong):
    """More samples than slots, in completion order; at max_len 32 every
    prompt is over-long and all three run the per-sample path, counted."""
    jchat, tchat = chats
    samples = _samples(bench_dir)
    kw = dict(slots=2, max_len=max_len, chunk=4, ask_simple=ask_simple, max_new_tokens=6)
    want = [(ex["question"], p) for ex, p in jmv.infer_mvbench_serving(jchat, samples, **kw)]
    stats = {}
    got = [(ex["question"], p) for ex, p in tmv.infer_mvbench_serving(tchat, samples,
                                                                      stats=stats, **kw)]
    assert got == want
    assert stats.get("overlong", 0) == overlong
    per_sample = {s["question"]: tmv.infer_mvbench(tchat, s, ask_simple=ask_simple,
                                                   max_new_tokens=6) for s in samples}
    assert dict(got) == per_sample


@pytest.mark.parametrize("route", [dict(), dict(batch_size=2), dict(serving_slots=2),
                                   dict(ask_simple=True, serving_slots=2,
                                        serving_max_len=256)])
def test_run_mvbench_json_matches_jax(bench_dir, chats, tmp_path, route):
    """run_mvbench through each route writes the JAX package's result JSON
    byte for byte (each package reads and transforms its own frames)."""
    jchat, tchat = chats
    jds, tds = _datasets(bench_dir)
    want = jmv.run_mvbench(jchat, jds, output_dir=str(tmp_path / "j"), output_name="r",
                           verbose=False, **route)
    got = tmv.run_mvbench(tchat, tds, output_dir=str(tmp_path / "t"), output_name="r",
                          verbose=False, **route)
    assert got == want
    assert (tmp_path / "t" / "r.json").read_text() == (tmp_path / "j" / "r.json").read_text()
    assert sum(v[1] for k, v in got["acc_dict"].items() if k != "Total Acc") == 3


@pytest.mark.parametrize("pred,gt", [("(b) green", "(B) green."), ("(B)", "(b) green"),
                                     ("(a) red", "(b) green"), ("b. something", "(b) green"),
                                     ("(C) blue", "(C) blue"), ("", "(A) x")])
def test_check_ans_matches_jax(pred, gt):
    assert tmv.check_ans(pred, gt) == jmv.check_ans(pred, gt)


def test_prompts_and_template_match_jax():
    for data in ({"question": "Q?", "candidates": ["x", "y"], "answer": "y"},
                 {"question": "Which?", "candidates": ["a", "b", "c", "d"], "answer": "a"}):
        assert tmv.MVBenchDataset.qa_template(data) == jmv.MVBenchDataset.qa_template(data)
    assert tmv.MVBenchDataset.qa_template(
        {"question": "Q?", "candidates": ["x", "y"], "answer": "y"}) == \
        ("Question: Q?\nOptions:\n(A) x\n(B) y", "(B) y")
    for ap in (tmv.ANSWER_PROMPT, None):
        assert tmv.mvbench_prompt(tmv.SYSTEM, "QTEXT", ap) == jmv.mvbench_prompt(
            jmv.SYSTEM, "QTEXT", ap)
    assert tmv.DATA_LIST == jmv.DATA_LIST
    assert (tmv.SYSTEM, tmv.QUESTION_PROMPT, tmv.ANSWER_PROMPT, tmv.RETURN_PROMPT) == \
        (jmv.SYSTEM, jmv.QUESTION_PROMPT, jmv.ANSWER_PROMPT, jmv.RETURN_PROMPT)


def test_cli_runs_on_the_cpu(bench_dir, tmp_path):
    """``python -m stllm_tpu_torch.evalharness.mvbench --cpu`` on a tiny
    YAML: random weights, toy tokenizers, every sample scored."""
    anno, media, data_list = bench_dir
    # the CLI reads the reference table's names: Task A is an "Action
    # Sequence" (bounded mp4) task
    fname, prefix = data_list["Task A"][:2]
    real_json, real_prefix = tmv.DATA_LIST["Action Sequence"][:2]
    Path(anno, real_json).write_text(Path(anno, fname).read_text())
    Path(media, real_prefix).parent.mkdir(parents=True, exist_ok=True)
    Path(media, real_prefix.rstrip("/")).symlink_to(Path(media, prefix.rstrip("/")))
    cfg = tmp_path / "tiny.yaml"
    cfg.write_text(json.dumps({"model": {
        "arch": "st_llm_hf", "model_type": "instructblip_vicuna0_btadapter", "dtype": "fp32",
        "video_input": "all", "btadapter_depth": 1,
        "vit": {"image_size": 28, "width": 32, "depth": 2, "heads": 2, "mlp_hidden": 64},
        "qformer": {"hidden": 16, "num_layers": 1, "heads": 2, "intermediate": 32,
                    "encoder_width": 32, "num_query": 4, "vocab_size": 64},
        "llama": {"vocab_size": 97, "hidden": 32, "num_layers": 1, "heads": 2,
                  "intermediate": 64}}}))
    out = tmp_path / "out"
    proc = subprocess.run(
        [sys.executable, "-m", "stllm_tpu_torch.evalharness.mvbench", "--cfg-path", str(cfg),
         "--anno-path", anno, "--data-root", media, "--num-frames", "4",
         "--specified_item", "Action Sequence", "--output_dir", str(out), "--output_name", "r",
         "--cpu"], cwd=REPO, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-2000:]
    result = json.loads((out / "r.json").read_text())
    assert "Total Acc" in result["acc_dict"] and len(result["res_list"]) == 2


class _Built(Exception):
    """Raised in place of building the model: the CLI got as far as that."""


def _cli_model_cfg(monkeypatch, zoo_cls, main, argv) -> dict:
    """The model section ``main`` hands to ``from_config`` for ``argv``."""
    seen = {}

    def capture(model_cfg, *args, **kw):
        seen.update(model_cfg)
        raise _Built

    monkeypatch.setattr(zoo_cls, "from_config", capture)
    monkeypatch.setattr(sys, "argv", ["mvbench", *argv])
    with pytest.raises(_Built):
        main()
    return seen


def test_cli_options_reach_model_cfg(tmp_path, monkeypatch):
    """``--options`` dotlist overrides reach the model section in the
    port's CLI as in the JAX CLI (the tiny YAML sets use_flash False and
    max_txt_len 32)."""
    from stllm_tpu.models import zoo as jzoo
    from stllm_tpu_torch.models import zoo as tzoo

    argv = ["--cfg-path", str(REPO / "config" / "tiny_debug.yaml"), "--anno-path",
            str(tmp_path), "--output_dir", str(tmp_path / "out"), "--output_name", "r", "--cpu",
            "--options", "model.vit.use_flash=True", "model.max_txt_len=64"]
    got = _cli_model_cfg(monkeypatch, tzoo.STLLM, tmv.main, argv)
    want = _cli_model_cfg(monkeypatch, jzoo.STLLM, jmv.main, argv)
    assert got["vit"]["use_flash"] is True and got["max_txt_len"] == 64
    assert got == want
