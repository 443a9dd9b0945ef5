"""PyTorch port, checkpoints (stllm_tpu_torch/train/checkpoint.py) and the
Trainer's save, resume and profile window, on a tiny fp32 model on the CPU.

The port writes its own format (torch.save of flat {path: tensor} dicts),
so the round trips are held bit for bit against the port itself, and the
tree helpers (``flatten_tree`` paths, strict and non-strict
``unflatten_like``) against the JAX package's."""

import json
import os

import jax
import numpy as np
import pytest
import torch

from stllm_tpu.train import checkpoint as jckpt
from stllm_tpu_torch.common.optim import warmup_cosine_decay
from stllm_tpu_torch.data.collate import TrainCollator
from stllm_tpu_torch.models import llama as tllama
from stllm_tpu_torch.models import zoo as tzoo
from stllm_tpu_torch.train import checkpoint as tckpt
from stllm_tpu_torch.train.step import tree_paths
from stllm_tpu_torch.train.trainer import Trainer

MODEL_CFG = {
    "arch": "st_llm_hf", "model_type": "instructblip_vicuna0_btadapter", "dtype": "fp32",
    "video_input": "all", "btadapter_depth": 1, "use_mask": True, "mvm_decode": True,
    "max_txt_len": 8, "freeze_LLM": False,
    "vit": {"image_size": 28, "width": 32, "depth": 2, "heads": 2, "mlp_hidden": 64},
    "qformer": {"hidden": 16, "num_layers": 1, "heads": 2, "intermediate": 32,
                "encoder_width": 32, "num_query": 4, "vocab_size": 64},
    "llama": {"vocab_size": 97, "hidden": 32, "num_layers": 2, "heads": 2,
              "intermediate": 64, "max_positions": 128}}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: parallel test processes do not oversubscribe
    the cores, and CPU sums run in one fixed order."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _model(seed=0):
    return tzoo.STLLM.from_config(MODEL_CFG, seed=seed, device="cpu")


@pytest.fixture(scope="module")
def batches():
    model = _model()
    col = TrainCollator(model.cfg, tzoo.ToyHashTokenizer(97), tzoo.ToyHashTokenizer(64, reserve=2),
                        seq_multiple=16, seed=0)
    rng = np.random.default_rng(3)
    return [col([{"image": rng.integers(0, 256, (2, 28, 28, 3), dtype=np.uint8),
                  "instruction_input": f"###Human: <Video><ImageHere></Video> what {i} "
                                       "###Assistant:",
                  "answer": "a cat on the mat"[:6 + 2 * j]} for j in range(2)])
            for i in range(4)]


def _trainer(model, out, **kw):
    kw.setdefault("learning_rate", warmup_cosine_decay(0.0, 1e-3, 2, 4))
    return Trainer(model.cfg, model.params, output_dir=str(out), device="cpu",
                   trainable_fn=model.trainable_fn(), log_freq=1, **kw)


def _snapshot(state):
    return ({k: v.detach().clone() for k, v in state.params.items()},
            {k: v.clone() for k, v in state.opt_state["mu"].items()},
            {k: v.clone() for k, v in state.opt_state["nu"].items()},
            state.opt_state["count"], state.step)


def _assert_same(a, b):
    for da, db in zip(a[:3], b[:3]):
        assert set(da) == set(db)
        for k in da:
            assert torch.equal(da[k], db[k]), k
    assert a[3:] == b[3:]


def test_save_restore_round_trip_is_bit_exact(tmp_path, batches):
    """A restore into another model's state gives back every trainable leaf,
    both moments, ``count`` and the step bit for bit, written into the
    state's own tensors: ``state.tree`` (what the model reads) sees them."""
    tr = _trainer(_model(), tmp_path, save_freq=100)
    tr.train(iter(batches[:2]), 2)
    saved = _snapshot(tr.state)
    assert tr.ckpt.latest_step() == 2 and saved[3] == 2
    other = _trainer(_model(seed=5), tmp_path / "other")
    tensors = {k: v for k, v in other.state.params.items()}
    assert not all(torch.equal(tensors[k], saved[0][k]) for k in tensors)
    state = tckpt.CheckpointManager(str(tmp_path)).restore(other.state)
    assert state is other.state
    _assert_same(_snapshot(state), saved)
    tree = dict(tree_paths(state.tree))
    for k, v in state.params.items():
        assert v is tensors[k] and tree[k] is v
    payload = torch.load(tmp_path / "checkpoint_2" / "state.pt", weights_only=True)
    assert payload["meta"] == {"step": 2} and int(payload["opt_state"]["count"]) == 2
    assert set(payload["params"]) == set(state.params)     # trainable leaves only
    assert not set(payload["params"]) & set(state.frozen)


def test_resume_equals_uninterrupted(tmp_path, batches):
    """Two steps, then a new Trainer on a fresh model that resumes and takes
    two more, equals four straight steps bit for bit: the schedule goes on
    from the restored count."""
    straight = _trainer(_model(), tmp_path / "a", save_freq=100)
    straight.train(iter(batches), 4)
    first = _trainer(_model(), tmp_path / "b", save_freq=100)
    first.train(iter(batches[:2]), 2)
    second = _trainer(_model(), tmp_path / "b", save_freq=100)
    assert second.state.step == 0
    assert second.resume_if_available() == 2
    second.train(iter(batches[2:]), 4)
    _assert_same(_snapshot(second.state), _snapshot(straight.state))
    log = [json.loads(x) for x in (tmp_path / "b" / "log.txt").read_text().splitlines()]
    want = [json.loads(x) for x in (tmp_path / "a" / "log.txt").read_text().splitlines()]
    assert log == want and [r["step"] for r in log] == [1, 2, 3, 4]
    # resumed at the end, nothing is left to run
    third = _trainer(_model(), tmp_path / "b", save_freq=100)
    assert third.resume_if_available() == 4
    assert third.train(iter([]), 4)["loss"] == 0.0


def test_max_keep_prunes_and_eval_saves(tmp_path, batches):
    tr = _trainer(_model(), tmp_path, save_freq=1, max_keep=2)
    metric = iter([1.0, 0.5])
    tr.train(iter(batches), 4, eval_fn=lambda: next(metric), eval_freq=2, best_mode="max")
    assert sorted(os.listdir(tmp_path)) == ["best.json", "checkpoint_3", "checkpoint_4",
                                            "log.txt"]
    assert tr.ckpt.all_steps() == [3, 4]
    assert json.loads((tmp_path / "best.json").read_text()) == {"step": 2, "metric": 1.0}


def test_latest_step_ignores_a_half_written_checkpoint(tmp_path, batches, monkeypatch):
    tr = _trainer(_model(), tmp_path, save_freq=100)
    tr.train(iter(batches[:1]), 1)
    (tmp_path / "checkpoint_7").mkdir()                 # a directory with no state file
    (tmp_path / "checkpoint_x").mkdir()
    assert tr.ckpt.latest_step() == 1

    def killed(obj, path, *a, **k):
        with open(path, "wb") as f:
            f.write(b"partial")
        raise OSError("no space left mid-save")

    monkeypatch.setattr(tckpt.torch, "save", killed)
    with pytest.raises(OSError):
        tr.train(iter(batches[1:2]), 2)
    monkeypatch.undo()
    assert not (tmp_path / "checkpoint_2").exists()
    assert tr.ckpt.latest_step() == 1
    fresh = _trainer(_model(), tmp_path)
    assert fresh.resume_if_available() == 1


def test_tree_helpers_match_jax_strict_and_not():
    rng = np.random.default_rng(0)
    tree = {"llama": {"layers": [{"q": {"w": rng.standard_normal((2, 3)).astype(np.float32)}},
                                 {"q": {"w": rng.standard_normal((2, 3)).astype(np.float32),
                                        "b": None}}],
                      "norm": {"scale": np.ones(3, np.float32)}},
            "llama_proj": {"w": np.zeros((3, 2), np.float32)}}
    ttree = jax.tree_util.tree_map(torch.from_numpy, tree)
    # the same paths (JAX lists dict keys sorted, the port in insertion order)
    assert set(tckpt.flatten_tree(ttree)) == set(jckpt.flatten_tree(tree))
    part = {k: v for k, v in jckpt.flatten_tree(tree).items() if "norm" not in k}
    tpart = {k: torch.from_numpy(v) + 1 for k, v in part.items()}
    with pytest.raises(KeyError):
        jckpt.unflatten_like(tree, part)
    with pytest.raises(KeyError):
        tckpt.unflatten_like(ttree, tpart)
    want = jckpt.unflatten_like(tree, {k: v + 1 for k, v in part.items()}, strict=False)
    got = tckpt.unflatten_like(ttree, tpart, strict=False)
    assert got["llama"]["layers"][1]["q"]["b"] is None
    assert got["llama"]["norm"]["scale"] is ttree["llama"]["norm"]["scale"]
    jflat, tflat = jckpt.flatten_tree(want), tckpt.flatten_tree(got)
    assert set(jflat) == set(tflat)
    for k in jflat:
        np.testing.assert_array_equal(tflat[k].numpy(), jflat[k])


def test_strict_restore_raises_on_a_missing_leaf(tmp_path, batches):
    tr = _trainer(_model(), tmp_path, save_freq=100)
    tr.train(iter(batches[:1]), 1)
    lora = _model()
    lora.params["llama"]["layers"][0]["q_lora"] = {"a": torch.zeros(32, 2), "b": torch.zeros(2, 32)}
    other = _trainer(lora, tmp_path / "x")
    with pytest.raises(KeyError):
        tr.ckpt.restore(other.state)


def test_serving_round_trip_keeps_codes_and_layout(tmp_path):
    """int4 codes and their scales (the fused per-channel tree with its int8
    head) and int8 ``w_q`` come back bit for bit in their dtypes, ``w_q``
    column-major."""
    cfg = tllama.LlamaConfig(vocab_size=97, hidden=64, num_layers=2, heads=4, intermediate=128,
                             dtype=torch.bfloat16)
    dense = tllama.init_llama(torch.Generator().manual_seed(0), cfg)
    for name, tree in (
            ("w4", tllama.quantize_llama_params_int4(dense, group=None, fuse=True,
                                                     quant_head=True)),
            ("w8", tllama.quantize_llama_params(tllama.init_llama(
                torch.Generator().manual_seed(1), cfg)))):
        tckpt.save_serving_params(str(tmp_path / name), tree)
        template = jax.tree_util.tree_map(torch.zeros_like, tree)
        back = tckpt.load_serving_params(str(tmp_path / name), template)
        want, got = tckpt.flatten_tree(tree), tckpt.flatten_tree(back)
        assert set(want) == set(got)
        for k in want:
            assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
        wq = [v for k, v in got.items() if k.endswith("/w_q")]
        assert (name == "w8") == bool(wq) and all(t.stride(0) == 1 for t in wq)
        if name == "w4":
            assert got["layers/0/qkv/w4"].dtype in (torch.int8, torch.uint8)
            assert got["lm_head/w_q16"].dtype == torch.int8


def test_profile_window_writes_a_trace(tmp_path, batches):
    tr = _trainer(_model(), tmp_path, profile_dir=str(tmp_path / "prof"), profile_steps=(1, 2))
    tr.train(iter(batches[:3]), 3)
    traces = os.listdir(tmp_path / "prof")
    assert traces == ["trace_steps_1_2.json"]
    trace = json.loads((tmp_path / "prof" / traces[0]).read_text())
    assert trace["traceEvents"]
