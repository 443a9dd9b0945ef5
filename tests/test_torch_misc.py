"""PyTorch port, the common pieces of the config-driven path and the rest of
the data helpers against the JAX package: the registry, Config with
``cfg_dict`` and its validator, the logging and rank helpers, io_utils,
randaugment, synth, and the runner (stllm_tpu_torch/runners/runner_base.py).

Tolerances: configs, registry lists, op picks, synthetic frames and file
contents exactly; the pointwise augmentation ops and Equalize bit for bit;
Sharpness and the warpAffine ops (Shear, Translate, Rotate) within one
uint8 step on all but 0.5% of the values; the runner's learning rate
optax's value to float32 rounding (1e-6 relative, 1e-6 of the peak
absolute); the runner's losses the port's own Trainer.train on the same
batches, exactly (the same code on the same device)."""

import json
import logging
import pickle
import socket
import types

import numpy as np
import pytest
import torch

import stllm_tpu.common.optim  # noqa: F401  (registers the JAX schedulers)
import stllm_tpu.runners  # noqa: F401
import stllm_tpu.tasks  # noqa: F401
import stllm_tpu.train.step as jstep
import stllm_tpu.train.trainer as jtrainer
from stllm_tpu.common import config as jconfig
from stllm_tpu.common import io_utils as jio
from stllm_tpu.common.registry import Registry as JRegistry
from stllm_tpu.data import randaugment as jra
from stllm_tpu.data import synth as jsynth
from stllm_tpu_torch.common import config as tconfig
from stllm_tpu_torch.common import io_utils as tio
from stllm_tpu_torch.common import logging as tlog
from stllm_tpu_torch.common.registry import Registry as TRegistry
from stllm_tpu_torch.data import randaugment as tra
from stllm_tpu_torch.data import synth as tsynth
from stllm_tpu_torch.data.packing import pack_training_batch
from stllm_tpu_torch.runners import RunnerBase
from stllm_tpu_torch.tasks import base_task as tbase
from stllm_tpu_torch.tasks import setup_task
from stllm_tpu_torch.train import checkpoint as tckpt
from stllm_tpu_torch.train.step import make_optimizer
from stllm_tpu_torch.train.trainer import Trainer


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# registry, config, logging
# ---------------------------------------------------------------------------

def test_registry_namespaces_and_values():
    import stllm_tpu_torch.data.builders  # noqa: F401
    import stllm_tpu.data.builders  # noqa: F401

    assert TRegistry.list_tasks() == JRegistry.list_tasks()
    assert TRegistry.list_runners() == JRegistry.list_runners() == ["runner_base"]
    assert sorted(TRegistry._maps["dataset_builder"]) == ["cc_sbu", "cc_sbu_align", "laion"]
    assert TRegistry.get_runner_class("runner_base") is RunnerBase
    assert TRegistry.get("MAX_INT") == JRegistry.get("MAX_INT") == 2**31 - 1
    assert TRegistry.get("SPLIT_NAMES") == ["train", "val", "test"]
    root = TRegistry.get_path("library_root")
    assert root.endswith("stllm_tpu_torch") and TRegistry.get_path("repo_root") == \
        JRegistry.get_path("repo_root")
    assert TRegistry.get_path("no_such_path", "d") == "d" and TRegistry.get("nothing") is None

    class A:
        pass

    class B:
        pass

    try:
        TRegistry.register_task("_test_force")(A)
        TRegistry.register_task("_test_force")(A)          # the same object again: fine
        with pytest.raises(KeyError, match="already registered"):
            TRegistry.register_task("_test_force")(B)
        TRegistry._register("task", "_test_force", B, force=True)
        assert TRegistry.get_task_class("_test_force") is B
    finally:
        TRegistry._maps["task"].pop("_test_force", None)


def _runner_cfg(tmp_path, **run):
    return {
        "model": {
            "arch": "st_llm_hf", "model_type": "instructblip_vicuna0",
            "dtype": "fp32", "use_mask": False,
            "vit": {"image_size": 28, "patch_size": 14, "width": 32, "depth": 2, "heads": 2,
                    "mlp_hidden": 64, "use_flash": False},
            "qformer": {"hidden": 16, "num_layers": 2, "heads": 2, "intermediate": 32,
                        "encoder_width": 32, "num_query": 4, "vocab_size": 64},
            "llama": {"vocab_size": 97, "hidden": 32, "num_layers": 2, "heads": 2,
                      "intermediate": 64, "max_positions": 256},
        },
        "run": {"task": "video_text_it", "max_epoch": 1, "iters_per_epoch": 2,
                "batch_size_train": 2, "init_lr": 1e-3, "output_dir": str(tmp_path),
                "log_freq": 1, "num_workers": 1, **run},
        "datasets": {},
    }


def test_config_merges_as_jax(tmp_path):
    d = _runner_cfg(tmp_path)
    got, want = tconfig.Config(cfg_dict=d), jconfig.Config(cfg_dict=d)
    assert got.to_dict() == want.to_dict()
    assert got.model_cfg["num_query_token"] == 32      # from the model type's default YAML
    path = "config/instructblipbase_stllm_qa.yaml"
    opts = ["model.lora_r=8", "run.init_lr", "2e-4"]
    for kw in ({}, {"cfg_dict": {"run": {"max_epoch": 3}, "model": {"freeze_LLM": True}}}):
        assert tconfig.Config(path, opts, **kw).to_dict() == jconfig.Config(path, opts,
                                                                             **kw).to_dict()
    cfg = tconfig.Config(path, options=opts, cfg_dict={"run": {"output_dir": "x"}})
    assert cfg.run_cfg.init_lr == 2e-4 and cfg.model_cfg.lora_r == 8
    assert cfg.run_cfg.output_dir == "x" and cfg.get("run") is cfg.config["run"]
    assert cfg.get("nothing", 5) == 5 and json.loads(cfg.pretty_print()) == cfg.to_dict()
    copy = cfg.config.copy()
    copy.run["output_dir"] = "y"
    assert isinstance(copy.run, tconfig.ConfigDict) and cfg.run_cfg.output_dir == "x"
    assert tconfig.Config().to_dict() == jconfig.Config().to_dict() == {"model": {}}


def test_runner_config_validator():
    v = tconfig.create_runner_config_validator()
    j = jconfig.create_runner_config_validator()
    assert set(v.schema) == set(j.schema)
    assert v.schema["task"][1] == j.schema["task"][1] == ["image_text_pretrain", "video_text_it"]
    assert v.schema["lr_sched"][1] == j.schema["lr_sched"][1]
    assert v.format_help() == j.format_help() and str(v) == v.format_help()
    ok = {"max_epoch": 3, "init_lr": 1e-4, "seed": 42, "output_dir": "out", "device": "cuda",
          "num_beams": 5, "task": "video_text_it"}
    assert v.validate(ok) is ok
    for bad, msg in (({"no_such_flag": 1}, "not a valid argument"),
                     ({"device": "mps"}, "must be one of"),
                     ({"task": "captioning"}, "must be one of"),
                     ({"max_epoch": "three point five.."}, "not a valid")):
        with pytest.raises(ValueError, match=msg):
            v.validate(bad)
        with pytest.raises(ValueError, match=msg):
            j.validate(bad)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_logging_and_ranks_without_and_with_a_process_group(tmp_path):
    import torch.distributed as dist

    tlog.setup_logger(logging.INFO)
    assert tlog.is_main_process() and not tlog.dist_initialized()
    meter = tlog.SmoothedValue()
    for x in (1.0, 3.0):
        meter.update(x)
    ml = tlog.MetricLogger()
    ml.add_meter("m", meter)
    ml.synchronize_between_processes()
    assert (meter.count, meter.total) == (2, 4.0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{_free_port()}",
                            world_size=1, rank=0)
    try:
        assert tlog.dist_initialized() and tlog.is_main_process()
        assert tbase.get_rank() == 0 and tbase.get_world_size() == 1
        tbase.barrier()
        ml.synchronize_between_processes()
        assert (meter.count, meter.total) == (2, 4.0)
        out = tbase.BaseTask.save_result([{"a": 1}], str(tmp_path), "r")
        assert json.loads(open(out).read()) == [{"a": 1}]
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# io_utils, synth
# ---------------------------------------------------------------------------

def test_io_utils_equal_jax(tmp_path):
    assert tio.is_url("https://x.com/a.pth") and not tio.is_url("/local/path")
    for u in ("file:///a/b", "s3://bucket/k", "C:/x", "no/scheme"):
        assert tio.is_url(u) == jio.is_url(u)
    assert len(tio.now()) == 11 and tio.now()[:8].isdigit()
    assert tio.get_cache_path("x/y") == jio.get_cache_path("x/y")
    assert tio.get_abs_path("configs") == str(TRegistry.get_path("library_root")) + "/configs"
    obj = {"x": [1, 2], "y": "z"}
    for save, load, name in ((tio.save_json, jio.load_json, "a/b.json"),
                             (tio.save_yaml_file, jio.load_yaml_file, "c.yaml"),
                             (tio.save_pickle, jio.load_pickle, "d/e.pkl")):
        save(obj, str(tmp_path / name))
        assert load(str(tmp_path / name)) == obj
    jio.save_json(obj, str(tmp_path / "j.json"))
    assert tio.load_json(str(tmp_path / "j.json")) == obj
    arr = np.arange(6).reshape(2, 3)
    tio.save_npy(arr, str(tmp_path / "n" / "a.npy"))
    np.testing.assert_array_equal(jio.load_npy(str(tmp_path / "n" / "a.npy")), arr)
    assert pickle.loads((tmp_path / "d" / "e.pkl").read_bytes()) == obj


def test_download_cached_file_reads_a_local_url_once(tmp_path):
    """The cached name is the JAX package's (sha256 of the URL, 8 hex
    digits, then the file name). JAX's function itself cannot run: its
    function-local ``import urllib.request`` makes ``urllib`` a local name,
    unbound where the function first reads it."""
    import hashlib

    src = tmp_path / "weights.bin"
    src.write_bytes(b"\x01\x02payload")
    url = src.as_uri()
    with pytest.raises(UnboundLocalError):
        jio.download_cached_file(url, cache_dir=str(tmp_path / "j"))
    got = tio.download_cached_file(url, cache_dir=str(tmp_path / "t"))
    assert got == str(tmp_path / "t" / f"{hashlib.sha256(url.encode()).hexdigest()[:8]}-weights.bin")
    assert open(got, "rb").read() == b"\x01\x02payload"
    src.unlink()     # a second call is served from the cache
    assert tio.download_cached_file(url, cache_dir=str(tmp_path / "t")) == got
    with pytest.raises(OSError):
        tio.download_cached_file((tmp_path / "missing.bin").as_uri(),
                                 cache_dir=str(tmp_path / "t"))


def test_synth_equals_jax():
    for t, size in ((4, 16), (3, 9)):
        np.testing.assert_array_equal(tsynth.synth_video(np.random.default_rng(2), t, size),
                                      jsynth.synth_video(np.random.default_rng(2), t, size))
        np.testing.assert_array_equal(tsynth.noise_video(np.random.default_rng(3), t, size),
                                      jsynth.noise_video(np.random.default_rng(3), t, size))
    assert tsynth.synth_video(np.random.default_rng(0), 4, 16).shape == (1, 4, 16, 16, 3)


# ---------------------------------------------------------------------------
# randaugment
# ---------------------------------------------------------------------------

WARPS = ("Sharpness", "ShearX", "ShearY", "TranslateX", "TranslateY", "Rotate")


def _images():
    rng = np.random.default_rng(0)
    return [rng.integers(0, 256, (32, 40, 3)).astype(np.uint8),
            np.clip(rng.normal(120, 20, (17, 23, 3)), 0, 255).astype(np.uint8),
            np.full((8, 8, 3), 77, np.uint8),
            rng.integers(30, 60, (3, 12, 16, 3)).astype(np.uint8)]


def _close(got, want, name):
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    if name in WARPS:
        assert d.max() <= 1 and (d > 0).mean() <= 0.005, (name, d.max(), (d > 0).mean())
    else:
        np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("name", list(jra.OPS))
def test_augment_op_equals_jax(name):
    assert list(tra.OPS) == list(jra.OPS) and tra.OPS[name][1] == jra.OPS[name][1]
    lo, hi = jra.OPS[name][1]
    levels = [0] if not hi else [lo, hi, (lo + hi) / 2, lo + (hi - lo) * 0.37]
    for img in _images():
        for level in levels:
            got = tra.OPS[name][0](torch.from_numpy(img), level).numpy()
            # the JAX op takes one image; a clip goes frame by frame
            want = (np.stack([jra.OPS[name][0](f, level) for f in img]) if img.ndim == 4
                    else jra.OPS[name][0](img, level))
            assert got.dtype == np.uint8 and got.shape == img.shape
            _close(got, want, name)


def test_random_augment_picks_and_output_equal_jax(monkeypatch):
    img = _images()[0]
    clip = np.stack([img, img[::-1], img])
    for cls in ("RandomAugment", "VideoRandomAugment"):
        for n, m, augs in ((2, 9, None), (3, 5, ["Rotate", "Equalize", "Posterize"])):
            t = getattr(tra, cls)(n=n, m=m, augs=augs, seed=11, device="cpu")
            j = getattr(jra, cls)(n=n, m=m, augs=augs, seed=11)
            for _ in range(4):
                x = clip if cls.startswith("Video") else img
                got, want = t(x), j(x)
                d = np.abs(got.astype(np.int32) - want.astype(np.int32))
                assert got.shape == x.shape and d.max() <= 1 and (d > 0).mean() <= 0.005
            assert t._pick() == j._pick()
    vout = tra.VideoRandomAugment(n=2, m=5, seed=0, device="cpu")(np.stack([img] * 3))
    assert np.array_equal(vout[0], vout[1]) and np.array_equal(vout[1], vout[2])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tra.RandomAugment()


# ---------------------------------------------------------------------------
# runner
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_model(tmp_path_factory):
    cfg = tconfig.Config(cfg_dict=_runner_cfg(tmp_path_factory.mktemp("m")))
    return setup_task(cfg).build_model(cfg, device="cpu")


class _Data:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return i


def _capture_jax_runner(monkeypatch, cfg_dict, datasets):
    """JAX's RunnerBase.trainer with make_optimizer and Trainer replaced by
    captures: its schedule and trainer arguments, no JAX model or step."""
    seen = {}
    monkeypatch.setattr(jstep, "make_optimizer",
                        lambda lr, **kw: seen.setdefault("opt", (lr, kw)))
    monkeypatch.setattr(jtrainer, "Trainer",
                        lambda *a, **kw: seen.setdefault("trainer", (a, kw)))
    model = types.SimpleNamespace(cfg=None, params=None, trainable_fn=lambda: None)
    runner = JRegistry.get_runner_class("runner_base")(jconfig.Config(cfg_dict=cfg_dict), None,
                                                       model, datasets)
    runner.trainer
    return runner, seen


@pytest.mark.parametrize("run", [
    {"max_epoch": 3, "iters_per_epoch": 5, "warmup_steps": 4, "warmup_lr": 1e-5,
     "init_lr": 2e-4, "min_lr": 1e-6, "weight_decay": 0.02, "save_freq": 7},
    {"max_epoch": 2, "iters_per_epoch": None, "batch_size_train": 3, "warmup_ratio": 0.1,
     "learning_rate": 3e-4, "warmup_lr": -1, "init_lr": None, "accum_grad_iters": 2},
    {"max_epoch": 1, "iters_per_epoch": 2}])
def test_runner_schedule_and_trainer_equal_jax(tmp_path, monkeypatch, tiny_model, run):
    d = _runner_cfg(tmp_path, **run)
    d["run"] = {k: v for k, v in d["run"].items() if v is not None}
    datasets = {"a": {"train": _Data(10)}, "b": {"train": _Data(7)}}
    jrunner, seen = _capture_jax_runner(monkeypatch, d, datasets)
    runner = RunnerBase(tconfig.Config(cfg_dict=d), None, tiny_model, datasets)
    assert (runner.iters_per_epoch, runner.max_steps) == (jrunner.iters_per_epoch,
                                                          jrunner.max_steps)
    trainer = runner.trainer
    want_lr, want_kw = seen["opt"]
    peak = max(float(want_lr(s)) for s in range(runner.max_steps + 1))
    for step in range(runner.max_steps + 3):
        assert trainer.optimizer.learning_rate(step) == pytest.approx(
            float(want_lr(step)), rel=1e-6, abs=peak * 1e-6), step
    assert trainer.optimizer.weight_decay == want_kw["weight_decay"]
    _, jkw = seen["trainer"]
    assert (trainer.output_dir, trainer.log_freq, trainer.save_freq) == (
        jkw["output_dir"], jkw["log_freq"], jkw["save_freq"])
    assert trainer.device.type == "cpu" and runner.trainer is trainer


def _collate(rng, cfg):
    v = cfg.num_video_tokens(4)

    def collate(samples):
        b = len(samples)
        batch = pack_training_batch([[5, 6]] * b, [[8]] * b, [[11, 12]] * b,
                                    num_video=v, seq_len=32, pad_id=0)
        batch["frames"] = rng.normal(size=(b, 4, 28, 28, 3)).astype(np.float32)
        batch["qformer_input_ids"] = rng.integers(0, 64, (b, 5)).astype(np.int32)
        batch["qformer_attention_mask"] = np.ones((b, 5), np.int32)
        return batch

    return collate


def test_runner_trains_as_the_trainer_and_resumes(tmp_path, monkeypatch):
    """Two steps through the runner, losses equal to Trainer.train on the
    batches the runner collated; a second runner with max_epoch 2 over the
    same output_dir resumes at step 2 and stops at 4. Each step's
    checkpoint is written once."""
    saves = []
    real_save = tckpt.CheckpointManager.save
    monkeypatch.setattr(tckpt.CheckpointManager, "save",
                        lambda self, state, extra=None: (saves.append(int(state.step)),
                                                         real_save(self, state, extra)))
    out = tmp_path / "run"
    cfg = tconfig.Config(cfg_dict=_runner_cfg(out))
    task = setup_task(cfg)
    model = task.build_model(cfg, device="cpu")
    batches = []
    collate = _collate(np.random.default_rng(0), model.cfg)
    runner = TRegistry.get_runner_class("runner_base")(
        cfg, task, model, {"d": {"train": _Data(8)}})
    stats = runner.train(collate_fn=lambda s: batches.append(collate(s)) or batches[-1])
    assert np.isfinite(stats["loss"]) and runner.trainer.ckpt.latest_step() == 2
    log = [json.loads(x) for x in (out / "log.txt").read_text().splitlines()]
    assert [r["step"] for r in log] == [1, 2] and len(batches) >= 2 and saves == [2]

    fresh = task.build_model(cfg, device="cpu")
    ref = Trainer(fresh.cfg, fresh.params, make_optimizer(
        runner.trainer.optimizer.learning_rate, weight_decay=0.05),
        output_dir=str(tmp_path / "ref"), device="cpu", trainable_fn=fresh.trainable_fn(),
        log_freq=1)
    ref.train(iter(batches), 2)
    ref_log = [json.loads(x) for x in (tmp_path / "ref" / "log.txt").read_text().splitlines()]
    assert [r["loss"] for r in ref_log] == [r["loss"] for r in log]

    saves.clear()
    cfg2 = tconfig.Config(cfg_dict=_runner_cfg(out, max_epoch=2))
    model2 = task.build_model(cfg2, device="cpu")
    runner2 = RunnerBase(cfg2, task, model2, {"d": {"train": _Data(8)}})
    runner2.train(collate_fn=_collate(np.random.default_rng(1), model2.cfg))
    log = [json.loads(x) for x in (out / "log.txt").read_text().splitlines()]
    assert [r["step"] for r in log] == [1, 2, 3, 4] and all(np.isfinite(r["loss"]) for r in log)
    assert runner2.trainer.state.step == 4 and runner2.trainer.ckpt.latest_step() == 4
    assert saves == [4]
    assert sorted(p.name for p in out.iterdir() if p.name.startswith((".", "checkpoint"))) == [
        "checkpoint_2", "checkpoint_4"]


def test_build_model_defaults_to_the_card(monkeypatch, tmp_path):
    cfg = tconfig.Config(cfg_dict=_runner_cfg(tmp_path))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        setup_task(cfg).build_model(cfg)
