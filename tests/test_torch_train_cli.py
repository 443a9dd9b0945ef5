"""PyTorch port, the corpus side of training and the train CLI
(stllm_tpu_torch/data/{datasets,loaders,instruction_data}.py,
common/optim.warmup_cosine_decay, train/train.py) against the JAX package:
the same annotation files and seeds give the same samples and prompt
strings, the loaders the same batches in the same order, MetaLoader the same
schedule, and the learning-rate schedule optax's value at every step. All
exact, but for the schedule: the port computes it in float64, optax in
float32, so they agree to float32 rounding (1e-6 relative, and 1e-6 of the
peak where the cosine's terms cancel near its end). Then the CLI
trains the tiny debug config on synthetic mp4s with --cpu, writes log.txt
and a checkpoint, and resumes from it."""

import json

import cv2
import numpy as np
import optax
import pytest
import torch

from stllm_tpu.data import datasets as jds
from stllm_tpu.data import loaders as jld
from stllm_tpu.data.instruction_data import build_corpus as jcorpus
from stllm_tpu_torch.common.optim import warmup_cosine_decay
from stllm_tpu_torch.data import datasets as tds
from stllm_tpu_torch.data import loaders as tld
from stllm_tpu_torch.data.instruction_data import build_corpus as tcorpus
from stllm_tpu_torch.train import train as ttrain


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A video annotation file (QA lists, clip windows, frame counts, one
    broken video) and an image one with PNGs written by cv2 (and captions
    and video names for the pretraining sets)."""
    root = tmp_path_factory.mktemp("corpus")
    vids = [{"video": f"v{i}.mp4", "QA": [{"i": "Watch." if i % 2 else "", "q": f"what {i}?",
                                           "a": f"ans {i}"}, {"q": f"why {i}?", "a": "so"}]}
            for i in range(5)]
    vids[1].update(start=0.5, end=2.0)
    vids[2]["num_frames"] = 30
    vids[3]["video"] = "broken.mp4"
    (root / "vid.json").write_text(json.dumps(vids))
    imgs = [{"image": f"i{i}.png", "video": f"v{i}.mp4", "QA": [{"q": f"q{i}", "a": f"a{i}"}],
             "caption": f"A Cat-{i}!"} for i in range(3)]
    (root / "img.json").write_text(json.dumps(imgs))
    rng = np.random.default_rng(0)
    for i in range(3):
        cv2.imwrite(str(root / f"i{i}.png"), rng.integers(0, 256, (10, 12, 3), dtype=np.uint8))
    return root


def _reader(path, num_frames, sample, max_num_frames=-1, clip=None, rng=None):
    """A stand-in video reader for both packages: it draws its frame indices
    from the dataset's generator as a real read does and fails on the broken
    file, so retries and the generator's stream are exercised alike."""
    if "broken" in path:
        raise IOError(f"cannot decode {path}")
    idx = sorted(rng.choice(40, num_frames, replace=False).tolist())
    seed = sum(map(ord, path)) + (0 if clip is None else int(clip[0] * 10))
    frames = np.random.default_rng(seed).integers(0, 256, (num_frames, 4, 4, 3), dtype=np.uint8)
    return frames, idx, 4.0


def _samples(ds, order):
    out = []
    for i in order:
        s = ds[i]
        out.append(s if isinstance(s, tuple) else dict(s))
    return out


def _same(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


@pytest.mark.parametrize("kind", ["video", "video_simple_msg", "image", "pt_video", "pt_image"])
def test_datasets_give_jax_samples(corpus, kind):
    order = [0, 3, 1, 2, 4, 3, 0] if kind.startswith("video") else [2, 0, 1, 2]
    vid, img = [str(corpus / "vid.json"), str(corpus), "video"], [str(corpus / "img.json"),
                                                                  str(corpus)]
    build = {
        "video": lambda m: m.ITVidTrainDataset(vid, num_frames=3, system="You help. ", seed=7),
        "video_simple_msg": lambda m: m.ITVidTrainDataset(vid, num_frames=2, simple=True,
                                                          add_second_msg=True, seed=8),
        "image": lambda m: m.ITImgTrainDataset(img, system="Sys. ", seed=9),
        "pt_video": lambda m: m.PTVidTrainDataset(
            [str(corpus / "img.json"), str(corpus), "video"], num_frames=2, seed=3),
        "pt_image": lambda m: m.PTImgTrainDataset(img, seed=4)}[kind]
    jd, td = build(jds), build(tds)
    failed = []

    def counted(path, *a, **k):
        failed.append("broken" in path)
        return _reader(path, *a, **k)

    if kind.startswith(("video", "pt_video")):
        jd.video_reader, td.video_reader = _reader, counted
    _same(_samples(td, order), _samples(jd, order))
    # each failed read is replaced by a random other video, and counted
    assert td.retries == sum(failed) == (order.count(3) if kind.startswith("video") else 0)


def test_prompt_strings_byte_for_byte(corpus):
    vid = [str(corpus / "vid.json"), str(corpus), "video"]
    msg = " The video contains 2 frames sampled at 0.0, 1.0 seconds. "
    cases = [([{"i": "Watch carefully.", "q": "what color?", "a": "gray"}], msg),
             ([{"q": "count?", "a": "three"}], ""), ([{"i": "", "q": "what?", "a": "x"}], msg)]
    for kw in ({"system": "You are a helper. "}, {"simple": True}, {"simple": True,
                                                                     "system": "S. "}):
        jd = jds.ITVidTrainDataset(vid, num_frames=2, seed=0, **kw)
        td = tds.ITVidTrainDataset(vid, num_frames=2, seed=0, **kw)
        for qa, m in cases:
            assert td.process_qa(qa, m) == jd.process_qa(qa, m)
    td = tds.ITVidTrainDataset(vid, num_frames=2, system="You are a helper. ", seed=0)
    assert td.process_qa(*cases[0])[0] == (
        "You are a helper. Watch carefully. ###Human: <Video><ImageHere></Video> The video "
        "contains 2 frames sampled at 0.0, 1.0 seconds. what color? ###Assistant: ")
    with pytest.raises(ValueError):
        tds.ITVidTrainDataset(vid, system="no trailing space")
    for text in ("A Cat-1!", "x/y <person> said: \"hi\";  ok\n", "plain"):
        assert tds.pre_text(text) == jds.pre_text(text)
    assert tcorpus("/anno", "/data") == jcorpus("/anno", "/data")


class _Range:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return i * 10


def test_loaders_give_jax_batches_and_schedule():
    def batches(m, n, bs, drop, epochs):
        it = m.IterLoader(m.DataLoader(_Range(n), bs, np.array, num_workers=2, drop_last=drop,
                                       seed=5))
        return [next(it).tolist() for _ in range(epochs * len(it))]

    for n, bs, drop in ((10, 3, True), (10, 3, False), (7, 7, True)):
        assert batches(tld, n, bs, drop, 3) == batches(jld, n, bs, drop, 3)

    def schedule(m):
        loaders = [m.IterLoader(m.DataLoader(_Range(n), 2, list, seed=n)) for n in (6, 2, 4)]
        meta = iter(m.MetaLoader(loaders, seed=11))
        multi = m.MultiIterLoader([m.IterLoader(m.DataLoader(_Range(4), 1, list, seed=1))
                                   for _ in range(2)], ratios=[3, 1], seed=2)
        return [next(meta) for _ in range(12)], [next(multi) for _ in range(8)]

    assert schedule(tld) == schedule(jld)


@pytest.mark.parametrize("peak,warmup,total", [(1e-3, 1, 2), (2e-5, 3, 100), (1e-4, 30, 31),
                                               (5e-4, 1, 1000)])
def test_schedule_equals_optax(peak, warmup, total):
    want = optax.warmup_cosine_decay_schedule(0.0, peak, warmup, total)
    got = warmup_cosine_decay(0.0, peak, warmup, total)
    for step in range(total + 3):
        assert got(step) == pytest.approx(float(want(step)), rel=1e-6, abs=peak * 1e-6), step
    with pytest.raises(ValueError):
        optax.warmup_cosine_decay_schedule(0.0, peak, total, total)
    with pytest.raises(ValueError):
        warmup_cosine_decay(0.0, peak, total, total)


def test_prefetcher_moves_batches_and_raises_the_producer_error(monkeypatch):
    def loader():
        yield {"x": np.arange(3), "name": "a"}
        yield {"x": torch.ones(2)}
        raise IOError("decoder missing")

    got = []
    with pytest.raises(IOError, match="decoder missing"):
        for batch in tld.DevicePrefetcher(loader(), device="cpu"):
            got.append(batch)
    assert [type(b["x"]) for b in got] == [torch.Tensor, torch.Tensor] and got[0]["name"] == "a"
    assert got[0]["x"].tolist() == [0, 1, 2]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tld.DevicePrefetcher([])


def test_cli_trains_writes_a_checkpoint_and_resumes(tmp_path, monkeypatch):
    out = tmp_path / "out"
    argv = ["--cfg-path", "config/tiny_debug.yaml", "--synthetic-data", "4", "--cpu",
            "--options", f"run.output_dir={out}", "run.dataloader_num_workers=1",
            "run.logging_steps=1"]
    stats = ttrain.main(argv + ["--max-steps", "2"])
    assert np.isfinite(stats["loss"])
    log = [json.loads(x) for x in (out / "log.txt").read_text().splitlines()]
    assert [r["step"] for r in log] == [1, 2]
    assert (out / "checkpoint_2" / "state.pt").is_file()
    assert len(list((out / "synthetic_data" / "vids").glob("*.mp4"))) == 4
    stats = ttrain.main(argv + ["--max-steps", "3"])
    log = [json.loads(x) for x in (out / "log.txt").read_text().splitlines()]
    assert [r["step"] for r in log] == [1, 2, 3]
    assert sorted(p.name for p in out.glob("checkpoint_*")) == ["checkpoint_2", "checkpoint_3"]
    # a mesh of two ranks in a world of one (no torchrun): the mesh's size check
    with pytest.raises(ValueError, match="needs 2 ranks"):
        ttrain.main(argv + ["--data-parallel", "2"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttrain.main([a for a in argv if a != "--cpu"])
