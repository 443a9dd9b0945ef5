"""PyTorch port, the task layer and the data pieces of the config-driven
path (stllm_tpu_torch/tasks, data/{wds,builders,samplers_grouped}.py,
common/gradcam.py) against the JAX package: the same configs, annotation
files, tar shards and seeds through both. Samples, indices and merged
results are held exactly; the builder's normalized images within 1e-6;
the attention overlay within one jet step (4/255, where att * 255
truncates into the next LUT index) and 1e-3 on average."""

import io
import itertools
import json
import tarfile

import cv2
import numpy as np
import pytest
import torch

import stllm_tpu.data.builders  # noqa: F401  (registers the JAX builders)
import stllm_tpu.models.zoo  # noqa: F401
from stllm_tpu.common import config as jconfig
from stllm_tpu.common.gradcam import get_att_map as jatt
from stllm_tpu.common.registry import Registry as JRegistry
from stllm_tpu.data import datasets as jds
from stllm_tpu.data import samplers_grouped as jsg
from stllm_tpu.data import wds as jwds
from stllm_tpu.tasks import base_task as jbase
from stllm_tpu.tasks import setup_task as jsetup
from stllm_tpu_torch.common import config as tconfig
from stllm_tpu_torch.common.gradcam import get_att_map as tatt
from stllm_tpu_torch.common.registry import Registry as TRegistry
from stllm_tpu_torch.data import builders as tbuilders
from stllm_tpu_torch.data import datasets as tds
from stllm_tpu_torch.data import samplers_grouped as tsg
from stllm_tpu_torch.data import wds as twds
from stllm_tpu_torch.tasks import base_task as tbase
from stllm_tpu_torch.tasks import setup_task as tsetup


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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


# ---------------------------------------------------------------------------
# tasks
# ---------------------------------------------------------------------------

def test_setup_task_gives_the_registered_task():
    d = {"run": {"task": "video_text_it"}, "model": {}, "datasets": {}}
    task = tsetup(tconfig.Config(cfg_dict=d))
    assert type(task).__name__ == type(jsetup(jconfig.Config(cfg_dict=d))).__name__ \
        == "VideoTextItTask"
    assert TRegistry.list_tasks() == JRegistry.list_tasks() == ["image_text_pretrain",
                                                                  "video_text_it"]
    assert task.evaluation(None, [1, 2]) == []
    with pytest.raises(KeyError):
        tsetup(tconfig.Config(cfg_dict={"run": {"task": "no_such_task"}}))


@pytest.mark.parametrize("simple", [True, False])
def test_task_build_datasets_gives_jax_samples(tmp_path, monkeypatch, simple):
    import stllm_tpu.data.instruction_data as jidata
    import stllm_tpu_torch.data.instruction_data as tidata

    vids = tmp_path / "vids"
    vids.mkdir()
    vw = cv2.VideoWriter(str(vids / "a.mp4"), cv2.VideoWriter_fourcc(*"mp4v"), 10, (32, 32))
    for i in range(20):
        vw.write(np.full((32, 32, 3), 10 * i, np.uint8))
    vw.release()
    (tmp_path / "anno.json").write_text(json.dumps(
        [{"video": "a.mp4", "QA": [{"q": "what?", "a": "a"}, {"q": "why?", "a": "b"}]}]))
    (tmp_path / "img.json").write_text(json.dumps([{"image": "i.png", "QA": [{"q": "q",
                                                                              "a": "a"}]}]))
    cv2.imwrite(str(tmp_path / "i.png"), np.full((8, 8, 3), 77, np.uint8))
    for m in (jidata, tidata):
        monkeypatch.setitem(m.available_corpus, "test_corpus",
                            [str(tmp_path / "anno.json"), str(vids), "video"])
        monkeypatch.setitem(m.available_corpus, "test_images",
                            [str(tmp_path / "img.json"), str(tmp_path)])
    d = {"run": {"task": "video_text_it"}, "model": {"qformer_text_input": simple},
         "datasets": {"test_corpus": {"num_frames": 4}, "test_images": None}}
    got = tsetup(tconfig.Config(cfg_dict=d)).build_datasets(tconfig.Config(cfg_dict=d), seed=3)
    want = jsetup(jconfig.Config(cfg_dict=d)).build_datasets(jconfig.Config(cfg_dict=d), seed=3)
    assert isinstance(got["test_corpus"]["train"], tds.ITVidTrainDataset)
    assert isinstance(got["test_images"]["train"], tds.ITImgTrainDataset)
    for name in ("test_corpus", "test_images"):
        _same(dict(got[name]["train"][0]), dict(want[name]["train"][0]))
    item = got["test_corpus"]["train"][0]
    assert item["image"].shape[0] == 4
    assert item["instruction_input"].startswith("<ImageHere>") == simple
    with pytest.raises(AssertionError):
        tsetup(tconfig.Config(cfg_dict=d)).build_datasets(
            tconfig.Config(cfg_dict={**d, "datasets": {}}))


def test_save_result_merges_as_jax(tmp_path):
    res = [{"id": 1, "v": "a"}, {"id": 1, "v": "b"}, {"id": 2, "v": "c"}]
    for dedup in ("id", ""):
        out = tbase.BaseTask.save_result(res, str(tmp_path / "t"), "res", remove_duplicate=dedup)
        want = jbase.BaseTask.save_result(res, str(tmp_path / "j"), "res", remove_duplicate=dedup)
        assert json.loads(open(out).read()) == json.loads(open(want).read())
        assert (tmp_path / "t" / "res_rank0.json").is_file()
    assert json.loads(open(out).read()) == res


def test_main_process_and_evaluation():
    calls = []

    @tbase.main_process
    def fn(x):
        calls.append(x)
        return x

    assert fn(3) == 3 and calls == [3]
    assert tbase.get_rank() == 0 and tbase.get_world_size() == 1
    tbase.barrier()

    class Task(tbase.BaseTask):
        def valid_step(self, model, samples):
            return [{"x": s * model} for s in samples]

    assert Task().evaluation(10, [[1, 2], [3]], print_freq=1) == [{"x": 10}, {"x": 20},
                                                                  {"x": 30}]


# ---------------------------------------------------------------------------
# wds
# ---------------------------------------------------------------------------

def _make_shard(path, n, with_json, broken=()):
    with tarfile.open(path, "w") as tf:
        for i in range(n):
            ok, enc = cv2.imencode(".jpg", np.full((16, 16, 3), 10 * i, np.uint8))
            data = b"not a jpeg" if i in broken else enc.tobytes()
            meta = (json.dumps({"caption": f"Cap {i}!"}) if with_json else f"Text {i}").encode()
            for ext, payload in (("jpg", data), ("json" if with_json else "txt", meta)):
                ti = tarfile.TarInfo(f"{i:05d}.{ext}")
                ti.size = len(payload)
                tf.addfile(ti, io.BytesIO(payload))


def test_expand_shards_equals_jax(tmp_path):
    for p in ("a", "b", "c"):
        (tmp_path / f"s-{p}.tar").write_bytes(b"")
    for urls in ("s-{0000..0002}.tar", "x-{7..12}.tar", ["a", "b"], "one.tar",
                 str(tmp_path / "s-*.tar")):
        assert twds.expand_shards(urls) == jwds.expand_shards(urls)
    assert twds.expand_shards("s-{0000..0002}.tar") == ["s-0000.tar", "s-0001.tar", "s-0002.tar"]


def test_pipelines_give_jax_samples(tmp_path):
    cc, la = str(tmp_path / "cc-0000.tar"), str(tmp_path / "laion-0000.tar")
    _make_shard(cc, 6, with_json=True, broken=(2,))
    _make_shard(la, 5, with_json=False)
    _same(list(twds.tar_samples(cc)), list(jwds.tar_samples(cc)))
    for urls, mapper, buf, resample, n in ((cc, "cc_sbu_map", 3, False, None),
                                           (la, "laion_map", 1, False, None),
                                           ([cc, la], "cc_sbu_map", 4, True, 13)):
        def run(m):
            it = iter(m.WebDatasetPipeline(urls, getattr(m, mapper)(), shuffle_buffer=buf,
                                           seed=9, resample=resample))
            return list(it) if n is None else [next(it) for _ in range(n)]

        got, want = run(twds), run(jwds)
        _same(got, want)
    out = list(twds.WebDatasetPipeline(cc, twds.cc_sbu_map(), shuffle_buffer=2, resample=False))
    assert len(out) == 5        # the undecodable sample is skipped
    assert {o["instruction_input"] for o in out} == {"<ImageHere> "}
    assert out[0]["image"].shape == (16, 16, 3)
    with pytest.raises(ValueError):
        twds.WebDatasetPipeline(str(tmp_path / "none-*.tar"), twds.laion_map())


# ---------------------------------------------------------------------------
# length-grouped sampler
# ---------------------------------------------------------------------------

def test_split_to_even_chunks_equals_jax():
    rng = np.random.default_rng(0)
    for n, k in ((4, 2), (12, 3), (7, 2), (10, 5)):
        lengths = rng.integers(1, 50, n).tolist()
        order = sorted(range(n), key=lambda i: -lengths[i])
        assert tsg.split_to_even_chunks(order, lengths, k) == \
            jsg.split_to_even_chunks(order, lengths, k)
    chunks = tsg.split_to_even_chunks([0, 3, 1, 2], [10, 1, 1, 10], 2)
    assert sorted(sum([10, 1, 1, 10][i] for i in c) for c in chunks) == [11, 11]


@pytest.mark.parametrize("mixed", [True, False])
def test_modality_grouped_indices_equal_jax(mixed):
    lengths = np.random.default_rng(1).integers(1, 90, 37).tolist()
    if mixed:
        lengths = [-x if i % 3 == 0 else x for i, x in enumerate(lengths)]
    for bs, ws in ((2, 2), (3, 1), (4, 3)):
        got = tsg.get_modality_length_grouped_indices(lengths, bs, ws, np.random.default_rng(5))
        assert got == jsg.get_modality_length_grouped_indices(lengths, bs, ws,
                                                              np.random.default_rng(5))
        assert sorted(got) == list(range(len(lengths)))
    if mixed:       # each megabatch of the mixed set is of one modality
        idx = tsg.get_modality_length_grouped_indices([5, 6, 7, 8, -5, -6, -7, -8], 2, 2,
                                                      np.random.default_rng(0))
        assert all(len({[5, 6, 7, 8, -5, -6, -7, -8][j] > 0 for j in idx[i:i + 4]}) == 1
                   for i in (0, 4))


def test_sampler_epochs_equal_jax():
    lengths = [3, 1, 2, 8, 5, 4, 7, 6, -2, -9]
    for by_modality in (False, True):
        t = tsg.LengthGroupedSampler(2, 2, lengths, seed=4, group_by_modality=by_modality)
        j = jsg.LengthGroupedSampler(2, 2, lengths, seed=4, group_by_modality=by_modality)
        assert [list(t) for _ in range(3)] == [list(j) for _ in range(3)]
        assert len(t) == 10 and sorted(t) == list(range(10))
    with pytest.raises(ValueError):
        tsg.LengthGroupedSampler(2, 2, None)


# ---------------------------------------------------------------------------
# builders
# ---------------------------------------------------------------------------

def test_cc_sbu_builder_gives_jax_samples(tmp_path):
    shard = str(tmp_path / "cc-00000.tar")
    _make_shard(shard, 4, with_json=True)
    cfg = {"build_info": {"storage": shard},
           "vis_processor": {"train": {"name": "blip2_image_eval", "image_size": 16}},
           "text_processor": {"train": {"name": "blip_caption"}}}
    tb = TRegistry.get_builder_class("cc_sbu")
    assert issubclass(tb, tbuilders.BaseDatasetBuilder)
    # the pipeline resamples its shards without end (and fills a 1000-sample
    # shuffle buffer first): take six samples
    got = list(itertools.islice(tb(tconfig.wrap(cfg), device="cpu").build_datasets()["train"], 6))
    want = list(itertools.islice(
        JRegistry.get_builder_class("cc_sbu")(jconfig.wrap(cfg)).build_datasets()["train"], 6))
    for g, w in zip(got, want):
        assert g["answer"] == w["answer"] and g["answer"].startswith("cap")
        assert g["image"].shape == (16, 16, 3)
        np.testing.assert_allclose(g["image"], w["image"], atol=1e-6, rtol=0)


def test_builder_default_yamls_equal_jax(tmp_path):
    names = ("cc_sbu", "laion", "cc_sbu_align")
    for name in names:
        t, j = TRegistry.get_builder_class(name)(), JRegistry.get_builder_class(name)()
        assert tconfig.unwrap(t.config) == jconfig.unwrap(j.config)
        assert "storage" in t.config["build_info"]
    (tmp_path / "image").mkdir()
    cv2.imwrite(str(tmp_path / "image" / "a.jpg"), np.full((8, 8, 3), 50, np.uint8))
    (tmp_path / "filter_cap.json").write_text(json.dumps(
        [{"image": "a.jpg", "QA": [{"q": "describe", "a": "gray"}]}]))
    cfg = {"build_info": {"storage": str(tmp_path)}}
    got = TRegistry.get_builder_class("cc_sbu_align")(tconfig.wrap(cfg)).build_datasets()
    want = JRegistry.get_builder_class("cc_sbu_align")(jconfig.wrap(cfg)).build_datasets()
    _same(dict(got["train"][0]), dict(want["train"][0]))


def test_pre_text_and_pt_datasets_equal_jax(tmp_path):
    for text in ("A Dog, running!", "Keep AS-IS"):
        for pre in (True, False):
            assert tds.pre_text(text, pre=pre) == jds.pre_text(text, pre=pre)
    cv2.imwrite(str(tmp_path / "img.jpg"), np.full((16, 16, 3), 128, np.uint8))
    (tmp_path / "img_anno.json").write_text(json.dumps([{"image": "img.jpg",
                                                         "caption": "A Cat."}]))
    ann = [str(tmp_path / "img_anno.json"), str(tmp_path)]
    got, want = tds.PTImgTrainDataset(ann, seed=0)[0], jds.PTImgTrainDataset(ann, seed=0)[0]
    _same(got, want)
    assert got[1] == "a cat"


# ---------------------------------------------------------------------------
# gradcam
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("blur,overlap", [(True, True), (False, True), (True, False)])
def test_att_map_equals_jax(blur, overlap):
    img = np.random.default_rng(0).random((32, 40, 3)).astype(np.float32)
    att = np.random.default_rng(1).random((8, 10)).astype(np.float32)
    got = tatt(img, att, blur=blur, overlap=overlap, device="cpu")
    want = jatt(img, att, blur=blur, overlap=overlap)
    assert got.shape == want.shape == (32, 40, 3)
    # unblurred, the bicubic upsample leaves [0, 1] at some pixels and the
    # reference's att ** 0.7 is NaN where it undershoots: the same pixels in both
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got).any() == (not blur)
    ok = ~np.isnan(want)
    if blur:
        assert 0.0 <= got.min() and got.max() <= 1.0 + 1e-6
    diff = np.abs(got[ok] - want[ok])
    assert diff.max() <= 4 / 255 + 1e-5 and diff.mean() <= 1e-3, (diff.max(), diff.mean())
