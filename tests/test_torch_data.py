"""PyTorch port, the host side of the main path (stllm_tpu_torch/data:
samplers, processors, video readers, data utilities) against the JAX
package on the same numpy inputs from a seed.

Samplers, crop boxes, readers and the dataset utilities agree exactly. The
eval transform's bicubic resize is torch's (Keys a = -0.75, no antialias,
rounded and saturated to uint8) where the JAX package calls cv2's
INTER_CUBIC: outputs agree within one uint8 step on at most 0.5% of the
pixels. The device-side ``resize_bicubic`` (antialiased, a = -0.5) agrees
with ``jax.image.resize`` within 5e-3 on the 0-255 scale."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from stllm_tpu.data import data_utils as jdu
from stllm_tpu.data import processors as jproc
from stllm_tpu.data import samplers as jsamp
from stllm_tpu.data import video_reader as jvr
from stllm_tpu_torch.common.registry import Registry as TRegistry
from stllm_tpu_torch.data import data_utils as tdu
from stllm_tpu_torch.data import processors as tproc
from stllm_tpu_torch.data import samplers as tsamp
from stllm_tpu_torch.data import video_reader as tvr

N_FRAMES, H, W, FPS = 48, 64, 80, 12
SOURCES = [(480, 640), (360, 480), (270, 480), (100, 120), (60, 40), (224, 224)]


def _img(shape, seed=0, smooth=False):
    rng = np.random.default_rng(seed)
    if not smooth:
        return rng.integers(0, 256, shape).astype(np.uint8)
    *lead, h, w, c = shape
    yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w), indexing="ij")
    base = 127.5 + 120 * np.sin(6 * yy + rng.random() * 3)[..., None] * np.cos(5 * xx)[..., None]
    return np.broadcast_to(base, tuple(lead) + (h, w, c)).round().astype(np.uint8)


# ---------------------------------------------------------------------------
# samplers: exact
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("num,vlen,kw", [
    (8, 30, dict(sample="middle")), (16, 10, dict(sample="middle")),
    (8, 30, dict(sample="rand")), (8, 5, dict(sample="rand")),
    (8, 30, dict(sample="middle", fix_start=1)), (8, 30, dict(sample="rand", fix_start=1)),
    (0, 90, dict(sample="fps1", input_fps=30)),
    (0, 100, dict(sample="fps0.5", input_fps=10, max_num_frames=8))])
def test_get_frame_indices_matches_jax(num, vlen, kw):
    """Including the Generator-driven 'rand' draws (and its permutation
    fallback when segments are empty)."""
    want = jsamp.get_frame_indices(num, vlen, rng=np.random.default_rng(7), **kw)
    got = tsamp.get_frame_indices(num, vlen, rng=np.random.default_rng(7), **kw)
    assert got == want


def test_seq_mvbench_and_clip_samplers_match_jax():
    for total, want_n in ((100, 10), (7, 16), (250, 64)):
        assert tsamp.get_seq_frames(total, want_n) == jsamp.get_seq_frames(total, want_n)
    for vl in (2.0, 4.0, 9.7, 16.0, 100.0):
        assert tsamp.mvbench_num_segments(vl) == jsamp.mvbench_num_segments(vl)
    for bound, fps, max_frame, first, n in [(None, 30, 299, 0, 8), (None, 30, 299, 0, 0),
                                            ((2, 9), 25, 500, 0, 0), ((0, 3), 10, 100, 1, 0),
                                            (None, 3, 40, 0, 0), ((1.0, 4.0), 10, 49, 0, 16)]:
        np.testing.assert_array_equal(
            tsamp.mvbench_frame_indices(bound, fps, max_frame, first, n),
            jsamp.mvbench_frame_indices(bound, fps, max_frame, first, n))
    for total, clips, clip_len, interval, test_mode, oob in [
            (32, 8, 1, 1, True, "loop"), (3, 8, 1, 1, True, "loop"), (100, 16, 1, 1, False, "loop"),
            (10, 4, 3, 2, False, "repeat_last"), (5, 8, 1, 1, False, "loop"),
            (40, 4, 4, 2, True, "repeat_last")]:
        args = (total, clips, clip_len, interval, test_mode, oob)
        np.testing.assert_array_equal(
            tsamp.sample_frames_indices(*args, rng=np.random.default_rng(3)),
            jsamp.sample_frames_indices(*args, rng=np.random.default_rng(3)))


# ---------------------------------------------------------------------------
# processors
# ---------------------------------------------------------------------------

def _step_diff(got, want):
    d = np.abs(got.astype(np.int64) - want.astype(np.int64))
    return int(d.max()), float((d > 0).mean())


@pytest.mark.parametrize("hw", SOURCES)
@pytest.mark.parametrize("smooth", [False, True])
def test_chat_video_eval_processor_matches_cv2(hw, smooth):
    """Downscale and upscale sources to 224: within one uint8 step on at
    most 0.5% of the pixels; normalize=True within that step over std."""
    frames = _img((3,) + hw + (3,), seed=hw[0], smooth=smooth)
    want = jproc.ChatVideoEvalProcessor(224, normalize=False)(frames)
    got = tproc.ChatVideoEvalProcessor(224, normalize=False, device="cpu")(frames)
    assert got.dtype == np.uint8 and got.shape == want.shape == (3, 224, 224, 3)
    worst, share = _step_diff(got, want)
    assert worst <= 1 and share <= 5e-3, (worst, share)
    want_n = jproc.ChatVideoEvalProcessor(224)(frames)
    got_n = tproc.ChatVideoEvalProcessor(224, device="cpu")(frames)
    assert got_n.dtype == np.float32
    step = 1.0 / (255.0 * np.asarray(tproc.CLIP_STD, np.float32))
    assert (np.abs(got_n - want_n) <= step + 1e-5).all()


@pytest.mark.parametrize("size", [(56, 56), (224, 224), (300, 200), (28, 90)])
def test_resize_bicubic_matches_jax_image_resize(size):
    frames = _img((2, 3, 96, 128, 3), seed=size[0])
    want = np.asarray(jproc.resize_bicubic(jnp.asarray(frames), size))
    got = tproc.resize_bicubic(torch.from_numpy(frames), size)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=5e-3, rtol=0)


def test_geometry_helpers_match_jax():
    frames = _img((2, 120, 160, 3), seed=1)
    for size in (56, 224):
        w, g = jproc.scale_short_side(frames, size), tproc.scale_short_side(frames, size, "cpu")
        assert g.shape == w.shape and _step_diff(g, w)[0] <= 1
        np.testing.assert_array_equal(tproc.center_crop(w, size), jproc.center_crop(w, size))
    tall = _img((200, 100, 3), seed=2)
    assert tproc.center_crop(tproc.scale_short_side(tall, 56, "cpu"), 56).shape == (56, 56, 3)
    rj, rt = np.random.default_rng(5), np.random.default_rng(5)
    for h, w, scale in [(100, 150, (0.5, 1.0)), (30, 300, (0.08, 1.0)), (300, 30, (0.9, 1.0)),
                        (64, 64, (0.5, 1.0))]:
        for _ in range(20):
            assert tproc.random_resized_crop_box(rt, h, w, scale) == \
                jproc.random_resized_crop_box(rj, h, w, scale)
    # float frames keep their dtype and match cv2 closely
    f = frames.astype(np.float32)
    np.testing.assert_allclose(tproc.resize_hw(f, 50, 70, "cpu"), jproc.resize_hw(f, 50, 70),
                               atol=0.5, rtol=0)
    np.testing.assert_allclose(tproc.normalize_np(frames), jproc.normalize_np(frames), rtol=1e-6)
    dev = tproc.normalize_frames(torch.from_numpy(frames), torch.float32).numpy()
    np.testing.assert_allclose(dev, np.asarray(jproc.normalize_frames(jnp.asarray(frames),
                                                                      dtype="float32")),
                               rtol=1e-5, atol=1e-5)


def test_processor_classes_match_jax():
    assert TRegistry.list_processors() == sorted(
        ["blip_caption", "blip2_image_train", "blip2_image_eval", "blip2_video_train",
         "chat_video_eval"])
    for name in TRegistry.list_processors():
        assert TRegistry.get_processor_class(name).__name__ == \
            jproc.Registry.get_processor_class(name).__name__
    for cap in ("A  Dog! (running)", "one two three four five", "#tag: x;y~z"):
        for kw in (dict(prompt="a photo of "), dict(max_words=3)):
            assert tproc.BlipCaptionProcessor(**kw)(cap) == jproc.BlipCaptionProcessor(**kw)(cap)
    img = _img((100, 80, 3), seed=3)
    train_t = tproc.Blip2ImageTrainProcessor(image_size=56, seed=0, normalize=False,
                                             device="cpu")
    train_j = jproc.Blip2ImageTrainProcessor(image_size=56, seed=0, normalize=False)
    for _ in range(3):
        assert _step_diff(train_t(img), train_j(img))[0] <= 1
    ev_t = tproc.Blip2ImageEvalProcessor(image_size=56, device="cpu")(img)
    ev_j = jproc.Blip2ImageEvalProcessor(image_size=56)(img)
    assert ev_t.dtype == np.float32 and np.abs(ev_t - ev_j).max() <= 0.016
    clip = _img((40, 20, 20, 3), seed=4)
    for test_mode in (True, False):
        np.testing.assert_array_equal(
            tproc.Blip2VideoTrainProcessor(8, test_mode=test_mode, seed=1)(clip),
            jproc.Blip2VideoTrainProcessor(8, test_mode=test_mode, seed=1)(clip))

    class FakePIL:       # anything with convert() is taken for a PIL image
        def convert(self, mode):
            assert mode == "RGB"
            return img

    np.testing.assert_array_equal(tproc._to_numpy(FakePIL()), img)
    out = tproc.ChatVideoEvalProcessor(56, normalize=False, device="cpu")(FakePIL())
    assert out.shape == (56, 56, 3) and out.dtype == np.uint8


def test_host_resize_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tproc.ChatVideoEvalProcessor(56)(_img((1, 60, 60, 3)))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdu.prepare_sample({"x": np.ones(2)})


# ---------------------------------------------------------------------------
# video readers: frame for frame
# ---------------------------------------------------------------------------

def _level(i: int) -> int:
    return 16 + 4 * i


@pytest.fixture(scope="module")
def mp4(tmp_path_factory):
    import cv2

    path = str(tmp_path_factory.mktemp("vid") / "synthetic.mp4")
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), FPS, (W, H))
    assert vw.isOpened(), "cv2 VideoWriter failed (mp4v codec missing)"
    rng = np.random.default_rng(0)
    for i in range(N_FRAMES):
        f = np.full((H, W, 3), _level(i), np.uint8)
        f[8:24, 8:40] = rng.integers(0, 256, (16, 32, 3))
        vw.write(f)
    vw.release()
    return path


def test_cv2_reader_matches_jax(mp4):
    idx = [40, 3, 3, 17, 0, 47]
    j, t = jvr.Cv2VideoReader(mp4), tvr.Cv2VideoReader(mp4)
    assert (len(t), t.get_avg_fps(), t.height, t.width) == \
        (len(j), j.get_avg_fps(), j.height, j.width) == (N_FRAMES, FPS, H, W)
    np.testing.assert_array_equal(t.get_batch(idx), j.get_batch(idx))
    j.close()
    t.close()


def test_native_reader_matches_jax(mp4, tmp_path):
    """The shared native decoder through the port's ctypes binding, frame
    for frame against the JAX package's binding and close to cv2; garbage
    and out-of-range indices raise."""
    if not tvr.native_available():
        pytest.skip("libvideodec.so not built (native/videodec)")
    assert jvr.native_available()
    idx = [40, 3, 3, 17, 0, 47]
    t, j = tvr.NativeVideoReader(mp4), jvr.NativeVideoReader(mp4)
    assert (len(t), t.height, t.width) == (len(j), j.height, j.width)
    assert abs(t.get_avg_fps() - FPS) < 0.5
    got = t.get_batch(idx)
    np.testing.assert_array_equal(got, j.get_batch(idx))
    assert np.abs(got.astype(int) - tvr.Cv2VideoReader(mp4).get_batch(idx).astype(int)).mean() < 2
    with pytest.raises(IOError):
        t.get_batch([len(t) + 5])
    t.close()
    bad = tmp_path / "not_a_video.mp4"
    bad.write_bytes(b"this is not an mp4 at all" * 100)
    with pytest.raises(IOError):
        tvr.NativeVideoReader(str(bad))
    assert isinstance(tvr.open_video(mp4), tvr.NativeVideoReader)


def test_read_frames_match_jax(mp4, tmp_path):
    import cv2
    import imageio

    for kw in (dict(sample="middle"), dict(sample="middle", clip=(1.0, 3.0)),
               dict(sample="rand"), dict(sample="fps2", max_num_frames=5)):
        want = jvr.read_frames_video(mp4, 8, rng=np.random.default_rng(1), **kw)
        got = tvr.read_frames_video(mp4, 8, rng=np.random.default_rng(1), **kw)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:] == want[1:]
    assert type(tvr.open_video(mp4)).__name__ == type(jvr.open_video(mp4)).__name__

    gif = str(tmp_path / "synthetic.gif")
    imageio.mimsave(gif, [np.full((H, W, 3), _level(i), np.uint8) for i in range(16)],
                    duration=0.1)
    want, got = jvr.read_frames_gif(gif, 4, sample="middle"), tvr.read_frames_gif(gif, 4,
                                                                                 sample="middle")
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:] and got[2] == 25.0

    raw = tmp_path / "raw"
    raw.mkdir()
    for i in range(1, 11):
        cv2.imwrite(str(raw / f"{i:0>6}.jpg"), np.full((H, W, 3), 10 * i, np.uint8))
    want = jvr.read_frames_rawframes(str(raw), 4, sample="middle", max_num_frames=10)
    got = tvr.read_frames_rawframes(str(raw), 4, sample="middle", max_num_frames=10)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:] and got[2] == 2.0
    assert set(tvr.VIDEO_READER_FUNCS) == set(jvr.VIDEO_READER_FUNCS)


# ---------------------------------------------------------------------------
# data utilities
# ---------------------------------------------------------------------------

class Seq:
    def __init__(self, items):
        self.items = items

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


class Stream:
    def __init__(self, tag):
        self.tag = tag

    def __iter__(self):
        while True:
            yield self.tag


def test_data_utils_match_jax():
    parts = [Seq([1, 2]), Seq([3, 4, 5]), Seq([6])]
    t, j = tdu.ConcatDataset(parts), jdu.ConcatDataset(parts)
    assert len(t) == len(j) == 6 and [t[i] for i in range(6)] == [j[i] for i in range(6)]
    samples = [{"a": 1, "b": 2}, {"a": 3, "c": 4}]
    assert tdu.ConcatDataset.shared_key_samples(samples) == \
        jdu.ConcatDataset.shared_key_samples(samples) == [{"a": 1}, {"a": 3}]
    ct = iter(tdu.ChainDataset([Stream("x"), Stream("y")], ratios=[1, 9], seed=0))
    cj = iter(jdu.ChainDataset([Stream("x"), Stream("y")], ratios=[1, 9], seed=0))
    assert [next(ct) for _ in range(200)] == [next(cj) for _ in range(200)]
    split = {"a": {"train": parts[0], "val": parts[2]}, "b": {"train": parts[1]},
             "c": {"train": Stream("s")}}
    rt, rj = tdu.reorg_datasets_by_split(split), jdu.reorg_datasets_by_split(split)
    assert rt == rj
    mt, mj = tdu.concat_datasets(rt), jdu.concat_datasets(rj)
    assert set(mt) == set(mj) == {"train", "val"}
    assert len(mt["train"][0]) == len(mj["train"][0]) == 5 and mt["val"] is parts[2]
    out = tdu.prepare_sample({"x": np.ones((2, 2), np.float32), "n": 3, "t": torch.ones(1),
                              "label": "keep", "ids": [1, 2]}, device="cpu")
    assert isinstance(out["x"], torch.Tensor) and out["x"].device.type == "cpu"
    assert int(out["n"]) == 3 and out["label"] == "keep" and out["ids"] == [1, 2]
