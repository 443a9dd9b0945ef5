"""Video readers (stllm_tpu/data/video_reader.py): the repository's native
C++ FFmpeg decoder (``native/videodec``, shared with the JAX package,
through ctypes) with cv2 and imageio fallbacks, plus the reader-function
table the datasets and the eval harness dispatch on.

The reader semantics are the reference's (reference:
stllm/datasets/datasets/utils.py:302-417, read_frames_{decord,av,gif,rawframes}
and VIDEO_READER_FUNCS). Frames come back as NumPy (T, H, W, C) uint8, NHWC
and un-normalized, so they cross to the device as uint8 and are normalized
there. cv2 and imageio are imported inside the readers that use them: the
card's machine may have neither, and needs neither to run the port.
"""

from __future__ import annotations

import ctypes
import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from stllm_tpu_torch.data.samplers import get_frame_indices

_LIB_ENV = "STLLM_VIDEODEC_LIB"


def _find_library() -> Optional[str]:
    cands = []
    if os.environ.get(_LIB_ENV):
        cands.append(os.environ[_LIB_ENV])
    here = os.path.dirname(os.path.abspath(__file__))
    repo = os.path.dirname(os.path.dirname(here))
    cands.append(os.path.join(repo, "native", "videodec", "build", "libvideodec.so"))
    for c in cands:
        if os.path.exists(c):
            return c
    return None


_lib = None
_lib_tried = False


def _load_library():
    global _lib, _lib_tried
    if _lib_tried:
        return _lib
    _lib_tried = True
    path = _find_library()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None
    lib.vd_open.restype = ctypes.c_void_p
    lib.vd_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.vd_close.argtypes = [ctypes.c_void_p]
    lib.vd_num_frames.restype = ctypes.c_int64
    lib.vd_num_frames.argtypes = [ctypes.c_void_p]
    lib.vd_avg_fps.restype = ctypes.c_double
    lib.vd_avg_fps.argtypes = [ctypes.c_void_p]
    lib.vd_width.restype = ctypes.c_int
    lib.vd_width.argtypes = [ctypes.c_void_p]
    lib.vd_height.restype = ctypes.c_int
    lib.vd_height.argtypes = [ctypes.c_void_p]
    lib.vd_get_batch.restype = ctypes.c_int
    lib.vd_get_batch.argtypes = [
        ctypes.c_void_p,
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        ctypes.c_int64,
        np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
    ]
    lib.vd_last_error.restype = ctypes.c_char_p
    _lib = lib
    return _lib


def native_available() -> bool:
    return _load_library() is not None


class NativeVideoReader:
    """decord.VideoReader-equivalent over native/videodec (frame-accurate
    random access via a demux-scan pts index)."""

    def __init__(self, path: str, num_threads: int = 1):
        lib = _load_library()
        if lib is None:
            raise RuntimeError("libvideodec.so not built; see native/videodec")
        self._lib = lib
        self._h = lib.vd_open(path.encode(), num_threads)
        if not self._h:
            raise IOError(f"videodec open failed: {lib.vd_last_error().decode()}")
        self.width = lib.vd_width(self._h)
        self.height = lib.vd_height(self._h)

    def __len__(self) -> int:
        return int(self._lib.vd_num_frames(self._h))

    def get_avg_fps(self) -> float:
        return float(self._lib.vd_avg_fps(self._h))

    def get_batch(self, indices: Sequence[int]) -> np.ndarray:
        idx = np.ascontiguousarray(indices, np.int64)
        out = np.empty((len(idx), self.height, self.width, 3), np.uint8)
        rc = self._lib.vd_get_batch(self._h, idx, len(idx), out)
        if rc != 0:
            raise IOError(f"videodec get_batch failed ({rc}): "
                          f"{self._lib.vd_last_error().decode()}")
        return out

    def close(self):
        if self._h:
            self._lib.vd_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class Cv2VideoReader:
    """cv2.VideoCapture fallback with sequential-decode gather (cv2 frame
    seeks are unreliable; we decode forward and keep requested frames)."""

    def __init__(self, path: str, num_threads: int = 1):
        import cv2

        self._cv2 = cv2
        self.cap = cv2.VideoCapture(path)
        if not self.cap.isOpened():
            raise IOError(f"cv2 failed to open {path}")
        self._n = int(self.cap.get(cv2.CAP_PROP_FRAME_COUNT))
        self._fps = float(self.cap.get(cv2.CAP_PROP_FPS)) or 25.0
        self.width = int(self.cap.get(cv2.CAP_PROP_FRAME_WIDTH))
        self.height = int(self.cap.get(cv2.CAP_PROP_FRAME_HEIGHT))

    def __len__(self) -> int:
        return self._n

    def get_avg_fps(self) -> float:
        return self._fps

    def get_batch(self, indices: Sequence[int]) -> np.ndarray:
        cv2 = self._cv2
        want: Dict[int, List[int]] = {}
        for slot, i in enumerate(indices):
            want.setdefault(int(i), []).append(slot)
        out = np.empty((len(indices), self.height, self.width, 3), np.uint8)
        self.cap.set(cv2.CAP_PROP_POS_FRAMES, 0)
        last = max(want)
        i = 0
        got = 0
        while i <= last:
            ok, frame = self.cap.read()
            if not ok:
                break
            if i in want:
                rgb = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
                for slot in want[i]:
                    out[slot] = rgb
                got += len(want[i])
            i += 1
        if got < len(indices):  # stream shorter than header count: repeat last
            for idx in sorted(want):
                if idx >= i:
                    for slot in want[idx]:
                        out[slot] = out[max(0, got - 1)]
        return out

    def close(self):
        self.cap.release()


def open_video(path: str, num_threads: int = 1):
    """Native reader when built, cv2 otherwise."""
    if native_available():
        return NativeVideoReader(path, num_threads)
    return Cv2VideoReader(path, num_threads)


# ---------------------------------------------------------------------------
# reader functions (reference: VIDEO_READER_FUNCS, utils.py:412-417)
# ---------------------------------------------------------------------------

def read_frames_video(
    video_path: str,
    num_frames: int,
    sample: str = "rand",
    fix_start: Optional[int] = None,
    max_num_frames: int = -1,
    client=None,
    clip: Optional[Tuple[float, float]] = None,
    rng: Optional[np.random.Generator] = None,
) -> Tuple[np.ndarray, List[int], float]:
    """decord-semantics reader (reference read_frames_decord, utils.py:345-373):
    clip [start,end] seconds remaps the sampling window. Returns
    (frames THWC uint8, frame_indices, duration_seconds)."""
    vr = open_video(video_path, num_threads=1)
    try:
        vlen = len(vr)
        fps = vr.get_avg_fps()
        duration = vlen / float(fps)
        start_index = 0
        if clip:
            start, end = clip
            duration = end - start
            vlen = int(duration * fps)
            start_index = int(start * fps)
        frame_indices = get_frame_indices(
            num_frames, vlen, sample=sample, fix_start=fix_start,
            input_fps=fps, max_num_frames=max_num_frames, rng=rng,
        )
        if clip:
            frame_indices = [f + start_index for f in frame_indices]
        frames = vr.get_batch(frame_indices)
        return frames, list(frame_indices), float(duration)
    finally:
        vr.close()


def read_frames_gif(
    video_path: str,
    num_frames: int,
    sample: str = "rand",
    fix_start: Optional[int] = None,
    max_num_frames: int = -1,
    client=None,
    clip=None,
    rng: Optional[np.random.Generator] = None,
) -> Tuple[np.ndarray, List[int], float]:
    """GIF reader (reference read_frames_gif, utils.py:320-343; fps fixed at
    25 for TGIF)."""
    import imageio

    gif = imageio.get_reader(video_path)
    vlen = gif.get_length()
    if not np.isfinite(vlen) or vlen <= 0:
        vlen = sum(1 for _ in imageio.get_reader(video_path))
    vlen = int(vlen)
    frame_indices = get_frame_indices(
        num_frames, vlen, sample=sample, fix_start=fix_start,
        max_num_frames=max_num_frames, rng=rng,
    )
    wanted = set(frame_indices)
    by_index = {}
    for index, frame in enumerate(gif):
        if index in wanted:
            f = np.asarray(frame)
            if f.ndim == 2:
                f = np.stack([f] * 3, axis=-1)
            elif f.shape[-1] == 4:
                import cv2

                f = cv2.cvtColor(f, cv2.COLOR_RGBA2RGB)
            by_index[index] = f
    frames = np.stack([by_index[i] for i in sorted(by_index)])
    return frames, list(frame_indices), 25.0


def read_frames_rawframes(
    video_path: str,
    num_frames: int,
    sample: str = "rand",
    fix_start: Optional[int] = None,
    max_num_frames: int = -1,
    client=None,
    clip=None,
    rng: Optional[np.random.Generator] = None,
) -> Tuple[np.ndarray, List[int], float]:
    """Directory-of-jpgs reader: fps=5, filenames {:0>6}.jpg with offset 1 and
    an idx+1 fallback for missing files (reference read_frames_rawframes,
    utils.py:377-410)."""
    import cv2

    fps = 5
    tmpl = "{:0>6}.jpg"
    offset = 1
    frame_indices = get_frame_indices(
        num_frames, max_num_frames, sample=sample, fix_start=fix_start,
        input_fps=fps, max_num_frames=-1, rng=rng,
    )
    imgs: List[np.ndarray] = []
    cache: Dict[int, int] = {}
    for i, frame_idx in enumerate(frame_indices):
        if frame_idx in cache:
            imgs.append(imgs[cache[frame_idx]].copy())
            continue
        cache[frame_idx] = i
        fp = os.path.join(video_path, tmpl.format(frame_idx + offset))
        if not os.path.exists(fp):
            fp = os.path.join(video_path, tmpl.format(frame_idx + offset + 1))
        img = cv2.imread(fp)
        if img is None:
            raise IOError(f"missing raw frame {fp}")
        imgs.append(cv2.cvtColor(img, cv2.COLOR_BGR2RGB))
    frames = np.stack(imgs)
    return frames, list(frame_indices), float(max_num_frames / fps)


# 'decord' and 'av' both map to the native reader: they only differed by
# decode library in the reference (utils.py:412-417).
VIDEO_READER_FUNCS: Dict[str, Callable] = {
    "decord": read_frames_video,
    "av": read_frames_video,
    "video": read_frames_video,
    "gif": read_frames_gif,
    "rawframe": read_frames_rawframes,
}
