"""Frame-index samplers (the port's copy of stllm_tpu/data/samplers.py):
every sampling rule the reference uses, in plain NumPy and Python on the
host, ahead of decode. The same arguments and the same ``np.random.Generator``
state give the same indices as the JAX package, bit for bit; the rules move
benchmark accuracy (MVBench indexing).

Sources:
  - get_frame_indices      reference: stllm/datasets/datasets/utils.py:262-300
  - get_seq_frames         reference: stllm/test/video_utils.py:75-99
  - mvbench_frame_indices  reference: stllm/test/mvbench/mv_bench.py:112-140
  - SampleFrames offsets   reference: stllm/processors/video_transform.py:40-220
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np


def get_frame_indices(
    num_frames: int,
    vlen: int,
    sample: str = "rand",
    fix_start: Optional[int] = None,
    input_fps: float = 1,
    max_num_frames: int = -1,
    rng: Optional[np.random.Generator] = None,
) -> List[int]:
    """Uniform-interval ('rand'/'middle') or fixed-fps ('fpsX') sampling
    (reference: stllm/datasets/datasets/utils.py:262-300). ``rng`` replaces the
    reference's global random state for reproducibility."""
    rng = rng or np.random.default_rng()
    if sample in ("rand", "middle"):
        acc_samples = min(num_frames, vlen)
        intervals = np.linspace(start=0, stop=vlen, num=acc_samples + 1).astype(int)
        ranges = [(intervals[i], intervals[i + 1] - 1) for i in range(acc_samples)]
        # NB branch ORDER matters: 'rand' wins over fix_start (reference
        # utils.py:271-280 checks sample=='rand' first)
        if sample == "rand":
            try:
                frame_indices = [int(rng.integers(x[0], x[1])) for x in ranges]
            except ValueError:  # empty range (x[1] <= x[0])
                frame_indices = sorted(rng.permutation(vlen)[:acc_samples].tolist())
        elif fix_start is not None:
            frame_indices = [x[0] + fix_start for x in ranges]
        else:
            frame_indices = [(x[0] + x[1]) // 2 for x in ranges]
        if len(frame_indices) < num_frames:  # pad with the last frame
            padded = [frame_indices[-1]] * num_frames
            padded[: len(frame_indices)] = frame_indices
            frame_indices = padded
        return frame_indices
    if sample.startswith("fps"):
        output_fps = float(sample[3:])
        duration = float(vlen) / input_fps
        delta = 1 / output_fps
        frame_seconds = np.arange(0 + delta / 2, duration + delta / 2, delta)
        frame_indices = np.around(frame_seconds * input_fps).astype(int)
        frame_indices = [int(e) for e in frame_indices if e < vlen]
        if 0 < max_num_frames < len(frame_indices):
            frame_indices = frame_indices[:max_num_frames]
        return frame_indices
    raise ValueError(f"unknown sample mode {sample!r}")


def get_seq_frames(total_num_frames: int, desired_num_frames: int) -> List[int]:
    """Segment-midpoint sampling used by the 64-frame QA/VCG evals
    (reference: stllm/test/video_utils.py:75-99)."""
    seg_size = float(total_num_frames - 1) / desired_num_frames
    seq = []
    for i in range(desired_num_frames):
        start = int(np.round(seg_size * i))
        end = int(np.round(seg_size * (i + 1)))
        seq.append((start + end) // 2)
    return seq


def mvbench_num_segments(video_len: float) -> int:
    """fps-1 adaptive segment count: 4..16 (reference: mv_bench.py:125-133)."""
    if video_len < 4:
        return 4
    if video_len > 16:
        return 16
    return math.floor(video_len)


def mvbench_frame_indices(
    bound: Optional[Tuple[float, float]],
    fps: float,
    max_frame: int,
    first_idx: int = 0,
    num_segments: int = 0,
) -> np.ndarray:
    """MVBench per-task frame picker, including the [start,end]-bounded clips
    and the fps-1 adaptive count when num_segments == 0
    (reference: stllm/test/mvbench/mv_bench.py:112-140; NB first_idx=1 for
    rawframe tasks)."""
    if bound:
        start, end = bound[0], bound[1]
    else:
        start, end = -100000, 100000
    start_idx = max(first_idx, round(start * fps))
    end_idx = min(round(end * fps), max_frame)
    video_len = (bound[1] - bound[0]) if bound else max_frame / fps
    n = num_segments if num_segments > 0 else mvbench_num_segments(video_len)
    seg_size = float(end_idx - start_idx) / n
    return np.array(
        [int(start_idx + (seg_size / 2) + np.round(seg_size * i)) for i in range(n)]
    )


# ---------------------------------------------------------------------------
# mmaction2-style SampleFrames (reference: processors/video_transform.py)
# ---------------------------------------------------------------------------

def sample_frames_indices(
    total_frames: int,
    num_clips: int,
    clip_len: int = 1,
    frame_interval: int = 1,
    test_mode: bool = True,
    out_of_bound: str = "loop",
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """Clip-offset frame sampling (reference: video_transform.py:61-145 for
    offsets, :180-214 for index expansion + out-of-bound handling). The
    configs only use clip_len=1/frame_interval=1 (blip_processors.py:113-135),
    but the general rule is kept."""
    rng = rng or np.random.default_rng()
    if test_mode:
        ori_clip_len = (clip_len - 1) * frame_interval + 1
        if clip_len == 1:
            avg = total_frames / float(num_clips)
            offsets = np.arange(num_clips) * avg + avg / 2.0
        else:
            max_offset = max(total_frames - ori_clip_len, 0)
            if num_clips > 1:
                between = max_offset / float(num_clips - 1)
                offsets = np.round(np.arange(num_clips) * between)
            else:
                offsets = np.array([max_offset // 2])
    else:
        ori_clip_len = clip_len * frame_interval
        avg = (total_frames - ori_clip_len + 1) // num_clips
        if avg > 0:
            offsets = np.arange(num_clips) * avg + rng.integers(0, avg, size=num_clips)
        elif total_frames > max(num_clips, ori_clip_len):
            offsets = np.sort(rng.integers(0, total_frames - ori_clip_len + 1,
                                           size=num_clips))
        elif avg == 0:
            ratio = (total_frames - ori_clip_len + 1.0) / num_clips
            offsets = np.around(np.arange(num_clips) * ratio)
        else:
            offsets = np.zeros((num_clips,), dtype=np.int32)

    inds = offsets[:, None].astype(np.int64) + np.arange(clip_len)[None, :] * frame_interval
    inds = inds.reshape((-1, clip_len))
    if out_of_bound == "loop":
        inds = np.mod(inds, total_frames)
    elif out_of_bound == "repeat_last":
        safe = inds < total_frames
        last = np.max(np.where(safe, inds, 0), axis=1)
        inds = np.where(safe, inds, last[:, None])
    else:
        raise ValueError(f"illegal out_of_bound option {out_of_bound!r}")
    return inds.reshape(-1).astype(np.int32)
