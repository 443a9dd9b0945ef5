"""Synthetic video (stllm_tpu/data/synth.py): smooth drifting frames,
whose adjacent frames share most content as real video does (the case
temporal token merging exploits), and iid noise (no redundancy, the
adversarial case). The same numpy ``Generator`` draws give the same frames.
"""

import numpy as np


def synth_video(rng, t: int, size: int) -> np.ndarray:
    """Smooth synthetic video (1, t, size, size, 3) uint8: random low-freq
    base + drifting crop window + small per-frame noise — adjacent frames
    share most content, like real video."""
    base = rng.normal(size=(size + t, size + t, 3)) * 40 + 128
    # blur the base a little (box filter) for spatial coherence
    k = 5
    c = np.cumsum(np.cumsum(base, 0), 1)
    c = np.pad(c, ((k, 0), (k, 0), (0, 0)))
    blur = (c[k:, k:] - c[:-k, k:] - c[k:, :-k] + c[:-k, :-k]) / (k * k)
    frames = []
    for i in range(t):
        win = blur[i:i + size, i:i + size]
        win = win + rng.normal(size=win.shape) * 4.0
        frames.append(np.clip(win, 0, 255))
    return np.stack(frames).astype(np.uint8)[None]


def noise_video(rng, t: int, size: int) -> np.ndarray:
    """iid uint8 noise frames (1, t, size, size, 3): no spatial or temporal
    redundancy — the adversarial arm for every merging lever."""
    return rng.integers(0, 256, (1, t, size, size, 3)).astype(np.uint8)
