"""Attention-map overlay (stllm_tpu/common/gradcam.py): bicubic upsample,
optional Gaussian blur, jet colormap, alpha blend. No cv2: the resize is
``data.processors.resize_hw`` (cv2's INTER_CUBIC) on ``device``, the blur
is scipy's ``gaussian_filter`` as in the JAX package, and the colormap is
the jet of OpenCV's ``COLORMAP_JET`` (its float32 anchors times 255,
rounded to nearest even: one entry of the 768 differs from cv2's by one
step).
"""

from __future__ import annotations

import numpy as np


def _jet_lut() -> np.ndarray:
    """(256, 3) float32 RGB in [0, 1]."""
    x = np.arange(256) / 255.0
    rgb = np.stack([np.clip(1.5 - np.abs(4 * x - c), 0, 1) for c in (3, 2, 1)], -1)
    return (np.round(rgb.astype(np.float32) * np.float32(255)) / 255.0).astype(np.float32)


def get_att_map(img: np.ndarray, att_map: np.ndarray, blur: bool = True,
                overlap: bool = True, device=None) -> np.ndarray:
    """img: (H, W, 3) float in [0, 1]; att_map: (h, w) at any scale. Returns
    the (H, W, 3) overlay in [0, 1]. The resize runs on ``device`` (the
    CUDA card unless another is named)."""
    from scipy.ndimage import gaussian_filter

    from stllm_tpu_torch.data.processors import resize_hw

    att = att_map.astype(np.float32)
    att -= att.min()
    if att.max() > 0:
        att /= att.max()
    h, w = img.shape[:2]
    att = resize_hw(att[..., None], h, w, device)[..., 0]
    if blur:
        att = gaussian_filter(att, 0.02 * max(h, w))
        att -= att.min()
        if att.max() > 0:
            att /= att.max()
    heat = _jet_lut()[(att * 255).astype(np.uint8)]
    if overlap:
        a = (att ** 0.7)[..., None]
        return (1 - a) * img + a * heat
    return heat
