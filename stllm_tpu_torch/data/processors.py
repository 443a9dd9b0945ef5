"""Image and video preprocessing (stllm_tpu/data/processors.py): the
reference's torchvision processor pipeline split between host and device
(reference: stllm/processors/blip_processors.py,
stllm/conversation/conversation.py:192-200, instruction_data.py:8-19).

Geometry (resize, crop) takes and returns NumPy NHWC (T, H, W, C) or HWC
arrays, as the JAX package's does. The bicubic resize itself runs in torch
on an explicit device, the CUDA card unless the caller names another:
``F.interpolate(mode="bicubic", align_corners=False, antialias=False)`` is
Keys' cubic with a = -0.75 on half-pixel centres with clamped edges, which
is cv2's ``INTER_CUBIC``, so uint8 frames come back within one step of the
JAX package's cv2 resize (a few pixels in a thousand differ, by one). The
CLIP normalize and the dtype cast run on the device (``normalize_frames``),
and ``resize_bicubic`` is the device-side resize of the JAX package
(``jax.image.resize(..., "bicubic")``: a = -0.5, antialiased when
downsampling). Nothing here imports cv2 or PIL.
"""

from __future__ import annotations

import re
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from stllm_tpu_torch.common.device import resolve_device
from stllm_tpu_torch.common.registry import Registry
from stllm_tpu_torch.data.samplers import sample_frames_indices
from stllm_tpu_torch.models.vit import CLIP_MEAN, CLIP_STD
from stllm_tpu_torch.models.vit import normalize_uint8 as normalize_frames  # noqa: F401


def _to_numpy(img) -> np.ndarray:
    """PIL.Image (anything with ``convert``) | array -> HWC/THWC ndarray."""
    if hasattr(img, "convert"):
        img = np.asarray(img.convert("RGB"))
    return np.asarray(img)


# ---------------------------------------------------------------------------
# device-side ops
# ---------------------------------------------------------------------------

def _interpolate_nhwc(frames: torch.Tensor, size: Tuple[int, int], antialias: bool
                      ) -> torch.Tensor:
    """Bicubic resize of (N, H, W, C) float32 -> (N, h, w, C) float32."""
    x = frames.permute(0, 3, 1, 2)
    y = F.interpolate(x, size=size, mode="bicubic", align_corners=False,
                      antialias=antialias)
    return y.permute(0, 2, 3, 1)


def resize_bicubic(frames: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """On-device bicubic resize of (..., H, W, C) to ``size`` (H', W'), in
    float32, on the frames' device: Keys' cubic with a = -0.5, antialiased
    when downsampling, as ``jax.image.resize(..., "bicubic")``."""
    lead, (h, w, c) = frames.shape[:-3], frames.shape[-3:]
    flat = frames.float().reshape((-1, h, w, c))
    out = _interpolate_nhwc(flat, tuple(size), antialias=True)
    return out.reshape(tuple(lead) + (size[0], size[1], c))


# ---------------------------------------------------------------------------
# host-side geometric ops (NumPy in, NumPy out)
# ---------------------------------------------------------------------------

def resize_hw(frames: np.ndarray, h: int, w: int, device=None) -> np.ndarray:
    """Bicubic resize of HWC or THWC frames to (h, w), computed on
    ``device`` (the card by default, "cpu" when asked). uint8 frames are
    rounded and saturated back to uint8, as cv2 does; float frames keep
    their dtype."""
    dev = resolve_device(device)
    single = frames.ndim == 3
    x = torch.from_numpy(np.ascontiguousarray(frames[None] if single else frames))
    y = _interpolate_nhwc(x.to(dev).float(), (h, w), antialias=False)
    if frames.dtype == np.uint8:
        y = y.round().clamp(0, 255).to(torch.uint8)
    out = y.cpu().numpy().astype(frames.dtype, copy=False)
    return out[0] if single else out


def scale_short_side(frames: np.ndarray, size: int, device=None) -> np.ndarray:
    """Resize so the SHORTER side equals ``size``, keeping aspect ratio
    (reference GroupScale, stllm/test/video_transforms.py + conversation.py:195)."""
    h, w = frames.shape[-3:-1]
    if h <= w:
        nh, nw = size, max(1, int(round(w * size / h)))
    else:
        nh, nw = max(1, int(round(h * size / w))), size
    return resize_hw(frames, nh, nw, device)


def center_crop(frames: np.ndarray, size: int) -> np.ndarray:
    """(…, H, W, C) -> centered (…, size, size, C)."""
    h, w = frames.shape[-3:-1]
    top = max(0, (h - size) // 2)
    left = max(0, (w - size) // 2)
    return frames[..., top:top + size, left:left + size, :]


def random_resized_crop_box(
    rng: np.random.Generator,
    h: int,
    w: int,
    scale: Tuple[float, float] = (0.5, 1.0),
    ratio: Tuple[float, float] = (3.0 / 4.0, 4.0 / 3.0),
) -> Tuple[int, int, int, int]:
    """torchvision RandomResizedCrop.get_params semantics: 10 tries of
    (area-scaled, log-uniform aspect) boxes, else center-crop fallback.
    Returns (top, left, crop_h, crop_w)."""
    area = h * w
    log_ratio = (np.log(ratio[0]), np.log(ratio[1]))
    for _ in range(10):
        target_area = area * rng.uniform(scale[0], scale[1])
        aspect = np.exp(rng.uniform(*log_ratio))
        cw = int(round(np.sqrt(target_area * aspect)))
        ch = int(round(np.sqrt(target_area / aspect)))
        if 0 < cw <= w and 0 < ch <= h:
            top = int(rng.integers(0, h - ch + 1))
            left = int(rng.integers(0, w - cw + 1))
            return top, left, ch, cw
    in_ratio = w / h
    if in_ratio < ratio[0]:
        cw = w
        ch = int(round(cw / ratio[0]))
    elif in_ratio > ratio[1]:
        ch = h
        cw = int(round(ch * ratio[1]))
    else:
        cw, ch = w, h
    return (h - ch) // 2, (w - cw) // 2, ch, cw


def random_resized_crop(
    rng: np.random.Generator,
    frames: np.ndarray,
    size: int,
    scale: Tuple[float, float] = (0.5, 1.0),
    device=None,
) -> np.ndarray:
    """RandomResizedCrop(size, scale, bicubic) over HWC or THWC frames; one
    box shared by all frames of a clip (the reference applies the transform
    to the whole stacked clip tensor)."""
    h, w = frames.shape[-3:-1]
    top, left, ch, cw = random_resized_crop_box(rng, h, w, scale)
    crop = frames[..., top:top + ch, left:left + cw, :]
    return resize_hw(crop, size, size, device)


def normalize_np(frames: np.ndarray) -> np.ndarray:
    """Host-side ToTensor+Normalize (float32, NHWC)."""
    x = frames.astype(np.float32) / 255.0
    return (x - np.asarray(CLIP_MEAN, np.float32)) / np.asarray(CLIP_STD, np.float32)


# ---------------------------------------------------------------------------
# processors (registry names match the reference YAMLs)
# ---------------------------------------------------------------------------

class BaseProcessor:
    """Identity transform (reference: processors/base_processor.py:11-26)."""

    def __call__(self, item):
        return item

    @classmethod
    def from_config(cls, cfg=None):
        return cls()


@Registry.register_processor("blip_caption")
class BlipCaptionProcessor(BaseProcessor):
    """Caption cleanup: strip punctuation/extra spaces, word-cap, optional
    prompt prefix (reference: blip_processors.py:29-69)."""

    def __init__(self, prompt: str = "", max_words: int = 50):
        self.prompt = prompt
        self.max_words = max_words

    def __call__(self, caption: str) -> str:
        return self.prompt + self.pre_caption(caption)

    def pre_caption(self, caption: str) -> str:
        caption = re.sub(r"([.!\"()*#:;~])", " ", caption.lower())
        caption = re.sub(r"\s{2,}", " ", caption)
        caption = caption.rstrip("\n").strip(" ")
        words = caption.split(" ")
        if len(words) > self.max_words:
            caption = " ".join(words[: self.max_words])
        return caption

    @classmethod
    def from_config(cls, cfg=None):
        cfg = cfg or {}
        return cls(prompt=cfg.get("prompt", ""), max_words=cfg.get("max_words", 50))


@Registry.register_processor("blip2_image_train")
class Blip2ImageTrainProcessor(BaseProcessor):
    """RandomResizedCrop(224, scale .5-1, bicubic) + normalize
    (reference: blip_processors.py:72-111). Returns float32 NHWC (or HWC);
    normalize=False keeps uint8 for the device-side normalize."""

    def __init__(self, image_size: int = 224, min_scale: float = 0.5,
                 max_scale: float = 1.0, normalize: bool = True,
                 seed: Optional[int] = None, device=None):
        self.image_size = image_size
        self.scale = (min_scale, max_scale)
        self.normalize = normalize
        self.rng = np.random.default_rng(seed)
        self.device = device

    def __call__(self, item):
        frames = _to_numpy(item)
        out = random_resized_crop(self.rng, frames, self.image_size, self.scale, self.device)
        return normalize_np(out) if self.normalize else out

    @classmethod
    def from_config(cls, cfg=None):
        cfg = cfg or {}
        return cls(
            image_size=cfg.get("image_size", 224),
            min_scale=cfg.get("min_scale", 0.5),
            max_scale=cfg.get("max_scale", 1.0),
            device=cfg.get("device"),
        )


@Registry.register_processor("blip2_image_eval")
class Blip2ImageEvalProcessor(BaseProcessor):
    """Resize(224,224, bicubic) + normalize (reference: blip_processors.py:138-165)."""

    def __init__(self, image_size: int = 224, normalize: bool = True, device=None):
        self.image_size = image_size
        self.normalize = normalize
        self.device = device

    def __call__(self, item):
        frames = _to_numpy(item)
        out = resize_hw(frames, self.image_size, self.image_size, self.device)
        return normalize_np(out) if self.normalize else out

    @classmethod
    def from_config(cls, cfg=None):
        cfg = cfg or {}
        return cls(image_size=cfg.get("image_size", 224), device=cfg.get("device"))


@Registry.register_processor("blip2_video_train")
class Blip2VideoTrainProcessor(BaseProcessor):
    """SampleFrames(clip_len=1, num_clips=num_frames) over a decoded clip
    (reference: blip_processors.py:113-135). Returns the sampled THWC frames
    (un-normalized, like the reference's bare ToTensor)."""

    def __init__(self, num_frames: int = 16, test_mode: bool = True,
                 seed: Optional[int] = None):
        self.num_frames = num_frames
        self.test_mode = test_mode
        self.rng = np.random.default_rng(seed)

    def __call__(self, item):
        frames = _to_numpy(item)  # (T, H, W, C)
        idx = sample_frames_indices(
            frames.shape[0], self.num_frames, test_mode=self.test_mode, rng=self.rng
        )
        return frames[idx]

    @classmethod
    def from_config(cls, cfg=None):
        cfg = cfg or {}
        return cls(num_frames=cfg.get("num_frames", 16),
                   test_mode=cfg.get("test_mode", True))


@Registry.register_processor("chat_video_eval")
class ChatVideoEvalProcessor(BaseProcessor):
    """GroupScale(224) + GroupCenterCrop(224) + normalize — the Chat/eval
    transform (reference: conversation.py:192-200). The resize runs on
    ``device`` (the card unless "cpu" is named); the result is host NumPy,
    uint8 unless ``normalize``."""

    def __init__(self, image_size: int = 224, normalize: bool = True, device=None):
        self.image_size = image_size
        self.normalize = normalize
        self.device = device

    def __call__(self, item):
        frames = _to_numpy(item)
        out = center_crop(scale_short_side(frames, self.image_size, self.device),
                          self.image_size)
        return normalize_np(out) if self.normalize else out

    @classmethod
    def from_config(cls, cfg=None):
        cfg = cfg or {}
        return cls(image_size=cfg.get("image_size", 224), device=cfg.get("device"))
