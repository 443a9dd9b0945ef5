"""RandomAugment and VideoRandomAugment (stllm_tpu/data/randaugment.py), in
PyTorch on an explicit device: the CUDA card unless the caller names
another. The card's machine has no cv2, so the ops that the JAX package
leaves to cv2 are written out here:

  - ``equalize`` is cv2's ``equalizeHist`` LUT (float32 scale, rounded to
    nearest even) per image and channel;
  - ``sharpness`` blurs with cv2's 3x3 Gaussian for uint8 (weights
    1-2-1 by 1-2-1, reflect-101 borders, the sum rounded half up by 16);
  - Shear, Translate and Rotate are OpenCV 5's ``warpAffine`` (bilinear,
    border value 128), in float32 with fused multiply-adds.

The pointwise ops keep NumPy's arithmetic dtypes (float32 where the JAX op
multiplies a float32 array by a Python float, float64 where NumPy promotes
to it), so they and ``equalize`` give the JAX package's bytes.

Every op takes a uint8 tensor (..., H, W, C) and acts on each image of the
leading dimensions alone. The op picks come from a numpy ``Generator``
seeded as the JAX package's is, so one seed picks the same ops.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from stllm_tpu_torch.common.device import resolve_device

_IMG = (-3, -2, -1)


def identity(img, _):
    return img


def autocontrast(img, _):
    lo = img.amin(dim=_IMG, keepdim=True)
    hi = img.amax(dim=_IMG, keepdim=True)
    span = (hi.to(torch.int32) - lo.to(torch.int32)).to(torch.float64)
    scaled = (img.double() - lo.double()) * (255.0 / span.clamp(min=1.0))
    out = scaled.clamp(0, 255).to(torch.uint8)
    return torch.where(hi > lo, out, img)


def equalize(img, _):
    """cv2.equalizeHist on each channel of each image."""
    h, w, c = img.shape[-3:]
    flat = img.reshape(-1, h * w, c).permute(0, 2, 1).reshape(-1, h * w).long()   # (N*C, HW)
    rows = flat.shape[0]
    offsets = torch.arange(rows, device=img.device)[:, None] * 256
    hist = torch.bincount((flat + offsets).reshape(-1), minlength=rows * 256).reshape(rows, 256)
    first = (hist > 0).long().argmax(dim=1, keepdim=True)          # lowest value present
    h0 = hist.gather(1, first)
    total = h * w
    scale = torch.tensor(255.0, dtype=torch.float32, device=img.device) / (
        (total - h0).clamp(min=1).to(torch.float32))
    bins = torch.arange(256, device=img.device)[None]
    csum = torch.where(bins > first, hist, 0).cumsum(dim=1)
    lut = (csum.to(torch.float32) * scale).round().clamp(0, 255)
    lut = torch.where(h0 == total, first.to(torch.float32).expand(-1, 256), lut).to(torch.uint8)
    out = lut.gather(1, flat)
    return out.reshape(-1, c, h * w).permute(0, 2, 1).reshape(img.shape)


def _gaussian3(img):
    """cv2.GaussianBlur(img, (3, 3), 0) for uint8: (1, 2, 1) x (1, 2, 1) / 16,
    reflect-101 borders, the sum rounded half up."""
    x = img.to(torch.int32)
    h, w = x.shape[-3:-1]
    rows = torch.cat([x[..., 1:2, :, :], x, x[..., h - 2:h - 1, :, :]], dim=-3)
    v = rows[..., :-2, :, :] + 2 * rows[..., 1:-1, :, :] + rows[..., 2:, :, :]
    cols = torch.cat([v[..., :, 1:2, :], v, v[..., :, w - 2:w - 1, :]], dim=-2)
    s = cols[..., :, :-2, :] + 2 * cols[..., :, 1:-1, :] + cols[..., :, 2:, :]
    return ((s + 8) >> 4).to(torch.uint8)


def brightness(img, level):
    return (img.float() * level).clamp(0, 255).to(torch.uint8)


def sharpness(img, level):
    blurred = _gaussian3(img)
    out = img.float() * (1 + level) - blurred.float() * level
    return out.clamp(0, 255).to(torch.uint8)


def _fma(a, b, c):
    """a * b + c in float32 with one rounding (the float32 product is exact
    in float64)."""
    return (a.double() * b.double() + c.double()).float()


def _warp(img, m):
    """cv2.warpAffine(img, m, (w, h), INTER_LINEAR, BORDER_CONSTANT 128) as
    OpenCV 5 computes it: the inverse map in float64, then float32 source
    coordinates and bilinear lerps by fused multiply-adds, rounded to
    nearest even. ``m``: the 2x3 forward map as float64 numbers."""
    (m00, m01, m02), (m10, m11, m12) = m
    d = m00 * m11 - m01 * m10
    d = 1.0 / d if d != 0 else 0.0
    a11, a22, a12, a21 = m11 * d, m00 * d, -m01 * d, -m10 * d
    b1 = -a11 * m02 - a12 * m12
    b2 = -a21 * m02 - a22 * m12
    h, w = img.shape[-3:-1]
    dev = img.device
    a11, a12, b1, a21, a22, b2 = (torch.tensor(v, dtype=torch.float32, device=dev)
                                  for v in (a11, a12, b1, a21, a22, b2))
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None].expand(h, w)
    ys = torch.arange(h, dtype=torch.float32, device=dev)[:, None].expand(h, w)
    sx = _fma(a11, xs, _fma(a12, ys, b1))
    sy = _fma(a21, xs, _fma(a22, ys, b2))
    ix, iy = torch.floor(sx), torch.floor(sy)
    fx, fy = (sx - ix)[..., None], (sy - iy)[..., None]
    ix, iy = ix.long(), iy.long()
    x = img.float()

    def corner(dy, dx):
        yy, xx = iy + dy, ix + dx
        inside = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        v = x[..., yy.clamp(0, h - 1), xx.clamp(0, w - 1), :]
        return torch.where(inside[..., None], v, 128.0)

    p00, p01, p10, p11 = corner(0, 0), corner(0, 1), corner(1, 0), corner(1, 1)
    v0 = _fma(fx, p01 - p00, p00)
    v1 = _fma(fx, p11 - p10, p10)
    return torch.round(_fma(fy, v1 - v0, v0)).clamp(0, 255).to(torch.uint8)


def _f32(v: float) -> float:
    """``v`` rounded to float32, as the JAX op's float32 matrix holds it."""
    return float(np.float32(v))


def shear_x(img, level):
    return _warp(img, ((1.0, _f32(level), 0.0), (0.0, 1.0, 0.0)))


def shear_y(img, level):
    return _warp(img, ((1.0, 0.0, 0.0), (_f32(level), 1.0, 0.0)))


def translate_x(img, level):
    return _warp(img, ((1.0, 0.0, _f32(level * img.shape[-2])), (0.0, 1.0, 0.0)))


def translate_y(img, level):
    return _warp(img, ((1.0, 0.0, 0.0), (0.0, 1.0, _f32(level * img.shape[-3]))))


def rotate(img, degrees):
    """cv2.getRotationMatrix2D((w / 2, h / 2), degrees, 1.0), in float32."""
    h, w = img.shape[-3:-1]
    cx, cy = w / 2, h / 2
    angle = degrees * math.pi / 180
    alpha, beta = math.cos(angle), math.sin(angle)
    m = ((alpha, beta, (1 - alpha) * cx - beta * cy), (-beta, alpha, beta * cx + (1 - alpha) * cy))
    return _warp(img, tuple(tuple(_f32(v) for v in row) for row in m))


def posterize(img, bits):
    shift = 8 - int(bits)
    return (img >> shift) << shift


def solarize(img, thresh):
    return torch.where(img.double() < thresh, img, 255 - img)   # NumPy compares in float64


def color(img, level):
    gray = img.double().mean(dim=-1, keepdim=True)
    out = gray + (img.double() - gray) * level
    return out.clamp(0, 255).to(torch.uint8)


def contrast(img, level):
    mean = img.double().mean(dim=_IMG, keepdim=True)
    out = mean + (img.double() - mean) * level
    return out.clamp(0, 255).to(torch.uint8)


# name -> (fn, magnitude range at level 10)
OPS = {
    "Identity": (identity, (0, 0)),
    "AutoContrast": (autocontrast, (0, 0)),
    "Equalize": (equalize, (0, 0)),
    "Brightness": (brightness, (0.6, 1.4)),
    "Sharpness": (sharpness, (0.0, 1.0)),
    "ShearX": (shear_x, (-0.3, 0.3)),
    "ShearY": (shear_y, (-0.3, 0.3)),
    "TranslateX": (translate_x, (-0.2, 0.2)),
    "TranslateY": (translate_y, (-0.2, 0.2)),
    "Rotate": (rotate, (-30, 30)),
    "Posterize": (posterize, (4, 8)),
    "Solarize": (solarize, (64, 256)),
    "Color": (color, (0.6, 1.4)),
    "Contrast": (contrast, (0.6, 1.4)),
}


class RandomAugment:
    """Pick N random ops at magnitude M in [0, 10] per call. Takes and
    returns a uint8 (H, W, C) NumPy image; the ops run on ``device``."""

    def __init__(self, n: int = 2, m: int = 9,
                 augs: Optional[Sequence[str]] = None,
                 seed: Optional[int] = None, device=None):
        self.n = n
        self.m = m
        self.augs = list(augs) if augs else list(OPS)
        self.rng = np.random.default_rng(seed)
        self.device = resolve_device(device)

    def _level(self, name: str) -> float:
        lo, hi = OPS[name][1]
        return lo + (hi - lo) * (self.m / 10.0)

    def _pick(self) -> List[Tuple[str, float]]:
        names = [self.augs[i] for i in self.rng.integers(0, len(self.augs), self.n)]
        return [(n, self._level(n)) for n in names]

    def __call__(self, img: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(np.ascontiguousarray(img)).to(self.device)
        for name, level in self._pick():
            x = OPS[name][0](x, level)
        return x.cpu().numpy()


class VideoRandomAugment(RandomAugment):
    """The same op sequence on every frame of a clip (T, H, W, C): one pick
    a call, and the ops take each frame's statistics alone."""
