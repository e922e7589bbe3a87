"""paddle.vision.transforms parity (ref: python/paddle/vision/
transforms/transforms.py surface). A copy of
``paddle_tpu/vision/transforms.py``.

Numpy-based (HWC uint8/float arrays in, like the reference's 'cv2'
backend); ToTensor converts to CHW float32. PIL is not required. The
random transforms draw from Python's ``random``, so a DataLoader's
forked workers draw what the reference's would (``io/dataloader.py``).
"""
from __future__ import annotations

import numbers
import random
from typing import List, Sequence

import numpy as np


def _as_hwc(img):
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[:, :, None]
    return img


class Compose:
    def __init__(self, transforms: Sequence):
        self.transforms = list(transforms)

    def __call__(self, img):
        for t in self.transforms:
            img = t(img)
        return img


class BaseTransform:
    def __call__(self, img):
        return self._apply_image(img)


class ToTensor(BaseTransform):
    """HWC [0,255] -> CHW float32 [0,1] (ref: transforms.ToTensor)."""

    def __init__(self, data_format="CHW"):
        self.data_format = data_format

    def _apply_image(self, img):
        img = _as_hwc(img)
        if img.dtype == np.uint8:
            img = img.astype(np.float32) / 255.0
        else:
            img = img.astype(np.float32)
        if self.data_format == "CHW":
            img = img.transpose(2, 0, 1)
        return img


class Normalize(BaseTransform):
    """(x - mean) / std, operating on the configured data_format."""

    def __init__(self, mean=0.0, std=1.0, data_format="CHW",
                 to_rgb=False):
        if isinstance(mean, numbers.Number):
            mean = [mean, mean, mean]
        if isinstance(std, numbers.Number):
            std = [std, std, std]
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        self.data_format = data_format

    def _apply_image(self, img):
        img = np.asarray(img, np.float32)
        c = img.shape[0] if self.data_format == "CHW" else img.shape[-1]
        mean = self.mean[:c]
        std = self.std[:c]
        if self.data_format == "CHW":
            return (img - mean[:, None, None]) / std[:, None, None]
        return (img - mean) / std


def _resize_np(img, size, interpolation="bilinear"):
    """Bilinear / nearest resize without cv2/PIL (host numpy; small
    images, dataset-time cost). Nearest preserves exact values — needed
    for label/segmentation maps."""
    h, w = img.shape[:2]
    if isinstance(size, int):
        # shorter side to `size`, keep aspect (paddle semantics)
        if h < w:
            oh, ow = size, max(int(round(w * size / h)), 1)
        else:
            oh, ow = max(int(round(h * size / w)), 1), size
    else:
        oh, ow = size
    if (oh, ow) == (h, w):
        return img
    if interpolation == "nearest":
        yi = np.clip(np.round(np.linspace(0, h - 1, oh)).astype(int),
                     0, h - 1)
        xi = np.clip(np.round(np.linspace(0, w - 1, ow)).astype(int),
                     0, w - 1)
        return np.asarray(img)[yi][:, xi]
    if interpolation != "bilinear":
        raise ValueError(f"unsupported interpolation {interpolation!r}; "
                         "use 'bilinear' or 'nearest'")
    ys = np.linspace(0, h - 1, oh)
    xs = np.linspace(0, w - 1, ow)
    y0 = np.floor(ys).astype(int)
    x0 = np.floor(xs).astype(int)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    wy = (ys - y0)[:, None, None]
    wx = (xs - x0)[None, :, None]
    img_f = _as_hwc(img).astype(np.float32)
    top = img_f[y0][:, x0] * (1 - wx) + img_f[y0][:, x1] * wx
    bot = img_f[y1][:, x0] * (1 - wx) + img_f[y1][:, x1] * wx
    out = top * (1 - wy) + bot * wy
    if img.dtype == np.uint8:
        out = np.clip(np.round(out), 0, 255).astype(np.uint8)
    if np.asarray(img).ndim == 2:
        out = out[:, :, 0]
    return out


class Resize(BaseTransform):
    def __init__(self, size, interpolation="bilinear"):
        self.size = size
        self.interpolation = interpolation

    def _apply_image(self, img):
        return _resize_np(np.asarray(img), self.size, self.interpolation)


class CenterCrop(BaseTransform):
    def __init__(self, size):
        self.size = (size, size) if isinstance(size, int) else tuple(size)

    def _apply_image(self, img):
        img = np.asarray(img)
        h, w = img.shape[:2]
        th, tw = self.size
        i = max((h - th) // 2, 0)
        j = max((w - tw) // 2, 0)
        return img[i:i + th, j:j + tw]


class RandomCrop(BaseTransform):
    def __init__(self, size, padding=0):
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        self.padding = padding

    def _apply_image(self, img):
        img = np.asarray(img)
        if self.padding:
            p = self.padding
            pad = [(p, p), (p, p)] + [(0, 0)] * (img.ndim - 2)
            img = np.pad(img, pad, mode="constant")
        h, w = img.shape[:2]
        th, tw = self.size
        i = random.randint(0, max(h - th, 0))
        j = random.randint(0, max(w - tw, 0))
        return img[i:i + th, j:j + tw]


class RandomHorizontalFlip(BaseTransform):
    def __init__(self, prob=0.5):
        self.prob = prob

    def _apply_image(self, img):
        if random.random() < self.prob:
            return np.asarray(img)[:, ::-1].copy()
        return np.asarray(img)


class RandomVerticalFlip(BaseTransform):
    def __init__(self, prob=0.5):
        self.prob = prob

    def _apply_image(self, img):
        if random.random() < self.prob:
            return np.asarray(img)[::-1].copy()
        return np.asarray(img)


class RandomResizedCrop(BaseTransform):
    def __init__(self, size, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3)):
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        self.scale = scale
        self.ratio = ratio

    def _apply_image(self, img):
        img = np.asarray(img)
        h, w = img.shape[:2]
        area = h * w
        for _ in range(10):
            target = random.uniform(*self.scale) * area
            ar = random.uniform(*self.ratio)
            tw = int(round((target * ar) ** 0.5))
            th = int(round((target / ar) ** 0.5))
            if 0 < tw <= w and 0 < th <= h:
                i = random.randint(0, h - th)
                j = random.randint(0, w - tw)
                return _resize_np(img[i:i + th, j:j + tw], self.size)
        return _resize_np(img, self.size)


class Transpose(BaseTransform):
    def __init__(self, order=(2, 0, 1)):
        self.order = order

    def _apply_image(self, img):
        return _as_hwc(img).transpose(self.order)


class Pad(BaseTransform):
    """paddle semantics: int → all sides; (w, h) → left/right=w,
    top/bottom=h; (left, top, right, bottom) → asymmetric."""

    def __init__(self, padding, fill=0, padding_mode="constant"):
        if isinstance(padding, int):
            padding = (padding, padding, padding, padding)
        elif len(padding) == 2:
            padding = (padding[0], padding[1], padding[0], padding[1])
        elif len(padding) != 4:
            raise ValueError("padding must be an int, 2-tuple or 4-tuple")
        self.padding = tuple(padding)          # (left, top, right, bottom)
        self.fill = fill
        self.mode = padding_mode

    def _apply_image(self, img):
        img = np.asarray(img)
        left, top, right, bottom = self.padding
        pad = [(top, bottom), (left, right)] + [(0, 0)] * (img.ndim - 2)
        if self.mode == "constant":
            return np.pad(img, pad, mode="constant",
                          constant_values=self.fill)
        return np.pad(img, pad, mode=self.mode)


class BrightnessTransform(BaseTransform):
    def __init__(self, value):
        self.value = value

    def _apply_image(self, img):
        if not self.value:
            return np.asarray(img)
        img = np.asarray(img)
        alpha = 1 + random.uniform(-self.value, self.value)
        out = img.astype(np.float32) * alpha
        if img.dtype == np.uint8:
            return np.clip(out, 0, 255).astype(np.uint8)
        return out
