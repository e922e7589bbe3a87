"""Image-processing utilities (ref: python/paddle/dataset/image.py).
A copy of ``paddle_tpu/vision/image_utils.py``.

The reference backs these with cv2 (BGR uint8 HWC arrays); PIL
provides decode here, imported at first use, and numpy the rest. The
array contract is identical — HWC uint8 in, float32 CHW out of
``simple_transform`` — except channel order is RGB.
"""
from __future__ import annotations

import os
import pickle
import tarfile

import numpy as np

from ..core.enforce import InvalidArgumentError, enforce

__all__ = [
    "load_image", "load_image_bytes", "resize_short", "to_chw",
    "center_crop", "random_crop", "left_right_flip",
    "simple_transform", "load_and_transform", "batch_images_from_tar",
]


def _pil():
    try:
        from PIL import Image
        return Image
    except ImportError as e:  # pragma: no cover
        raise ImportError(
            "paddle.dataset.image needs Pillow (the reference used "
            "cv2, which is not shipped here)") from e


def load_image_bytes(data: bytes, is_color: bool = True) -> np.ndarray:
    """ref: image.py:141 — decode an encoded image from memory."""
    import io
    img = _pil().open(io.BytesIO(data))
    img = img.convert("RGB" if is_color else "L")
    arr = np.asarray(img)
    return arr


def load_image(file: str, is_color: bool = True) -> np.ndarray:
    """ref: image.py:167."""
    with open(file, "rb") as f:
        return load_image_bytes(f.read(), is_color)


def resize_short(im: np.ndarray, size: int) -> np.ndarray:
    """ref: image.py:197 — scale so the SHORTER edge equals size
    (delegates to the package's one short-edge resize,
    transforms._resize_np, so both paths round identically)."""
    from .transforms import _resize_np
    return _resize_np(np.asarray(im), size)


def to_chw(im: np.ndarray, order=(2, 0, 1)) -> np.ndarray:
    """ref: image.py:225."""
    enforce(len(im.shape) == len(order),
            f"to_chw: image rank {len(im.shape)} != order rank "
            f"{len(order)}", InvalidArgumentError)
    return im.transpose(order)


def _crop(im: np.ndarray, h0: int, w0: int, size: int) -> np.ndarray:
    return im[h0:h0 + size, w0:w0 + size]


def center_crop(im: np.ndarray, size: int,
                is_color: bool = True) -> np.ndarray:
    """ref: image.py:249."""
    h, w = im.shape[:2]
    return _crop(im, (h - size) // 2, (w - size) // 2, size)


def random_crop(im: np.ndarray, size: int,
                is_color: bool = True) -> np.ndarray:
    """ref: image.py:277."""
    h, w = im.shape[:2]
    h0 = np.random.randint(0, h - size + 1)
    w0 = np.random.randint(0, w - size + 1)
    return _crop(im, h0, w0, size)


def left_right_flip(im: np.ndarray, is_color: bool = True) -> np.ndarray:
    """ref: image.py:305."""
    return im[:, ::-1, :] if is_color and im.ndim == 3 else im[:, ::-1]


def simple_transform(im: np.ndarray, resize_size: int, crop_size: int,
                     is_train: bool, is_color: bool = True,
                     mean=None) -> np.ndarray:
    """ref: image.py simple_transform — resize-short, crop (+ random
    flip when training), CHW float32, optional mean subtraction."""
    im = resize_short(im, resize_size)
    if is_train:
        im = random_crop(im, crop_size, is_color)
        if np.random.randint(0, 2) == 1:
            im = left_right_flip(im, is_color)
    else:
        im = center_crop(im, crop_size, is_color)
    if im.ndim == 3:
        im = to_chw(im)
    im = im.astype(np.float32)
    if mean is not None:
        mean = np.asarray(mean, np.float32)
        if mean.ndim == 1 and im.ndim == 3:
            mean = mean[:, None, None]
        im -= mean
    return im


def load_and_transform(filename: str, resize_size: int, crop_size: int,
                       is_train: bool, is_color: bool = True,
                       mean=None) -> np.ndarray:
    """ref: image.py load_and_transform."""
    return simple_transform(load_image(filename, is_color), resize_size,
                            crop_size, is_train, is_color, mean)


def batch_images_from_tar(data_file: str, dataset_name: str,
                          img2label: dict,
                          num_per_batch: int = 1024) -> str:
    """ref: image.py:80 — decode every image in a tar into pickled
    (data, label) batch files next to it; returns the meta-file path."""
    batch_dir = data_file + "_batch"
    out_path = os.path.join(batch_dir, dataset_name)
    meta = os.path.join(out_path, "batch_meta")
    if os.path.exists(meta):
        return meta
    os.makedirs(out_path, exist_ok=True)
    data, labels, names, batch_idx = [], [], [], 0
    with tarfile.open(data_file) as tf:
        for member in tf.getmembers():
            if member.name not in img2label:
                continue
            raw = tf.extractfile(member).read()
            data.append(raw)
            labels.append(img2label[member.name])
            if len(data) == num_per_batch:
                name = os.path.join(out_path, f"batch_{batch_idx}")
                with open(name, "wb") as f:
                    pickle.dump({"data": data, "label": labels}, f,
                                protocol=2)
                names.append(name)
                data, labels = [], []
                batch_idx += 1
    if data:
        name = os.path.join(out_path, f"batch_{batch_idx}")
        with open(name, "wb") as f:
            pickle.dump({"data": data, "label": labels}, f, protocol=2)
        names.append(name)
    with open(meta, "w") as f:
        f.write("\n".join(names))
    return meta
