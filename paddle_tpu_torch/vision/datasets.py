"""paddle.vision.datasets parity (ref: python/paddle/vision/datasets/
and python/paddle/dataset/ — MNIST, FashionMNIST, Cifar10/100). A copy
of ``paddle_tpu/vision/datasets.py``.

Nothing is downloaded: each dataset (1) reads the standard archive
format from ``data_file``/the cache dir when present, else (2) with
``PADDLE_TPU_SYNTHETIC_DATA=1`` generates a small deterministic
synthetic split (shape/dtype/label-range faithful — enough for
pipelines and tests), else (3) raises naming what to place where. The
cache dir is ``PADDLE_TPU_DATA_HOME`` (default
``~/.cache/paddle_tpu/datasets``), the JAX package's, so one setting
serves both packages.
"""
from __future__ import annotations

import gzip
import os
import pickle
import struct
import tarfile
from typing import Callable, Optional

import numpy as np

from ..io.dataloader import Dataset
_CACHE = os.path.expanduser(os.environ.get(
    "PADDLE_TPU_DATA_HOME", "~/.cache/paddle_tpu/datasets"))


def _synthetic_ok():
    return os.environ.get("PADDLE_TPU_SYNTHETIC_DATA") == "1"


def _missing(name, url_hint):
    raise RuntimeError(
        f"{name}: data files not found under {_CACHE} and this "
        f"environment cannot download ({url_hint}). Place the files "
        f"there, pass data_file=, or set PADDLE_TPU_SYNTHETIC_DATA=1 "
        f"for a deterministic synthetic split.")


class _ArrayDataset(Dataset):
    def __init__(self, images, labels, transform: Optional[Callable]):
        self.images = images
        self.labels = labels
        self.transform = transform

    def __len__(self):
        return len(self.images)

    def __getitem__(self, idx):
        img = self.images[idx]
        if self.transform is not None:
            img = self.transform(img)
        return img, self.labels[idx]


class MNIST(_ArrayDataset):
    """ref: python/paddle/vision/datasets/mnist.py (idx-ubyte format)."""

    NAME = "mnist"
    _IMAGE_MAGIC = 2051
    _LABEL_MAGIC = 2049

    def __init__(self, image_path=None, label_path=None, mode="train",
                 transform=None, download=True, backend=None):
        tag = "train" if mode == "train" else "t10k"
        image_path = image_path or os.path.join(
            _CACHE, self.NAME, f"{tag}-images-idx3-ubyte.gz")
        label_path = label_path or os.path.join(
            _CACHE, self.NAME, f"{tag}-labels-idx1-ubyte.gz")
        if os.path.exists(image_path) and os.path.exists(label_path):
            images = self._read_idx(image_path, self._IMAGE_MAGIC)
            labels = self._read_idx(label_path, self._LABEL_MAGIC)
        elif _synthetic_ok():
            # LEARNABLE synthetic split: a label-keyed bright square on
            # noise, so book-test convergence gates (test acc > chance)
            # hold like they would on the real digits
            # >= 640 train rows so batch-64 loops hit the book tests'
            # every-10-batches eval checkpoints
            n = 1024 if mode == "train" else 128
            rs = np.random.RandomState(0 if mode == "train" else 1)
            labels = rs.randint(0, 10, (n,)).astype(np.int64)
            images = rs.rand(n, 28, 28) * 64.0
            for i, k in enumerate(labels):
                images[i, 2 * k:2 * k + 8, 2 * k:2 * k + 8] += 160.0
            images = np.clip(images, 0, 255).astype(np.uint8)
        else:
            _missing(self.NAME, "http://yann.lecun.com/exdb/mnist/")
        super().__init__(images, labels.astype(np.int64), transform)

    @staticmethod
    def _read_idx(path, expect_magic):
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rb") as f:
            magic, n = struct.unpack(">II", f.read(8))
            assert magic == expect_magic, f"bad idx magic in {path}"
            if magic == 2051:
                rows, cols = struct.unpack(">II", f.read(8))
                data = np.frombuffer(f.read(), np.uint8)
                return data.reshape(n, rows, cols)
            return np.frombuffer(f.read(), np.uint8).astype(np.int64)


class FashionMNIST(MNIST):
    NAME = "fashion-mnist"


class Cifar10(_ArrayDataset):
    """ref: python/paddle/vision/datasets/cifar.py (python-pickle tar)."""

    NAME = "cifar10"
    _ARCHIVE = "cifar-10-python.tar.gz"
    _MEMBER = "cifar-10-batches-py/{}"
    _CLASSES = 10

    def __init__(self, data_file=None, mode="train", transform=None,
                 download=True, backend=None):
        data_file = data_file or os.path.join(_CACHE, self._ARCHIVE)
        if os.path.exists(data_file):
            images, labels = self._read_tar(data_file, mode)
        elif _synthetic_ok():
            n = 256 if mode == "train" else 64
            rs = np.random.RandomState(2 if mode == "train" else 3)
            images = (rs.rand(n, 32, 32, 3) * 255).astype(np.uint8)
            labels = rs.randint(0, self._CLASSES, (n,)).astype(np.int64)
        else:
            _missing(self.NAME, "https://www.cs.toronto.edu/~kriz/cifar.html")
        super().__init__(images, np.asarray(labels, np.int64), transform)

    def _read_tar(self, path, mode):
        names = ([self._MEMBER.format(f"data_batch_{i}")
                  for i in range(1, 6)] if mode == "train"
                 else [self._MEMBER.format("test_batch")])
        ims, labs = [], []
        with tarfile.open(path) as tf:
            for name in names:
                d = pickle.load(tf.extractfile(name), encoding="bytes")
                ims.append(np.asarray(d[b"data"], np.uint8)
                           .reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1))
                labs.extend(d.get(b"labels", d.get(b"fine_labels")))
        return np.concatenate(ims), labs


class Cifar100(Cifar10):
    NAME = "cifar100"
    _ARCHIVE = "cifar-100-python.tar.gz"
    _CLASSES = 100

    def _read_tar(self, path, mode):
        member = ("cifar-100-python/train" if mode == "train"
                  else "cifar-100-python/test")
        with tarfile.open(path) as tf:
            d = pickle.load(tf.extractfile(member), encoding="bytes")
        ims = (np.asarray(d[b"data"], np.uint8)
               .reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1))
        return ims, d[b"fine_labels"]
