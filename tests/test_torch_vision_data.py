"""The port's ``vision/transforms.py``, ``vision/image_utils.py`` and
``vision/datasets.py`` against the JAX package's, on the CPU.

Tolerance 0 throughout: the modules are numpy copies, so under one
``random.seed`` and numpy seed every transform's output, the
``image_utils`` helpers' (PIL's decode where this machine has PIL), each
dataset's synthetic split, an archive read from a fixture, and the
"files not found" error are bit-equal to the reference's. The PaddleClas
recipe is ``chip_smoke.imagenet_transform``, the card's Drive A.
"""
import gzip
import io as _io
import pickle
import random
import struct
import tarfile

import numpy as np
import pytest

from paddle_tpu.vision import datasets as jds
from paddle_tpu.vision import image_utils as jiu
from paddle_tpu.vision import transforms as jT

import chip_smoke
import paddle_tpu_torch as tpt
from paddle_tpu_torch.vision import datasets as pds
from paddle_tpu_torch.vision import image_utils as piu
from paddle_tpu_torch.vision import transforms as pT


@pytest.fixture(autouse=True)
def _cpu():
    tpt.set_device("cpu")


def images():
    rs = np.random.RandomState(0)
    return {"uint8": rs.randint(0, 256, (37, 29, 3)).astype(np.uint8),
            "float": rs.rand(23, 31, 3).astype(np.float32),
            "gray": rs.randint(0, 256, (17, 21)).astype(np.uint8)}


def transforms(T):
    """(name, transform) pairs over the package's module ``T``."""
    return [
        ("to_tensor", T.ToTensor()),
        ("to_tensor_hwc", T.ToTensor(data_format="HWC")),
        ("normalize_hwc", T.Normalize([10.0, 20.0, 30.0], [2.0, 3.0, 4.0],
                                      data_format="HWC")),
        ("normalize_chw", T.Compose([T.ToTensor(), T.Normalize(0.5, 0.25)])),
        ("resize_short", T.Resize(16)),
        ("resize_hw", T.Resize((13, 40))),
        ("resize_nearest", T.Resize((9, 11), interpolation="nearest")),
        ("center_crop", T.CenterCrop((12, 9))),
        ("random_crop", T.RandomCrop(11, padding=2)),
        ("hflip", T.RandomHorizontalFlip(0.5)),
        ("vflip", T.RandomVerticalFlip(0.5)),
        ("resized_crop", T.RandomResizedCrop(15)),
        ("transpose", T.Transpose()),
        ("pad_int", T.Pad(2, fill=7)),
        ("pad_wh", T.Pad((1, 3))),
        ("pad_reflect", T.Pad((1, 2, 3, 4), padding_mode="reflect")),
        ("brightness", T.BrightnessTransform(0.4)),
        ("brightness_off", T.BrightnessTransform(0)),
        ("imagenet", chip_smoke.imagenet_transform(T, 20)),
    ]


@pytest.mark.parametrize("kind", ["uint8", "float", "gray"])
def test_transforms_bit_equal(kind):
    img = images()[kind]
    outs = []
    for T in (jT, pT):
        random.seed(3)
        out = []
        for name, t in transforms(T):
            if kind == "gray" and name in ("normalize_hwc", "imagenet",
                                           "transpose"):
                continue
            for _ in range(3):        # the random ones draw anew
                out.append((name, np.asarray(t(img))))
        outs.append(out)
    assert [n for n, _ in outs[1]] == [n for n, _ in outs[0]]
    for (name, got), (_, want) in zip(outs[1], outs[0]):
        assert got.dtype == want.dtype and got.shape == want.shape, name
        assert np.array_equal(got, want), name


def test_transform_errors_match():
    img = images()["uint8"]
    for T in (jT, pT):
        with pytest.raises(ValueError, match="unsupported interpolation"):
            T.Resize(8, interpolation="bicubic")(img)
        with pytest.raises(ValueError, match="padding must be"):
            T.Pad((1, 2, 3))


def test_image_utils_bit_equal(tmp_path):
    img = images()["uint8"]
    Image = pytest.importorskip("PIL.Image")
    png = _io.BytesIO()
    Image.fromarray(img).save(png, format="PNG")
    (tmp_path / "a.png").write_bytes(png.getvalue())
    with tarfile.open(tmp_path / "imgs.tar", "w") as tf:
        for i in range(3):
            info = tarfile.TarInfo(f"img{i}.png")
            info.size = len(png.getvalue())
            tf.addfile(info, _io.BytesIO(png.getvalue()))
    outs = []
    for iu in (jiu, piu):
        np.random.seed(4)
        out = [iu.resize_short(img, 20), iu.to_chw(img),
               iu.center_crop(img, 15), iu.random_crop(img, 15),
               iu.left_right_flip(img), iu.left_right_flip(img[:, :, 0],
                                                           False)]
        for train in (True, False):
            out.append(iu.simple_transform(img, 24, 20, train,
                                           mean=[1.0, 2.0, 3.0]))
        out += [iu.load_image(str(tmp_path / "a.png")),
                iu.load_image_bytes(png.getvalue(), is_color=False),
                iu.load_and_transform(str(tmp_path / "a.png"), 24, 20,
                                      False)]
        data_file = tmp_path / f"imgs-{len(outs)}.tar"
        data_file.write_bytes((tmp_path / "imgs.tar").read_bytes())
        meta = iu.batch_images_from_tar(str(data_file), "set",
                                        {"img0.png": 1, "img2.png": 0},
                                        num_per_batch=1)
        for name in open(meta).read().split():
            with open(name, "rb") as f:
                d = pickle.load(f)
            out += [np.frombuffer(d["data"][0], np.uint8),
                    np.asarray(d["label"])]
        outs.append(out)
    assert len(outs[0]) == len(outs[1]) == 15
    for got, want in zip(outs[1], outs[0]):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    with pytest.raises(Exception, match="to_chw"):
        piu.to_chw(img, (1, 0))


def _idx(path, magic, arr):
    with gzip.open(path, "wb") as f:
        f.write(struct.pack(">II", magic, arr.shape[0]))
        if magic == 2051:
            f.write(struct.pack(">II", *arr.shape[1:]))
        f.write(arr.astype(np.uint8).tobytes())


def _cifar(path, member_fmt, label_key, n=6):
    rs = np.random.RandomState(9)
    with tarfile.open(path, "w:gz") as tf:
        for name in member_fmt:
            blob = pickle.dumps({
                b"data": rs.randint(0, 256, (n, 3072)).astype(np.uint8),
                label_key: rs.randint(0, 10, (n,)).tolist()})
            info = tarfile.TarInfo(name)
            info.size = len(blob)
            tf.addfile(info, _io.BytesIO(blob))


def both(monkeypatch, synthetic, make):
    """make(datasets module) under PADDLE_TPU_SYNTHETIC_DATA, for both
    packages: each result, or the error it raised."""
    if synthetic:
        monkeypatch.setenv("PADDLE_TPU_SYNTHETIC_DATA", "1")
    else:
        monkeypatch.delenv("PADDLE_TPU_SYNTHETIC_DATA", raising=False)
    out = []
    for mod in (jds, pds):
        try:
            out.append(make(mod))
        except RuntimeError as e:
            out.append(str(e))
    return out


def samples(ds):
    return [ds[i] for i in range(len(ds))]


def assert_samples_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            a, b = np.asarray(a), np.asarray(b)
            assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("cls", ["MNIST", "FashionMNIST", "Cifar10",
                                 "Cifar100"])
def test_synthetic_splits_and_missing_files_match(monkeypatch, cls,
                                                  tmp_path):
    missing = tmp_path / "nowhere"
    for mode in ("train", "test"):
        jset, pset = both(monkeypatch, True, lambda m: getattr(m, cls)(
            mode=mode))
        assert len(pset) > 0
        assert_samples_equal(samples(pset), samples(jset))
    kw = ({"image_path": str(missing), "label_path": str(missing)}
          if "MNIST" in cls else {"data_file": str(missing)})
    jerr, perr = both(monkeypatch, False,
                      lambda m: getattr(m, cls)(mode="train", **kw))
    assert isinstance(perr, str) and perr == jerr
    assert "PADDLE_TPU_SYNTHETIC_DATA=1" in perr


def test_archives_read_alike(monkeypatch, tmp_path):
    rs = np.random.RandomState(8)
    imgs = rs.randint(0, 256, (5, 28, 28))
    _idx(tmp_path / "i.gz", 2051, imgs)
    _idx(tmp_path / "l.gz", 2049, rs.randint(0, 10, (5,)))
    _cifar(tmp_path / "c10.tar.gz", [f"cifar-10-batches-py/data_batch_{i}"
                                     for i in range(1, 6)], b"labels")
    _cifar(tmp_path / "c100.tar.gz", ["cifar-100-python/train"],
           b"fine_labels")
    sets = [
        lambda m: m.MNIST(image_path=str(tmp_path / "i.gz"),
                          label_path=str(tmp_path / "l.gz"),
                          transform=lambda x: x[::2]),
        lambda m: m.Cifar10(data_file=str(tmp_path / "c10.tar.gz")),
        lambda m: m.Cifar100(data_file=str(tmp_path / "c100.tar.gz"))]
    for make in sets:
        jset, pset = both(monkeypatch, False, make)
        assert len(pset) in (5, 30, 6)
        assert_samples_equal(samples(pset), samples(jset))
