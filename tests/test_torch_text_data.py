"""The port's ``text/datasets.py`` against the JAX package's, on the CPU.

Tolerance 0: the module is a numpy copy, so every dataset's synthetic
split (train and test, under ``PADDLE_TPU_SYNTHETIC_DATA=1``), each
archive read from a small fixture, the vocabularies built from them, a
DataLoader pass over one, and the "files not found" error are equal to
the reference's.
"""
import tarfile
import zipfile

import numpy as np
import pytest

from paddle_tpu import text as jtext
from paddle_tpu.io import DataLoader as JaxDataLoader

import paddle_tpu_torch as tpt
from paddle_tpu_torch import text as ptext
from paddle_tpu_torch.io import DataLoader as PortDataLoader

CLASSES = {"Imdb": {}, "Imikolov": {"window_size": 4},
           "Imikolov_seq": {"data_type": "SEQ"}, "WMT16": {},
           "WMT14": {"dict_size": 500}, "Conll05st": {}, "Movielens": {},
           "UCIHousing": {}}


@pytest.fixture(autouse=True)
def _cpu():
    tpt.set_device("cpu")


def build(mod, name, **kw):
    return getattr(mod, name.split("_")[0])(**dict(CLASSES[name], **kw))


def flat(sample):
    if isinstance(sample, (tuple, list)):
        return [np.asarray(x) for x in sample]
    return [np.asarray(sample)]


def assert_same(got, want):
    assert type(got).__name__ == type(want).__name__ and len(got) == len(want)
    for i in range(len(want)):
        g, w = flat(got[i]), flat(want[i])
        assert len(g) == len(w)
        for a, b in zip(g, w):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    assert getattr(got, "word_idx", None) == getattr(want, "word_idx", None)


@pytest.mark.parametrize("name", list(CLASSES))
def test_synthetic_splits_and_missing_files_match(monkeypatch, tmp_path, name):
    monkeypatch.setenv("PADDLE_TPU_SYNTHETIC_DATA", "1")
    for mode in ("train", "test"):
        assert_same(build(ptext, name, mode=mode),
                    build(jtext, name, mode=mode))
    monkeypatch.delenv("PADDLE_TPU_SYNTHETIC_DATA")
    errors = []
    for mod in (jtext, ptext):
        with pytest.raises(RuntimeError) as e:
            build(mod, name, data_file=str(tmp_path / "nowhere"))
        errors.append(str(e.value))
    assert errors[0] == errors[1] and "not found" in errors[1]


def test_archives_read_alike(tmp_path):
    root = tmp_path / "aclImdb"
    for lab in ("pos", "neg"):
        d = root / "train" / lab
        d.mkdir(parents=True)
        for i in range(3):
            (d / f"{i}.txt").write_text(
                f"This movie was {'great fun' if lab == 'pos' else 'awful'}"
                f", number {i}!")
    with tarfile.open(tmp_path / "imdb.tar.gz", "w:gz") as tf:
        tf.add(root, arcname="aclImdb")
    data = tmp_path / "simple-examples" / "data"
    data.mkdir(parents=True)
    (data / "ptb.train.txt").write_text(
        "the cat sat on the mat\nthe dog sat on the rug\n")
    (data / "ptb.valid.txt").write_text("the cat sat on the rug\n")
    with tarfile.open(tmp_path / "ptb.tgz", "w:gz") as tf:
        tf.add(tmp_path / "simple-examples", arcname="./simple-examples")
    (tmp_path / "train").write_text("a b c\tx y\nno tab here\nd e\tz\n")
    with tarfile.open(tmp_path / "wmt16.tar.gz", "w:gz") as tf:
        tf.add(tmp_path / "train", arcname="wmt16/train")
    with zipfile.ZipFile(tmp_path / "ml.zip", "w") as zf:
        zf.writestr("ml-1m/ratings.dat", "".join(
            f"{u}::{m}::{(u * m) % 5 + 1}::0\n" for u in range(1, 5)
            for m in range(1, 6)))
    rs = np.random.RandomState(3)
    np.savetxt(tmp_path / "housing.data", rs.rand(20, 14))
    cases = [
        ("Imdb", dict(data_file=str(tmp_path / "imdb.tar.gz"), cutoff=0)),
        ("Imikolov", dict(data_file=str(tmp_path / "ptb.tgz"),
                          min_word_freq=0)),
        ("Imikolov_seq", dict(data_file=str(tmp_path / "ptb.tgz"),
                              min_word_freq=0, mode="test")),
        ("WMT16", dict(data_file=str(tmp_path / "wmt16.tar.gz"),
                       src_dict_size=50, trg_dict_size=60)),
        ("Movielens", dict(data_file=str(tmp_path / "ml.zip"),
                           mode="test")),
        ("UCIHousing", dict(data_file=str(tmp_path / "housing.data")))]
    for name, kw in cases:
        got, want = build(ptext, name, **kw), build(jtext, name, **kw)
        assert len(got) > 0
        assert_same(got, want)


def test_a_dataloader_pass_over_a_dataset(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_SYNTHETIC_DATA", "1")
    got = []
    for mod, loader in ((jtext, JaxDataLoader), (ptext, PortDataLoader)):
        ds = mod.UCIHousing(mode="test")
        got.append(list(loader(ds, batch_size=16, num_workers=2)))
    assert len(got[1]) == len(got[0]) == 7
    for g, w in zip(*got[::-1]):
        for a, b in zip(g, w):
            assert np.array_equal(a, b) and a.dtype == b.dtype
