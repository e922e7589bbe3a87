"""Native runtime bindings (C++ blocking queue + multi-threaded file
DataFeed) via ctypes.

Port of ``paddle_tpu/native/__init__.py`` over the port's own copy of
the C++ source, ``src/datafeed.cc`` (ref: framework/data_feed.h
MultiSlotDataFeed, operators/reader/lod_tensor_blocking_queue.h):
batch assembly and file parsing run in C++ threads that never touch
the GIL, so the python train loop only pops ready numpy batches.

The shared library is compiled by ``g++`` at first use (never when this
module is imported) into ``build/paddle_tpu_torch/`` at the repository
root, keyed by a hash of the source and the flags, as
``ops/kernels.py`` builds the CUDA kernels; nothing is written beside
the source. ``PADDLE_TPU_NO_NATIVE=1`` skips the native route, as in
the JAX package (the Python parser still works). Every batch a
:class:`MultiSlotFeeder` hands out adds one to the
``dataset/native_batches`` counter.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from ..observability import metrics as _metrics

_SRC = Path(__file__).resolve().parent / "src" / "datafeed.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "paddle_tpu_torch"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-pthread", "-std=c++17"]
_lock = threading.Lock()
_lib = None


class NativeUnavailable(RuntimeError):
    pass


def library_path() -> Path:
    """Where the library of this source and these flags is built."""
    digest = hashlib.sha256(_SRC.read_bytes()
                            + " ".join(CXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libdatafeed_{digest[:16]}.so"


def _build(out: Path):
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(_SRC)],
                       check=True, capture_output=True, timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        detail = getattr(e, "stderr", b"") or b""
        raise NativeUnavailable(
            f"native build failed: {e}\n{detail.decode(errors='replace')}"
        ) from e
    os.replace(tmp, out)


def load_library():
    """Load (building if needed) the native library; raises
    NativeUnavailable when compilation is impossible."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        if os.environ.get("PADDLE_TPU_NO_NATIVE") == "1":
            raise NativeUnavailable("disabled via PADDLE_TPU_NO_NATIVE")
        path = library_path()
        if not path.exists():
            _build(path)
        lib = ctypes.CDLL(str(path))
        lib.ptq_create.restype = ctypes.c_void_p
        lib.ptq_create.argtypes = [ctypes.c_size_t]
        lib.ptq_destroy.argtypes = [ctypes.c_void_p]
        lib.ptq_push.restype = ctypes.c_int
        lib.ptq_push.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                 ctypes.c_size_t, ctypes.c_int]
        lib.ptq_pop.restype = ctypes.c_int64
        lib.ptq_pop.argtypes = [ctypes.c_void_p,
                                ctypes.POINTER(ctypes.c_char_p),
                                ctypes.c_int]
        lib.ptq_free.argtypes = [ctypes.c_char_p]
        lib.ptq_close.argtypes = [ctypes.c_void_p]
        lib.ptq_size.restype = ctypes.c_size_t
        lib.ptq_size.argtypes = [ctypes.c_void_p]
        lib.ptf_create.restype = ctypes.c_void_p
        lib.ptf_create.argtypes = [ctypes.POINTER(ctypes.c_char_p),
                                   ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                   ctypes.c_int, ctypes.c_size_t]
        lib.ptf_next.restype = ctypes.c_int
        lib.ptf_next.argtypes = [ctypes.c_void_p,
                                 ctypes.POINTER(ctypes.c_float),
                                 ctypes.POINTER(ctypes.c_int64),
                                 ctypes.c_int]
        lib.ptf_destroy.argtypes = [ctypes.c_void_p]
        lib.ptm_create.restype = ctypes.c_void_p
        lib.ptm_create.argtypes = [ctypes.POINTER(ctypes.c_char_p),
                                   ctypes.c_int, ctypes.c_int,
                                   ctypes.POINTER(ctypes.c_int),
                                   ctypes.POINTER(ctypes.c_int),
                                   ctypes.c_int, ctypes.c_int,
                                   ctypes.c_size_t]
        lib.ptm_batch_bytes.restype = ctypes.c_size_t
        lib.ptm_batch_bytes.argtypes = [ctypes.c_void_p]
        lib.ptm_next.restype = ctypes.c_int
        lib.ptm_next.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                 ctypes.c_int]
        lib.ptm_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def available() -> bool:
    try:
        load_library()
        return True
    except NativeUnavailable:
        return False


class BlockingQueue:
    """Bounded byte-buffer channel living in C++ (ref:
    LoDTensorBlockingQueue). push/pop release the GIL while blocked."""

    def __init__(self, capacity: int = 64):
        self._lib = load_library()
        self._q = self._lib.ptq_create(capacity)

    def push(self, data: bytes, timeout_ms: int = -1) -> bool:
        """False on timeout; raises on closed queue."""
        r = self._lib.ptq_push(self._q, data, len(data), timeout_ms)
        if r == -1:
            raise RuntimeError("queue closed")
        return r == 0

    def pop(self, timeout_ms: int = -1) -> Optional[bytes]:
        """None when closed and drained; raises TimeoutError."""
        out = ctypes.c_char_p()
        n = self._lib.ptq_pop(self._q, ctypes.byref(out), timeout_ms)
        if n == -1:
            return None
        if n == -2:
            raise TimeoutError("queue pop timed out")
        data = ctypes.string_at(out, n)
        self._lib.ptq_free(out)
        return data

    def close(self):
        self._lib.ptq_close(self._q)

    def __len__(self):
        return self._lib.ptq_size(self._q)

    def __del__(self):
        if getattr(self, "_q", None):
            self._lib.ptq_destroy(self._q)
            self._q = None


class FileFeeder:
    """Multi-threaded dense-slot text feeder (ref: MultiSlotDataFeed).

    Files hold lines "label v0 v1 ... v_{dim-1}"; C++ reader threads
    shard the file list and emit (features [n, dim] float32,
    labels [n] int64) batches.

        feeder = FileFeeder(files, batch_size=256, dim=39)
        for feats, labels in feeder:
            ...
    """

    def __init__(self, files: Sequence[str], batch_size: int, dim: int,
                 num_threads: int = 4, queue_capacity: int = 64):
        self._lib = load_library()
        self.batch_size = batch_size
        self.dim = dim
        arr = (ctypes.c_char_p * len(files))(
            *[os.fsencode(f) for f in files])
        self._f = self._lib.ptf_create(arr, len(files), batch_size, dim,
                                       num_threads, queue_capacity)
        self._feat_buf = np.empty((batch_size, dim), np.float32)
        self._label_buf = np.empty((batch_size,), np.int64)

    def next_batch(self, timeout_ms: int = -1):
        """(features, labels) copies, or None when drained."""
        n = self._lib.ptf_next(
            self._f,
            self._feat_buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            self._label_buf.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            timeout_ms)
        if n == 0:
            return None
        if n == -2:
            raise TimeoutError("feeder starved")
        if n == -4:
            raise IOError("FileFeeder: a data file failed to open")
        return (self._feat_buf[:n].copy(), self._label_buf[:n].copy())

    def __iter__(self):
        while True:
            b = self.next_batch()
            if b is None:
                return
            yield b

    def __del__(self):
        if getattr(self, "_f", None):
            self._lib.ptf_destroy(self._f)
            self._f = None


def ensure_built():
    """Eager pre-build entry: compiles the library now instead of at
    first use and returns the loaded ctypes library handle."""
    return load_library()


class MultiSlotFeeder:
    """Native MultiSlot-format parser (ref: framework/data_feed.cc
    MultiSlotDataFeed): reader threads shard the filelist, parse
    "<n> v..." slot groups per line and emit ready batches without
    holding the GIL. slots: list of (name, dtype, dim) with dtype
    "float32" (dense, n must equal dim) or "int64" (sparse, padded to
    dim with a per-row length vector).

    Iteration yields {name: np.ndarray} dicts (+ "<name>@LEN" for
    sparse slots) — the Dataset batch contract."""

    def __init__(self, files: Sequence[str], batch_size: int, slots,
                 num_threads: int = 4, queue_capacity: int = 64):
        self._lib = load_library()
        self.batch_size = int(batch_size)
        self.slots = [(n, d, int(dim)) for n, d, dim in slots]
        dtypes = (ctypes.c_int * len(slots))(
            *[0 if d == "float32" else 1 for _, d, _ in self.slots])
        dims = (ctypes.c_int * len(slots))(
            *[dim for _, _, dim in self.slots])
        arr = (ctypes.c_char_p * len(files))(
            *[os.fsencode(f) for f in files])
        self._m = self._lib.ptm_create(arr, len(files), self.batch_size,
                                       dtypes, dims, len(slots),
                                       num_threads, queue_capacity)
        self._buf = ctypes.create_string_buffer(
            self._lib.ptm_batch_bytes(self._m))

    def next_batch(self, timeout_ms: int = -1):
        n = self._lib.ptm_next(self._m, self._buf, timeout_ms)
        if n == 0:
            return None
        if n == -2:
            raise TimeoutError("multislot feeder starved")
        if n == -3:
            raise ValueError(
                "malformed MultiSlot line (dense slot arity mismatch, "
                "non-numeric token, or truncated record)")
        if n == -4:
            raise FileNotFoundError(
                "a file in the filelist could not be opened")
        out = {}
        off = ctypes.sizeof(ctypes.c_int)
        # np.frombuffer reads the ctypes buffer in place; only the
        # per-slot views are copied out (no full staging-buffer copy)
        for name, dtype, dim in self.slots:
            if dtype == "float32":
                out[name] = np.frombuffer(
                    self._buf, np.float32, n * dim,
                    off).reshape(n, dim).copy()
                off += 4 * n * dim
            else:
                out[name] = np.frombuffer(
                    self._buf, np.int64, n * dim,
                    off).reshape(n, dim).copy()
                off += 8 * n * dim
                out[name + "@LEN"] = np.frombuffer(
                    self._buf, np.int64, n, off).copy()
                off += 8 * n
        _metrics.counter_add("dataset/native_batches")
        return out

    def __iter__(self):
        while True:
            b = self.next_batch()
            if b is None:
                return
            yield b

    def __del__(self):
        if getattr(self, "_m", None):
            self._lib.ptm_destroy(self._m)
            self._m = None
