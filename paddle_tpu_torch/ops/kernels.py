"""Build and load the port's CUDA kernels.

Each source under ``paddle_tpu_torch/csrc/`` is compiled by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface and loaded with
``ctypes``. The build runs at first use, into ``build/paddle_tpu_torch/``
at the repository root (listed in ``.gitignore``), keyed by the source's
content hash so an edited source is rebuilt. Nothing is built when the
module is imported: the CPU tests import every module.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

from ..core.enforce import ExternalError, UnavailableError

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "paddle_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I64, _I, _F = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, \
    ctypes.c_float
_DIMS = [_I64] * 11                    # B, H, Sq, Sk, D, q strides, k strides
_TAIL = [_F, _I, _I, _P]               # scale, causal, dtype, stream
# source name -> {C function: argtypes}; every function returns a
# cudaError_t as int
SOURCES = {
    "flash_attention": {
        "ptt_flash_fwd": [_P] * 5 + _DIMS + _TAIL,
        "ptt_flash_bwd_dq": [_P] * 8 + _DIMS + _TAIL,
        "ptt_flash_bwd_dkv": [_P] * 8 + _DIMS + _TAIL,
        "ptt_flash_occupancy": [_I, _I, _I64, _P],   # kernel, dtype, D, int[4]
    },
}

_lock = threading.Lock()
_libs: dict = {}       # built library path -> loaded library
_active: dict = {}     # source name -> the library path its wrappers launch
# source name -> {"seconds": build time, "ptxas": nvcc's -Xptxas -v report}
build_log: dict = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise UnavailableError("nvcc not found: the CUDA kernels build only "
                               "where the CUDA toolkit is installed")
    return path


def _target(name: str, src=None) -> Path:
    src = Path(src) if src else CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:16]}.so"


def _load(name: str, path: Path):
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in SOURCES[name].items():
        if hasattr(lib, fn):       # an older version may lack a query entry
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = _I
    lib.ptt_error_string.argtypes = [_I]
    lib.ptt_error_string.restype = ctypes.c_char_p
    _libs[path] = lib


def build(names=None, sources=None) -> dict:
    """Build (or find already built) and load the named sources, all
    ``nvcc`` processes started together. ``sources`` maps a name to another
    file to build in place of ``csrc/<name>.cu`` (a version to compare
    with); the wrappers launch the library last built for a name. Returns
    :data:`build_log`."""
    sources = dict(sources or {})
    names = list(SOURCES) if names is None and not sources else \
        list(dict.fromkeys([*(names or ()), *sources]))
    with _lock:
        targets = {n: (Path(sources.get(n, CSRC / f"{n}.cu")),
                       _target(n, sources.get(n))) for n in names}
        procs = {}
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        for name, (src, out) in targets.items():
            if out in _libs:
                continue
            if out.exists():
                build_log[name] = {"seconds": 0.0, "ptxas": "(cached build)"}
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
            procs[name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp, out)
        for name, (proc, tmp, out) in procs.items():
            report, _ = proc.communicate()
            if proc.returncode != 0:
                raise ExternalError(f"nvcc failed on {targets[name][0]}:\n"
                                    f"{report}")
            os.replace(tmp, out)
            build_log[name] = {"seconds": time.perf_counter() - t0,
                               "ptxas": report}
        for name, (_, out) in targets.items():
            if out not in _libs:
                _load(name, out)
            _active[name] = out
    return build_log


def library(name: str):
    if name not in _active:
        build([name])
    return _libs[_active[name]]


def check(lib, err: int, what: str):
    """Raise on a nonzero cudaError_t from a C entry point: a refused
    launch never runs, and a later synchronize would not report it."""
    if err != 0:
        raise ExternalError(
            f"{what}: CUDA error {err} "
            f"({lib.ptt_error_string(err).decode()})")
