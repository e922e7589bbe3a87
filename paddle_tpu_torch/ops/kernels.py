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
    },
}

_lock = threading.Lock()
_libs: dict = {}
# source name -> {"seconds": build time, "ptxas": nvcc's -Xptxas -v report}
build_log: dict = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise UnavailableError("nvcc not found: the CUDA kernels build only "
                               "where the CUDA toolkit is installed")
    return path


def _target(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:16]}.so"


def _load(name: str, path: Path):
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in SOURCES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = _I
    lib.ptt_error_string.argtypes = [_I]
    lib.ptt_error_string.restype = ctypes.c_char_p
    _libs[name] = lib


def build(names=None) -> dict:
    """Build (or find already built) and load the named sources, all
    ``nvcc`` processes started together. Returns :data:`build_log`."""
    names = list(SOURCES) if names is None else list(names)
    with _lock:
        todo = [n for n in names if n not in _libs]
        procs = {}
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        for name in todo:
            out = _target(name)
            if out.exists():
                build_log[name] = {"seconds": 0.0, "ptxas": "(cached build)"}
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                   str(CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp, out)
        for name, (proc, tmp, out) in procs.items():
            report, _ = proc.communicate()
            if proc.returncode != 0:
                raise ExternalError(f"nvcc failed on {name}.cu:\n{report}")
            os.replace(tmp, out)
            build_log[name] = {"seconds": time.perf_counter() - t0,
                               "ptxas": report}
        for name in todo:
            _load(name, _target(name))
    return build_log


def library(name: str):
    if name not in _libs:
        build([name])
    return _libs[name]


def check(lib, err: int, what: str):
    """Raise on a nonzero cudaError_t from a C entry point: a refused
    launch never runs, and a later synchronize would not report it."""
    if err != 0:
        raise ExternalError(
            f"{what}: CUDA error {err} "
            f"({lib.ptt_error_string(err).decode()})")
