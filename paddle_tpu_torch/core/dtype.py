"""Dtype names to ``torch.dtype``.

Port of ``paddle_tpu/core/dtype.py``: the same public names
(``float32``, ``bfloat16``, ...) and aliases, backed by torch dtypes.
"""
from __future__ import annotations

import numpy as np
import torch

from .enforce import InvalidArgumentError, enforce

bool_ = torch.bool
int8 = torch.int8
uint8 = torch.uint8
int16 = torch.int16
int32 = torch.int32
int64 = torch.int64
float16 = torch.float16
bfloat16 = torch.bfloat16
float32 = torch.float32
float64 = torch.float64
complex64 = torch.complex64
complex128 = torch.complex128

_ALIASES = {
    "bool": bool_,
    "int8": int8,
    "uint8": uint8,
    "int16": int16,
    "int32": int32,
    "int64": int64,
    "float16": float16,
    "fp16": float16,
    "bfloat16": bfloat16,
    "bf16": bfloat16,
    "float32": float32,
    "fp32": float32,
    "float": float32,
    "float64": float64,
    "fp64": float64,
    "double": float64,
    "complex64": complex64,
    "complex128": complex128,
}


def convert_dtype(dtype) -> torch.dtype:
    """Normalize any dtype spec (str, torch.dtype, numpy dtype) to a
    ``torch.dtype``."""
    if dtype is None:
        return float32
    if isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str):
        key = dtype.lower()
        enforce(key in _ALIASES, f"unknown dtype {dtype!r}",
                InvalidArgumentError)
        return _ALIASES[key]
    name = np.dtype(dtype).name
    enforce(name in _ALIASES, f"unknown dtype {dtype!r}",
            InvalidArgumentError)
    return _ALIASES[name]


_NAMES = {bool_: "bool", int8: "int8", uint8: "uint8", int16: "int16",
          int32: "int32", int64: "int64", float16: "float16",
          bfloat16: "bfloat16", float32: "float32", float64: "float64",
          complex64: "complex64", complex128: "complex128"}


def dtype_name(dtype) -> str:
    """The canonical name of a dtype ("float32", "int64", ...): what the
    Program IR writes, as the JAX package writes ``np.dtype.name``."""
    return _NAMES[convert_dtype(dtype)]


def is_floating(dtype) -> bool:
    return convert_dtype(dtype).is_floating_point
