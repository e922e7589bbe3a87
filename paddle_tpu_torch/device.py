"""Where the port's tensors live.

The port runs on ``cuda`` unless the caller asks for the CPU with
``set_device("cpu")`` (the tests do). With no card and no such request
:func:`get_device` raises: nothing falls back to the CPU by itself.
"""
from __future__ import annotations

import torch

from .core.enforce import InvalidArgumentError, UnavailableError

_device = None   # None: "cuda", checked at first use


def set_device(device: str) -> torch.device:
    """paddle.set_device parity: "cpu", "cuda" or "cuda:N"."""
    global _device
    dev = torch.device(device)
    if dev.type not in ("cpu", "cuda"):
        raise InvalidArgumentError(f"unsupported device {device!r}")
    _device = dev
    return dev


def get_device() -> torch.device:
    dev = _device if _device is not None else torch.device("cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise UnavailableError(
            "no CUDA device is available; call "
            "paddle_tpu_torch.device.set_device('cpu') to run on the CPU")
    return dev
