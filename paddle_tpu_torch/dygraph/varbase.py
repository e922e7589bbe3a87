"""Eager tensors and parameters.

Port of ``paddle_tpu/dygraph/varbase.py``. The JAX package wraps each
array in a ``VarBase`` that carries its tape node; here a plain
``torch.Tensor`` is the eager tensor, torch autograd is the tape, and a
parameter is a ``torch.nn.Parameter``. Arithmetic on tensors (``+``,
``/``, ``reshape``, indexing) is torch's own: none of those op types is
on an AMP list, so the reference's routing of them through the tracer
changes no value.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import get_device

Parameter = torch.nn.Parameter


def to_variable(value) -> torch.Tensor:
    """fluid.dygraph.to_variable parity: a tensor on the current device,
    keeping the value's dtype."""
    dev = get_device()
    if isinstance(value, torch.Tensor):
        return value if value.device == dev else value.to(dev)
    return torch.from_numpy(np.array(value)).to(dev)
