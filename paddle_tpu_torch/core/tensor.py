"""Tensor core: a torch tensor on an explicit device with LoD metadata.

Port of ``TpuTensor`` (``paddle_tpu/core/tensor.py:25``), the value a
``Scope`` variable holds (ref: paddle/fluid/framework/tensor.h:46,
lod_tensor.h:114). The data is a ``torch.Tensor``; a numpy value is
copied onto the device it is given, else onto
:func:`paddle_tpu_torch.device.get_device`, so nothing lands on the CPU
unless the caller asked for it. ``LoDTensorView`` and ``SelectedRows``
are not ported: no op of the port makes them yet.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from . import dtype as dtypes

LoD = List[List[int]]  # level-of-detail offsets, e.g. [[0, 2, 5]]


def _on_device(value, device) -> torch.Tensor:
    from ..device import get_device
    if isinstance(value, torch.Tensor):
        return value if device is None else value.to(device)
    arr = np.array(value)                  # a copy: the caller keeps theirs
    return torch.from_numpy(arr).to(device if device is not None
                                    else get_device())


class TpuTensor:
    """A dense device tensor with optional LoD metadata."""

    __slots__ = ("value", "lod")

    def __init__(self, value, lod: Optional[LoD] = None, device=None):
        if isinstance(value, TpuTensor):
            lod = lod if lod is not None else value.lod
            value = value.value
        self.value = _on_device(value, device)
        self.lod = lod or []

    @property
    def shape(self):
        return tuple(self.value.shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.value.dtype

    @property
    def device(self) -> torch.device:
        return self.value.device

    def numel(self) -> int:
        return self.value.numel()

    def set_lod(self, lod: LoD):
        self.lod = lod

    def set(self, value, place=None):
        """pybind ``LoDTensor.set(ndarray, place)`` parity: replace the
        value, on ``place`` when given, else on the default device."""
        if isinstance(value, TpuTensor):
            value = value.value
        if place is None and not isinstance(value, torch.Tensor):
            from ..device import get_device
            place = get_device()
        self.value = _on_device(value, place)

    def recursive_sequence_lengths(self) -> List[List[int]]:
        return [[b - a for a, b in zip(level, level[1:])] for level in self.lod]

    def numpy(self) -> np.ndarray:
        """A host copy; bfloat16, which numpy lacks, comes back float32."""
        v = self.value.detach()
        if v.dtype == torch.bfloat16:
            v = v.float()
        return v.cpu().numpy()

    def astype(self, dtype) -> "TpuTensor":
        return TpuTensor(self.value.to(dtypes.convert_dtype(dtype)), self.lod)

    def __repr__(self):
        return (f"TpuTensor(shape={self.shape}, dtype={self.dtype}, "
                f"device={self.device}, lod={self.lod})")
