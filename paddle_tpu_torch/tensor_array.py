"""TensorArray: the LOD_TENSOR_ARRAY of eager code.

Port of ``paddle_tpu/tensor_array.py`` (ref: framework/lod_tensor_array.h,
fluid/layers/control_flow.py create_array / array_write / array_read /
array_length). The JAX package's array is a dense preallocated
``[max_size, ...]`` buffer with functional writes, so that it can be a
``lax.while_loop`` carry; the port keeps that design and its results,
value for value:

- ``write`` returns a new array. An index at or past ``max_size``
  raises; a negative one counts from the end, as numpy's does, and one
  still out of range after that is dropped; ``length()`` is the
  high-water mark ``min(max(length, index + 1), max_size)`` of the
  indices as given;
- ``read`` counts a negative index from the end and clamps one out of
  range into [0, max_size - 1], as a gather does in XLA;
- ``stack`` is the whole buffer, the unwritten rows zero.

Values are torch tensors (the port's VarBase). Reading an index the
caller passes as a tensor reads it on the host.
"""
from __future__ import annotations

import numpy as np
import torch

from .core import dtype as dtypes
from .core.enforce import InvalidArgumentError, enforce


def _raw(v):
    return v if isinstance(v, torch.Tensor) else torch.as_tensor(
        np.asarray(v))


def _index(v) -> int:
    return int(_raw(v).reshape(()).to(torch.int64).item())


class TensorArray:
    """Fixed-capacity functional tensor array."""

    def __init__(self, element_shape, max_size, dtype="float32",
                 initial=None):
        self.max_size = int(max_size)
        enforce(self.max_size > 0, "TensorArray needs max_size > 0",
                InvalidArgumentError)
        if initial is not None:
            buf = _raw(initial)
            enforce(buf.shape[0] == self.max_size,
                    "initial buffer leading dim must equal max_size",
                    InvalidArgumentError)
            self._buf = buf
        else:
            from .device import get_device
            self._buf = torch.zeros(
                (self.max_size,) + tuple(element_shape),
                dtype=dtypes.convert_dtype(dtype), device=get_device())
        self._size = 0

    def write(self, index, value) -> "TensorArray":
        """array.write(i, v) -> a new array (ref write_to_array op)."""
        idx = _index(index)
        enforce(idx < self.max_size,
                f"TensorArray write at {idx} exceeds max_size "
                f"{self.max_size}; preallocate a larger array",
                InvalidArgumentError)
        out = TensorArray.__new__(TensorArray)
        out.max_size = self.max_size
        slot = idx + self.max_size if idx < 0 else idx
        value = _raw(value).to(self._buf.device, self._buf.dtype)
        out._buf = self._buf if slot < 0 else self._buf.index_copy(
            0, torch.tensor([slot], device=self._buf.device),
            value.reshape((1,) + tuple(self._buf.shape[1:])))
        out._size = min(max(self._size, idx + 1), self.max_size)
        return out

    def append(self, value) -> "TensorArray":
        return self.write(self._size, value)

    def read(self, index) -> torch.Tensor:
        """ref read_from_array op."""
        idx = _index(index)
        if idx < 0:
            idx += self.max_size
        return self._buf[min(max(idx, 0), self.max_size - 1)]

    def stack(self) -> torch.Tensor:
        """The dense [max_size, ...] buffer (callers mask or slice by
        length())."""
        return self._buf

    def length(self) -> torch.Tensor:
        """ref array_length op: int32, 0-d."""
        return torch.tensor(self._size, dtype=torch.int32)

    def __len__(self):
        return int(self._size)


def create_array(dtype="float32", element_shape=(), max_size=64):
    """fluid.layers.create_array parity."""
    return TensorArray(element_shape, max_size, dtype)


def array_write(x, i, array: TensorArray) -> TensorArray:
    """fluid.layers.array_write parity, functional: returns the new
    array."""
    return array.write(i, x)


def array_read(array: TensorArray, i) -> torch.Tensor:
    return array.read(i)


def array_length(array: TensorArray) -> torch.Tensor:
    return array.length()


def create_array_like(values) -> TensorArray:
    """A TensorArray holding ``values``, stacked."""
    vals = [_raw(v) for v in values]
    ta = TensorArray(vals[0].shape, len(vals), initial=torch.stack(vals))
    ta._size = len(vals)
    return ta
