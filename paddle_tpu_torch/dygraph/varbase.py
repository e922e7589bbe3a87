"""Eager tensors and parameters.

Port of ``paddle_tpu/dygraph/varbase.py``. The JAX package wraps each
array in a ``VarBase`` that carries its tape node; here a
``torch.Tensor`` is the eager tensor and torch autograd is the tape.
The members of the reference's ``VarBase`` that torch lacks are
installed on ``torch.Tensor`` when this module is imported, so every
tensor has them, whichever op made it, at no cost an op:

- ``stop_gradient``, over ``requires_grad``. ``False`` makes a floating
  tensor a leaf that gathers gradients; ``True`` on a tensor that an op
  made cuts the gradient there for the ops that read it afterwards
  (``detach_``), as the reference's tracer stops recording through it;
- ``gradient()`` (the accumulated gradient as a numpy array, or None),
  ``clear_gradient()`` and ``clear_grad()`` (it goes back to None);
  gradients add up across ``backward()`` calls until then, as torch's
  leaves do and the reference's engine does (``engine.py:24-36``);
- ``set_value``, ``astype`` and ``cast``, and ``persistable``.

Members torch already has keep torch's meaning (``grad``, ``detach``,
``clone``, ``backward``, ``__eq__``, ``shape``, ``size``, ``transpose``,
``max``, ``name``), with one extension: ``numpy()`` gives the host copy
where torch raises, for a tensor on the card, one that requires grad,
and bfloat16 (as ``ml_dtypes.bfloat16`` when that imports, the dtype of
the reference's arrays, else float32). Where torch returns an array it
returns the same one.

A parameter is a :class:`Parameter`, a ``torch.nn.Parameter`` that also
carries the reference's ``name``, ``trainable``, ``optimize_attr`` and
``regularizer`` (``:324-335``). Arithmetic on tensors (``+``, ``/``,
``reshape``, indexing) is torch's own: none of those op types is on an
AMP list, so the reference's routing of them through the tracer
changes no value.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import dtype as dtypes
from ..core.enforce import InvalidArgumentError
from ..device import get_device

_name_counter = [0]


def _auto_name():
    _name_counter[0] += 1
    return f"param_{_name_counter[0]}"


def _get_stop_gradient(self) -> bool:
    return not self.requires_grad


def _set_stop_gradient(self, value):
    if bool(value) == (not self.requires_grad):
        return
    if not value:
        # an integer tensor takes no gradient here or in the reference
        if self.is_floating_point() or self.is_complex():
            self.requires_grad_(True)
        return
    if self.is_leaf:
        self.requires_grad_(False)
        return
    try:
        self.detach_()
    except RuntimeError as e:
        raise InvalidArgumentError(
            "stop_gradient = True on a view that an op made cannot cut "
            "the gradient in place; take x = x.detach() instead") from e


def _numpy(self, *, force: bool = False) -> np.ndarray:
    if (not force and self.device.type == "cpu" and not self.requires_grad
            and self.dtype != torch.bfloat16):
        return _torch_numpy(self)
    return dtypes.host_array(self)


def _gradient(self):
    return None if self.grad is None else dtypes.host_array(self.grad)


def _clear_gradient(self):
    self.grad = None


def _set_value(self, value):
    """Replace the value, keeping the tensor object (the optimizer and
    ``state_dict`` hold it); of another shape or dtype the value's own
    are taken, as the reference's ``set_value`` does."""
    src = value if isinstance(value, torch.Tensor) else \
        dtypes.from_host(value)
    src = src.detach().to(self.device)
    with torch.no_grad():
        if src.shape == self.shape and src.dtype == self.dtype:
            self.copy_(src)
        else:
            self.data = src


def _astype(self, dtype):
    return self.to(dtypes.convert_dtype(dtype))


def _get_persistable(self) -> bool:
    return self.__dict__.get("_pt_persistable",
                             isinstance(self, torch.nn.Parameter))


def _set_persistable(self, value):
    self.__dict__["_pt_persistable"] = bool(value)


_MEMBERS = {
    "stop_gradient": property(_get_stop_gradient, _set_stop_gradient),
    "gradient": _gradient,
    "clear_gradient": _clear_gradient,
    "clear_grad": _clear_gradient,
    "set_value": _set_value,
    "astype": _astype,
    "cast": _astype,
    "persistable": property(_get_persistable, _set_persistable),
}
if not getattr(torch.Tensor, "_pt_members", False):
    # a member torch already has keeps torch's meaning
    _clash = [n for n in _MEMBERS if hasattr(torch.Tensor, n)]
    if _clash:
        raise RuntimeError(f"torch.Tensor already has {_clash}")
    torch.Tensor._pt_torch_numpy = torch.Tensor.numpy
    torch.Tensor._pt_members = True
_torch_numpy = torch.Tensor._pt_torch_numpy
for _name, _member in _MEMBERS.items():
    setattr(torch.Tensor, _name, _member)
torch.Tensor.numpy = _numpy


# the eager tensor is torch's (``dygraph.VarBase``, ``nn.VarBase``)
VarBase = torch.Tensor


class Parameter(torch.nn.Parameter):
    """A trainable leaf (ref: ``framework.py:5063`` Parameter): a
    ``torch.nn.Parameter`` with the reference's ``name``, ``trainable``
    (over ``requires_grad``), ``optimize_attr`` and ``regularizer``."""

    def __new__(cls, data=None, requires_grad=True, name=None):
        p = super().__new__(cls, data, requires_grad)
        p.__dict__["_pt_name"] = name or _auto_name()
        p.optimize_attr = {"learning_rate": 1.0}
        p.regularizer = None
        return p

    @property
    def name(self):
        return self.__dict__.get("_pt_name")

    @name.setter
    def name(self, value):
        self.__dict__["_pt_name"] = value

    @property
    def trainable(self) -> bool:
        return self.requires_grad

    @trainable.setter
    def trainable(self, value):
        self.requires_grad_(bool(value))


def to_variable(value, name=None, zero_copy=None) -> torch.Tensor:
    """fluid.dygraph.to_variable parity: a tensor on the current device,
    keeping the value's dtype; a tensor already there is returned as it
    is (the reference returns the same ``VarBase``)."""
    dev = get_device()
    if isinstance(value, torch.Tensor):
        return value if value.device == dev else value.to(dev)
    return dtypes.from_host(value).to(dev)
