"""LoDTensorArray and control-flow glue ops.

Port of ``paddle_tpu/ops/array_ops.py`` (ref: the LOD_TENSOR_ARRAY family:
tensor_array_read_write.cc, lod_tensor_to_array_op.cc,
array_to_lod_tensor_op.cc, shrink_rnn_memory_op.cc,
split/merge_lod_tensor_op.cc, select_input/select_output). The JAX
package keeps a tensor array in one of two forms, and the port keeps the
same form wherever the JAX package would:

- dense: a preallocated ``[max_size, ...]`` buffer written out of place.
  ``array_length`` is then its capacity, not the number of writes; a
  negative index counts from the end and one still out of range is
  clamped into it (``lax.dynamic_update_index_in_dim`` and
  ``lax.dynamic_index_in_dim`` do both), where torch indexing would
  raise;
- list: a growing :class:`LoDTensorArrayValue` of (value, lod) entries,
  the reference's own LoDTensorArray, whose elements may change shape.

The list form is taken only while the LoD side channel (``core.lodctx``)
is active, which the executor arranges where the JAX executor runs a
block eagerly, and only outside a body the JAX package would trace
(:func:`traced_body`: the sub-blocks of ``static_rnn``, a bounded or
dense ``while_loop``, ``conditional_block`` and ``switch``).

``lod_tensor_to_array`` / ``array_to_lod_tensor`` are the dense
batch-time pivot with Length carried beside it; ``shrink_rnn_memory``
zero-masks finished rows instead of slicing a sorted prefix;
``split_lod_tensor`` / ``merge_lod_tensor`` route rows by a mask read on
the host (ragged outputs, eager only, as the reference's CPU kernel).
"""
from __future__ import annotations

import contextlib
import threading

import numpy as np
import torch

from ..core import lodctx
from ..core.enforce import InvalidArgumentError, enforce, host_only
from ..core.registry import register_op

_tls = threading.local()


def traced() -> bool:
    """Whether a sub-block the JAX package traces is running."""
    return getattr(_tls, "depth", 0) > 0


@contextlib.contextmanager
def traced_body():
    """Mark the run of a body the JAX package would trace (its values
    are tracers there, so its array ops take the dense form)."""
    _tls.depth = getattr(_tls, "depth", 0) + 1
    try:
        yield
    finally:
        _tls.depth -= 1


class LoDTensorArrayValue(list):
    """The list form of a tensor array: (value, lod) entries that grow
    with each write."""

    def entry(self, i):
        return self[int(i)]


def _scalar(v, dtype, device):
    # a fill kernel: no host-to-device copy (which syncs on the card)
    return torch.full((), v, dtype=dtype, device=device)


def _clamped(i, n):
    """Index tensor [1] of ``i`` on the device: a negative one counts
    from the end, then it is clamped into [0, n-1] (lax's dynamic
    slices)."""
    i = i.reshape(1).to(torch.int64)
    return torch.where(i < 0, i + n, i).clamp(0, max(n - 1, 0))


# ------------------------------------------------------------ array r/w
@register_op("write_to_array", non_differentiable_inputs=("I",))
def write_to_array(inputs, attrs):
    """ref: WriteToArrayOp. Array: the buffer (made from attr
    ``max_size`` when absent), X: the element, I: its index."""
    x = inputs["X"][0]
    i = inputs["I"][0]
    prev = inputs["Array"][0] if inputs.get("Array") else None
    if lodctx.active() is not None and not traced() and (
            prev is None or isinstance(prev, LoDTensorArrayValue)):
        idx = int(i.reshape(()).item())
        arr = LoDTensorArrayValue(prev or [])
        while len(arr) <= idx:
            arr.append(None)
        arr[idx] = (x, lodctx.input_lod("X"))
        return {"Out": [arr]}
    if prev is not None:
        buf = prev
    else:
        max_size = int(attrs.get("max_size", 0))
        enforce(max_size > 0, "write_to_array without an Array input "
                "needs a 'max_size' attr", InvalidArgumentError)
        buf = torch.zeros((max_size,) + tuple(x.shape), dtype=x.dtype,
                          device=x.device)
    return {"Out": [buf.index_copy(0, _clamped(i, buf.shape[0]),
                                   x.unsqueeze(0).to(buf.dtype))]}


@register_op("read_from_array", non_differentiable_inputs=("I",))
def read_from_array(inputs, attrs):
    """ref: ReadFromArrayOp."""
    buf = inputs["X"][0]
    i = inputs["I"][0]
    if isinstance(buf, LoDTensorArrayValue):
        idx = int(i.reshape(()).item())
        enforce(0 <= idx < len(buf) and buf[idx] is not None,
                f"read_from_array: index {idx} is unwritten (array has "
                f"{len(buf)} slots, holes unfilled)", InvalidArgumentError)
        val, lod = buf.entry(idx)
        if lod:
            lodctx.set_output_lod("Out", lod)
        return {"Out": [val]}
    return {"Out": [buf.index_select(0, _clamped(i, buf.shape[0]))[0]]}


@register_op("array_length", non_differentiable_inputs=("X",))
def array_length(inputs, attrs):
    """ref: LoDArrayLengthOp: the list form's length; the dense form's
    capacity (its leading dim; the live length is the loop counter in
    the While carry)."""
    buf = inputs["X"][0]
    if isinstance(buf, LoDTensorArrayValue):
        from ..device import creation_device
        return {"Out": [_scalar(len(buf), torch.int64, creation_device())]}
    return {"Out": [_scalar(buf.shape[0], torch.int64, buf.device)]}


# ------------------------------------------------------ batch/time pivot
@register_op("lod_tensor_to_array", non_differentiable_inputs=("Length",))
def lod_tensor_to_array(inputs, attrs):
    """[B, T, ...] -> buffer [T, B, ...] (Length rides beside it)."""
    x = inputs["X"][0]
    enforce(x.ndim >= 2, "lod_tensor_to_array needs [B, T, ...]",
            InvalidArgumentError)
    return {"Out": [x.transpose(0, 1)]}


@register_op("array_to_lod_tensor", non_differentiable_inputs=("Length",))
def array_to_lod_tensor(inputs, attrs):
    """[T, B, ...] -> [B, T, ...]; rows past Length are zeroed."""
    out = inputs["X"][0].transpose(0, 1)
    if inputs.get("Length"):
        length = inputs["Length"][0].to(torch.int64)
        t = torch.arange(out.shape[1], device=out.device)
        mask = t[None, :] < length[:, None]
        mask = mask.reshape(mask.shape + (1,) * (out.ndim - 2))
        out = torch.where(mask, out, torch.zeros((), dtype=out.dtype,
                                                 device=out.device))
    return {"Out": [out]}


@register_op("shrink_rnn_memory", non_differentiable_inputs=("I",
                                                             "Length"))
def shrink_rnn_memory(inputs, attrs):
    """Rows whose Length is at most I are zeroed (the static-shape form
    of slicing the still-active prefix of a length-sorted batch)."""
    x = inputs["X"][0]
    i = inputs["I"][0].reshape(()).to(torch.int64)
    active = inputs["Length"][0].to(torch.int64) > i
    active = active.reshape(active.shape + (1,) * (x.ndim - 1))
    return {"Out": [torch.where(active, x, torch.zeros(
        (), dtype=x.dtype, device=x.device))]}


# ------------------------------------------------------- mask routing
def _host_mask(mask, op):
    return host_only(mask, op).reshape(-1).astype(bool)


@register_op("split_lod_tensor", non_differentiable_inputs=("Mask",))
def split_lod_tensor(inputs, attrs):
    """Rows of X where Mask is set (OutTrue) and the others (OutFalse);
    the mask is read on the host (ragged outputs)."""
    x = inputs["X"][0]
    mask = _host_mask(inputs["Mask"][0], "split_lod_tensor")
    enforce(mask.shape[0] == x.shape[0],
            "split_lod_tensor: mask length must match batch",
            InvalidArgumentError)
    rows = np.arange(mask.shape[0])
    pick = [torch.from_numpy(rows[m]).to(x.device) for m in (mask, ~mask)]
    return {"OutTrue": [x.index_select(0, pick[0])],
            "OutFalse": [x.index_select(0, pick[1])]}


@register_op("merge_lod_tensor", non_differentiable_inputs=("Mask",))
def merge_lod_tensor(inputs, attrs):
    """Inverse of split_lod_tensor: InTrue and InFalse rows back into
    Mask order."""
    mask = _host_mask(inputs["Mask"][0], "merge_lod_tensor")
    in_true, in_false = inputs["InTrue"][0], inputs["InFalse"][0]
    enforce(in_true.shape[0] + in_false.shape[0] == mask.shape[0],
            "merge_lod_tensor: row counts must sum to mask length",
            InvalidArgumentError)
    rows = np.arange(mask.shape[0])
    dev = in_true.device
    out = torch.zeros((mask.shape[0],) + tuple(in_true.shape[1:]),
                      dtype=in_true.dtype, device=dev)
    out = out.index_copy(0, torch.from_numpy(rows[mask]).to(dev), in_true)
    out = out.index_copy(0, torch.from_numpy(rows[~mask]).to(dev),
                         in_false.to(in_true.dtype))
    return {"Out": [out]}


# ---------------------------------------------------- branch multiplex
@register_op("select_input", non_differentiable_inputs=("Mask",))
def select_input(inputs, attrs):
    """Out = X[Mask], Mask counted from the end when negative and clamped
    into range; branches must agree in shape and dtype."""
    branches = inputs["X"]
    enforce(len(branches) >= 1, "select_input needs branches",
            InvalidArgumentError)
    for b in branches[1:]:
        enforce(b.shape == branches[0].shape and
                b.dtype == branches[0].dtype,
                "select_input branches must agree in shape/dtype "
                "(the XLA static-shape contract)", InvalidArgumentError)
    stacked = torch.stack(branches, 0)
    return {"Out": [stacked.index_select(
        0, _clamped(inputs["Mask"][0], len(branches)))[0]]}


@register_op("select_output", non_differentiable_inputs=("Mask",))
def select_output(inputs, attrs):
    """X to output slot Mask; the other outputs carry zeros."""
    x = inputs["X"][0]
    mask = inputs["Mask"][0].reshape(()).to(torch.int32)
    zero = torch.zeros_like(x)
    return {"Out": [torch.where(mask == k, x, zero)
                    for k in range(int(attrs.get("num_outputs", 2)))]}


@register_op("lod_reset", non_differentiable_inputs=("Y",))
def lod_reset(inputs, attrs):
    """Data passes through; OutLength is Y's real lod (an active LoD
    side channel), else Y, else attr ``target_lod`` as lengths."""
    x = inputs["X"][0]
    ylod = lodctx.input_lod("Y")
    if ylod:
        lodctx.set_output_lod("Out", ylod)
        return {"Out": [x], "OutLength": [torch.tensor(
            lodctx.widths(ylod[-1]), dtype=torch.int64).to(x.device)]}
    if inputs.get("Y"):
        new_len = inputs["Y"][0].to(torch.int64)
    else:
        tl = attrs.get("target_lod")
        enforce(tl is not None, "lod_reset needs Y or target_lod",
                InvalidArgumentError)
        new_len = torch.tensor(np.asarray(tl, np.int64)).to(x.device)
    return {"Out": [x], "OutLength": [new_len]}
