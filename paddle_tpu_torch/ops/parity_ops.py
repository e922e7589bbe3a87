"""Tensor ops of ``paddle_tpu/ops/parity_ops.py``.

Port of the nine op types of that module that the 2.0 tensor API
reaches: ``allclose``, ``bernoulli``, ``diag_v2``, ``empty``, ``eye``,
``histogram``, ``isinf``, ``isnan`` and ``randperm``. The rest of the
module waits for ROADMAP Queue 1 item 4c. The random ops draw on the
CPU from ``core/rng`` (a nonzero ``seed`` attr gives the op a stream of
its own; 0 a fresh seed from the global generator) and move the result.
"""
from __future__ import annotations

import torch

from ..core import dtype as dtypes, rng
from ..core.registry import register_op
from ..device import creation_device
from .tensor_ops import jnp_linspace


@register_op("allclose", non_differentiable_inputs=("Input", "Other"))
def allclose(inputs, attrs):
    """One bool (0-d): |x - y| <= atol + rtol * |y| everywhere."""
    x, y = inputs["Input"][0], inputs["Other"][0]
    return {"Out": [torch.isclose(
        x, y, rtol=float(attrs.get("rtol", 1e-5)),
        atol=float(attrs.get("atol", 1e-8)),
        equal_nan=bool(attrs.get("equal_nan", False))).all()]}


@register_op("bernoulli", non_differentiable_inputs=("X",))
def bernoulli(inputs, attrs):
    """A coin flip for each element, 1 with probability X, in X's dtype."""
    x = inputs["X"][0]
    gen = rng.op_generator(int(attrs.get("seed", 0)), "cpu")
    u = torch.rand(x.shape, generator=gen).to(x.device)
    return {"Out": [(u < x).to(x.dtype)]}


@register_op("diag_v2")
def diag_v2(inputs, attrs):
    """1-D: the square matrix with X on diagonal ``offset`` and
    ``padding_value`` elsewhere; 2-D: diagonal ``offset``."""
    x = inputs["X"][0]
    offset = int(attrs.get("offset", 0))
    padding = float(attrs.get("padding_value", 0.0))
    if x.ndim == 1:
        out = torch.diag(x, offset)
        if padding:
            mask = torch.diag(torch.ones_like(x), offset)
            out = out + (1 - mask) * padding
        return {"Out": [out]}
    return {"Out": [torch.diagonal(x, offset)]}


@register_op("empty")
def empty(inputs, attrs):
    """An uninitialized tensor of ``shape`` and ``dtype``."""
    shape = [int(v) for v in attrs.get("shape", [])]
    return {"Out": [torch.empty(shape, dtype=dtypes.convert_dtype(
        attrs.get("dtype", "float32")), device=creation_device())]}


@register_op("eye")
def eye(inputs, attrs):
    rows = int(attrs["num_rows"])
    cols = int(attrs.get("num_columns", -1))
    return {"Out": [torch.eye(rows, cols if cols >= 0 else rows,
                              dtype=dtypes.convert_dtype(
                                  attrs.get("dtype", "float32")),
                              device=creation_device())]}


@register_op("histogram", non_differentiable_inputs=("X",))
def histogram(inputs, attrs):
    """int64 counts of X in ``bins`` equal bins over [min, max] (the data's
    own range when both are 0), the last bin closed, values outside
    dropped: ``jnp.histogram``'s edges (its linspace) and its
    right-side search."""
    x = inputs["X"][0].reshape(-1)
    if not x.is_floating_point():
        x = x.to(torch.get_default_dtype())
    bins = int(attrs.get("bins", 100))
    lo, hi = float(attrs.get("min", 0)), float(attrs.get("max", 0))
    if lo == 0 and hi == 0:
        lo_t, hi_t = x.amin(), x.amax()
    else:
        lo_t = torch.tensor(lo, dtype=x.dtype, device=x.device)
        hi_t = torch.tensor(hi, dtype=x.dtype, device=x.device)
    same = lo_t == hi_t
    lo_t, hi_t = torch.where(same, lo_t - 0.5, lo_t), \
        torch.where(same, hi_t + 0.5, hi_t)
    edges = jnp_linspace(lo_t, hi_t, bins + 1)
    idx = torch.searchsorted(edges, x, right=True)
    idx = torch.where(x == edges[-1], bins, idx)
    counts = torch.zeros(bins + 2, dtype=torch.int64, device=x.device)
    counts.index_add_(0, idx, torch.ones_like(idx))
    return {"Out": [counts[1:bins + 1]]}


@register_op("isinf", non_differentiable_inputs=("X",))
def isinf(inputs, attrs):
    """One bool (0-d): any element infinite."""
    return {"Out": [torch.isinf(inputs["X"][0]).any()]}


@register_op("isnan", non_differentiable_inputs=("X",))
def isnan(inputs, attrs):
    return {"Out": [torch.isnan(inputs["X"][0]).any()]}


@register_op("randperm")
def randperm(inputs, attrs):
    """A permutation of 0..n-1, int64."""
    gen = rng.op_generator(int(attrs.get("seed", 0)), "cpu")
    return {"Out": [torch.randperm(int(attrs["n"]), generator=gen).to(
        creation_device())]}
