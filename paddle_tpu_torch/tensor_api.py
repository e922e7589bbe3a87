"""The 2.0 eager tensor API (``paddle.*``).

Port of ``paddle_tpu/tensor_api.py`` (ref: python/paddle/tensor/{math,
logic,creation,linalg,manipulation,search,random,stat}.py): the same
100 public names, each a thin eager shim over the registered op set
through ``trace_op``, so torch autograd differentiates them where the op
is differentiable. A non-tensor argument becomes a tensor on the current
device (``to_tensor``). The reference's quirks are kept: ``argmax`` and
``argmin`` with no ``axis`` take the last axis (the ``arg_*`` ops read no
``flatten`` attr), ``isfinite``, ``isinf`` and ``isnan`` give one flag
for the whole tensor, and ``equal_all`` is ``allclose`` at zero
tolerance, as no op type ``equal_all`` is registered.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.dtype import convert_dtype, dtype_name
from .core.enforce import InvalidArgumentError, enforce
from .core.registry import OpInfoMap
from .dygraph.tracer import trace_op

__all__ = [
    "add", "addcmul", "addmm", "allclose", "arange", "argmax", "argmin",
    "argsort", "bernoulli", "bmm", "cholesky", "chunk", "clip", "concat",
    "cross", "cumsum", "diag", "dist", "divide", "dot", "elementwise_sum",
    "empty", "empty_like", "equal", "equal_all", "expand", "expand_as",
    "eye", "flatten", "flip", "floor_divide", "full", "full_like", "gather",
    "gather_nd", "gaussian", "greater_equal", "greater_than", "histogram",
    "index_sample", "index_select", "inverse", "isfinite", "isinf", "isnan",
    "kron", "less_equal", "less_than", "log1p", "logsumexp",
    "masked_select", "matmul", "max", "maximum", "mean", "meshgrid", "min",
    "minimum", "mm", "multiply", "mv", "nonzero", "norm", "normal",
    "not_equal", "numel", "ones", "ones_like", "pow", "prod", "rand",
    "randint", "randperm", "remainder", "reshape", "roll", "scatter", "sign",
    "sort", "split", "squeeze", "stack", "standard_normal", "std", "sum",
    "t", "tanh", "tile", "topk", "trace", "tril", "triu", "unbind",
    "uniform", "unique", "unsqueeze", "var", "where", "zeros", "zeros_like"]


def _v(x):
    if isinstance(x, torch.Tensor):
        return x
    from . import to_tensor
    return to_tensor(np.asarray(x))


def _one(op, ins, attrs=None, slot="Out"):
    return trace_op(op, ins, attrs or {}, out_slots=[slot])[0]


def _unary(op, slot="Out", **fixed):
    def fn(x, name=None, **kw):
        return _one(op, {"X": [_v(x)]}, dict(fixed, **kw), slot)
    fn.__name__ = op
    return fn


def _binary(op, **fixed):
    def fn(x, y, name=None, **kw):
        return _one(op, {"X": [_v(x)], "Y": [_v(y)]}, dict(fixed, **kw))
    fn.__name__ = op
    return fn


def _axes_attr(axis):
    return list(axis) if isinstance(axis, (list, tuple)) else [axis]


def _reduce(op):
    def fn(x, axis=None, keepdim=False, name=None):
        attrs = {"keep_dim": keepdim}
        if axis is None:
            attrs["reduce_all"] = True
        else:
            attrs["dim"] = _axes_attr(axis)
        return _one(op, {"X": [_v(x)]}, attrs)
    fn.__name__ = op
    return fn


def _cast(out, dtype):
    if convert_dtype(dtype) != torch.int64:
        out = _one("cast", {"X": [out]}, {"out_dtype": dtype_name(dtype)})
    return out


# ------------------------------------------------------------- math
add = _binary("elementwise_add")
multiply = _binary("elementwise_mul")
divide = _binary("elementwise_div")
floor_divide = _binary("elementwise_floordiv")
remainder = _binary("elementwise_mod")
maximum = _binary("elementwise_max")
minimum = _binary("elementwise_min")
tanh = _unary("tanh")
sign = _unary("sign")
log1p = _unary("log1p")
kron = _binary("kron")
dot = _binary("dot")
cross = _binary("cross")
sum = _reduce("reduce_sum")
mean = _reduce("reduce_mean")
max = _reduce("reduce_max")
min = _reduce("reduce_min")
prod = _reduce("reduce_prod")


def pow(x, y, name=None):
    if isinstance(y, (int, float)):
        return _one("pow", {"X": [_v(x)]}, {"factor": float(y)})
    return _binary("elementwise_pow")(x, y)


def addcmul(input, tensor1, tensor2, value=1.0, name=None):
    return add(input, multiply(tensor1, tensor2) * float(value))


def addmm(input, x, y, beta=1.0, alpha=1.0, name=None):
    return _one("addmm", {"Input": [_v(input)], "X": [_v(x)],
                          "Y": [_v(y)]},
                {"Alpha": float(alpha), "Beta": float(beta)})


def logsumexp(x, axis=None, keepdim=False, name=None):
    attrs = {"keepdim": keepdim}
    if axis is None:
        attrs.update(reduce_all=True, axis=[])
    else:
        attrs["axis"] = _axes_attr(axis)
    return _one("logsumexp", {"X": [_v(x)]}, attrs)


def clip(x, min=None, max=None, name=None):
    return _one("clip", {"X": [_v(x)]},
                {"min": -3.4e38 if min is None else float(min),
                 "max": 3.4e38 if max is None else float(max)})


def trace(x, offset=0, axis1=0, axis2=1, name=None):
    return _one("trace", {"Input": [_v(x)]},
                {"offset": offset, "axis1": axis1, "axis2": axis2})


def elementwise_sum(inputs, name=None):
    return _one("sum", {"X": [_v(v) for v in inputs]})


# ------------------------------------------------------------- logic
equal = _binary("equal")
not_equal = _binary("not_equal")
less_than = _binary("less_than")
less_equal = _binary("less_equal")
greater_than = _binary("greater_than")
greater_equal = _binary("greater_equal")


def allclose(x, y, rtol=1e-5, atol=1e-8, equal_nan=False, name=None):
    return _one("allclose", {"Input": [_v(x)], "Other": [_v(y)]},
                {"rtol": float(rtol), "atol": float(atol),
                 "equal_nan": equal_nan})


def equal_all(x, y, name=None):
    if OpInfoMap.instance().has("equal_all"):
        return _one("equal_all", {"X": [_v(x)], "Y": [_v(y)]})
    return allclose(x, y, rtol=0.0, atol=0.0)


isfinite = _unary("isfinite")
isinf = _unary("isinf")
isnan = _unary("isnan")


# ---------------------------------------------------------- creation
def arange(start=0, end=None, step=1, dtype="int64", name=None):
    if end is None:
        start, end = 0, start
    return _one("range", {}, {"start": float(start), "end": float(end),
                              "step": float(step),
                              "dtype": dtype_name(dtype)})


def full(shape, fill_value, dtype="float32", name=None):
    return _one("fill_constant", {},
                {"shape": list(shape), "value": float(fill_value),
                 "dtype": dtype_name(dtype)})


def zeros(shape, dtype="float32", name=None):
    return full(shape, 0.0, dtype)


def ones(shape, dtype="float32", name=None):
    return full(shape, 1.0, dtype)


def full_like(x, fill_value, dtype=None, name=None):
    attrs = {"value": float(fill_value)}
    if dtype is not None:
        attrs["dtype"] = dtype_name(dtype)
    return _one("fill_any_like", {"X": [_v(x)]}, attrs)


def zeros_like(x, dtype=None, name=None):
    return full_like(x, 0.0, dtype)


def ones_like(x, dtype=None, name=None):
    return full_like(x, 1.0, dtype)


def empty(shape, dtype="float32", name=None):
    return _one("empty", {}, {"shape": list(shape),
                              "dtype": dtype_name(dtype)})


def empty_like(x, dtype=None, name=None):
    x = _v(x)
    return empty(list(x.shape), dtype or x.dtype)


def eye(num_rows, num_columns=None, dtype="float32", name=None):
    return _one("eye", {}, {"num_rows": int(num_rows),
                            "num_columns": int(num_columns or num_rows),
                            "dtype": dtype_name(dtype)})


def diag(x, offset=0, padding_value=0, name=None):
    return _one("diag_v2", {"X": [_v(x)]},
                {"offset": offset, "padding_value": padding_value})


def meshgrid(*args, **kwargs):
    arrs = args[0] if len(args) == 1 and isinstance(
        args[0], (list, tuple)) else list(args)
    return trace_op("meshgrid", {"X": [_v(a) for a in arrs]}, {},
                    out_slots=["Out"])


# ------------------------------------------------------------ linalg
def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    return _one("matmul_v2", {"X": [_v(x)], "Y": [_v(y)]},
                {"trans_x": transpose_x, "trans_y": transpose_y})


mm = matmul
bmm = _binary("bmm")
cholesky = _unary("cholesky", upper=False)


def inverse(x, name=None):
    return _one("inverse", {"Input": [_v(x)]}, slot="Output")


def mv(x, vec, name=None):
    return _one("mv", {"X": [_v(x)], "Vec": [_v(vec)]})


def t(x, name=None):
    x = _v(x)
    enforce(x.ndim <= 2, "t() expects rank <= 2", InvalidArgumentError)
    if x.ndim < 2:
        return x
    return _one("transpose2", {"X": [x]}, {"axis": [1, 0]})


def dist(x, y, p=2.0, name=None):
    return _one("dist", {"X": [_v(x)], "Y": [_v(y)]}, {"p": float(p)})


def norm(x, p=2.0, axis=None, keepdim=False, name=None):
    if isinstance(axis, (list, tuple)):
        # a matrix / several-axes norm composes ops (p_norm takes one axis)
        enforce(p == "fro" or p == 2.0 or p == 2,
                "multi-axis norm supports only the Frobenius/2-norm",
                InvalidArgumentError)
        sq = multiply(_v(x), _v(x))
        return pow(sum(sq, axis=list(axis), keepdim=keepdim), 0.5)
    if p == "fro" and axis is None:
        return _one("frobenius_norm", {"X": [_v(x)]},
                    {"reduce_all": True, "keep_dim": keepdim})
    attrs = {"porder": float(p if p != "fro" else 2.0),
             "keepdim": keepdim, "asvector": axis is None}
    if axis is not None:
        attrs["axis"] = int(axis)
    return _one("p_norm", {"X": [_v(x)]}, attrs)


def histogram(input, bins=100, min=0, max=0, name=None):
    return _one("histogram", {"X": [_v(input)]},
                {"bins": bins, "min": min, "max": max})


# ------------------------------------------------------- manipulation
def concat(x, axis=0, name=None):
    return _one("concat", {"X": [_v(v) for v in x]}, {"axis": int(axis)})


def stack(x, axis=0, name=None):
    return _one("stack", {"X": [_v(v) for v in x]}, {"axis": int(axis)},
                slot="Y")


def unbind(input, axis=0):
    return trace_op("unbind", {"X": [_v(input)]}, {"axis": int(axis)},
                    out_slots=["Out"])


def split(x, num_or_sections, axis=0, name=None):
    attrs = {"axis": int(axis)}
    if isinstance(num_or_sections, int):
        attrs["num"] = num_or_sections
    else:
        attrs["sections"] = list(num_or_sections)
    return trace_op("split", {"X": [_v(x)]}, attrs, out_slots=["Out"])


def chunk(x, chunks, axis=0, name=None):
    return split(x, chunks, axis)


def reshape(x, shape, name=None):
    return _one("reshape2", {"X": [_v(x)]}, {"shape": list(shape)})


def squeeze(x, axis=None, name=None):
    axes = [] if axis is None else _axes_attr(axis)
    return _one("squeeze2", {"X": [_v(x)]}, {"axes": axes})


def unsqueeze(x, axis, name=None):
    return _one("unsqueeze2", {"X": [_v(x)]}, {"axes": _axes_attr(axis)})


def flatten(x, start_axis=0, stop_axis=-1, name=None):
    return _one("flatten_contiguous_range", {"X": [_v(x)]},
                {"start_axis": start_axis, "stop_axis": stop_axis})


def flip(x, axis, name=None):
    return _one("flip", {"X": [_v(x)]}, {"axis": _axes_attr(axis)})


def roll(x, shifts, axis=None, name=None):
    attrs = {"shifts": _axes_attr(shifts)}
    if axis is not None:
        attrs["axis"] = _axes_attr(axis)
    return _one("roll", {"X": [_v(x)]}, attrs)


def tile(x, repeat_times, name=None):
    return _one("tile", {"X": [_v(x)]},
                {"repeat_times": list(repeat_times)})


def expand(x, shape, name=None):
    return _one("expand_v2", {"X": [_v(x)]}, {"shape": list(shape)})


def expand_as(x, y, name=None):
    return _one("expand_as_v2", {"X": [_v(x)]},
                {"target_shape": list(_v(y).shape)})


def gather(x, index, axis=0, name=None):
    return _one("gather", {"X": [_v(x)], "Index": [_v(index)]},
                {"axis": int(axis)})


def gather_nd(x, index, name=None):
    return _one("gather_nd", {"X": [_v(x)], "Index": [_v(index)]})


def scatter(x, index, updates, overwrite=True, name=None):
    return _one("scatter", {"X": [_v(x)], "Ids": [_v(index)],
                            "Updates": [_v(updates)]},
                {"overwrite": overwrite})


def where(condition, x=None, y=None, name=None):
    if x is None and y is None:
        return nonzero(condition)
    return _one("where", {"Condition": [_v(condition)], "X": [_v(x)],
                          "Y": [_v(y)]})


# -------------------------------------------------------------- search
def argmax(x, axis=None, keepdim=False, dtype="int64", name=None):
    out = _one("arg_max", {"X": [_v(x)]},
               {"axis": -1 if axis is None else int(axis),
                "flatten": axis is None, "keepdims": keepdim})
    return _cast(out, dtype)


def argmin(x, axis=None, keepdim=False, dtype="int64", name=None):
    out = _one("arg_min", {"X": [_v(x)]},
               {"axis": -1 if axis is None else int(axis),
                "flatten": axis is None, "keepdims": keepdim})
    return _cast(out, dtype)


def argsort(x, axis=-1, descending=False, name=None):
    return _one("argsort", {"X": [_v(x)]},
                {"axis": int(axis), "descending": descending},
                slot="Indices")


def sort(x, axis=-1, descending=False, name=None):
    return _one("argsort", {"X": [_v(x)]},
                {"axis": int(axis), "descending": descending})


def topk(x, k, axis=-1, largest=True, sorted=True, name=None):
    outs = trace_op("top_k_v2", {"X": [_v(x)]},
                    {"k": int(k), "axis": int(axis),
                     "largest": largest, "sorted": sorted},
                    out_slots=["Out", "Indices"])
    return outs[0], outs[1]


def nonzero(x, as_tuple=False):
    out = _one("where_index", {"Condition": [_v(x)]})
    enforce(not as_tuple, "nonzero(as_tuple=True) unsupported: use the "
            "[N, rank] index matrix form", InvalidArgumentError)
    return out


def index_select(x, index, axis=0, name=None):
    return _one("index_select", {"X": [_v(x)], "Index": [_v(index)]},
                {"dim": int(axis)})


def index_sample(x, index):
    return _one("index_sample", {"X": [_v(x)], "Index": [_v(index)]})


def masked_select(x, mask, name=None):
    return _one("masked_select", {"X": [_v(x)], "Mask": [_v(mask)]},
                slot="Y")


def unique(x, return_index=False, return_inverse=False,
           return_counts=False, axis=None, dtype="int64", name=None):
    enforce(axis is None, "unique(axis=...) is unsupported: the op "
            "flattens (the reference's default)", InvalidArgumentError)
    out, inv, first, cnt = trace_op(
        "unique", {"X": [_v(x)]}, {},
        out_slots=["Out", "Index", "Indices", "Counts"])
    res = [out]
    if return_index:
        res.append(first)
    if return_inverse:
        res.append(inv)
    if return_counts:
        res.append(cnt)
    return res[0] if len(res) == 1 else tuple(res)


# -------------------------------------------------------------- random
def uniform(shape, dtype="float32", min=-1.0, max=1.0, seed=0, name=None):
    return _one("uniform_random", {},
                {"shape": list(shape), "min": float(min),
                 "max": float(max), "seed": int(seed),
                 "dtype": dtype_name(dtype)})


rand = uniform


def normal(mean=0.0, std=1.0, shape=None, name=None):
    return _one("gaussian_random", {},
                {"shape": list(shape or [1]), "mean": float(mean),
                 "std": float(std), "dtype": "float32"})


def standard_normal(shape, dtype="float32", name=None):
    return _one("gaussian_random", {},
                {"shape": list(shape), "mean": 0.0, "std": 1.0,
                 "dtype": dtype_name(dtype)})


gaussian = standard_normal


def randint(low=0, high=None, shape=(1,), dtype="int64", name=None):
    if high is None:
        low, high = 0, low
    return _one("randint", {}, {"low": int(low), "high": int(high),
                                "shape": list(shape),
                                "dtype": dtype_name(dtype)})


def randperm(n, dtype="int64", name=None):
    return _cast(_one("randperm", {}, {"n": int(n)}), dtype)


def bernoulli(x, name=None):
    return _one("bernoulli", {"X": [_v(x)]})


# ---------------------------------------------------------------- stat
def std(x, axis=None, unbiased=True, keepdim=False, name=None):
    return pow(var(x, axis, unbiased, keepdim), 0.5)


def var(x, axis=None, unbiased=True, keepdim=False, name=None):
    x = _v(x)
    d = x - mean(x, axis, True)
    out = mean(multiply(d, d), axis, keepdim)
    if unbiased:
        shape = x.shape
        n = 1
        for a in (range(len(shape)) if axis is None else _axes_attr(axis)):
            n *= int(shape[a])
        if n > 1:
            out = multiply(out, full([1], n / (n - 1)))
    return out


def numel(x, name=None):
    return _one("size", {"Input": [_v(x)]})


def cumsum(x, axis=None, dtype=None, name=None):
    """paddle semantics: axis=None flattens first."""
    out = _one("cumsum", {"X": [_v(x)]},
               {"axis": -1 if axis is None else int(axis),
                "flatten": axis is None})
    if dtype is not None:
        out = _one("cast", {"X": [out]}, {"out_dtype": dtype_name(dtype)})
    return out


def tril(x, diagonal=0, name=None):
    return _one("tril_triu", {"X": [_v(x)]},
                {"diagonal": int(diagonal), "lower": True})


def triu(x, diagonal=0, name=None):
    return _one("tril_triu", {"X": [_v(x)]},
                {"diagonal": int(diagonal), "lower": False})
