"""Tensor creation and manipulation ops.

Port of every op type of ``paddle_tpu/ops/tensor_ops.py``. An op with no
tensor input creates its output on ``device.creation_device()``: the
static executor's device, or ``meta`` while a builder infers shapes.
The random ops draw on the CPU (from ``core/rng.random_generator``) and
move the result, so one seed gives the same values on every device;
torch's Philox never gives the reference's threefry draws. Shapes that
depend on the data (``where_index``) are read on the host, as the
reference does. Index ops take int32 or int64 indices.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..core import dtype as dtypes, rng
from ..core.registry import register_op
from ..device import creation_device


def _dtype_attr(attrs, default="float32"):
    return dtypes.convert_dtype(attrs.get("dtype", default))


def _shape_attr(attrs):
    return tuple(int(s) for s in attrs.get("shape", [1]))


def _x(inputs, slot="X"):
    return inputs[slot][0]


def _xshape(x):
    """The reference's empty tensor that carries the input shape to its
    grad op, allocated with no bytes."""
    return x.new_empty((0,) + tuple(x.shape))


@register_op("fill_constant")
def fill_constant(inputs, attrs):
    """``ShapeTensor`` and ``ValueTensor``, when given, override the
    attrs (``ShapeTensor`` is read on the host, as the reference does)."""
    shape = _shape_attr(attrs)
    if inputs.get("ShapeTensor"):
        shape = tuple(int(s) for s in inputs["ShapeTensor"][0].tolist())
    dt = _dtype_attr(attrs)
    if inputs.get("ValueTensor"):
        v = inputs["ValueTensor"][0]
        return {"Out": [torch.broadcast_to(v.to(dt), shape).clone()]}
    value = attrs.get("value", 0.0)
    if dt == torch.bool:
        value = bool(value)
    elif not dt.is_floating_point:
        value = int(value)                 # jnp.full truncates a float
    return {"Out": [torch.full(shape, value, dtype=dt,
                               device=creation_device())]}


def _random(attrs, draw):
    shape, dev = _shape_attr(attrs), creation_device()
    if dev.type == "meta":                 # shape inference draws nothing
        return torch.empty(shape, dtype=_dtype_attr(attrs), device=dev)
    out = draw(shape, rng.random_generator(attrs.get("seed", 0) or 0))
    return out.to(_dtype_attr(attrs)).to(dev)


@register_op("gaussian_random")
def gaussian_random(inputs, attrs):
    mean, std = attrs.get("mean", 0.0), attrs.get("std", 1.0)
    return {"Out": [_random(attrs, lambda shape, gen: mean + std * torch.randn(
        shape, generator=gen, dtype=torch.float32))]}


@register_op("uniform_random")
def uniform_random(inputs, attrs):
    lo, hi = attrs.get("min", -1.0), attrs.get("max", 1.0)
    return {"Out": [_random(attrs, lambda shape, gen: torch.empty(
        shape, dtype=torch.float32).uniform_(lo, hi, generator=gen))]}


@register_op("assign")
def assign(inputs, attrs):
    return {"Out": [inputs["X"][0]]}


@register_op("cast")
def cast(inputs, attrs):
    out_dtype = dtypes.convert_dtype(attrs.get("out_dtype", attrs.get(
        "dtype", "float32")))
    return {"Out": [inputs["X"][0].to(out_dtype)]}


def _infer_reshape(x, shape):
    shape = [int(s) for s in shape]
    for i, s in enumerate(shape):
        if s == 0:  # 0 = copy input dim (fluid semantics)
            shape[i] = x.shape[i]
    return shape


@register_op("reshape")
def reshape(inputs, attrs):
    x = inputs["X"][0]
    shape = attrs.get("shape")
    if inputs.get("Shape"):
        shape = [int(s) for s in inputs["Shape"][0].tolist()]
    return {"Out": [x.reshape(_infer_reshape(x, shape))]}


@register_op("flatten2", intermediate_outputs=("XShape",))
def flatten2(inputs, attrs):
    """Dims before ``axis`` into the rows, the rest into the columns;
    ``XShape`` is the reference's empty tensor carrying the input shape,
    allocated with no bytes."""
    x = inputs["X"][0]
    lead = math.prod(x.shape[:attrs.get("axis", 1)])
    return {"Out": [x.reshape((lead, -1))], "XShape": [_xshape(x)]}


@register_op("flatten_contiguous_range", intermediate_outputs=("XShape",))
def flatten_contiguous_range(inputs, attrs):
    """Dims start_axis..stop_axis into one. ``XShape`` (an empty tensor
    that carries the input shape to the reference's grad op) has no use
    under torch autograd and is not made."""
    x = inputs["X"][0]
    start = attrs.get("start_axis", 1) % max(x.ndim, 1)
    stop = attrs.get("stop_axis", -1) % max(x.ndim, 1)
    mid = math.prod(x.shape[start:stop + 1])
    return {"Out": [x.reshape(tuple(x.shape[:start]) + (mid,)
                              + tuple(x.shape[stop + 1:]))]}


@register_op("transpose2", intermediate_outputs=("XShape",))
def transpose2(inputs, attrs):
    """``Out`` is a permuted view (no copy); ``XShape`` is the reference's
    empty tensor that carries the input shape, allocated with no bytes."""
    x = inputs["X"][0]
    return {"Out": [x.permute(*attrs["axis"])], "XShape": [_xshape(x)]}


@register_op("concat")
def concat(inputs, attrs):
    """``AxisTensor``, when given, overrides the ``axis`` attr (read on
    the host, as the reference does)."""
    axis = attrs.get("axis", 0)
    if inputs.get("AxisTensor"):
        axis = int(inputs["AxisTensor"][0])
    return {"Out": [torch.cat(inputs["X"], dim=axis)]}



def _like_shape(inputs, attrs):
    """``shape`` with dim ``output_dim_idx`` taken from ``Input``'s dim
    ``input_dim_idx`` (the *_batch_size_like ops)."""
    shape = [int(s) for s in attrs.get("shape", [1])]
    shape[attrs.get("output_dim_idx", 0)] = int(
        inputs["Input"][0].shape[attrs.get("input_dim_idx", 0)])
    return shape


# ---- creation ----
@register_op("fill_constant_batch_size_like")
def fill_constant_batch_size_like(inputs, attrs):
    ref = inputs["Input"][0]
    return {"Out": [torch.full(_like_shape(inputs, attrs),
                               attrs.get("value", 0.0),
                               dtype=_dtype_attr(attrs), device=ref.device)]}


@register_op("fill_zeros_like")
def fill_zeros_like(inputs, attrs):
    return {"Out": [torch.zeros_like(_x(inputs))]}


@register_op("fill_any_like")
def fill_any_like(inputs, attrs):
    x = _x(inputs)
    dt = attrs.get("dtype", -1)
    dtype = x.dtype if dt in (-1, None) else dtypes.convert_dtype(dt)
    value = attrs.get("value", 0.0)
    if not dtype.is_floating_point and dtype != torch.bool:
        value = int(value)
    return {"Out": [torch.full_like(x, value, dtype=dtype)]}


@register_op("uniform_random_batch_size_like")
def uniform_random_batch_size_like(inputs, attrs):
    return uniform_random({}, dict(attrs, shape=_like_shape(inputs, attrs)))


@register_op("gaussian_random_batch_size_like")
def gaussian_random_batch_size_like(inputs, attrs):
    return gaussian_random({}, dict(attrs, shape=_like_shape(inputs, attrs)))


@register_op("truncated_gaussian_random")
def truncated_gaussian_random(inputs, attrs):
    """mean + std * a normal draw truncated to [-2, 2]."""
    mean, std = attrs.get("mean", 0.0), attrs.get("std", 1.0)
    return {"Out": [_random(attrs, lambda shape, gen: mean + std * (
        torch.nn.init.trunc_normal_(torch.empty(shape), 0.0, 1.0, -2.0, 2.0,
                                    generator=gen)))]}


@register_op("randint", non_differentiable_inputs=("ShapeTensor",))
def randint(inputs, attrs):
    lo, hi = attrs.get("low", 0), attrs.get("high", 100)
    return {"Out": [_random(dict(attrs, dtype=attrs.get("dtype", "int64")),
                            lambda shape, gen: torch.randint(
                                lo, hi, shape, generator=gen))]}


def _host_scalar(inputs, slot, attrs, key, default=None):
    return float(inputs[slot][0]) if inputs.get(slot) else \
        attrs.get(key, default)


@register_op("range")
def range_op(inputs, attrs):
    """[start, end) by step, computed in float64 and cast (``jnp.arange``
    of Python floats, with 64-bit types on); length ceil((end - start)
    / step)."""
    start = _host_scalar(inputs, "Start", attrs, "start", 0)
    end = _host_scalar(inputs, "End", attrs, "end")
    step = _host_scalar(inputs, "Step", attrs, "step", 1)
    out = torch.arange(float(start), float(end), float(step),
                       dtype=torch.float64, device=creation_device())
    return {"Out": [out.to(_dtype_attr(attrs))]}


def jnp_linspace(start, stop, num: int):
    """``jnp.linspace(start, stop, num)`` in the inputs' floating type,
    by its formula: start * (1 - t) + stop * t for t = i / (num - 1),
    the last point ``stop`` itself. ``start`` and ``stop`` are tensors of
    one shape; the points run along a new first dim."""
    dt = torch.promote_types(start.dtype, stop.dtype)
    if not dt.is_floating_point:
        dt = torch.get_default_dtype()
    start, stop = start.to(dt), stop.to(dt)
    if num == 1:
        return start.unsqueeze(0)
    div = num - 1
    t = (torch.arange(div, dtype=dt, device=start.device) /
         torch.tensor(div, dtype=dt, device=start.device))
    t = t.reshape((div,) + (1,) * start.ndim)
    return torch.cat([start * (1 - t) + stop * t, stop.unsqueeze(0)])


@register_op("linspace")
def linspace(inputs, attrs):
    num = int(inputs["Num"][0])
    out = jnp_linspace(inputs["Start"][0], inputs["Stop"][0], num)
    dt = _dtype_attr(attrs)
    if not dt.is_floating_point:
        out = torch.floor(out)
    return {"Out": [out.to(dt)]}


@register_op("assign_value")
def assign_value(inputs, attrs):
    shape = [int(s) for s in attrs.get("shape", [])]
    dt = _dtype_attr(attrs)
    for key in ("fp32_values", "int32_values", "int64_values", "bool_values",
                "values"):
        if attrs.get(key):
            arr = np.asarray(attrs[key]).reshape(shape)
            return {"Out": [torch.from_numpy(arr).to(
                dtype=dt, device=creation_device())]}
    return {"Out": [torch.zeros(shape, dtype=dt, device=creation_device())]}


@register_op("shape", non_differentiable_inputs=("Input",))
def shape_op(inputs, attrs):
    x = inputs["Input"][0]
    return {"Out": [torch.tensor(list(x.shape), dtype=torch.int32,
                                 device=x.device)]}


@register_op("size", non_differentiable_inputs=("Input",))
def size_op(inputs, attrs):
    x = inputs["Input"][0]
    return {"Out": [torch.tensor(x.numel(), dtype=torch.int64,
                                 device=x.device)]}


# ---- reshape family (XShape mirrors fluid's reshape2 contract) ----
@register_op("reshape2", intermediate_outputs=("XShape",))
def reshape2(inputs, attrs):
    x = _x(inputs)
    shape = attrs.get("shape")
    if inputs.get("Shape"):
        shape = [int(s) for s in inputs["Shape"][0].tolist()]
    return {"Out": [x.reshape(_infer_reshape(x, shape))],
            "XShape": [_xshape(x)]}


@register_op("transpose")
def transpose(inputs, attrs):
    return {"Out": [_x(inputs).permute(*attrs["axis"])]}


@register_op("squeeze")
def squeeze(inputs, attrs):
    """The dims of ``axes`` that are 1 (every dim of 1 when ``axes`` is
    empty)."""
    x = _x(inputs)
    axes = attrs.get("axes", [])
    if axes:
        keep = tuple(a % x.ndim for a in axes if x.shape[a % x.ndim] == 1)
        return {"Out": [x.squeeze(keep) if keep else x]}
    return {"Out": [x.squeeze()]}


@register_op("squeeze2", intermediate_outputs=("XShape",))
def squeeze2(inputs, attrs):
    return dict(squeeze(inputs, attrs), XShape=[_xshape(_x(inputs))])


@register_op("unsqueeze")
def unsqueeze(inputs, attrs):
    x = _x(inputs)
    for a in sorted(attrs.get("axes", [])):
        x = x.unsqueeze(a)
    return {"Out": [x]}


@register_op("unsqueeze2", intermediate_outputs=("XShape",))
def unsqueeze2(inputs, attrs):
    return dict(unsqueeze(inputs, attrs), XShape=[_xshape(_x(inputs))])


@register_op("flatten")
def flatten(inputs, attrs):
    x = _x(inputs)
    return {"Out": [x.reshape((math.prod(x.shape[:attrs.get("axis", 1)]),
                               -1))]}


# ---- combination / split ----
@register_op("split")
def split(inputs, attrs):
    """``num`` equal parts, or ``sections`` (one of them -1: the rest)."""
    x = _x(inputs)
    axis = attrs.get("axis", 0)
    num = attrs.get("num", 0)
    total = x.shape[axis]
    if num:
        sizes = [total // num] * num
    else:
        sections = attrs.get("sections", [])
        rest = total - sum(v for v in sections if v >= 0)
        sizes = [int(v) if v >= 0 else rest for v in sections]
    return {"Out": list(torch.split(x, sizes, dim=axis))}


@register_op("stack")
def stack(inputs, attrs):
    return {"Y": [torch.stack(inputs["X"], dim=attrs.get("axis", 0))]}


@register_op("unstack")
def unstack(inputs, attrs):
    x = _x(inputs)
    axis = attrs.get("axis", 0)
    return {"Y": list(torch.unbind(x, dim=axis))}


@register_op("slice")
def slice_op(inputs, attrs):
    """Basic slices (views) along ``axes``, starts and ends clamped to
    the dims (``StartsTensor`` / ``EndsTensor`` read on the host); the
    dims of ``decrease_axis`` dropped."""
    x = inputs["Input"][0]
    starts, ends = attrs.get("starts", []), attrs.get("ends", [])
    if inputs.get("StartsTensor"):
        starts = [int(v) for v in inputs["StartsTensor"][0].tolist()]
    if inputs.get("EndsTensor"):
        ends = [int(v) for v in inputs["EndsTensor"][0].tolist()]
    idx = [slice(None)] * x.ndim
    for ax, st, en in zip(attrs["axes"], starts, ends):
        dim = x.shape[ax]
        st = max(st + dim, 0) if st < 0 else min(st, dim)
        en = max(en + dim, 0) if en < 0 else min(en, dim)
        idx[ax] = slice(int(st), int(en))
    out = x[tuple(idx)]
    for ax in sorted(attrs.get("decrease_axis", []) or [], reverse=True):
        out = out.squeeze(ax)
    return {"Out": [out]}


@register_op("strided_slice")
def strided_slice(inputs, attrs):
    """Python slices along ``axes``; a negative stride (which torch's
    slicing lacks) gathers the indices the slice names."""
    x = inputs["Input"][0]
    out = x
    for ax, st, en, sd in zip(attrs["axes"], attrs["starts"], attrs["ends"],
                              attrs.get("strides",
                                        [1] * len(attrs["axes"]))):
        if sd > 0:
            idx = [slice(None)] * x.ndim
            idx[ax] = slice(st, en, sd)
            out = out[tuple(idx)]
        else:
            picks = range(*slice(st, en, sd).indices(out.shape[ax]))
            out = out.index_select(ax, torch.tensor(
                list(picks), dtype=torch.int64, device=x.device))
    return {"Out": [out]}


def _index(t):
    return t.long()


@register_op("gather", non_differentiable_inputs=("Index",))
def gather(inputs, attrs):
    """``jnp.take(x, index, axis)``: index of any shape."""
    x, index = inputs["X"][0], inputs["Index"][0]
    axis = attrs.get("axis", 0) % x.ndim
    out = x.index_select(axis, _index(index).reshape(-1))
    return {"Out": [out.reshape(tuple(x.shape[:axis]) + tuple(index.shape)
                                + tuple(x.shape[axis + 1:]))]}


@register_op("gather_nd", non_differentiable_inputs=("Index",))
def gather_nd(inputs, attrs):
    x, index = inputs["X"][0], inputs["Index"][0]
    return {"Out": [x[tuple(_index(index).unbind(-1))]]}


@register_op("scatter", non_differentiable_inputs=("Ids",))
def scatter(inputs, attrs):
    """Rows ``Ids`` of X set to ``Updates`` (``overwrite``) or added to.
    Set with a repeated id keeps the last of its rows, as XLA's
    sequential scatter on the CPU does, on every device (torch's
    ``index_put`` leaves the order to the device)."""
    x, ids, updates = inputs["X"][0], inputs["Ids"][0], inputs["Updates"][0]
    ids = _index(ids)
    if not attrs.get("overwrite", True):
        return {"Out": [x.index_add(0, ids, updates.to(x.dtype))]}
    pos = torch.arange(ids.shape[0], device=x.device)
    last = torch.full((x.shape[0],), -1, dtype=torch.int64,
                      device=x.device).scatter_reduce(0, ids, pos, "amax")
    hit = (last >= 0).reshape((-1,) + (1,) * (x.ndim - 1))
    return {"Out": [torch.where(hit, updates[last.clamp_min(0)].to(x.dtype),
                                x)]}


@register_op("scatter_nd_add", non_differentiable_inputs=("Index",))
def scatter_nd_add(inputs, attrs):
    x, index, updates = inputs["X"][0], inputs["Index"][0], \
        inputs["Updates"][0]
    return {"Out": [x.index_put(tuple(_index(index).unbind(-1)),
                                updates.to(x.dtype), accumulate=True)]}


@register_op("index_select", non_differentiable_inputs=("Index",))
def index_select(inputs, attrs):
    x, index = inputs["X"][0], inputs["Index"][0]
    return {"Out": [x.index_select(attrs.get("dim", 0) % x.ndim,
                                   _index(index))]}


@register_op("expand")
def expand(inputs, attrs):
    x = _x(inputs)
    return {"Out": [torch.tile(x, tuple(attrs.get("expand_times",
                                                  [1] * x.ndim)))]}


@register_op("expand_v2")
def expand_v2(inputs, attrs):
    """Broadcast to ``shape``; -1 keeps the input's dim."""
    x = _x(inputs)
    shape = list(attrs.get("shape"))
    for i, s in enumerate(shape):
        if s == -1:
            shape[i] = x.shape[i - len(shape) + x.ndim]
    return {"Out": [torch.broadcast_to(x, tuple(shape))]}


@register_op("expand_as_v2")
def expand_as_v2(inputs, attrs):
    x = _x(inputs)
    target = attrs.get("target_shape") or inputs["Y"][0].shape
    return {"Out": [torch.broadcast_to(x, tuple(target))]}


@register_op("tile")
def tile(inputs, attrs):
    return {"Out": [torch.tile(_x(inputs),
                               tuple(attrs.get("repeat_times", [1])))]}


def _one_hot(ids, depth):
    """float32 rows with a 1 at each id; an id outside [0, depth) gives
    a row of zeros (``jax.nn.one_hot``; torch's raises)."""
    cols = torch.arange(depth, device=ids.device)
    return (ids.long().unsqueeze(-1) == cols).to(torch.float32)


@register_op("one_hot", non_differentiable_inputs=("X",))
def one_hot(inputs, attrs):
    x = _x(inputs)
    depth = attrs.get("depth")
    if inputs.get("depth_tensor"):
        depth = int(inputs["depth_tensor"][0])
    if x.ndim >= 1 and x.shape[-1] == 1:
        x = x.squeeze(-1)
    return {"Out": [_one_hot(x, depth)]}


@register_op("one_hot_v2", non_differentiable_inputs=("X",))
def one_hot_v2(inputs, attrs):
    return {"Out": [_one_hot(_x(inputs), attrs.get("depth"))]}


def _torch_pads(pairs):
    """Per-dim (before, after) pairs, first dim first, as F.pad's flat
    list (last dim first)."""
    return [int(v) for pair in reversed(pairs) for v in pair]


@register_op("pad")
def pad(inputs, attrs):
    x = _x(inputs)
    p = attrs["paddings"]
    pairs = [(p[2 * i], p[2 * i + 1]) for i in range(x.ndim)]
    return {"Out": [F.pad(x, _torch_pads(pairs),
                          value=attrs.get("pad_value", 0.0))]}


_PAD_MODES = {"reflect": "reflect", "edge": "replicate",
              "replicate": "replicate"}


def _pad_spatial(x, spatial_pairs, mode, value, channels_last):
    """Pad the spatial dims of an N, C, spatial... tensor (channels last
    when ``channels_last``): constant, reflect (no edge repeat) or edge
    (replicate)."""
    if channels_last:
        x = x.movedim(-1, 1)
    pads = _torch_pads(spatial_pairs)
    out = F.pad(x, pads, value=value) if mode == "constant" else \
        F.pad(x, pads, mode=_PAD_MODES[mode])
    return out.movedim(1, -1) if channels_last else out


@register_op("pad2d")
def pad2d(inputs, attrs):
    x = _x(inputs)
    p = attrs.get("paddings", [0, 0, 0, 0])
    return {"Out": [_pad_spatial(
        x, [(p[0], p[1]), (p[2], p[3])], attrs.get("mode", "constant"),
        attrs.get("pad_value", 0.0),
        attrs.get("data_format", "NCHW") != "NCHW")]}


@register_op("pad3d")
def pad3d(inputs, attrs):
    x = _x(inputs)
    p = attrs.get("paddings", [0] * 6)
    return {"Out": [_pad_spatial(
        x, [(p[4], p[5]), (p[2], p[3]), (p[0], p[1])],
        attrs.get("mode", "constant"), attrs.get("value", 0.0),
        attrs.get("data_format", "NCDHW") != "NCDHW")]}


@register_op("where", non_differentiable_inputs=("Condition",))
def where_op(inputs, attrs):
    return {"Out": [torch.where(inputs["Condition"][0], inputs["X"][0],
                                inputs["Y"][0])]}


@register_op("where_index", non_differentiable_inputs=("Condition",))
def where_index(inputs, attrs):
    """[N, rank] int64 indices of the true elements; N depends on the
    data, so it is read on the host (one sync on the card)."""
    return {"Out": [torch.nonzero(inputs["Condition"][0])]}


@register_op("tril_triu")
def tril_triu(inputs, attrs):
    x = _x(inputs)
    diag = attrs.get("diagonal", 0)
    return {"Out": [torch.tril(x, diag) if attrs.get("lower", True)
                    else torch.triu(x, diag)]}


@register_op("meshgrid")
def meshgrid(inputs, attrs):
    return {"Out": list(torch.meshgrid(*inputs["X"], indexing="ij"))}


@register_op("flip")
def flip(inputs, attrs):
    axis = attrs.get("axis", 0)
    return {"Out": [torch.flip(_x(inputs), tuple(
        axis if isinstance(axis, (list, tuple)) else [axis]))]}


@register_op("roll")
def roll(inputs, attrs):
    shifts = attrs.get("shifts", 0)
    axis = attrs.get("axis", None)
    return {"Out": [torch.roll(_x(inputs), shifts, axis)]}


@register_op("coalesce_tensor")
def coalesce_tensor(inputs, attrs):
    """ref: operators/coalesce_tensor_op.cc: the inputs as they are and
    one buffer of all of them, flattened and concatenated."""
    xs = inputs["Input"]
    return {"Output": list(xs),
            "FusedOutput": [torch.cat([x.reshape(-1) for x in xs])]}
