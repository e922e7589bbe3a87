"""Sequence ops over dense padded tensors plus a length vector.

Port of ``paddle_tpu/ops/sequence_ops.py`` (ref:
paddle/fluid/operators/sequence_ops/). As in the JAX package, a ragged
batch is [batch, max_len, ...] with a ``Length`` [batch] vector: masks
are computed inline, padded positions stay in place, and only the
fluid ``sequence_expand(x, y)`` form reads a real LoD, through the
eager side channel (``core.lodctx``). Two ops size their output from
the data when no ``maxlen`` is given (``sequence_mask``,
``sequence_expand`` with ``RefLength``), and ``segment_pool`` with no
``num_segments``: each reads one number on the host, one sync on the
card. Shape inference on ``meta`` tensors has no data, so there they
need the attr, as the JAX package's jit does.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import lodctx
from ..core.dtype import convert_dtype
from ..core.enforce import InvalidArgumentError, enforce
from ..core.registry import register_op

NEG_INF = -1e30


def _mask(length, max_len, dtype):
    """[B, T] validity mask from lengths."""
    t = torch.arange(max_len, device=length.device)
    return (t[None, :] < length[:, None]).to(dtype)


def _tail(x, lead):
    """``x``'s trailing singleton dims after ``lead`` dims, for
    broadcasting a [B, T] mask against it."""
    return (1,) * (x.ndim - lead)


def _concrete_maxlen(x, op_name):
    """Derive maxlen from data: one host read (a sync on the card).
    Shape inference runs on ``meta`` tensors, which hold no lengths, so
    it needs the static ``maxlen`` attr there, as the JAX package's
    jit does."""
    if x.device.type == "meta":
        raise ValueError(
            f"{op_name}: 'maxlen' attr is required when traced under "
            "jit/to_static (output shape must be static); the "
            "data-dependent max-length path only works eagerly")
    return int(x.max()) if x.numel() else 0


@register_op("sequence_mask", non_differentiable_inputs=("X",
                                                         "MaxLenTensor"))
def sequence_mask(inputs, attrs):
    """ref: sequence_ops/sequence_mask_op.cc. X: lengths [B] ->
    Y: [B, maxlen]. The optional MaxLenTensor input supplies maxlen
    from its leading static dim."""
    x = inputs["X"][0]
    maxlen = attrs.get("maxlen", -1)
    if (maxlen is None or maxlen < 0) and inputs.get("MaxLenTensor"):
        maxlen = int(inputs["MaxLenTensor"][0].shape[0])
    if maxlen is None or maxlen < 0:
        maxlen = _concrete_maxlen(x, "sequence_mask")
    out_dtype = convert_dtype(str(attrs.get("out_dtype", "int64")))
    return {"Y": [_mask(x.to(torch.int32), maxlen, out_dtype)]}


@register_op("sequence_pool", non_differentiable_inputs=("Length",))
def sequence_pool(inputs, attrs):
    """ref: sequence_ops/sequence_pool_op.cc. X: [B, T, ...dense],
    Length: [B]. pooltype: SUM/AVERAGE/MAX/MIN/LAST/FIRST/SQRT.
    Out: [B, ...dense]. MAX and MIN split the gradient evenly between
    tied elements (``amax``), as the reference's ``jnp.max`` does."""
    x = inputs["X"][0]
    length = inputs["Length"][0].to(torch.int32)
    pooltype = attrs.get("pooltype", "SUM").upper()
    b, t = x.shape[0], x.shape[1]
    tail = _tail(x, 2)
    m = _mask(length, t, x.dtype).reshape((b, t) + tail)
    safe_len = torch.clamp_min(length, 1).reshape((b,) + tail)
    nonempty = (length > 0).reshape(safe_len.shape)
    if pooltype == "SUM":
        out = torch.sum(x * m, dim=1)
    elif pooltype == "AVERAGE":
        out = torch.sum(x * m, dim=1) / safe_len
    elif pooltype == "SQRT":
        out = torch.sum(x * m, dim=1) / torch.sqrt(safe_len.to(x.dtype))
    elif pooltype == "MAX":
        out = torch.amax(torch.where(m > 0, x, NEG_INF), dim=1)
        out = torch.where(nonempty, out, 0.0)
    elif pooltype == "MIN":
        out = torch.amin(torch.where(m > 0, x, -NEG_INF), dim=1)
        out = torch.where(nonempty, out, 0.0)
    elif pooltype == "LAST":
        idx = torch.clamp_min(length - 1, 0).long()
        out = torch.take_along_dim(
            x, idx.reshape((b, 1) + tail), dim=1).squeeze(1)
    elif pooltype == "FIRST":
        out = x[:, 0]
    else:
        raise InvalidArgumentError(f"unknown pooltype {pooltype!r}")
    return {"Out": [out.to(x.dtype)]}


@register_op("sequence_softmax", non_differentiable_inputs=("Length",))
def sequence_softmax(inputs, attrs):
    """ref: sequence_ops/sequence_softmax_op.cc: softmax over the valid
    prefix of each row. X: [B, T], Length: [B]."""
    x = inputs["X"][0]
    length = inputs["Length"][0].to(torch.int32)
    m = _mask(length, x.shape[1], torch.float32)
    z = torch.where(m > 0, x, NEG_INF)
    out = torch.softmax(z, dim=-1) * m
    return {"Out": [out.to(x.dtype)]}


@register_op("sequence_expand", non_differentiable_inputs=("RefLength",
                                                           "Y"))
def sequence_expand(inputs, attrs):
    """ref: sequence_ops/sequence_expand_op.cc in the dense+length
    convention: repeat each row i RefLength[i] times along a new step
    dim. X: [B, ...], RefLength: [B]; Out [B, maxlen, ...], zero past
    each row's length.

    The fluid (x, y) form replicates x's rows by y's ref-level LoD
    widths (a flat output, the reference semantics): eager LoD programs
    only."""
    x = inputs["X"][0]
    if inputs.get("Y") and not inputs.get("RefLength"):
        if lodctx.in_infer_shape():
            # build-time proxy: expansion keeps the feature dims, the
            # row count depends on the data
            return {"Out": [x]}
        ylod = lodctx.input_lod("Y")
        enforce(ylod, "sequence_expand(x, y) needs y's LoD — eager only "
                "(jit programs pass RefLength)", InvalidArgumentError)
        level = ylod[int(attrs.get("ref_level", -1))]
        w = np.asarray(lodctx.widths(level), np.int64)
        enforce(w.shape[0] == x.shape[0],
                f"sequence_expand: x has {x.shape[0]} rows but the ref "
                f"lod level describes {w.shape[0]} groups",
                InvalidArgumentError)
        out = torch.repeat_interleave(
            x, torch.from_numpy(w).to(x.device), dim=0,
            output_size=int(w.sum()))
        return {"Out": [out]}
    ref = inputs["RefLength"][0].to(torch.int32)
    maxlen = attrs.get("maxlen", None)
    t = int(maxlen) if maxlen else _concrete_maxlen(ref, "sequence_expand")
    tiled = x[:, None].expand((x.shape[0], t) + tuple(x.shape[1:]))
    m = _mask(ref, t, x.dtype).reshape((x.shape[0], t) + _tail(x, 1))
    return {"Out": [tiled * m]}


def _reverse_index(length, t):
    """[B, T] gather index that reverses each row's valid prefix and
    keeps its padding in place."""
    pos = torch.arange(t, device=length.device)[None, :]
    ln = length.reshape(-1, 1)
    return torch.where(pos < ln, ln - 1 - pos, pos)


def ragged_reverse(x, length):
    """Reverse each row of [B, T, ...] within its own length (the LoD
    reverse contract: padding stays in place, valid steps flip)."""
    b, t = x.shape[0], x.shape[1]
    idx = _reverse_index(length.long(), t).reshape((b, t) + _tail(x, 2))
    return torch.take_along_dim(x, idx, dim=1)


@register_op("sequence_reverse", non_differentiable_inputs=("Length",))
def sequence_reverse(inputs, attrs):
    """ref: sequence_ops/sequence_reverse_op.h: reverse the valid
    prefix, keep padding in place. X: [B, T, ...], Length: [B]."""
    return {"Y": [ragged_reverse(inputs["X"][0], inputs["Length"][0])]}


@register_op("sequence_pad", non_differentiable_inputs=("Length",))
def sequence_pad(inputs, attrs):
    """ref: sequence_ops/sequence_pad_op.cc: in the dense convention
    this sets padding positions to PadValue and clips or extends to
    padded_length. Length comes back as int32, as the JAX op's."""
    x = inputs["X"][0]
    length = inputs["Length"][0].to(torch.int32)
    pad_value = attrs.get("pad_value", 0.0)
    if inputs.get("PadValue"):
        pad_value = inputs["PadValue"][0]
    padded_len = attrs.get("padded_length", -1)
    t = x.shape[1] if padded_len in (-1, None) else int(padded_len)
    if t > x.shape[1]:
        x = torch.cat([x, x.new_zeros((x.shape[0], t - x.shape[1]) +
                                      tuple(x.shape[2:]))], dim=1)
    else:
        x = x[:, :t]
    m = _mask(length, t, x.dtype).reshape((x.shape[0], t) + _tail(x, 2))
    out = x * m + (1 - m) * pad_value
    return {"Out": [out], "Length": [length]}


@register_op("sequence_unpad", non_differentiable_inputs=("Length",))
def sequence_unpad(inputs, attrs):
    """ref: sequence_ops/sequence_unpad_op.cc: the dense convention
    keeps the [B, T, ...] shape and zeroes the padding."""
    x = inputs["X"][0]
    length = inputs["Length"][0].to(torch.int32)
    m = _mask(length, x.shape[1], x.dtype).reshape(
        (x.shape[0], x.shape[1]) + _tail(x, 2))
    return {"Out": [x * m]}


@register_op("sequence_concat")
def sequence_concat(inputs, attrs):
    """ref: sequence_ops/sequence_concat_op.cc: concat along time."""
    return {"Out": [torch.cat(inputs["X"], dim=1)]}


@register_op("segment_pool", non_differentiable_inputs=("SegmentIds",))
def segment_pool(inputs, attrs):
    """Segment reduction (the reference's SelectedRows sparse-gradient
    workhorse). X: [N, ...], SegmentIds: [N] int -> Out:
    [num_segments, ...]; pooltype SUM or MEAN. Ids outside
    [0, num_segments) are dropped, as ``jax.ops.segment_sum`` drops
    them; with no ``num_segments`` it is the largest id + 1 (one host
    read)."""
    x = inputs["X"][0]
    ids = inputs["SegmentIds"][0].long()
    num = attrs.get("num_segments")
    if num is None:
        num = _concrete_maxlen(ids, "segment_pool") + 1 if ids.numel() \
            else 0
    num = int(num)
    pooltype = attrs.get("pooltype", "SUM").upper()
    valid = (ids >= 0) & (ids < num)
    idx = torch.where(valid, ids, 0)
    keep = valid.reshape((-1,) + _tail(x, 1))

    def seg_sum(v):
        out = v.new_zeros((num,) + tuple(v.shape[1:]))
        return out.index_add(0, idx, torch.where(keep, v, 0))

    out = seg_sum(x)
    if pooltype == "MEAN":
        cnt = x.new_zeros((num,)).index_add(0, idx, valid.to(x.dtype))
        out = out / torch.clamp_min(cnt, 1).reshape((num,) + _tail(x, 1))
    return {"Out": [out]}


@register_op("sequence_reshape", non_differentiable_inputs=("Length",))
def sequence_reshape(inputs, attrs):
    """ref: sequence_ops/sequence_reshape_op.h: keep each sequence's
    element count, change the trailing width: [B, T, D] ->
    [B, T*D//new_dim, new_dim]; Length scales by D/new_dim."""
    x = inputs["X"][0]
    new_dim = int(attrs["new_dim"])
    b, t, d = x.shape[0], x.shape[1], x.shape[-1]
    total = t * d
    if total % new_dim:
        raise InvalidArgumentError(
            f"sequence_reshape: T*D={total} not divisible by "
            f"new_dim={new_dim}")
    outs = {"Out": [x.reshape(b, total // new_dim, new_dim)]}
    if inputs.get("Length"):
        outs["OutLength"] = [torch.div(inputs["Length"][0] * d, new_dim,
                                       rounding_mode="floor")]
    return outs


@register_op("sequence_scatter", non_differentiable_inputs=("Ids",))
def sequence_scatter(inputs, attrs):
    """ref: sequence_ops/sequence_scatter_op.cc: add Updates into X at
    per-sequence positions. X [B, T, ...], Ids [B, S] (time positions
    of each row; a negative one counts from the end, one still out of
    range is dropped, as JAX's ``.at[].add``), Updates [B, S, ...]."""
    x = inputs["X"][0]
    ids = inputs["Ids"][0].long()
    upd = inputs["Updates"][0]
    t = x.shape[1]
    ids = torch.where(ids < 0, ids + t, ids)
    valid = (ids >= 0) & (ids < t)
    shape = tuple(ids.shape) + _tail(upd, 2)
    idx = torch.where(valid, ids, 0).reshape(shape).expand(upd.shape)
    upd = torch.where(valid.reshape(shape), upd, 0)
    return {"Out": [x.scatter_add(1, idx, upd)]}


@register_op("sequence_slice", non_differentiable_inputs=("Offset",
                                                          "Length"))
def sequence_slice(inputs, attrs):
    """ref: sequence_ops/sequence_slice_op.h: per-sequence
    [offset, offset+length) slice. The output keeps T (or attr
    'max_out_len') columns; row b holds x[b, offset_b :
    offset_b+length_b] left-aligned and zero-padded, with the new
    lengths (int32) beside it, each clamped so that no position out of
    range is marked valid."""
    x = inputs["X"][0]
    offset = inputs["Offset"][0].to(torch.int32).reshape(-1)
    length = inputs["Length"][0].to(torch.int32).reshape(-1)
    t = x.shape[1]
    out_t = attrs.get("max_out_len", -1)
    out_t = t if out_t is None or int(out_t) < 0 else int(out_t)
    cols = torch.arange(out_t, device=x.device)
    eff_len = torch.clamp(torch.minimum(length, t - offset), 0, out_t)
    idx = torch.clamp(offset[:, None].long() + cols[None, :], 0, t - 1)
    shape = (x.shape[0], out_t) + _tail(x, 2)
    picked = torch.take_along_dim(x, idx.reshape(shape), dim=1)
    m = (cols[None, :] < eff_len[:, None]).reshape(shape)
    return {"Out": [torch.where(m, picked, 0)], "OutLength": [eff_len]}
