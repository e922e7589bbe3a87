"""Linear-algebra and indexing ops.

Port of ``paddle_tpu/ops/linalg_ops.py``. Dense linear algebra goes to
``torch.linalg`` (LAPACK on the CPU, cuSOLVER / cuBLAS on the card).
``argsort`` is a stable sort (descending sorts the negated input, as
the reference does, so ties come in index order). The outputs whose
length depends on the data (``masked_select``, ``unique_with_counts``)
are read on the host, one sync on the card.
"""
from __future__ import annotations

import torch

from ..core.enforce import InvalidArgumentError, enforce
from ..core.registry import register_op


def _axes(attrs, *keys):
    """The reduced dims of a reduction attr, or None for all of them."""
    axes = []
    for key in keys:
        if key in attrs:
            axes = attrs[key]
            break
    if attrs.get("reduce_all", False) or not len(list(axes)):
        return None
    return tuple(int(a) for a in axes)


def _all_dims(x, axes):
    return tuple(range(x.ndim)) if axes is None else axes


@register_op("argsort", intermediate_outputs=("Indices",))
def argsort(inputs, attrs):
    """Sorted values and int64 indices along ``axis``."""
    x = inputs["X"][0]
    axis = int(attrs.get("axis", -1))
    key = -x if attrs.get("descending", False) else x
    _, idx = torch.sort(key, dim=axis, stable=True)
    return {"Out": [torch.take_along_dim(x, idx, dim=axis)],
            "Indices": [idx]}


@register_op("masked_select", non_differentiable_inputs=("Mask",))
def masked_select(inputs, attrs):
    """The elements of X where Mask is true, flattened."""
    return {"Y": [torch.masked_select(inputs["X"][0], inputs["Mask"][0])]}


@register_op("index_sample", non_differentiable_inputs=("Index",))
def index_sample(inputs, attrs):
    """A gather along each row: X [N, D], Index [N, K]."""
    x, idx = inputs["X"][0], inputs["Index"][0]
    return {"Out": [torch.gather(x, 1, idx.long())]}


@register_op("multiplex", non_differentiable_inputs=("Ids",))
def multiplex(inputs, attrs):
    """Row m of the output comes from candidate X[Ids[m]]."""
    ids = inputs["Ids"][0].reshape(-1).long()
    stack = torch.stack(inputs["X"], dim=0)
    return {"Out": [stack[ids, torch.arange(ids.shape[0],
                                            device=ids.device)]]}


@register_op("mv")
def mv(inputs, attrs):
    return {"Out": [inputs["X"][0] @ inputs["Vec"][0]]}


@register_op("kron")
def kron(inputs, attrs):
    """Kronecker product; above two dims the reference broadcasts the
    leading dims and takes the product of the last two."""
    x, y = inputs["X"][0], inputs["Y"][0]
    if x.ndim <= 2 and y.ndim <= 2:
        return {"Out": [torch.kron(x, y)]}
    prod = x[..., :, None, :, None] * y[..., None, :, None, :]
    shape = prod.shape[:-4] + (prod.shape[-4] * prod.shape[-3],
                               prod.shape[-2] * prod.shape[-1])
    return {"Out": [prod.reshape(shape)]}


@register_op("cross")
def cross(inputs, attrs):
    """3-vector cross product along ``dim`` (9, the reference's "auto",
    takes the first dim of size 3)."""
    x, y = inputs["X"][0], inputs["Y"][0]
    dim = attrs.get("dim", 9)
    if dim == 9 or dim is None:
        dim = next(i for i, s in enumerate(x.shape) if s == 3)
    return {"Out": [torch.linalg.cross(x, y, dim=int(dim))]}


@register_op("trace")
def trace(inputs, attrs):
    x = inputs["Input"][0]
    return {"Out": [torch.diagonal(
        x, offset=int(attrs.get("offset", 0)),
        dim1=int(attrs.get("axis1", 0)),
        dim2=int(attrs.get("axis2", 1))).sum(-1)]}


@register_op("unbind")
def unbind(inputs, attrs):
    return {"Out": list(torch.unbind(inputs["X"][0],
                                     dim=int(attrs.get("axis", 0))))}


@register_op("cumprod")
def cumprod(inputs, attrs):
    return {"Out": [torch.cumprod(inputs["X"][0], dim=int(attrs.get(
        "dim", attrs.get("axis", -1))))]}


@register_op("shard_index", non_differentiable_inputs=("X",))
def shard_index(inputs, attrs):
    """A global id to its shard-local id, ``ignore_value`` where the id
    lives on another shard."""
    x = inputs["X"][0]
    nshards = int(attrs["nshards"])
    shard_size = (int(attrs["index_num"]) + nshards - 1) // nshards
    in_shard = torch.floor_divide(x, shard_size) == int(attrs["shard_id"])
    return {"Out": [torch.where(in_shard, torch.remainder(x, shard_size),
                                int(attrs.get("ignore_value", -1)))]}


@register_op("logsumexp")
def logsumexp(inputs, attrs):
    x = inputs["X"][0]
    keep = bool(attrs.get("keepdim", attrs.get("keep_dim", False)))
    return {"Out": [torch.logsumexp(
        x, dim=_all_dims(x, _axes(attrs, "axis", "dim")), keepdim=keep)]}


@register_op("inverse")
def inverse(inputs, attrs):
    return {"Output": [torch.linalg.inv(inputs["Input"][0])]}


@register_op("cholesky")
def cholesky(inputs, attrs):
    lower = torch.linalg.cholesky(inputs["X"][0])
    if bool(attrs.get("upper", False)):
        return {"Out": [lower.transpose(-1, -2)]}
    return {"Out": [lower]}


@register_op("frobenius_norm")
def frobenius_norm(inputs, attrs):
    x = inputs["X"][0]
    keep = bool(attrs.get("keep_dim", False))
    return {"Out": [torch.sqrt(torch.square(x).sum(
        dim=_all_dims(x, _axes(attrs, "dim", "axis")), keepdim=keep))]}


@register_op("l1_norm")
def l1_norm(inputs, attrs):
    return {"Out": [inputs["X"][0].abs().sum()]}


@register_op("norm", intermediate_outputs=("Norm",))
def norm(inputs, attrs):
    """L2-normalize along ``axis``; ``Norm`` is the denominator."""
    x = inputs["X"][0]
    axis = int(attrs.get("axis", -1))
    eps = float(attrs.get("epsilon", 1e-10))
    n = torch.sqrt(torch.square(x).sum(dim=axis, keepdim=True) + eps)
    return {"Out": [x / n], "Norm": [n]}


def _column_slices(inputs, attrs):
    start = int(attrs.get("start_index", 0))
    length = int(attrs.get("length", -1))
    for x in inputs["X"]:
        s = start if start >= 0 else x.shape[1] + start
        e = x.shape[1] if length < 0 else s + length
        yield x[:, s:e]


@register_op("partial_concat")
def partial_concat(inputs, attrs):
    """The [start, start + length) columns of every input, side by side."""
    return {"Out": [torch.cat(list(_column_slices(inputs, attrs)), dim=1)]}


@register_op("partial_sum")
def partial_sum(inputs, attrs):
    total = None
    for piece in _column_slices(inputs, attrs):
        total = piece if total is None else total + piece
    return {"Out": [total]}


@register_op("fsp")
def fsp(inputs, attrs):
    """Flow-of-solution-procedure matrix for distillation:
    [N, C1, H, W] x [N, C2, H, W] -> [N, C1, C2] / (H * W)."""
    x, y = inputs["X"][0], inputs["Y"][0]
    enforce(y.shape[2:] == x.shape[2:],
            f"fsp spatial dims mismatch: {tuple(x.shape)} vs "
            f"{tuple(y.shape)}", InvalidArgumentError)
    h, w = x.shape[2], x.shape[3]
    return {"Out": [torch.einsum("nchw,ndhw->ncd", x, y) / (h * w)]}


@register_op("unique_with_counts", non_differentiable_inputs=("X",))
def unique_with_counts(inputs, attrs):
    """Sorted unique values, each element's row among them and each
    value's count (int32)."""
    vals, idx, counts = torch.unique(inputs["X"][0], sorted=True,
                                     return_inverse=True,
                                     return_counts=True)
    return {"Out": [vals], "Index": [idx.to(torch.int32)],
            "Count": [counts.to(torch.int32)]}


@register_op("gather_tree", non_differentiable_inputs=("Ids", "Parents"))
def gather_tree(inputs, attrs):
    """Beam-search backtrace: Ids / Parents [max_len, batch, beam] to the
    full sequences, walking the parents back from the last step."""
    ids, parents = inputs["Ids"][0], inputs["Parents"][0]
    max_len, batch, beam = ids.shape
    rows = torch.arange(batch, device=ids.device)[:, None]
    parent = torch.arange(beam, device=ids.device).expand(batch, beam)
    out = []
    for t in range(max_len - 1, -1, -1):
        p = parent.long()
        out.append(ids[t][rows, p])
        parent = parents[t][rows, p]
    return {"Out": [torch.stack(out[::-1]).to(ids.dtype)]}
