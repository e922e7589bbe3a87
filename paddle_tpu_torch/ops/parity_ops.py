"""The parity tranche: ``paddle_tpu/ops/parity_ops.py``.

Port of that module's op types: trivial tensor ops, ``fc``, ``feed`` and
``fetch``, control and LoD glue, fused-op compositions, text-matching
ops, the TDM tree ops and the fake-quant variants. The glue types that
wrap control-flow and array ops (``while``, ``conditional_block_infer``,
``merge_lod_tensor_infer``, ``lod_array_length``) call the port's ops
through ``OpInfoMap``, as the reference's do; ``recurrent``, and
``while`` without a lowered ``cond_block``, raise with the reference's
message.

The random ops draw on the CPU from ``core/rng`` (a nonzero ``seed``
attr gives the op a stream of its own; 0 a fresh seed from the global
generator) and move the result. ``seed`` and ``tdm_sampler`` draw the
reference's own numbers: a per-op call counter and numpy's
``RandomState``. Ops that read their inputs on the host say so.
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from ..core import dtype as dtypes, rng
from ..core.enforce import InvalidArgumentError, enforce, host_only
from ..core.registry import OpInfoMap, register_op
from ..device import creation_device
from .tensor_ops import jnp_linspace


def _op(op_type):
    return OpInfoMap.instance().get(op_type).compute


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


@register_op("diag", non_differentiable_inputs=())
def diag(inputs, attrs):
    """Vector -> diagonal matrix (a matrix -> its diagonal)."""
    return {"Out": [torch.diag(inputs["Diagonal"][0])]}


@register_op("diag_embed")
def diag_embed(inputs, attrs):
    """The last dim as diagonal ``offset`` of a new trailing matrix."""
    return {"Out": [torch.diag_embed(inputs["Input"][0],
                                     int(attrs.get("offset", 0)))]}


@register_op("fill", non_differentiable_inputs=())
def fill(inputs, attrs):
    """A constant tensor from the attr list ``value``."""
    shape = [int(v) for v in attrs["shape"]]
    name = dtypes.dtype_name(dtypes.convert_dtype(
        attrs.get("dtype", "float32")))
    arr = np.asarray(attrs.get("value", [0.0])).astype(name).reshape(shape)
    return {"Out": [torch.from_numpy(arr).to(creation_device())]}


@register_op("fill_zeros_like2")
def fill_zeros_like2(inputs, attrs):
    return {"Out": [torch.zeros_like(inputs["X"][0])]}


@register_op("grad_add")
def grad_add(inputs, attrs):
    """The gradient-accumulation add."""
    return {"Out": [inputs["X"][0] + inputs["Y"][0]]}


@register_op("is_empty", non_differentiable_inputs=("X",))
def is_empty(inputs, attrs):
    x = inputs["X"][0]
    return {"Out": [torch.full((), x.numel() == 0, dtype=torch.bool,
                               device=x.device)]}


@register_op("seed")
def seed_op(inputs, attrs):
    """A seed scalar (int32): the ``seed`` attr, else 1 + this op's call
    count, as the reference emits it."""
    from .misc_ops import next_call
    s = int(attrs.get("seed", 0)) or 1 + next_call("seed_op")
    return {"Out": [torch.full((), s, dtype=torch.int32,
                               device=creation_device())]}


@register_op("squared_l2_distance")
def squared_l2_distance(inputs, attrs):
    sub = inputs["X"][0] - inputs["Y"][0]
    return {"Out": [sub.square().sum(-1, keepdim=True)],
            "sub_result": [sub]}


@register_op("modified_huber_loss",
             intermediate_outputs=("IntermediateVal",))
def modified_huber_loss(inputs, attrs):
    """Binary {0, 1} labels, margin z = (2y - 1) x: -4z below -1,
    (1 - z)^2 below 1, else 0."""
    x, y = inputs["X"][0], inputs["Y"][0]
    z = (2.0 * y - 1.0) * x
    zero = torch.zeros((), dtype=z.dtype, device=z.device)
    loss = torch.where(z < -1.0, -4.0 * z,
                       torch.where(z < 1.0, (1.0 - z).square(), zero))
    return {"Out": [loss], "IntermediateVal": [z]}


@register_op("maxout")
def maxout(inputs, attrs):
    """Max over ``groups`` consecutive channels of ``axis``."""
    x = inputs["X"][0]
    groups = int(attrs.get("groups", 1))
    axis = int(attrs.get("axis", 1))
    if axis < 0:
        axis += x.ndim
    c = x.shape[axis]
    enforce(c % groups == 0, f"maxout: channels {c} % groups {groups}",
            InvalidArgumentError)
    shape = x.shape[:axis] + (c // groups, groups) + x.shape[axis + 1:]
    return {"Out": [x.reshape(shape).amax(axis + 1)]}


@register_op("teacher_student_sigmoid_loss")
def teacher_student_sigmoid_loss(inputs, attrs):
    """CTR distillation loss: sigmoid cross entropy against the
    binarized label, or, for a label in (0, 1), against the teacher's
    score with x clipped to the soft bounds."""
    x = inputs["X"][0].reshape(-1)
    label = inputs["Label"][0].reshape(-1)
    xc = x.clamp(float(attrs.get("soft_max_lower_bound", -15.0)),
                 float(attrs.get("soft_max_up_bound", 15.0)))
    hard = torch.log1p(torch.exp(-x.abs())) + x.clamp_min(0.0) \
        - x * (label > 0.0)
    soft = torch.log1p(torch.exp(-xc.abs())) + xc.clamp_min(0.0) \
        - xc * label
    use_soft = (label > 0.0) & (label < 1.0)
    return {"Y": [torch.where(use_soft, soft, hard)[:, None]]}


@register_op("precision_recall",
             non_differentiable_inputs=("MaxProbs", "Indices", "Labels",
                                        "Weights", "StatesInfo"))
def precision_recall(inputs, attrs):
    """Per-class TP/FP/TN/FN of a batch (plus StatesInfo's running
    states) and their macro and micro precision, recall and F1."""
    idx = inputs["Indices"][0].reshape(-1).to(torch.int64)
    labels = inputs["Labels"][0].reshape(-1).to(torch.int64)
    c = int(attrs["class_number"])
    f32 = dict(dtype=torch.float32, device=idx.device)

    def seg(vals, ids):
        return torch.zeros(c, **f32).index_add_(0, ids, vals)

    tp = seg((idx == labels).to(torch.float32), labels)
    pred_cnt = seg(torch.ones(idx.shape, **f32), idx)
    lab_cnt = seg(torch.ones(labels.shape, **f32), labels)
    fp, fn = pred_cnt - tp, lab_cnt - tp
    tn = labels.shape[0] - tp - fp - fn
    batch_states = torch.stack([tp, fp, tn, fn], 1)
    accum_states = batch_states
    if inputs.get("StatesInfo"):
        accum_states = batch_states + inputs["StatesInfo"][0].to(
            torch.float32)

    def metrics(states):
        tp_, fp_, fn_ = states[:, 0], states[:, 1], states[:, 3]
        prec = tp_ / (tp_ + fp_).clamp_min(1.0)
        rec = tp_ / (tp_ + fn_).clamp_min(1.0)
        f1 = 2 * prec * rec / (prec + rec).clamp_min(1e-8)
        micro_p = tp_.sum() / (tp_ + fp_).sum().clamp_min(1.0)
        micro_r = tp_.sum() / (tp_ + fn_).sum().clamp_min(1.0)
        micro_f = 2 * micro_p * micro_r / (micro_p + micro_r).clamp_min(
            1e-8)
        return torch.stack([prec.mean(), rec.mean(), f1.mean(),
                            micro_p, micro_r, micro_f])

    return {"BatchMetrics": [metrics(batch_states)],
            "AccumMetrics": [metrics(accum_states)],
            "AccumStatesInfo": [accum_states]}


@register_op("polygon_box_transform", non_differentiable_inputs=("Input",))
def polygon_box_transform(inputs, attrs):
    """EAST geometry: offsets -> absolute quad coordinates, 4 * the
    (x, y) grid plus the input."""
    x = inputs["Input"][0]
    n, c, h, w = x.shape
    enforce(c % 2 == 0, "polygon_box_transform: C must be even",
            InvalidArgumentError)
    gx = torch.arange(w, dtype=x.dtype, device=x.device)[None, :].expand(
        h, w)
    gy = torch.arange(h, dtype=x.dtype, device=x.device)[:, None].expand(
        h, w)
    grid = torch.stack([gx, gy] * (c // 2), 0)
    return {"Output": [4.0 * grid[None] + x]}


@register_op("assert", non_differentiable_inputs=("Cond", "Data"))
def assert_op(inputs, attrs):
    """Cond read on the host: raises unless every element is true."""
    cond = host_only(inputs["Cond"][0], "assert")
    enforce(bool(np.all(cond)),
            "Assert failed: " + str(attrs.get("summarize", "")),
            InvalidArgumentError)
    return {}


@register_op("delete_var", non_differentiable_inputs=("X",))
def delete_var(inputs, attrs):
    """A GC hint: the executor frees a name after its last reader."""
    return {}


@register_op("get_places")
def get_places(inputs, attrs):
    """The number of devices of the current device's type, int64."""
    dev = creation_device()
    n = torch.cuda.device_count() if dev.type == "cuda" else 1
    return {"Out": [torch.full((), n, dtype=torch.int64, device=dev)]}


# ------------------------------------------------------------ fc family
@register_op("fc")
def fc(inputs, attrs):
    """Input . W (+ Bias), the first ``in_num_col_dims`` dims kept."""
    x, w = inputs["Input"][0], inputs["W"][0]
    ncol = int(attrs.get("in_num_col_dims", 1))
    out = x.reshape(math.prod(x.shape[:ncol]), -1) @ w
    if inputs.get("Bias"):
        out = out + inputs["Bias"][0].reshape(1, -1)
    act = attrs.get("activation_type", "")
    if act == "relu":
        out = torch.relu(out)
    elif act:
        raise InvalidArgumentError(f"fc: unsupported activation {act!r}")
    return {"Out": [out.reshape(tuple(x.shape[:ncol]) + (w.shape[1],))]}


@register_op("feed", non_differentiable_inputs=())
def feed(inputs, attrs):
    """Identity: the executor resolves feeds itself."""
    return {"Out": [inputs["X"][0]]}


@register_op("fetch", non_differentiable_inputs=())
def fetch(inputs, attrs):
    """Identity: the executor resolves fetches itself."""
    return {"Out": [inputs["X"][0]]}


# -------------------------------------------------- control / LoD glue
@register_op("while", non_differentiable_inputs=("Condition",))
def while_op(inputs, attrs):
    """The fluid ``while`` desc: a builder-lowered one (with
    ``cond_block``) runs as ``while_loop``; a raw sub_block desc from
    an untranslated program raises."""
    if "cond_block" in attrs:
        return _op("while_loop")(inputs, attrs)
    raise InvalidArgumentError(
        "while: raw fluid sub_block descs are lowered at the builder "
        "layer — rebuild the loop with static.control_flow.while_loop "
        "or While (the executor cannot dispatch an opaque sub_block)")


@register_op("conditional_block_infer")
def conditional_block_infer(inputs, attrs):
    return _op("conditional_block")(inputs, attrs)


@register_op("merge_lod_tensor_infer")
def merge_lod_tensor_infer(inputs, attrs):
    return _op("merge_lod_tensor")(inputs, attrs)


@register_op("lod_array_length", non_differentiable_inputs=("X",))
def lod_array_length(inputs, attrs):
    return _op("array_length")(inputs, attrs)


@register_op("lod_rank_table", non_differentiable_inputs=("X",))
def lod_rank_table(inputs, attrs):
    """(index, length) rows sorted by length descending, ties in index
    order. X is the Length vector; Out is [B, 2] int64."""
    length = inputs["X"][0].reshape(-1).to(torch.int64)
    order = torch.argsort(-length, stable=True)
    return {"Out": [torch.stack([order, length[order]], 1)]}


@register_op("max_sequence_len", non_differentiable_inputs=("RankTable",))
def max_sequence_len(inputs, attrs):
    return {"Out": [inputs["RankTable"][0][:, 1].amax().to(torch.int64)]}


@register_op("reorder_lod_tensor_by_rank",
             non_differentiable_inputs=("RankTable",))
def reorder_lod_tensor_by_rank(inputs, attrs):
    """Batch rows in rank-table order."""
    x, table = inputs["X"][0], inputs["RankTable"][0]
    return {"Out": [x.index_select(0, table[:, 0].to(torch.int64))]}


@register_op("rnn_memory_helper")
def rnn_memory_helper(inputs, attrs):
    """Identity that anchors RNN state gradients."""
    return {"Out": [inputs["X"][0]]}


@register_op("recurrent", non_differentiable_inputs=())
def recurrent(inputs, attrs):
    """The RecurrentOp block runner: recurrences are built with
    static.StaticRNN or while_loop instead."""
    raise InvalidArgumentError(
        "recurrent: build recurrences with static.StaticRNN or "
        "while_loop (the RecurrentOp sub-block protocol is lowered at "
        "the builder layer, not dispatched as a kernel)")


@register_op("tensor_array_to_tensor")
def tensor_array_to_tensor(inputs, attrs):
    """Stack (``use_stack``) or concatenate the dense array buffer's
    rows on ``axis``, all ``max_size`` of them, the unwritten ones
    zero; OutIndex is each row's extent on that axis."""
    buf = inputs["X"][0]
    enforce(isinstance(buf, torch.Tensor),
            "tensor_array_to_tensor takes the dense array form",
            InvalidArgumentError)
    axis = int(attrs.get("axis", 0))
    if bool(attrs.get("use_stack", False)):
        out, per = torch.movedim(buf, 0, axis), 1
    else:
        out = torch.cat(list(buf.unbind(0)), dim=axis)
        elem_axis = axis if axis >= 0 else axis + (buf.ndim - 1)
        per = buf.shape[elem_axis + 1] if buf.ndim > 1 else 1
    return {"Out": [out], "OutIndex": [torch.full(
        (buf.shape[0],), per, dtype=torch.int64, device=buf.device)]}


_READER_REGISTRY: Dict[str, object] = {}


def register_reader(name: str, iterator) -> None:
    """Bind an iterator for the ``read`` op (ref: reader_py.cc's
    registered queues)."""
    _READER_REGISTRY[name] = iterator


@register_op("read", non_differentiable_inputs=())
def read_op(inputs, attrs):
    """One batch from the python reader registered under attr
    ``reader_name``, on the current device."""
    name = attrs.get("reader_name", "")
    reader = _READER_REGISTRY.get(name)
    enforce(reader is not None, f"read: no reader {name!r} registered",
            InvalidArgumentError)
    batch = next(reader)
    vals = batch if isinstance(batch, (list, tuple)) else [batch]
    return {"Out": [dtypes.from_host(np.asarray(v)).to(creation_device())
                    for v in vals]}


@register_op("create_custom_reader", non_differentiable_inputs=())
def create_custom_reader(inputs, attrs):
    """Reader creation is the DataLoader's; a marker."""
    return {}


# -------------------------------------------------------- fused family
def _act(name, fns, op):
    fn = fns.get(name)
    enforce(fn is not None, f"{op}: act {name!r}", InvalidArgumentError)
    return fn


_RELU_OR_ID = {"relu": torch.relu, "identity": lambda v: v}


@register_op("conv2d_fusion")
def conv2d_fusion(inputs, attrs):
    """conv2d + bias + activation (+ residual)."""
    out = _op("conv2d")({"Input": inputs["Input"],
                         "Filter": inputs["Filter"]}, attrs)["Output"][0]
    if inputs.get("Bias"):
        out = out + inputs["Bias"][0].reshape(1, -1, 1, 1)
    if inputs.get("ResidualData"):
        out = out + inputs["ResidualData"][0]
    act = attrs.get("activation", "relu")
    if act == "relu":
        out = torch.relu(out)
    elif act not in ("identity", "", None):
        raise InvalidArgumentError(f"conv2d_fusion: activation {act!r}")
    return {"Output": [out]}


@register_op("conv2d_inception_fusion")
def conv2d_inception_fusion(inputs, attrs):
    """Four same-padded conv + bias + relu branches concatenated on
    channels (the GoogLeNet cell)."""
    x = inputs["Input"][0]
    conv = _op("conv2d")
    outs = []
    for w, b in zip(inputs["Filter"], inputs["Bias"]):
        k = w.shape[2]
        o = conv({"Input": [x], "Filter": [w]},
                 {"strides": [1, 1], "paddings": [k // 2, k // 2],
                  "dilations": [1, 1], "groups": 1})["Output"][0]
        outs.append(torch.relu(o + b.reshape(1, -1, 1, 1)))
    return {"Output": [torch.cat(outs, 1)]}


_BN_INTERMEDIATE = ("MeanOut", "VarianceOut", "SavedMean", "SavedVariance",
                    "ReserveSpace")


@register_op("fused_batch_norm_act", intermediate_outputs=_BN_INTERMEDIATE,
             non_differentiable_inputs=("Mean", "Variance"))
def fused_batch_norm_act(inputs, attrs):
    out = _op("batch_norm")(inputs, attrs)
    fn = _act(attrs.get("act_type", "relu"), _RELU_OR_ID,
              "fused_batch_norm_act")
    out["Y"] = [fn(out["Y"][0])]
    return out


@register_op("fused_bn_add_activation",
             intermediate_outputs=_BN_INTERMEDIATE,
             non_differentiable_inputs=("Mean", "Variance"))
def fused_bn_add_activation(inputs, attrs):
    """bn(x) + z, then the activation (the ResNet shortcut fusion)."""
    out = _op("batch_norm")({k: v for k, v in inputs.items() if k != "Z"},
                            attrs)
    fn = _act(attrs.get("act_type", "relu"), _RELU_OR_ID,
              "fused_bn_add_activation")
    out["Y"] = [fn(out["Y"][0] + inputs["Z"][0])]
    return out


@register_op("fused_elemwise_activation",
             intermediate_outputs=("IntermediateOut",))
def fused_elemwise_activation(inputs, attrs):
    """``functor_list`` composes one binary and one unary op:
    binary(x, unary(y)) or unary(binary(x, y))."""
    x, y = inputs["X"][0], inputs["Y"][0]
    functors = [f.strip() for f in attrs.get("functor_list", [])]
    enforce(len(functors) == 2, "fused_elemwise_activation needs two "
            "functors", InvalidArgumentError)
    scale = float(attrs.get("scale", 1.0))
    unary = {"relu": torch.relu, "scale": lambda v: v * scale,
             "tanh": torch.tanh, "sigmoid": torch.sigmoid}
    binary = {"elementwise_add": torch.add,
              "elementwise_mul": torch.mul}
    f0, f1 = functors
    if f0 in binary:
        mid = unary[f1.split("_")[0]](y) if f1 not in binary else y
        out = binary[f0](x, mid)
    else:
        mid = binary[f1](x, y)
        out = unary[f0.split("_")[0]](mid)
    return {"Out": [out], "IntermediateOut": [mid]}


@register_op("fused_embedding_seq_pool",
             non_differentiable_inputs=("Ids",))
def fused_embedding_seq_pool(inputs, attrs):
    """Lookup, then a sum over each sequence: Ids [B, T] (or [B, T, 1]),
    masked by Length, else by ``padding_idx`` (id 0 when it is -1)."""
    w = inputs["W"][0]
    ids = inputs["Ids"][0].to(torch.int64)
    if ids.ndim == 3 and ids.shape[-1] == 1:
        ids = ids[..., 0]
    emb = w[ids]
    if inputs.get("Length"):
        t = torch.arange(ids.shape[1], device=ids.device)
        mask = t[None, :] < inputs["Length"][0].to(torch.int64)[:, None]
    else:
        pad = int(attrs.get("padding_idx", -1))
        mask = ids != (pad if pad >= 0 else 0)
    return {"Out": [(emb * mask[:, :, None].to(emb.dtype)).sum(1)]}


@register_op("fused_fc_elementwise_layernorm",
             intermediate_outputs=("Mean", "Variance"))
def fused_fc_elementwise_layernorm(inputs, attrs):
    """layer_norm(fc(x) + y) over the last dim (biased variance)."""
    x, w = inputs["X"][0], inputs["W"][0]
    out = x.reshape(-1, x.shape[-1]) @ w
    if inputs.get("Bias0"):
        out = out + inputs["Bias0"][0].reshape(1, -1)
    out = out + inputs["Y"][0].reshape(out.shape)
    eps = float(attrs.get("epsilon", 1e-5))
    mean = out.mean(-1, keepdim=True)
    var = out.var(-1, keepdim=True, unbiased=False)
    norm = (out - mean) * torch.rsqrt(var + eps)
    if inputs.get("Scale"):
        norm = norm * inputs["Scale"][0]
    if inputs.get("Bias1"):
        norm = norm + inputs["Bias1"][0]
    return {"Out": [norm], "Mean": [mean[..., 0]],
            "Variance": [var[..., 0]]}


@register_op("fusion_seqpool_cvm_concat",
             non_differentiable_inputs=("CVM", "Length"))
def fusion_seqpool_cvm_concat(inputs, attrs):
    """ref: operators/fused/fusion_seqpool_cvm_concat_op.cc — each input
    sequence-pooled and concatenated (``fusion_seqpool_concat``), then
    the ``cvm`` transform."""
    pooled = _op("fusion_seqpool_concat")(
        {"X": inputs["X"], "Length": inputs.get("Length", [])},
        attrs)["Out"][0]
    return {"Out": [_op("cvm")(
        {"X": [pooled]},
        {"use_cvm": bool(attrs.get("use_cvm", True))})["Y"][0]]}


@register_op("fusion_transpose_flatten_concat")
def fusion_transpose_flatten_concat(inputs, attrs):
    axis = [int(v) for v in attrs.get("trans_axis", [])]
    flatten_axis = int(attrs.get("flatten_axis", 1))
    outs = []
    for x in inputs["X"]:
        t = x.permute(axis) if axis else x
        outs.append(t.reshape(math.prod(t.shape[:flatten_axis]), -1))
    return {"Out": [torch.cat(outs, int(attrs.get("concat_axis", 1)))]}


# ----------------------------------------------------------- text ops
@register_op("match_matrix_tensor", intermediate_outputs=("Tmp",))
def match_matrix_tensor(inputs, attrs):
    """X [B, Lx, D1] . W [D1, dim_t, D2] . Y [B, Ly, D2]^T per channel:
    Out [B, dim_t, Lx, Ly]."""
    x, y, w = inputs["X"][0], inputs["Y"][0], inputs["W"][0]
    tmp = torch.einsum("bxd,dte->btxe", x, w)
    return {"Out": [torch.einsum("btxe,bye->btxy", tmp, y)], "Tmp": [tmp]}


@register_op("sequence_topk_avg_pooling", intermediate_outputs=("pos",),
             non_differentiable_inputs=("ROW", "COLUMN"))
def sequence_topk_avg_pooling(inputs, attrs):
    """Per (row, channel), the mean of the top k values over the
    columns for each k of ``topks``: X [B, C, Lx, Ly] -> Out
    [B, Lx, C * len(topks)]."""
    x = inputs["X"][0]
    topks = [int(k) for k in attrs.get("topks", [1])]
    b, c, lx, ly = x.shape
    kmax = min(max(topks), ly)
    vals = torch.topk(x, kmax, dim=-1, sorted=True).values
    out = torch.stack([vals[..., :min(k, kmax)].sum(-1) / float(k)
                       for k in topks], -1)
    out = out.permute(0, 2, 1, 3).reshape(b, lx, -1)
    return {"Out": [out], "pos": [torch.zeros(1, dtype=torch.int32,
                                              device=x.device)]}


@register_op("sequence_expand_as", non_differentiable_inputs=("RefLength",))
def sequence_expand_as(inputs, attrs):
    """Row i repeated RefLength[i] times: [B, Tmax, ...], zero past each
    row's length. Tmax is attr ``max_len``, else the largest length,
    read on the host."""
    x = inputs["X"][0]
    ref_len = inputs["RefLength"][0].to(torch.int64)
    tmax = int(attrs.get("max_len", 0))
    if not tmax:
        ref = host_only(ref_len, "sequence_expand_as")
        tmax = int(ref.max()) if ref.size else 0
    reps = x[:, None].expand((x.shape[0], tmax) + tuple(x.shape[1:]))
    t = torch.arange(tmax, device=x.device)
    mask = (t[None, :] < ref_len[:, None]).to(x.dtype)
    return {"Out": [reps * mask.reshape(mask.shape + (1,) * (x.ndim - 1))]}


@register_op("spp")
def spp(inputs, attrs):
    """Spatial pyramid pooling: adaptive pools at 1, 2, 4, ... bins a
    side, flattened and concatenated."""
    x = inputs["X"][0]
    pool = _op("adaptive_pool2d")
    ptype = attrs.get("pooling_type", "max")
    n, c = x.shape[0], x.shape[1]
    outs = []
    for lvl in range(int(attrs.get("pyramid_height", 1))):
        bins = 2 ** lvl
        p = pool({"X": [x]}, {"pool_size": [bins, bins],
                              "pool_type": ptype})["Out"][0]
        outs.append(p.reshape(n, c * bins * bins))
    return {"Out": [torch.cat(outs, 1)]}


# -------------------------------------------------------- TDM tree ops
@register_op("tdm_child", non_differentiable_inputs=("X", "TreeInfo"))
def tdm_child(inputs, attrs):
    """TreeInfo rows are [item_id, layer_id, ancestor_id, child_0..]:
    each node's children and a leaf mask (a child with no child of its
    own)."""
    x = inputs["X"][0].to(torch.int64)
    info = inputs["TreeInfo"][0].to(torch.int64)
    child_nums = int(attrs.get("child_nums", info.shape[1] - 3))
    children = info[x.reshape(-1)][:, 3:3 + child_nums]
    grand = info[children.clamp(0, info.shape[0] - 1)][:, :, 3]
    leaf = (children != 0) & (grand == 0)
    shape = tuple(x.shape) + (child_nums,)
    out_dt = torch.int32 if attrs.get("dtype") in ("int32", 2) \
        else torch.int64
    return {"Child": [children.reshape(shape).to(out_dt)],
            "LeafMask": [leaf.reshape(shape).to(out_dt)]}


@register_op("tdm_sampler", non_differentiable_inputs=("X", "Travel",
                                                       "Layer"))
def tdm_sampler(inputs, attrs):
    """Per layer: the travel path's node and ``neg_samples_num_list``
    negatives drawn from that layer, with labels and a padding mask.
    Runs on the host, drawing from numpy's RandomState(seed) as the
    reference does, so a seed gives the reference's numbers."""
    travel = host_only(inputs["Travel"][0], "tdm_sampler").astype(np.int64)
    layer_nodes = host_only(inputs["Layer"][0],
                            "tdm_sampler").reshape(-1).astype(np.int64)
    neg = [int(v) for v in attrs.get("neg_samples_num_list", [1])]
    offsets = [int(v) for v in attrs.get("layer_offset_lod",
                                         [0, layer_nodes.size])]
    b, layers = travel.shape
    enforce(len(offsets) == layers + 1,
            "tdm_sampler: layer_offset_lod must have layers+1 entries",
            InvalidArgumentError)
    rs = np.random.RandomState(int(attrs.get("seed", 0)) or None)
    out_blocks, lab_blocks, mask_blocks = [], [], []
    for li in range(layers):
        pool = layer_nodes[offsets[li]:offsets[li + 1]]
        n_neg = neg[li] if li < len(neg) else neg[-1]
        block = np.zeros((b, 1 + n_neg), np.int64)
        labels = np.zeros((b, 1 + n_neg), np.int64)
        mask = np.ones((b, 1 + n_neg), np.int64)
        for i in range(b):
            pos = travel[i, li]
            block[i, 0] = pos
            labels[i, 0] = 1
            if pos == 0:
                mask[i, :] = 0
                continue
            cand = pool[pool != pos]
            if cand.size == 0:
                mask[i, 1:] = 0
                continue
            block[i, 1:] = rs.choice(cand, size=n_neg, replace=True)
        if not bool(attrs.get("output_positive", True)):
            block, labels, mask = block[:, 1:], labels[:, 1:], mask[:, 1:]
        out_blocks.append(block)
        lab_blocks.append(labels)
        mask_blocks.append(mask)
    dev = inputs["Travel"][0].device
    return {k: [torch.from_numpy(np.concatenate(v, 1)).to(dev)]
            for k, v in (("Out", out_blocks), ("Labels", lab_blocks),
                         ("Mask", mask_blocks))}


# ------------------------------------------------------- quant variants
def _bound(bits):
    return float(2 ** (int(bits) - 1) - 1)


@register_op("fake_quantize_range_abs_max",
             intermediate_outputs=("OutScale", "OutScales"),
             non_differentiable_inputs=("InScale", "Iter"))
def fake_quantize_range_abs_max(inputs, attrs):
    x = inputs["X"][0]
    bound = _bound(attrs.get("bit_length", 8))
    scale = x.abs().amax().clamp_min(1e-8)
    if inputs.get("InScale"):
        scale = torch.maximum(scale, inputs["InScale"][0].reshape(()))
    q = torch.round(x / scale * bound).clamp(-bound, bound)
    return {"Out": [q], "OutScale": [scale],
            "OutScales": [scale.reshape(1)]}


@register_op("fake_quantize_moving_average_abs_max",
             intermediate_outputs=("OutScale", "OutState", "OutAccum"),
             non_differentiable_inputs=("InScale", "InState", "InAccum"))
def fake_quantize_moving_average_abs_max(inputs, attrs):
    x = inputs["X"][0]
    bound = _bound(attrs.get("bit_length", 8))
    rate = float(attrs.get("moving_rate", 0.9))
    cur = x.abs().amax()
    state = inputs["InState"][0].reshape(()) if inputs.get("InState") \
        else torch.ones((), dtype=x.dtype, device=x.device)
    accum = inputs["InAccum"][0].reshape(()) if inputs.get("InAccum") \
        else cur
    state = rate * state + 1.0
    accum = rate * accum + cur
    scale = (accum / state).clamp_min(1e-8)
    q = torch.round(x / scale * bound).clamp(-bound, bound)
    return {"Out": [q], "OutScale": [scale.reshape(1)],
            "OutState": [state.reshape(1)], "OutAccum": [accum.reshape(1)]}


@register_op("fake_channel_wise_quantize_abs_max",
             intermediate_outputs=("OutScale",))
def fake_channel_wise_quantize_abs_max(inputs, attrs):
    x = inputs["X"][0]
    bound = _bound(attrs.get("bit_length", 8))
    axis = int(attrs.get("quant_axis", 0))
    red = tuple(i for i in range(x.ndim) if i != axis)
    scale = x.abs().amax(red).clamp_min(1e-8)
    bshape = [1] * x.ndim
    bshape[axis] = x.shape[axis]
    q = torch.round(x / scale.reshape(bshape) * bound).clamp(-bound, bound)
    return {"Out": [q], "OutScale": [scale]}


@register_op("fake_channel_wise_dequantize_max_abs",
             non_differentiable_inputs=("Scales",))
def fake_channel_wise_dequantize_max_abs(inputs, attrs):
    x = inputs["X"][0]
    scales = inputs["Scales"]
    bits = attrs.get("quant_bits", [8])
    axis = int(attrs.get("quant_axis", 0))
    bshape = [1] * x.ndim
    bshape[axis] = x.shape[axis]
    out = x * scales[0].reshape(bshape) / _bound(bits[0])
    if len(scales) > 1 and scales[1] is not None and len(bits) > 1:
        out = out * scales[1].reshape(()) / _bound(bits[1])
    return {"Out": [out]}


@register_op("dequantize_abs_max", non_differentiable_inputs=("Scale",))
def dequantize_abs_max(inputs, attrs):
    x = inputs["X"][0].to(torch.float32)
    return {"Out": [x * inputs["Scale"][0].reshape(()) /
                    float(attrs.get("max_range", 127.0))]}


@register_op("dequantize_log", non_differentiable_inputs=("Dict",))
def dequantize_log(inputs, attrs):
    """Codes index a dictionary; below 128 the value is negated."""
    x = inputs["X"][0].to(torch.int64)
    table = inputs["Dict"][0]
    neg = x < 128
    vals = table[torch.remainder(torch.where(neg, x, x - 128),
                                 table.shape[0])]
    return {"Out": [torch.where(neg, -vals, vals)]}


@register_op("lookup_table_dequant", non_differentiable_inputs=("Ids",))
def lookup_table_dequant(inputs, attrs):
    """Rows of (min, range, codes...) dequantized on lookup."""
    w = inputs["W"][0]
    ids = inputs["Ids"][0].to(torch.int64)
    if ids.ndim >= 2 and ids.shape[-1] == 1:
        ids = ids[..., 0]
    rows = w[ids]
    return {"Out": [rows[..., 2:] * rows[..., 1:2] / 255.0 + rows[..., 0:1]]}


@register_op("sequence_enumerate", non_differentiable_inputs=("X",))
def sequence_enumerate(inputs, attrs):
    """Each position's window of ``win_size`` ids, ``pad_value`` past
    the end: X [B, T] -> Out [B, T, win_size]."""
    x = inputs["X"][0]
    win = int(attrs.get("win_size", 2))
    t = x.shape[1]
    xp = F.pad(x, (0, win - 1), value=attrs.get("pad_value", 0))
    cols = torch.arange(t, device=x.device)[:, None] + torch.arange(
        win, device=x.device)[None, :]
    return {"Out": [xp[:, cols]]}
