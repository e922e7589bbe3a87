"""Functional nn API (paddle.nn.functional parity).

Port of ``paddle_tpu/nn/functional.py``. Each function dispatches
through ``trace_op`` into the op registry, so the AMP casts apply
exactly as in the reference; ``interpolate``, ``smooth_l1_loss`` and
``cosine_similarity``, which the reference runs through
``trace_with_fn`` and not the registry, are torch code here.
"""
from __future__ import annotations

from typing import Optional, Sequence  # noqa: F401  (reference's names)

import numpy as np
import torch

from ..dygraph.tracer import trace_op
from ..dygraph.varbase import to_variable

VarBase = torch.Tensor        # the eager tensor is torch's


def _v(x):
    return x if isinstance(x, torch.Tensor) else to_variable(x)


def _pair(v):
    if isinstance(v, (list, tuple)):
        return list(v)
    return [v, v]


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW"):
    """``padding``: an int, one per spatial dim, (lo, hi) pairs flattened,
    or "SAME" / "VALID"."""
    attrs = {"strides": _pair(stride), "paddings": _pair(padding),
             "dilations": _pair(dilation), "groups": groups,
             "data_format": data_format}
    if isinstance(padding, str):
        attrs["paddings"] = [0, 0]
        attrs["padding_algorithm"] = padding.upper()
    out = trace_op("conv2d", {"Input": [x], "Filter": [weight]}, attrs,
                   out_slots=["Output"])[0]
    if bias is not None:
        axis = -1 if data_format == "NHWC" else 1
        out = trace_op("elementwise_add", {"X": [out], "Y": [bias]},
                       {"axis": axis}, out_slots=["Out"])[0]
    return out


def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, dilation=1, groups=1,
                     data_format="NCHW"):
    """The weight is [in, out / groups, kh, kw]; any ``output_padding``
    (the ``conv2d_transpose`` op's rule)."""
    attrs = {"strides": _pair(stride), "paddings": _pair(padding),
             "dilations": _pair(dilation), "groups": groups,
             "output_padding": _pair(output_padding),
             "data_format": data_format}
    out = trace_op("conv2d_transpose", {"Input": [x],
                                        "Filter": [weight]},
                   attrs, out_slots=["Output"])[0]
    if bias is not None:
        axis = -1 if data_format == "NHWC" else 1
        out = trace_op("elementwise_add", {"X": [out], "Y": [bias]},
                       {"axis": axis}, out_slots=["Out"])[0]
    return out


def linear(x, weight, bias=None):
    out = trace_op("matmul_v2", {"X": [x], "Y": [weight]},
                   out_slots=["Out"])[0]
    if bias is not None:
        out = trace_op("elementwise_add", {"X": [out], "Y": [bias]},
                       {"axis": -1}, out_slots=["Out"])[0]
    return out


def _unary(op):
    def fn(x, name=None):
        return trace_op(op, {"X": [x]}, out_slots=["Out"])[0]
    fn.__name__ = op
    return fn


relu = _unary("relu")
sigmoid = _unary("sigmoid")
tanh = _unary("tanh")
softplus = _unary("softplus")
softsign = _unary("softsign")
silu = _unary("silu")
mish = _unary("mish")
selu = _unary("selu")


def relu6(x):
    return trace_op("relu6", {"X": [x]}, {"threshold": 6.0},
                    out_slots=["Out"])[0]


def elu(x, alpha=1.0):
    return trace_op("elu", {"X": [x]}, {"alpha": alpha},
                    out_slots=["Out"])[0]


def hardswish(x):
    return trace_op("hard_swish", {"X": [x]}, out_slots=["Out"])[0]


def hardsigmoid(x, slope=0.1666667, offset=0.5):
    return trace_op("hard_sigmoid", {"X": [x]},
                    {"slope": slope, "offset": offset}, out_slots=["Out"])[0]


def swish(x):
    return trace_op("swish", {"X": [x]}, {"beta": 1.0},
                    out_slots=["Out"])[0]


def prelu(x, weight):
    """One alpha ("all") or one a channel ("channel")."""
    mode = "all" if weight.numel() == 1 else "channel"
    return trace_op("prelu", {"X": [x], "Alpha": [weight]},
                    {"mode": mode}, out_slots=["Out"])[0]


def softmax(x, axis=-1):
    return trace_op("softmax", {"X": [x]}, {"axis": axis},
                    out_slots=["Out"])[0]


def log_softmax(x, axis=-1):
    return trace_op("log_softmax", {"X": [x]}, {"axis": axis},
                    out_slots=["Out"])[0]


def leaky_relu(x, negative_slope=0.01):
    return trace_op("leaky_relu", {"X": [x]}, {"alpha": negative_slope},
                    out_slots=["Out"])[0]


def gelu(x, approximate=False):
    return trace_op("gelu", {"X": [x]}, {"approximate": approximate},
                    out_slots=["Out"])[0]


def dropout(x, p=0.5, training=True, mode="upscale_in_train"):
    return trace_op("dropout", {"X": [x]},
                    {"dropout_prob": p, "is_test": not training,
                     "dropout_implementation": mode}, out_slots=["Out"])[0]


def max_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               data_format="NCHW"):
    return pool2d(x, kernel_size, "max", stride, padding, ceil_mode,
                  data_format=data_format)


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, data_format="NCHW"):
    return pool2d(x, kernel_size, "avg", stride, padding, ceil_mode,
                  exclusive, data_format=data_format)


def pool2d(x, ksize, pooling_type="max", stride=None, padding=0,
           ceil_mode=False, exclusive=True, global_pooling=False,
           adaptive=False, data_format="NCHW"):
    """``stride`` defaults to the window."""
    attrs = {"ksize": _pair(ksize), "pooling_type": pooling_type,
             "strides": _pair(stride if stride is not None else ksize),
             "paddings": _pair(padding), "ceil_mode": ceil_mode,
             "exclusive": exclusive, "global_pooling": global_pooling,
             "adaptive": adaptive, "data_format": data_format}
    return trace_op("pool2d", {"X": [x]}, attrs, out_slots=["Out"])[0]


def adaptive_avg_pool2d(x, output_size, data_format="NCHW"):
    return pool2d(x, output_size, "avg", adaptive=True,
                  data_format=data_format)


def adaptive_max_pool2d(x, output_size, data_format="NCHW"):
    return pool2d(x, output_size, "max", adaptive=True,
                  data_format=data_format)


def batch_norm(x, running_mean, running_var, weight, bias, training=False,
               momentum=0.9, epsilon=1e-5, data_format="NCHW"):
    """In training, writes the op's MeanOut / VarianceOut into
    ``running_mean`` / ``running_var`` in place (the fluid contract)."""
    return _batch_norm("batch_norm", x, running_mean, running_var, weight,
                       bias, training, momentum, epsilon, data_format)


def _batch_norm(op_type, x, running_mean, running_var, weight, bias,
                training, momentum, epsilon, data_format):
    y, mean_out, var_out = trace_op(
        op_type,
        {"X": [x], "Scale": [weight], "Bias": [bias],
         "Mean": [running_mean], "Variance": [running_var]},
        {"momentum": momentum, "epsilon": epsilon, "is_test": not training,
         "data_layout": data_format},
        out_slots=["Y", "MeanOut", "VarianceOut"])
    if training:
        with torch.no_grad():
            running_mean.copy_(mean_out)
            running_var.copy_(var_out)
    return y


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5):
    begin = x.ndim - (len(normalized_shape)
                      if isinstance(normalized_shape, (list, tuple)) else 1)
    inputs = {"X": [x]}
    if weight is not None:
        inputs["Scale"] = [weight]
    if bias is not None:
        inputs["Bias"] = [bias]
    return trace_op("layer_norm", inputs,
                    {"epsilon": epsilon, "begin_norm_axis": begin},
                    out_slots=["Y"])[0]


def embedding(x, weight, padding_idx=None):
    return trace_op("lookup_table_v2", {"W": [weight], "Ids": [x]},
                    {"padding_idx": -1 if padding_idx is None
                     else padding_idx}, out_slots=["Out"])[0]


def _reduce(loss, reduction):
    """``mean`` / ``sum`` through the ops, else the loss as it is."""
    if reduction == "mean":
        return trace_op("mean", {"X": [loss]}, out_slots=["Out"])[0]
    if reduction == "sum":
        return trace_op("reduce_sum", {"X": [loss]}, {"reduce_all": True},
                        out_slots=["Out"])[0]
    return loss


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True):
    """Softmax cross entropy; ``weight`` and ``use_softmax`` are taken
    and unused, as in the reference."""
    loss = trace_op("softmax_with_cross_entropy",
                    {"Logits": [input], "Label": [label]},
                    {"soft_label": soft_label, "ignore_index": ignore_index,
                     "axis": axis, "return_softmax": False},
                    out_slots=["Loss"])[0]
    return _reduce(loss, reduction)


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, axis=-1,
                               return_softmax=False):
    outs = trace_op("softmax_with_cross_entropy",
                    {"Logits": [logits], "Label": [label]},
                    {"soft_label": soft_label, "ignore_index": ignore_index,
                     "axis": axis, "return_softmax": return_softmax},
                    out_slots=["Loss", "Softmax"])
    if return_softmax:
        return outs[0], outs[1]
    return outs[0]


def mse_loss(input, label, reduction="mean"):
    loss = trace_op("mse_loss", {"X": [input], "Label": [label]},
                    out_slots=["Out"])[0]
    return _reduce(loss, reduction)


def binary_cross_entropy_with_logits(logit, label, reduction="mean"):
    loss = trace_op("sigmoid_cross_entropy_with_logits",
                    {"X": [logit], "Label": [label]},
                    out_slots=["Out"])[0]
    return _reduce(loss, reduction)


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW"):
    """Four values on a 4-D tensor go to ``pad2d`` as they are; any other
    form pads the last dims through ``pad``."""
    x = _v(x)
    if len(pad) == 4 and x.ndim == 4:
        return trace_op("pad2d", {"X": [x]},
                        {"paddings": list(pad), "mode": mode,
                         "pad_value": value, "data_format": data_format},
                        out_slots=["Out"])[0]
    full = [0] * (2 * x.ndim)
    full[-len(pad):] = list(pad)
    return trace_op("pad", {"X": [x]},
                    {"paddings": full, "pad_value": value},
                    out_slots=["Out"])[0]


def one_hot(x, num_classes):
    return trace_op("one_hot_v2", {"X": [x]}, {"depth": num_classes},
                    out_slots=["Out"])[0]


def _triangle(d):
    return (1.0 - d.abs()).clamp_min(0.0)


def _keys_cubic(d):
    """Keys' cubic kernel with a = -0.5 (torch's bicubic takes -0.75)."""
    out = ((1.5 * d - 2.5) * d) * d + 1.0
    out = torch.where(d >= 1.0, ((-0.5 * d + 2.5) * d - 4.0) * d + 2.0, out)
    return torch.where(d >= 2.0, 0.0, out)


def _resize_weights(m, n, kernel, device):
    """[m, n] float64 weights of output position j on input i, as
    ``jax.image``'s ``compute_weight_mat`` makes them with antialias on:
    half-pixel centres, the kernel widened by in/out when downsampling,
    each column renormalised to sum 1, and zero where the sample lies
    outside the input."""
    inv = 1.0 / (n / m)
    sample = (torch.arange(n, dtype=torch.float64, device=device) + 0.5) \
        * inv - 0.5
    dist = (sample[None, :] - torch.arange(
        m, dtype=torch.float64, device=device)[:, None]).abs() / torch.full(
            (), max(inv, 1.0), dtype=torch.float64, device=device)
    w = kernel(dist)
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= m - 0.5)
    return torch.where(inside[None, :], w, 0.0)


def _nearest(x, dim, m, n):
    """Output position j takes input floor((j + 0.5) * m / n), computed
    in float32 as ``jax.image.resize`` does (torch's "nearest" floors j *
    m / n, and its "nearest-exact" rounds m / n first, which picks
    another pixel at some sizes). An integer factor whose rule is i // s
    repeats each pixel with one copy and no index tensor."""
    rule = np.floor((np.arange(n, dtype=np.float32) + np.float32(0.5))
                    * np.float32(m) / np.float32(n)).astype(np.int64)
    s = n // m
    if n % m == 0 and np.array_equal(rule, np.arange(n) // s):
        shape = list(x.shape)
        shape[dim] = n
        return x.unsqueeze(dim + 1).expand(
            *x.shape[:dim + 1], s, *x.shape[dim + 1:]).reshape(shape)
    # a divisor on the device: torch's CUDA kernels would multiply by the
    # reciprocal of a Python one, which can floor to another pixel
    div = torch.full((), float(n), dtype=torch.float32, device=x.device)
    idx = torch.floor((torch.arange(n, dtype=torch.float32, device=x.device)
                       + 0.5) * m / div).long()
    return x.index_select(dim, idx)


def interpolate(x, size=None, scale_factor=None, mode="nearest"):
    """Resize an NCHW tensor with ``jax.image.resize``'s rules, as the
    reference does: "nearest", "bilinear" (triangle kernel) or "bicubic"
    (Keys, a = -0.5), half-pixel centres, antialiased when downsampling.
    ``scale_factor`` gives the size ``int(in * factor)``. A spatial dim
    whose size does not change is left as it is."""
    _, _, h, w = x.shape
    if size is None:
        sf = scale_factor if isinstance(scale_factor, (list, tuple)) else \
            [scale_factor, scale_factor]
        size = [int(h * sf[0]), int(w * sf[1])]
    kernel = {"nearest": None, "bilinear": _triangle,
              "bicubic": _keys_cubic}[mode]
    for dim, m, n in ((2, h, int(size[0])), (3, w, int(size[1]))):
        if m == n:
            continue
        if kernel is None:
            x = _nearest(x, dim, m, n)
        else:
            wts = _resize_weights(m, n, kernel, x.device).to(x.dtype)
            x = torch.einsum("nchw,hH->ncHw" if dim == 2 else
                             "nchw,wW->nchW", x, wts)
    return x


# ------------------------------------------------- extended functional
def _interp_op(x, op, size, scale_factor, align_corners, align_mode,
               nd=2):
    attrs = {"align_corners": bool(align_corners),
             "align_mode": int(align_mode)}
    keys = {1: ["out_w"], 2: ["out_h", "out_w"],
            3: ["out_d", "out_h", "out_w"]}[nd]
    if size is not None:
        size = [int(s) for s in (size if isinstance(size, (list, tuple))
                                 else [size] * nd)]
        for k, v in zip(keys, size):
            attrs[k] = v
    else:
        sf = scale_factor if isinstance(scale_factor, (list, tuple)) \
            else [scale_factor] * nd
        attrs["scale"] = [float(s) for s in sf]
    return trace_op(op, {"X": [x]}, attrs, out_slots=["Out"])[0]


def interpolate_v2(x, size=None, scale_factor=None, mode="nearest",
                   align_corners=False, align_mode=0,
                   data_format="NCHW"):
    """paddle.nn.functional.interpolate parity: the ``*_interp_v2`` ops,
    with ``interpolate_op.h``'s coordinate rules for every mode."""
    op = {"nearest": "nearest_interp_v2",
          "bilinear": "bilinear_interp_v2",
          "bicubic": "bicubic_interp_v2",
          "trilinear": "trilinear_interp_v2",
          "linear": "linear_interp_v2"}[mode]
    nd = {"linear": 1, "trilinear": 3}.get(mode, 2)
    return _interp_op(x, op, size, scale_factor, align_corners,
                      align_mode, nd)


def upsample(x, size=None, scale_factor=None, mode="nearest",
             align_corners=False):
    return interpolate_v2(x, size, scale_factor, mode, align_corners)


def grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                align_corners=True):
    return trace_op("grid_sampler", {"X": [x], "Grid": [grid]},
                    {"mode": mode, "padding_mode": padding_mode,
                     "align_corners": bool(align_corners)},
                    out_slots=["Output"])[0]


def affine_grid(theta, out_shape, align_corners=True):
    return trace_op("affine_grid", {"Theta": [theta]},
                    {"output_shape": [int(s) for s in out_shape],
                     "align_corners": bool(align_corners)},
                    out_slots=["Output"])[0]


def pixel_shuffle(x, upscale_factor, data_format="NCHW"):
    return trace_op("pixel_shuffle", {"X": [x]},
                    {"upscale_factor": int(upscale_factor),
                     "data_format": data_format}, out_slots=["Out"])[0]


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1):
    return trace_op("unfold", {"X": [x]},
                    {"kernel_sizes": _pair(kernel_sizes),
                     "strides": _pair(strides), "paddings": _pair(paddings),
                     "dilations": _pair(dilations)}, out_slots=["Y"])[0]


def max_unpool2d(x, indices, kernel_size=None, stride=None, padding=0,
                 output_size=None):
    """Without ``output_size``, the inverse of the pool's shape:
    (h - 1) stride - 2 padding + kernel (h * stride would misplace the
    flat indices the pool recorded)."""
    if output_size is None:
        h, w = x.shape[-2:]
        k = _pair(kernel_size)
        s = _pair(stride or k)
        p = _pair(padding)
        output_size = [(h - 1) * s[0] - 2 * p[0] + k[0],
                       (w - 1) * s[1] - 2 * p[1] + k[1]]
    return trace_op("unpool", {"X": [x], "Indices": [indices]},
                    {"unpooled_size": [int(v) for v in output_size[-2:]]},
                    out_slots=["Out"])[0]


def local_response_norm(x, size=5, alpha=1e-4, beta=0.75, k=1.0):
    return trace_op("lrn", {"X": [x]},
                    {"n": int(size), "alpha": float(alpha),
                     "beta": float(beta), "k": float(k)},
                    out_slots=["Out"])[0]


# --------------------------------------------------------------- losses
def l1_loss(input, label, reduction="mean"):
    d = trace_op("elementwise_sub", {"X": [input], "Y": [label]},
                 out_slots=["Out"])[0]
    return _reduce(d.abs(), reduction)


def smooth_l1_loss(input, label, reduction="mean", delta=1.0):
    """paddle 2.0's huber form: 0.5 z^2 / delta where |z| < delta, else
    |z| - 0.5 delta, then reduced (the fluid ``smooth_l1_loss`` op sums a
    sample, another contract: ``static.nn.smooth_l1``)."""
    d = float(delta)
    z = (_v(input) - _v(label)).abs()
    return _reduce(torch.where(z < d, 0.5 * z * z / d, z - 0.5 * d),
                        reduction)


def kl_div(input, label, reduction="mean"):
    return trace_op("kldiv_loss",
                    {"X": [input], "Target": [label]},
                    {"reduction": reduction}, out_slots=["Loss"])[0]


def nll_loss(input, label, weight=None, ignore_index=-100,
             reduction="mean"):
    ins = {"X": [input], "Label": [label]}
    if weight is not None:
        ins["Weight"] = [weight]
    return trace_op("nll_loss", ins,
                    {"ignore_index": int(ignore_index),
                     "reduction": reduction},
                    out_slots=["Out", "Total_weight"])[0]


def binary_cross_entropy(input, label, weight=None, reduction="mean"):
    out = trace_op("bce_loss", {"X": [input], "Label": [label]},
                   out_slots=["Out"])[0]
    if weight is not None:
        out = out * _v(weight)
    return _reduce(out, reduction)


def margin_ranking_loss(input, other, label, margin=0.0,
                        reduction="mean"):
    out = trace_op("margin_rank_loss",
                   {"Label": [label], "X1": [input],
                    "X2": [other]}, {"margin": float(margin)},
                   out_slots=["Out", "Activated"])[0]
    return _reduce(out, reduction)


def ctc_loss(log_probs, labels, input_lengths=None, label_lengths=None,
             blank=0, reduction="mean", norm_by_times=False):
    """log_probs [B, T, C] raw logits (warpctc applies the softmax);
    ``mean`` is the plain mean of the [B, 1] losses, as the reference's
    ``_reduce_loss``."""
    ins = {"Logits": [_v(log_probs)], "Label": [_v(labels)]}
    if input_lengths is not None:
        ins["LogitsLength"] = [_v(input_lengths)]
    if label_lengths is not None:
        ins["LabelLength"] = [_v(label_lengths)]
    out = trace_op("warpctc", ins,
                   {"blank": int(blank), "norm_by_times": norm_by_times},
                   out_slots=["Loss"])[0]
    return _reduce(out, reduction)


def cosine_similarity(x1, x2, axis=1, eps=1e-8):
    """The cosine along ``axis``, the norms' product floored at eps."""
    a, b = _v(x1), _v(x2)
    dot = (a * b).sum(dim=axis)
    na = torch.sqrt(torch.square(a).sum(dim=axis))
    nb = torch.sqrt(torch.square(b).sum(dim=axis))
    return dot / torch.clamp_min(na * nb, eps)


def pairwise_distance(x, y, p=2.0, epsilon=1e-6, keepdim=False):
    d = trace_op("elementwise_sub", {"X": [x], "Y": [y]},
                 out_slots=["Out"])[0]
    return trace_op("p_norm", {"X": [d.abs() + epsilon]},
                    {"porder": float(p), "axis": -1, "keepdim": keepdim},
                    out_slots=["Out"])[0]
