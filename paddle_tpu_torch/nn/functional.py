"""Functional nn API (paddle.nn.functional parity).

Port of the functions of ``paddle_tpu/nn/functional.py`` that BERT and
the vision and detection models use. Each dispatches through
``trace_op`` into the op registry, so the AMP casts apply exactly as in
the reference; ``interpolate``, which the reference runs through
``trace_with_fn`` and not the registry, is torch code here.
"""
from __future__ import annotations

import numpy as np
import torch

from ..dygraph.tracer import trace_op


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


def linear(x, weight, bias=None):
    out = trace_op("matmul_v2", {"X": [x], "Y": [weight]},
                   out_slots=["Out"])[0]
    if bias is not None:
        out = trace_op("elementwise_add", {"X": [out], "Y": [bias]},
                       {"axis": -1}, out_slots=["Out"])[0]
    return out


def relu(x):
    return trace_op("relu", {"X": [x]}, out_slots=["Out"])[0]


def relu6(x):
    return trace_op("relu6", {"X": [x]}, {"threshold": 6.0},
                    out_slots=["Out"])[0]


def tanh(x):
    return trace_op("tanh", {"X": [x]}, out_slots=["Out"])[0]


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


def cross_entropy(input, label, ignore_index=-100, reduction="mean"):
    loss = trace_op("softmax_with_cross_entropy",
                    {"Logits": [input], "Label": [label]},
                    {"ignore_index": ignore_index, "return_softmax": False},
                    out_slots=["Loss"])[0]
    if reduction == "mean":
        return trace_op("mean", {"X": [loss]}, out_slots=["Out"])[0]
    if reduction == "sum":
        return trace_op("reduce_sum", {"X": [loss]}, {"reduce_all": True},
                        out_slots=["Out"])[0]
    return loss


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
