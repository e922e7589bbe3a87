"""Functional nn API (paddle.nn.functional parity).

Port of the functions of ``paddle_tpu/nn/functional.py`` that BERT and
the vision models use. Each dispatches through ``trace_op`` into the op
registry, so the AMP casts apply exactly as in the reference.
"""
from __future__ import annotations

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
