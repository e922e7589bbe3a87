"""Functional nn API (paddle.nn.functional parity).

Port of the functions of ``paddle_tpu/nn/functional.py`` that BERT uses.
Each dispatches through ``trace_op`` into the op registry, so the AMP
casts apply exactly as in the reference.
"""
from __future__ import annotations

from ..dygraph.tracer import trace_op


def linear(x, weight, bias=None):
    out = trace_op("matmul_v2", {"X": [x], "Y": [weight]},
                   out_slots=["Out"])[0]
    if bias is not None:
        out = trace_op("elementwise_add", {"X": [out], "Y": [bias]},
                       {"axis": -1}, out_slots=["Out"])[0]
    return out


def tanh(x):
    return trace_op("tanh", {"X": [x]}, out_slots=["Out"])[0]


def gelu(x, approximate=False):
    return trace_op("gelu", {"X": [x]}, {"approximate": approximate},
                    out_slots=["Out"])[0]


def dropout(x, p=0.5, training=True, mode="upscale_in_train"):
    return trace_op("dropout", {"X": [x]},
                    {"dropout_prob": p, "is_test": not training,
                     "dropout_implementation": mode}, out_slots=["Out"])[0]


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
