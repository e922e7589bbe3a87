"""NN ops: layer norm, softmax cross-entropy, dropout, embedding lookup.

Port of the op types of ``paddle_tpu/ops/nn_ops.py`` that a BERT
pretraining step runs. The JAX package's custom grads for ``dropout``
(reuse the saved mask) and ``lookup_table_v2`` (scatter-add into the
table) are what torch autograd does for these ops by itself.
"""
from __future__ import annotations

import torch

from ..core import rng
from ..core.registry import register_op


@register_op("layer_norm", intermediate_outputs=("Mean", "Variance"))
def layer_norm(inputs, attrs):
    """ref: operators/layer_norm_op.cc."""
    x = inputs["X"][0]
    eps = attrs.get("epsilon", 1e-5)
    begin = attrs.get("begin_norm_axis", 1)
    norm_shape = list(x.shape[begin:])
    w = inputs["Scale"][0].reshape(norm_shape) if inputs.get("Scale") \
        else None
    b = inputs["Bias"][0].reshape(norm_shape) if inputs.get("Bias") \
        else None
    y, mean, rstd = torch.native_layer_norm(x, norm_shape, w, b, eps)
    lead = list(x.shape[:begin])
    var = rstd.detach().reshape(lead).pow(-2) - eps
    return {"Y": [y], "Mean": [mean.detach().reshape(lead)],
            "Variance": [var]}


@register_op("softmax_with_cross_entropy",
             intermediate_outputs=("Softmax",),
             non_differentiable_inputs=("Label",))
def softmax_with_cross_entropy(inputs, attrs):
    """ref: operators/softmax_with_cross_entropy_op.cc — one log_softmax.

    Eager torch has no dead-code pass to drop an output nobody reads, so
    ``return_softmax=False`` skips the [N, V] ``Softmax`` output (the
    loss-only caller, ``nn.functional.cross_entropy``)."""
    logits, label = inputs["Logits"][0], inputs["Label"][0]
    axis = attrs.get("axis", -1) % logits.ndim
    log_p = torch.log_softmax(logits, dim=axis)
    if attrs.get("soft_label", False):
        loss = -(label * log_p).sum(dim=axis, keepdim=True)
    else:
        lbl = label
        if lbl.ndim == logits.ndim:
            lbl = lbl.squeeze(axis)
        ignored = lbl == attrs.get("ignore_index", -100)
        safe_lbl = torch.where(ignored, 0, lbl).long()
        picked = log_p.gather(axis, safe_lbl.unsqueeze(axis))
        loss = torch.where(ignored.unsqueeze(axis), 0.0, -picked)
    out = {"Loss": [loss]}
    if attrs.get("return_softmax", True):
        out["Softmax"] = [log_p.exp()]
    return out


@register_op("dropout", intermediate_outputs=("Mask",))
def dropout(inputs, attrs):
    """ref: operators/dropout_op.cc. Draws from a generator of its own
    (``core/rng.op_generator``), so each call takes a fresh mask."""
    x = inputs["X"][0]
    p = attrs.get("dropout_prob", 0.5)
    impl = attrs.get("dropout_implementation", "downgrade_in_infer")
    if attrs.get("is_test", False):
        out = x if impl == "upscale_in_train" else x * (1.0 - p)
        return {"Out": [out.to(x.dtype)],
                "Mask": [torch.ones_like(x, dtype=torch.uint8)]}
    if p == 0.0:
        return {"Out": [x], "Mask": [torch.ones_like(x, dtype=torch.uint8)]}
    gen = rng.op_generator(attrs.get("seed", 0) or 0, x.device)
    keep = torch.rand(x.shape, generator=gen, device=x.device) < 1.0 - p
    if impl == "upscale_in_train":
        out = torch.where(keep, x / (1.0 - p), 0.0).to(x.dtype)
    else:
        out = torch.where(keep, x, 0.0).to(x.dtype)
    return {"Out": [out], "Mask": [keep.to(torch.uint8)]}


@register_op("lookup_table_v2", non_differentiable_inputs=("Ids",))
def lookup_table_v2(inputs, attrs):
    """Embedding (ref: operators/lookup_table_v2_op.cc): a dense gather."""
    w, ids = inputs["W"][0], inputs["Ids"][0]
    out = torch.nn.functional.embedding(ids.long(), w)
    padding_idx = attrs.get("padding_idx", -1)
    if padding_idx is not None and padding_idx != -1:
        pid = padding_idx if padding_idx >= 0 else w.shape[0] + padding_idx
        out = torch.where((ids == pid).unsqueeze(-1), 0.0, out)
    return {"Out": [out]}
