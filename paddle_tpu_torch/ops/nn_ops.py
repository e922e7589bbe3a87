"""NN ops: conv, pool, batch norm, layer norm, softmax cross-entropy,
dropout, embedding lookup.

Port of the op types of ``paddle_tpu/ops/nn_ops.py`` that a BERT
pretraining step and a ResNet training step run. The JAX package's
custom grads for ``dropout`` (reuse the saved mask) and
``lookup_table_v2`` (scatter-add into the table) are what torch autograd
does for these ops by itself.

Layout: the spatial ops honour ``data_format`` / ``data_layout`` as the
reference does. An NHWC tensor is a logical ``[N, H, W, C]`` tensor;
torch's kernels take its ``permute(0, 3, 1, 2)`` view, an NCHW tensor
laid out channels_last, with no copy, and keep that layout on CUDA, so
the result permutes back to NHWC with no copy either. Filters stay OIHW
in both layouts, as in the reference, so weights carry across unchanged.
No activation is made ``contiguous``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core import rng
from ..core.enforce import InvalidArgumentError, enforce
from ..core.registry import register_op


def _pair(v, n=2):
    if isinstance(v, (list, tuple)):
        if len(v) == 1:
            return tuple(v) * n
        return tuple(v)
    return (v,) * n


def _conv_padding(padding, ndim):
    """Paddle's padding forms as (lo, hi) pairs, one per spatial dim:
    one value, one per dim, or (lo, hi) per dim flattened."""
    padding = _pair(padding, ndim)
    if len(padding) == ndim:
        return [(p, p) for p in padding]
    if len(padding) == 2 * ndim:
        return [(padding[2 * i], padding[2 * i + 1]) for i in range(ndim)]
    raise InvalidArgumentError(f"bad conv padding {padding!r}")


def _layout(attrs):
    """The op's data layout attr (conv ops say ``data_format``, BN and
    pool ``data_layout``; either is accepted)."""
    fmt = attrs.get("data_format") or attrs.get("data_layout") or "NCHW"
    fmt = str(fmt).upper()
    if fmt in ("NCHW", "NCDHW", "ANYLAYOUT"):
        return "NCHW"
    if fmt in ("NHWC", "NDHWC"):
        return "NHWC"
    raise InvalidArgumentError(f"bad data_format {fmt!r}")


def _channel_axis(x, attrs):
    return 1 if _layout(attrs) == "NCHW" else x.ndim - 1


def _nchw(x, nhwc):
    """The NCHW view torch's kernels take (channels_last for NHWC)."""
    return x.permute(0, 3, 1, 2) if nhwc else x


def _back(y, nhwc):
    return y.permute(0, 2, 3, 1) if nhwc else y


def _same_pads(size, ksize, strides, dilations):
    """lax's SAME: out = ceil(in / stride), the odd pixel at the end."""
    pads = []
    for n, k, s, d in zip(size, ksize, strides, dilations):
        total = max((-(-n // s) - 1) * s + (k - 1) * d + 1 - n, 0)
        pads.append((total // 2, total - total // 2))
    return pads


@register_op("conv2d")
def conv2d(inputs, attrs):
    """ref: operators/conv_op.cc. Explicit (2- or 4-value), SAME and
    VALID padding at any stride; symmetric pads go to the conv itself,
    asymmetric ones (SAME at stride 2, the 4-value form) pad the input
    first."""
    x, w = inputs["Input"][0], inputs["Filter"][0]
    if x.dtype != w.dtype:  # promote like matmul (bf16 batch x f32 params)
        common = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(common), w.to(common)
    strides = _pair(attrs.get("strides", [1, 1]))
    dilations = _pair(attrs.get("dilations", [1, 1]))
    groups = attrs.get("groups", 1) or 1
    nhwc = _layout(attrs) == "NHWC"
    xv = _nchw(x, nhwc)
    paddings = attrs.get("paddings", [0, 0])
    algo = str(paddings if isinstance(paddings, str) else
               attrs.get("padding_algorithm", "EXPLICIT")).upper()
    if algo == "SAME":
        pads = _same_pads(xv.shape[2:], w.shape[2:], strides, dilations)
    elif algo == "VALID":
        pads = [(0, 0), (0, 0)]
    else:
        pads = _conv_padding(paddings, 2)
    if all(lo == hi >= 0 for lo, hi in pads):
        sym = [lo for lo, _ in pads]
    else:
        (t, b), (le, r) = pads
        xv, sym = F.pad(xv, (le, r, t, b)), [0, 0]
    out = F.conv2d(xv, w, None, strides, sym, dilations, groups)
    return {"Output": [_back(out, nhwc)]}


@register_op("depthwise_conv2d")
def depthwise_conv2d(inputs, attrs):
    x = inputs["Input"][0]
    attrs = dict(attrs)
    attrs["groups"] = x.shape[_channel_axis(x, attrs)]
    return conv2d(inputs, attrs)


def _torch_windows_match(n, k, s, p, ceil):
    """Whether torch's own padding gives the reference's windows along a
    dim of size n: torch pads at most half a window, and in ceil_mode it
    drops a last window that would start in the right padding, which the
    reference keeps."""
    if p > k // 2:
        return False
    out = -(-(n + 2 * p - k) // s) + 1        # the reference's ceil count
    return not ceil or (out - 1) * s < n + p


@register_op("pool2d")
def pool2d(inputs, attrs):
    """ref: operators/pool_op.cc. max/avg, global, adaptive, exclusive.

    ``ceil_mode`` pads the right and bottom so every window fits, as the
    reference does (its last window may lie in the padding, where torch
    drops it); where torch's own padding gives the same windows it pads,
    else the input is padded here first."""
    x = inputs["X"][0]
    ptype = attrs.get("pooling_type", "max")
    ksize = _pair(attrs.get("ksize", [2, 2]))
    strides = _pair(attrs.get("strides", [1, 1]))
    paddings = _pair(attrs.get("paddings", [0, 0]))
    nhwc = _layout(attrs) == "NHWC"
    sp = (1, 2) if nhwc else (2, 3)       # spatial dims
    if attrs.get("global_pooling", False) or tuple(ksize) == (-1, -1):
        if ptype == "max":
            return {"Out": [x.amax(dim=sp, keepdim=True)]}
        return {"Out": [x.mean(dim=sp, keepdim=True)]}
    if attrs.get("adaptive", False):
        oh, ow = ksize
        enforce(x.shape[sp[0]] % oh == 0 and x.shape[sp[1]] % ow == 0,
                "adaptive pool requires divisible input (the reference's "
                "static-shape rule)")
        kh, kw = x.shape[sp[0]] // oh, x.shape[sp[1]] // ow
        n, c = x.shape[0], x.shape[3 if nhwc else 1]
        if nhwc:
            xr, dims = x.reshape(n, oh, kh, ow, kw, c), (2, 4)
        else:
            xr, dims = x.reshape(n, c, oh, kh, ow, kw), (3, 5)
        red = xr.amax if ptype == "max" else xr.mean
        return {"Out": [red(dim=dims)]}
    ceil = attrs.get("ceil_mode", False)
    exclusive = attrs.get("exclusive", True)
    xv = _nchw(x, nhwc)
    size = xv.shape[2:]
    if all(_torch_windows_match(n, k, s, p, ceil)
           for n, k, s, p in zip(size, ksize, strides, paddings)):
        if ptype == "max":
            out = F.max_pool2d(xv, ksize, strides, paddings, ceil_mode=ceil)
        else:
            out = F.avg_pool2d(
                xv, ksize, strides, paddings, ceil_mode=ceil,
                count_include_pad=not exclusive,
                divisor_override=None if exclusive else ksize[0] * ksize[1])
        return {"Out": [_back(out, nhwc)]}
    extra = [(s - (n + 2 * p - k) % s) % s if ceil else 0
             for n, k, s, p in zip(size, ksize, strides, paddings)]
    pad = (paddings[1], paddings[1] + extra[1],
           paddings[0], paddings[0] + extra[0])
    if ptype == "max":
        low = float("-inf") if x.is_floating_point() else \
            torch.iinfo(x.dtype).min
        out = F.max_pool2d(F.pad(xv, pad, value=low), ksize, strides)
        return {"Out": [_back(out, nhwc)]}
    summed = F.avg_pool2d(F.pad(xv, pad), ksize, strides, divisor_override=1)
    if exclusive and (paddings[0] or paddings[1] or ceil):
        ones = F.pad(torch.ones_like(xv[:1, :1]), pad)
        out = summed / F.avg_pool2d(ones, ksize, strides, divisor_override=1)
    else:
        out = summed / (ksize[0] * ksize[1])
    return {"Out": [_back(out, nhwc)]}


_BN_INTERMEDIATE = ("MeanOut", "VarianceOut", "SavedMean", "SavedVariance",
                    "ReserveSpace")


@register_op("batch_norm", intermediate_outputs=_BN_INTERMEDIATE,
             non_differentiable_inputs=("Mean", "Variance"))
def batch_norm(inputs, attrs):
    """ref: operators/batch_norm_op.cc. Train: batch statistics and the
    running-stat update; test: the running stats.

    ``torch.native_batch_norm`` reads x in its own dtype, sums in fp32
    and writes y in x's dtype (bf16 under O1) with fp32 scale and bias,
    as the reference does, and saves for backward only what the batch
    statistics need. It is handed no running stats: torch would update
    them with momentum as the new sample's weight and the unbiased
    variance, where the reference keeps ``running * momentum + batch *
    (1 - momentum)`` with the biased one. ``SavedVariance`` is 1/std.
    The ghost-BN groups of the reference's data-parallel path are not
    ported (the port has no device mesh yet)."""
    x = inputs["X"][0]
    scale, bias = inputs["Scale"][0], inputs["Bias"][0]
    mean_in, var_in = inputs["Mean"][0], inputs["Variance"][0]
    eps = attrs.get("epsilon", 1e-5)
    ch = _channel_axis(x, attrs)
    xv = x.movedim(ch, 1)
    if attrs.get("is_test", False) or attrs.get("use_global_stats", False):
        y = torch.native_batch_norm(xv, scale, bias, mean_in, var_in, False,
                                    0.0, eps)[0]
        return {"Y": [y.movedim(1, ch)], "MeanOut": [mean_in],
                "VarianceOut": [var_in], "SavedMean": [mean_in],
                "SavedVariance": [var_in]}
    momentum = attrs.get("momentum", 0.9)
    y, mean, inv_std = torch.native_batch_norm(xv, scale, bias, None, None,
                                               True, 0.0, eps)
    mean, inv_std = mean.detach(), inv_std.detach()
    var = inv_std.pow(-2) - eps               # the biased batch variance
    return {"Y": [y.movedim(1, ch)],
            "MeanOut": [mean_in * momentum + mean * (1 - momentum)],
            "VarianceOut": [var_in * momentum + var * (1 - momentum)],
            "SavedMean": [mean], "SavedVariance": [inv_std]}


@register_op("sync_batch_norm", intermediate_outputs=_BN_INTERMEDIATE,
             non_differentiable_inputs=("Mean", "Variance"))
def sync_batch_norm(inputs, attrs):
    """Cross-replica BN (ref: operators/sync_batch_norm_op.cu). On one
    device, which is all the port runs yet, it is ``batch_norm``."""
    return batch_norm(inputs, attrs)


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
