"""NN ops: conv (2-D, 3-D, transposed, deformable), pool, the norms
(batch, layer, instance, group, data, spectral, local response),
softmax and the cross-entropies, dropout, embedding lookup, prelu and
the regression losses.

Port of every op type of ``paddle_tpu/ops/nn_ops.py``. The JAX package's
custom grad for ``lookup_table_v2`` (scatter-add into the table) is
what torch autograd does by itself. ``dropout`` keeps its custom grad
(``dx = dOut * Mask``) for the static graph's grad op, which must not
run the forward again: that would draw another mask.

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
from ..core.registry import register_grad, register_op


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


@register_op("softmax")
def softmax(inputs, attrs):
    return {"Out": [torch.softmax(inputs["X"][0],
                                  dim=attrs.get("axis", -1))]}


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
    """ref: operators/dropout_op.cc. Draws from
    ``core/rng.random_generator``: in a static executor run, keyed on
    (seed, step, the op's place among the block's random ops), so each
    step takes a fresh mask; in dygraph, a generator of its own each
    call."""
    x = inputs["X"][0]
    p = attrs.get("dropout_prob", 0.5)
    impl = attrs.get("dropout_implementation", "downgrade_in_infer")
    if attrs.get("is_test", False):
        out = x if impl == "upscale_in_train" else x * (1.0 - p)
        return {"Out": [out.to(x.dtype)],
                "Mask": [torch.ones_like(x, dtype=torch.uint8)]}
    if p == 0.0:
        return {"Out": [x], "Mask": [torch.ones_like(x, dtype=torch.uint8)]}
    if x.device.type == "meta":            # shape inference draws nothing
        keep = torch.empty(x.shape, dtype=torch.bool, device=x.device)
    else:
        gen = rng.random_generator(attrs.get("seed", 0) or 0, x.device)
        keep = torch.rand(x.shape, generator=gen, device=x.device) < 1.0 - p
    if impl == "upscale_in_train":
        out = torch.where(keep, x / (1.0 - p), 0.0).to(x.dtype)
    else:
        out = torch.where(keep, x, 0.0).to(x.dtype)
    return {"Out": [out], "Mask": [keep.to(torch.uint8)]}


@register_grad("dropout")
def dropout_grad(inputs, outputs, out_grads, attrs):
    """The static grad op's gradient, from the forward's saved Mask (the
    JAX package's ``dropout_grad``, ``paddle_tpu/ops/nn_ops.py:504``)."""
    g = out_grads["Out"][0]
    mask = outputs["Mask"][0].to(g.dtype)
    p = attrs.get("dropout_prob", 0.5)
    if attrs.get("dropout_implementation", "downgrade_in_infer") == \
            "upscale_in_train":
        gx = g * mask / (1.0 - p) if p != 1.0 else torch.zeros_like(g)
    else:
        gx = g * mask
    return {"X": [gx]}


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


@register_op("lookup_table", non_differentiable_inputs=("Ids",))
def lookup_table(inputs, attrs):
    """The 1.x embedding: ids [..., 1] (a trailing 1, as 1.x data
    declares them) or [...]."""
    w, ids = inputs["W"][0], inputs["Ids"][0]
    if ids.ndim >= 2 and ids.shape[-1] == 1:
        ids = ids.squeeze(-1)
    return lookup_table_v2({"W": [w], "Ids": [ids]}, attrs)


def _conv_transpose(inputs, attrs, nd):
    """ref: conv_transpose_op.cc. The reference computes a transposed
    conv as an lhs-dilated conv padded (K-1-p, K-1-p+output_padding),
    K the dilated kernel extent (``nn_ops.py:104-123``), so it takes any
    ``output_padding``. torch's own transposed conv computes the same
    where it accepts the attrs (output_padding < max(stride, dilation));
    past that it runs unpadded and its output is cropped by p at the
    front and padded with the zeros the reference's padding gives at the
    back. The filter is [in, out/groups, k...] in both libraries."""
    x, w = inputs["Input"][0], inputs["Filter"][0]
    strides = _pair(attrs.get("strides", [1] * nd), nd)
    dilations = _pair(attrs.get("dilations", [1] * nd), nd)
    groups = attrs.get("groups", 1) or 1
    paddings = _pair(attrs.get("paddings", [0] * nd), nd)
    out_pad = _pair(attrs.get("output_padding", [0] * nd) or [0] * nd, nd)
    nhwc = _layout(attrs) == "NHWC"
    xv = x.movedim(-1, 1) if nhwc else x
    fn = F.conv_transpose2d if nd == 2 else F.conv_transpose3d
    if all(0 <= op < max(s, d) and p >= 0 for op, s, d, p in
           zip(out_pad, strides, dilations, paddings)):
        out = fn(xv, w, None, strides, paddings, out_pad, groups, dilations)
    else:
        out = fn(xv, w, None, strides, 0, 0, groups, dilations)
        for i in range(nd):
            k = (w.shape[2 + i] - 1) * dilations[i] + 1
            n = (xv.shape[2 + i] - 1) * strides[i] + k
            length = n - 2 * paddings[i] + out_pad[i]
            lack = paddings[i] + length - n
            if lack > 0:
                pad = [0, 0] * (nd - 1 - i) + [0, lack]
                out = F.pad(out, pad)
            out = out.narrow(2 + i, paddings[i], length)
    return {"Output": [out.movedim(1, -1) if nhwc else out]}


@register_op("conv2d_transpose")
def conv2d_transpose(inputs, attrs):
    return _conv_transpose(inputs, attrs, 2)


@register_op("conv3d_transpose")
def conv3d_transpose(inputs, attrs):
    """ref: conv_transpose_op.cc, the 3-D variant."""
    return _conv_transpose(inputs, attrs, 3)


@register_op("depthwise_conv2d_transpose")
def depthwise_conv2d_transpose(inputs, attrs):
    x = inputs["Input"][0]
    attrs = dict(attrs)
    attrs["groups"] = x.shape[_channel_axis(x, attrs)]
    return conv2d_transpose(inputs, attrs)


@register_op("conv3d")
def conv3d(inputs, attrs):
    """ref: conv_op.cc, the 3-D variant: explicit padding (3 values, or
    a (lo, hi) pair a dim), asymmetric pads applied to the input first."""
    x, w = inputs["Input"][0], inputs["Filter"][0]
    strides = _pair(attrs.get("strides", [1, 1, 1]), 3)
    dilations = _pair(attrs.get("dilations", [1, 1, 1]), 3)
    groups = attrs.get("groups", 1) or 1
    pads = _conv_padding(attrs.get("paddings", [0, 0, 0]), 3)
    nhwc = _layout(attrs) == "NHWC"
    xv = x.movedim(-1, 1) if nhwc else x
    if all(lo == hi >= 0 for lo, hi in pads):
        sym = [lo for lo, _ in pads]
    else:
        flat = [v for lo, hi in reversed(pads) for v in (lo, hi)]
        xv, sym = F.pad(xv, flat), [0, 0, 0]
    out = F.conv3d(xv, w, None, strides, sym, dilations, groups)
    return {"Output": [out.movedim(1, -1) if nhwc else out]}


@register_op("deformable_conv", non_differentiable_inputs=("Mask",))
def deformable_conv(inputs, attrs):
    """Deformable conv v2 (ref: deformable_conv_op.cc): the input
    bilinearly sampled at the offset-shifted taps (a tap outside the
    image gives 0, a sample a whole pixel outside gives 0), modulated by
    Mask, then one contraction with the filter. groups = 1 and
    deformable_groups = 1, as in the reference."""
    from ._sampling import bilinear_gather
    x = inputs["Input"][0]
    offset = inputs["Offset"][0]
    mask = (inputs.get("Mask") or [None])[0]
    w = inputs["Filter"][0]
    strides = _pair(attrs.get("strides", [1, 1]))
    paddings = _pair(attrs.get("paddings", [0, 0]))
    dilations = _pair(attrs.get("dilations", [1, 1]))
    groups = int(attrs.get("groups", 1) or 1)
    d_groups = int(attrs.get("deformable_groups", 1) or 1)
    enforce(groups == 1 and d_groups == 1,
            "deformable_conv: only groups=1, deformable_groups=1 are "
            "supported", InvalidArgumentError)
    n, _, h, wid = x.shape
    _, _, kh, kw = w.shape
    oh = (h + 2 * paddings[0] - (dilations[0] * (kh - 1) + 1)) \
        // strides[0] + 1
    ow = (wid + 2 * paddings[1] - (dilations[1] * (kw - 1) + 1)) \
        // strides[1] + 1

    def grid(count, step, start, dtype):
        return torch.arange(count, device=x.device, dtype=dtype) * step \
            - start

    dt = offset.dtype
    oy, ox = grid(oh, strides[0], paddings[0], dt), \
        grid(ow, strides[1], paddings[1], dt)
    ky, kx = grid(kh, dilations[0], 0, dt), grid(kw, dilations[1], 0, dt)
    base_y = oy[:, None, None, None] + ky[None, None, :, None]
    base_x = ox[None, :, None, None] + kx[None, None, None, :]
    # offsets [N, 2*kh*kw, oh, ow], (y, x) a tap
    off = offset.reshape(n, kh * kw, 2, oh, ow)
    off_y = off[:, :, 0].permute(0, 2, 3, 1).reshape(n, oh, ow, kh, kw)
    off_x = off[:, :, 1].permute(0, 2, 3, 1).reshape(n, oh, ow, kh, kw)
    sy, sx = base_y[None] + off_y, base_x[None] + off_x
    valid = (sy > -1) & (sy < h) & (sx > -1) & (sx < wid)
    cols = bilinear_gather(x, sy, sx, True) * valid.unsqueeze(1)
    if mask is not None:                          # [N, C, oh, ow, kh, kw]
        m = mask.reshape(n, kh * kw, oh, ow).permute(0, 2, 3, 1).reshape(
            n, oh, ow, kh, kw)
        cols = cols * m[:, None]
    return {"Output": [torch.einsum("ncyxhw,ochw->noyx", cols, w)]}


def _moments(x, dims):
    """Mean and biased variance over ``dims``, kept as size-1 dims."""
    var, mean = torch.var_mean(x, dim=dims, correction=0, keepdim=True)
    return mean, var


@register_op("instance_norm",
             intermediate_outputs=("SavedMean", "SavedVariance"))
def instance_norm(inputs, attrs):
    """ref: instance_norm_op.cc: each (sample, channel) normalised over
    its spatial dims with the biased variance. ``SavedMean`` and
    ``SavedVariance`` are the statistics with every size-1 dim squeezed,
    as the reference returns them (``jnp.squeeze``): at batch 1 they are
    [C]."""
    x = inputs["X"][0]
    eps = attrs.get("epsilon", 1e-5)
    mean, var = _moments(x, tuple(range(2, x.ndim)))
    y = (x - mean) * torch.rsqrt(var + eps)
    bshape = [1, x.shape[1]] + [1] * (x.ndim - 2)
    if inputs.get("Scale"):
        y = y * inputs["Scale"][0].reshape(bshape)
    if inputs.get("Bias"):
        y = y + inputs["Bias"][0].reshape(bshape)
    return {"Y": [y], "SavedMean": [mean.detach().squeeze()],
            "SavedVariance": [var.detach().squeeze()]}


@register_op("group_norm", intermediate_outputs=("Mean", "Variance"))
def group_norm(inputs, attrs):
    """ref: group_norm_op.cc (NCHW): each sample's channels in ``groups``
    groups, each normalised with the biased variance; Mean and Variance
    squeezed as the reference returns them."""
    x = inputs["X"][0]
    g = attrs.get("groups", 1)
    eps = attrs.get("epsilon", 1e-5)
    n, c = x.shape[0], x.shape[1]
    xr = x.reshape((n, g, c // g) + tuple(x.shape[2:]))
    mean, var = _moments(xr, tuple(range(2, xr.ndim)))
    y = ((xr - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    bshape = [1, c] + [1] * (x.ndim - 2)
    if inputs.get("Scale"):
        y = y * inputs["Scale"][0].reshape(bshape)
    if inputs.get("Bias"):
        y = y + inputs["Bias"][0].reshape(bshape)
    return {"Y": [y], "Mean": [mean.detach().squeeze()],
            "Variance": [var.detach().squeeze()]}


@register_op("data_norm")
def data_norm(inputs, attrs):
    """ref: data_norm_op.cc:302: normalisation by accumulated batch
    statistics (CTR models): means = sum / size, scales = sqrt(size /
    square_sum), with no mean^2 subtracted (the reference keeps
    BatchSquareSum centred by its update rule)."""
    x = inputs["X"][0]
    bsize = inputs["BatchSize"][0]
    means = inputs["BatchSum"][0] / bsize
    scales = torch.sqrt(bsize / inputs["BatchSquareSum"][0])
    return {"Y": [(x - means) * scales], "Means": [means],
            "Scales": [scales]}


@register_op("spectral_norm")
def spectral_norm(inputs, attrs):
    """ref: spectral_norm_op.cc: weight / sigma, sigma from
    ``power_iters`` steps of power iteration started at the given U and
    V. As in the reference the iteration is part of the function, so the
    gradient flows through it too."""
    w = inputs["Weight"][0]
    u = inputs["U"][0].reshape(-1)
    v = inputs["V"][0].reshape(-1)
    dim = int(attrs.get("dim", 0))
    eps = float(attrs.get("eps", 1e-12))
    mat = w.movedim(dim, 0).reshape(w.shape[dim], -1)
    for _ in range(int(attrs.get("power_iters", 1))):
        v = mat.T @ u
        v = v / (torch.linalg.vector_norm(v) + eps)
        u = mat @ v
        u = u / (torch.linalg.vector_norm(u) + eps)
    return {"Out": [w / (u @ mat @ v)]}


@register_op("lrn", intermediate_outputs=("MidOut",))
def lrn(inputs, attrs):
    """ref: lrn_op.cc: local response norm across channels, x / (k +
    alpha * sum of x^2 over the n channels around)^beta."""
    x = inputs["X"][0]
    n_size = int(attrs.get("n", 5))
    alpha = float(attrs.get("alpha", 1e-4))
    beta = float(attrs.get("beta", 0.75))
    k = float(attrs.get("k", 2.0))
    half = n_size // 2
    sqp = F.pad(torch.square(x), (0, 0, 0, 0, half, n_size - 1 - half))
    acc = 0.0
    for i in range(n_size):
        acc = acc + sqp[:, i:i + x.shape[1]]
    mid = k + alpha * acc
    return {"Out": [x / torch.pow(mid, beta)], "MidOut": [mid]}


@register_op("log_softmax")
def log_softmax(inputs, attrs):
    return {"Out": [torch.log_softmax(inputs["X"][0],
                                      dim=attrs.get("axis", -1))]}


@register_op("cross_entropy", non_differentiable_inputs=("Label",))
def cross_entropy(inputs, attrs):
    """ref: cross_entropy_op.cc: X holds probabilities; log clamped at
    1e-20."""
    x, label = inputs["X"][0], inputs["Label"][0]
    if attrs.get("soft_label", False):
        loss = -(label * torch.log(x.clamp_min(1e-20))).sum(
            dim=-1, keepdim=True)
    else:
        lbl = label.squeeze(-1) if label.ndim == x.ndim else label
        picked = x.gather(-1, lbl.long().unsqueeze(-1))
        loss = -torch.log(picked.clamp_min(1e-20))
    return {"Y": [loss]}


@register_op("cross_entropy2", intermediate_outputs=("XShape", "MatchX"),
             non_differentiable_inputs=("Label",))
def cross_entropy2(inputs, attrs):
    out = cross_entropy(inputs, attrs)
    return {"Y": out["Y"], "MatchX": out["Y"], "XShape": [inputs["X"][0]]}


@register_op("sigmoid_cross_entropy_with_logits")
def sigmoid_cross_entropy_with_logits(inputs, attrs):
    """ref: sigmoid_cross_entropy_with_logits_op.cc: max(x, 0) - x*label
    + log(1 + exp(-|x|)); ``ignore_index`` zeroes a position, and
    ``normalize`` divides by the count of labels not ignored. Label is a
    differentiable input, as in the reference."""
    x, label = inputs["X"][0], inputs["Label"][0]
    loss = torch.clamp_min(x, 0) - x * label + F.softplus(-torch.abs(x))
    ignore = attrs.get("ignore_index", -1)
    if ignore != -1:
        loss = torch.where(label == ignore, 0.0, loss)
    if attrs.get("normalize", False):
        norm = (label != ignore).to(loss.dtype).sum().clamp_min(1.0)
        loss = loss / norm
    return {"Out": [loss]}


@register_op("embedding", non_differentiable_inputs=("Ids",))
def embedding(inputs, attrs):
    return lookup_table_v2(inputs, attrs)


@register_op("prelu")
def prelu(inputs, attrs):
    """ref: prelu_op.cc: x where x > 0, else alpha * x; mode "all" (one
    alpha), "channel" (one a channel, NCHW) or "element" (alpha shaped
    like x)."""
    x, alpha = inputs["X"][0], inputs["Alpha"][0]
    if attrs.get("mode", "all") == "channel":
        alpha = alpha.reshape([1, -1] + [1] * (x.ndim - 2))
    return {"Out": [torch.where(x > 0, x, alpha * x)]}


@register_op("huber_loss", intermediate_outputs=("Residual",))
def huber_loss(inputs, attrs):
    x, y = inputs["X"][0], inputs["Y"][0]
    d = attrs.get("delta", 1.0)
    r = y - x
    loss = torch.where(torch.abs(r) <= d, 0.5 * r * r,
                       d * (torch.abs(r) - 0.5 * d))
    return {"Out": [loss], "Residual": [r]}


@register_op("mse_loss")
def mse_loss(inputs, attrs):
    return {"Out": [torch.square(inputs["X"][0] - inputs["Label"][0])]}


@register_op("smooth_l1_loss", intermediate_outputs=("Diff",))
def smooth_l1_loss(inputs, attrs):
    """ref: smooth_l1_loss_op.h: summed over every dim but the first."""
    x, y = inputs["X"][0], inputs["Y"][0]
    sigma2 = attrs.get("sigma", 1.0) ** 2
    d = x - y
    if inputs.get("InsideWeight"):
        d = d * inputs["InsideWeight"][0]
    loss = torch.where(torch.abs(d) < 1.0 / sigma2,
                       0.5 * d * d * sigma2, torch.abs(d) - 0.5 / sigma2)
    if inputs.get("OutsideWeight"):
        loss = loss * inputs["OutsideWeight"][0]
    return {"Out": [loss.sum(dim=tuple(range(1, x.ndim)), keepdim=True)],
            "Diff": [d]}
