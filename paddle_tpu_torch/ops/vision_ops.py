"""Vision ops: the interpolation family, grid sampling, layout shuffles,
pooling with index, crops and pads.

Port of every op type of ``paddle_tpu/ops/vision_ops.py`` (ref:
paddle/fluid/operators/interpolate_op.{cc,h}, grid_sampler_op.cc,
affine_grid_op.cc, affine_channel_op.cc, pixel_shuffle_op.cc,
shuffle_channel_op.cc, space_to_depth_op.cc, temporal_shift_op.cc,
crop_op.cc, crop_tensor_op.cc, reverse_op.cc, pad_constant_like_op.cc,
unfold_op.cc, unpool_op.cc, pool_with_index_op.cc, pool_op.cc (3-D)).

Interpolation is separable: along each spatial axis a gather of source
rows and a weighted sum, by ``interpolate_op.h``'s coordinate rules (not
``F.interpolate``'s, which differ). The source indices and weights
depend only on the sizes, so they are computed on the host in float32
exactly as the reference computes them (``_src_coords``), and moved
once a device (cached, so a call on the card copies nothing from the
host): the card and the CPU pick the same pixels, where torch's CUDA
kernels, which multiply by the reciprocal of a Python divisor, could
floor to another one. ``max_pool*_with_index`` takes the window's first maximum
(``argmax``), and its gradient splits between tied maxima as
``jnp.max``'s does (``amax``).
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from ..core.enforce import InvalidArgumentError, enforce
from ..core.registry import register_op

# --------------------------------------------------------------- interp
_F32 = np.float32


def _ratio(out_len, in_len, align_corners):
    """The coordinate ratio in float32, as the reference's Python float
    enters its float32 arithmetic."""
    if align_corners:
        return _F32((in_len - 1.0) / (out_len - 1.0) if out_len > 1 else 0.0)
    return _F32(in_len / out_len)


def _per_device(plan):
    """``plan(*key)``'s numpy arrays (nested in tuples) as tensors on the
    device named by an extra last argument, cached."""
    def to(a, device):
        if isinstance(a, np.ndarray):
            return torch.from_numpy(a).to(device)
        return tuple(to(b, device) for b in a)

    @functools.lru_cache(maxsize=256)
    def cached(*args):
        return to(plan(*args[:-1]), args[-1])
    return cached


@_per_device
def _linear_plan(out_len, in_len, align_corners, align_mode):
    """Source rows lo / hi and hi's weight along an axis
    (``vision_ops.py:30-60``)."""
    i = np.arange(out_len, dtype=_F32)
    ratio = _ratio(out_len, in_len, align_corners)
    if align_corners or align_mode != 0:
        src = i * ratio
    else:
        src = np.maximum(ratio * (i + _F32(0.5)) - _F32(0.5), _F32(0.0))
    lo = np.clip(np.floor(src).astype(np.int32), 0, in_len - 1)
    hi = np.minimum(lo + 1, in_len - 1)
    return lo.astype(np.int64), hi.astype(np.int64), (src - lo).astype(_F32)


@_per_device
def _nearest_plan(out_len, in_len, align_corners):
    """Source rows: rounded when aligned, floored otherwise
    (``interpolate_op.h:96``)."""
    i = np.arange(out_len, dtype=_F32)
    src = i * _ratio(out_len, in_len, align_corners)
    if align_corners:
        src = src + _F32(0.5)
    return np.clip(src.astype(np.int32), 0, in_len - 1).astype(np.int64)


def _cubic_w(t, a=-0.75):
    """Keys' cubic convolution kernel (the reference's cubic weights)."""
    at = np.abs(t).astype(_F32)
    at2, at3 = at * at, at * at * at
    w1 = _F32(a + 2) * at3 - _F32(a + 3) * at2 + _F32(1)
    w2 = _F32(a) * at3 - _F32(5 * a) * at2 + _F32(8 * a) * at - _F32(4 * a)
    return np.where(at <= 1, w1, np.where(at < 2, w2, _F32(0.0))).astype(_F32)


@_per_device
def _cubic_plan(out_len, in_len, align_corners):
    """Four source rows and their weights along an axis."""
    i = np.arange(out_len, dtype=_F32)
    ratio = _ratio(out_len, in_len, align_corners)
    src = i * ratio if align_corners else \
        ratio * (i + _F32(0.5)) - _F32(0.5)
    base = np.floor(src).astype(np.int32)
    frac = (src - base).astype(_F32)
    return tuple((np.clip(base + k, 0, in_len - 1).astype(np.int64),
                  _cubic_w(frac - _F32(k))) for k in range(-1, 3))


def _weights(w, x, axis):
    shape = [1] * x.ndim
    shape[axis] = w.shape[0]
    return w.to(x.dtype).reshape(shape)


def _linear_axis(x, out_len, axis, align_corners, align_mode):
    in_len = x.shape[axis]
    if out_len == in_len and align_corners:
        return x
    lo, hi, w = _linear_plan(out_len, in_len, align_corners, align_mode,
                             str(x.device))
    wb = _weights(w, x, axis)
    return x.index_select(axis, lo) * (1 - wb) + \
        x.index_select(axis, hi) * wb


def _nearest_axis(x, out_len, axis, align_corners):
    return x.index_select(axis, _nearest_plan(
        out_len, x.shape[axis], align_corners, str(x.device)))


def _cubic_axis(x, out_len, axis, align_corners):
    out = 0.0
    for idx, w in _cubic_plan(out_len, x.shape[axis], align_corners,
                              str(x.device)):
        out = out + x.index_select(axis, idx) * _weights(w, x, axis)
    return out


def _interp(inputs, attrs, mode):
    x = inputs["X"][0]
    layout = attrs.get("data_layout", "NCHW")
    align_corners = bool(attrs.get("align_corners", True))
    align_mode = int(attrs.get("align_mode", 1))
    nd = x.ndim - 2                       # spatial rank: 1, 2 or 3
    enforce(nd in (1, 2, 3),
            f"interp expects 3/4/5-D input, got {x.ndim}-D",
            InvalidArgumentError)
    channels_last = layout in ("NHWC", "NWC", "NDHWC")
    if channels_last:
        x = x.movedim(-1, 1)
    keys = {1: ["out_w"], 2: ["out_h", "out_w"],
            3: ["out_d", "out_h", "out_w"]}[nd]
    scale = attrs.get("scale", 0.0)
    scales = list(scale) if isinstance(scale, (list, tuple)) else \
        [scale] * nd
    sizes = []
    for d, key in enumerate(keys):
        v = int(attrs.get(key, 0) or 0)
        if v <= 0:
            s = float(scales[d] if d < len(scales) else scales[-1])
            enforce(s > 0, f"interp needs {key} or a positive scale",
                    InvalidArgumentError)
            v = int(x.shape[2 + d] * s)
        sizes.append(v)
    for d, out_len in enumerate(sizes):
        axis = 2 + d
        if mode == "nearest":
            x = _nearest_axis(x, out_len, axis, align_corners)
        elif mode == "cubic":
            x = _cubic_axis(x, out_len, axis, align_corners)
        else:
            x = _linear_axis(x, out_len, axis, align_corners, align_mode)
    return {"Out": [x.movedim(1, -1) if channels_last else x]}


for _name, _mode in [
        ("linear_interp", "linear"), ("bilinear_interp", "linear"),
        ("trilinear_interp", "linear"), ("nearest_interp", "nearest"),
        ("bicubic_interp", "cubic")]:
    for _suffix in ("", "_v2"):
        register_op(_name + _suffix,
                    non_differentiable_inputs=("OutSize", "SizeTensor",
                                               "Scale"))(
            (lambda m: lambda inputs, attrs: _interp(inputs, attrs, m))(
                _mode))


# --------------------------------------------------------- grid sampling
@_per_device
def _affine_base(h, w, align):
    """[H, W, 3]: each output pixel's normalised (x, y, 1)."""
    if align:
        xs = np.linspace(-1.0, 1.0, w).astype(_F32)
        ys = np.linspace(-1.0, 1.0, h).astype(_F32)
    else:
        xs = ((np.arange(w) * 2 + 1).astype(_F32) / _F32(w) - _F32(1.0))
        ys = ((np.arange(h) * 2 + 1).astype(_F32) / _F32(h) - _F32(1.0))
    gx, gy = np.meshgrid(xs, ys)
    return np.ascontiguousarray(np.stack([gx, gy, np.ones_like(gx)], -1))


@register_op("affine_grid", non_differentiable_inputs=("OutputShape",))
def affine_grid(inputs, attrs):
    """ref: affine_grid_op.cc: Theta [N, 2, 3] -> Grid [N, H, W, 2] of
    normalised sample coordinates, for the ``output_shape`` attr."""
    theta = inputs["Theta"][0]
    out_shape = attrs.get("output_shape", [])
    enforce(len(out_shape) == 4, "affine_grid needs output_shape attr "
            "[N,C,H,W] (dynamic OutputShape input is not traceable)",
            InvalidArgumentError)
    _, _, h, w = [int(v) for v in out_shape]
    base = _affine_base(h, w, bool(attrs.get("align_corners", True)),
                        str(theta.device)).to(theta.dtype)
    return {"Output": [torch.einsum("hwk,nik->nhwi", base, theta)]}


@register_op("grid_sampler", non_differentiable_inputs=())
def grid_sampler(inputs, attrs):
    """ref: grid_sampler_op.cc: bilinear or nearest sampling of X [N, C,
    H, W] at Grid [N, Hg, Wg, 2] (normalised x, y); padding "zeros",
    "border" or "reflection". Grid is differentiable (through the
    bilinear weights), as in the reference."""
    from ._sampling import bilinear_gather
    x, grid = inputs["X"][0], inputs["Grid"][0]
    mode = attrs.get("mode", "bilinear")
    padding = attrs.get("padding_mode", "zeros")
    align = bool(attrs.get("align_corners", True))
    _, _, h, w = x.shape
    gx, gy = grid[..., 0], grid[..., 1]
    if align:
        fx = (gx + 1.0) * 0.5 * (w - 1)
        fy = (gy + 1.0) * 0.5 * (h - 1)
    else:
        fx = ((gx + 1.0) * w - 1.0) * 0.5
        fy = ((gy + 1.0) * h - 1.0) * 0.5
    if padding == "reflection":
        def refl(f, size):
            if align:
                span = 2 * (size - 1)
                f = torch.abs(torch.remainder(f, span))
                return torch.where(f > size - 1, span - f, f)
            span = 2 * size
            f = torch.remainder(torch.abs(f + 0.5), span)
            f = torch.where(f > size, span - f, f) - 0.5
            return f.clamp(0, size - 1)
        fx, fy = refl(fx, w), refl(fy, h)
    elif padding == "border":
        fx, fy = fx.clamp(0, w - 1), fy.clamp(0, h - 1)
    zeros_pad = padding == "zeros"
    if mode != "nearest":
        return {"Output": [bilinear_gather(x, fy, fx, zeros_pad)]}
    from ._sampling import _take
    yy, xx = torch.round(fy), torch.round(fx)
    v = _take(x, yy.to(torch.int32).clamp(0, h - 1).long(),
              xx.to(torch.int32).clamp(0, w - 1).long())
    if zeros_pad:
        ok = (yy >= 0) & (yy <= h - 1) & (xx >= 0) & (xx <= w - 1)
        v = v * ok.unsqueeze(1).to(v.dtype)
    return {"Output": [v]}


# ------------------------------------------------------- channel/layout
@register_op("affine_channel")
def affine_channel(inputs, attrs):
    """ref: affine_channel_op.cc: Out = Scale[C] * X + Bias[C]."""
    x = inputs["X"][0]
    scale = inputs["Scale"][0].reshape(-1)
    bias = inputs["Bias"][0].reshape(-1)
    shape = [1] * x.ndim
    shape[1 if attrs.get("data_layout", "NCHW") == "NCHW" else -1] = \
        scale.shape[0]
    return {"Out": [x * scale.reshape(shape) + bias.reshape(shape)]}


@register_op("pixel_shuffle")
def pixel_shuffle(inputs, attrs):
    """ref: pixel_shuffle_op.cc: [N, C r^2, H, W] -> [N, C, H r, W r]."""
    x = inputs["X"][0]
    r = int(attrs.get("upscale_factor", 1))
    if attrs.get("data_format", "NCHW") == "NCHW":
        n, c, h, w = x.shape
        x = x.reshape(n, c // (r * r), r, r, h, w).permute(0, 1, 4, 2, 5, 3)
        return {"Out": [x.reshape(n, c // (r * r), h * r, w * r)]}
    n, h, w, c = x.shape
    x = x.reshape(n, h, w, r, r, c // (r * r)).permute(0, 1, 3, 2, 4, 5)
    return {"Out": [x.reshape(n, h * r, w * r, c // (r * r))]}


@register_op("shuffle_channel")
def shuffle_channel(inputs, attrs):
    """ref: shuffle_channel_op.cc: ShuffleNet's group interleave."""
    x = inputs["X"][0]
    g = int(attrs.get("group", 1))
    n, c, h, w = x.shape
    return {"Out": [x.reshape(n, g, c // g, h, w).transpose(1, 2)
                    .reshape(n, c, h, w)]}


@register_op("space_to_depth")
def space_to_depth(inputs, attrs):
    """ref: space_to_depth_op.cc: [N, C, H, W] -> [N, C b^2, H/b, W/b]."""
    x = inputs["X"][0]
    b = int(attrs.get("blocksize", 1))
    n, c, h, w = x.shape
    enforce(h % b == 0 and w % b == 0,
            f"space_to_depth: spatial dims {(h, w)} not divisible by "
            f"blocksize {b}", InvalidArgumentError)
    x = x.reshape(n, c, h // b, b, w // b, b).permute(0, 3, 5, 1, 2, 4)
    return {"Out": [x.reshape(n, c * b * b, h // b, w // b)]}


@register_op("temporal_shift")
def temporal_shift(inputs, attrs):
    """ref: temporal_shift_op.cc: TSM's channel shift along segments, X
    [N*T, C, H, W]; the first fold takes t + 1, the second t - 1."""
    x = inputs["X"][0]
    t = int(attrs.get("seg_num", 1))
    ratio = float(attrs.get("shift_ratio", 0.25))
    nt, c, h, w = x.shape
    c1, c2 = int(c * ratio), int(c * 2 * ratio)
    v = x.reshape(nt // t, t, c, h, w)
    fwd = torch.cat([v[:, 1:, :c1], torch.zeros_like(v[:, :1, :c1])], 1)
    back = torch.cat([torch.zeros_like(v[:, :1, c1:c2]),
                      v[:, :-1, c1:c2]], 1)
    out = torch.cat([fwd, back, v[:, :, c2:]], dim=2)
    return {"Out": [out.reshape(nt, c, h, w)]}


# ------------------------------------------------------------ crop / pad
def _crop_common(x, offsets, shape):
    enforce(len(shape) == x.ndim and len(offsets) == x.ndim,
            f"crop: offsets/shape rank must match input rank {x.ndim}",
            InvalidArgumentError)
    for i, (o, s) in enumerate(zip(offsets, shape)):
        size = x.shape[i] if s in (-1, 0) or s is None else int(s)
        x = x.narrow(i, int(o), size)
    return x


@register_op("crop", non_differentiable_inputs=("Y", "Offsets"))
def crop(inputs, attrs):
    """ref: crop_op.cc: static offsets and shape (the shape may come
    from a Y tensor)."""
    x = inputs["X"][0]
    y = (inputs.get("Y") or [None])[0]
    shape = list(attrs.get("shape", []) or
                 (list(y.shape) if y is not None else []))
    offsets = list(attrs.get("offsets", []) or [0] * x.ndim)
    return {"Out": [_crop_common(x, offsets, shape)]}


@register_op("crop_tensor", non_differentiable_inputs=("Shape", "Offsets",
                                                       "ShapeTensor",
                                                       "OffsetsTensor"))
def crop_tensor(inputs, attrs):
    x = inputs["X"][0]
    shape = list(attrs.get("shape", []) or list(x.shape))
    offsets = list(attrs.get("offsets", []) or [0] * x.ndim)
    return {"Out": [_crop_common(x, offsets, shape)]}


@register_op("reverse")
def reverse(inputs, attrs):
    """ref: reverse_op.cc: flip along the given axes."""
    return {"Out": [torch.flip(inputs["X"][0], dims=tuple(
        int(a) for a in attrs.get("axis", [0])))]}


@register_op("pad_constant_like")
def pad_constant_like(inputs, attrs):
    """ref: pad_constant_like_op.cc: Y padded at the end of each dim up
    to X's shape with pad_value."""
    x, y = inputs["X"][0], inputs["Y"][0]
    pads = []
    for xs, ys in reversed(list(zip(x.shape, y.shape))):
        pads += [0, int(xs - ys)]
    return {"Out": [F.pad(y, pads, value=float(attrs.get("pad_value",
                                                          0.0)))]}


# ------------------------------------------------------- unfold / unpool
@register_op("unfold")
def unfold(inputs, attrs):
    """ref: unfold_op.cc: im2col, [N, C, H, W] -> [N, C kh kw, L], the
    channel major; paddings [top, left, bottom, right] (or two values)."""
    x = inputs["X"][0]
    p = list(attrs.get("paddings", [0, 0]))
    if len(p) == 2:
        p = [p[0], p[1], p[0], p[1]]
    xp = F.pad(x, (p[1], p[3], p[0], p[2]))
    return {"Y": [F.unfold(xp, list(attrs.get("kernel_sizes", [1, 1])),
                           dilation=list(attrs.get("dilations", [1, 1])),
                           stride=list(attrs.get("strides", [1, 1])))]}


def _max_pool_with_index(inputs, attrs, nd):
    """Windows of the input padded with -inf beside windows of the flat
    spatial index padded with -1: Out is each window's max (``amax``),
    Mask the index at its first maximum (``argmax``)."""
    x = inputs["X"][0]
    k = [int(v) for v in attrs.get("ksize", [1] * nd)]
    s = [int(v) for v in attrs.get("strides", [1] * nd)]
    p = [int(v) for v in attrs.get("paddings", [0] * nd)]
    if attrs.get("global_pooling", False):
        k, p = list(x.shape[2:]), [0] * nd
    spatial = tuple(x.shape[2:])
    pad = [v for i in reversed(range(nd)) for v in (p[i], p[i])]
    xp = F.pad(x, pad, value=float("-inf"))
    ip = F.pad(torch.arange(math.prod(spatial), dtype=torch.float32,
                            device=x.device).reshape((1, 1) + spatial),
               pad, value=-1.0)

    def windows(arr):
        for i in range(nd):
            arr = arr.unfold(2 + i, k[i], s[i])
        return arr.reshape(arr.shape[:2 + nd] + (-1,))

    vp, ipp = windows(xp), windows(ip)
    arg = vp.argmax(dim=-1, keepdim=True)
    idx = ipp.expand(vp.shape).gather(-1, arg).squeeze(-1)
    return {"Out": [vp.amax(dim=-1)], "Mask": [idx.to(torch.int32)]}


@register_op("max_pool2d_with_index", intermediate_outputs=("Mask",))
def max_pool2d_with_index(inputs, attrs):
    """ref: pool_with_index_op.cc: max pool with the flat H*W index of
    each maximum (unpool's companion)."""
    return _max_pool_with_index(inputs, attrs, 2)


@register_op("max_pool3d_with_index", intermediate_outputs=("Mask",))
def max_pool3d_with_index(inputs, attrs):
    return _max_pool_with_index(inputs, attrs, 3)


@register_op("unpool", non_differentiable_inputs=("Indices",))
def unpool(inputs, attrs):
    """ref: unpool_op.cc: the pooled values added back at the positions
    max_pool2d_with_index recorded."""
    x, idx = inputs["X"][0], inputs["Indices"][0]
    out_hw = attrs.get("unpooled_size", None) or attrs.get("output_size")
    enforce(out_hw is not None and len(out_hw) >= 2,
            "unpool needs unpooled_size [H, W]", InvalidArgumentError)
    oh, ow = int(out_hw[-2]), int(out_hw[-1])
    n, c = x.shape[:2]
    out = torch.zeros((n, c, oh * ow), dtype=x.dtype, device=x.device)
    out = out.scatter_add(2, idx.reshape(n, c, -1).long(),
                          x.reshape(n, c, -1))
    return {"Out": [out.reshape(n, c, oh, ow)]}


@register_op("pool3d")
def pool3d(inputs, attrs):
    """ref: pool_op.cc, the 3-D variant: max or avg over padded windows
    (``exclusive`` counts only the input's elements), global or adaptive
    (bins that divide the input)."""
    x = inputs["X"][0]
    ptype = attrs.get("pooling_type", "max")
    k = [int(v) for v in attrs.get("ksize", [1, 1, 1])]
    s = [int(v) for v in attrs.get("strides", [1, 1, 1])]
    p = [int(v) for v in attrs.get("paddings", [0, 0, 0])]
    if attrs.get("global_pooling", False):
        k, p = list(x.shape[2:]), [0, 0, 0]
    if attrs.get("adaptive", False):
        for i in range(3):
            enforce(x.shape[2 + i] % int(attrs["ksize"][i]) == 0,
                    f"adaptive pool3d: input dim {x.shape[2 + i]} not "
                    f"divisible by output bins {attrs['ksize'][i]}",
                    InvalidArgumentError)
        k = [x.shape[2 + i] // int(attrs["ksize"][i]) for i in range(3)]
        s, p = k, [0, 0, 0]
    pad = (p[2], p[2], p[1], p[1], p[0], p[0])
    if ptype == "max":
        return {"Out": [F.max_pool3d(F.pad(x, pad, value=float("-inf")),
                                     k, s)]}
    summed = F.avg_pool3d(F.pad(x, pad), k, s, divisor_override=1)
    if attrs.get("exclusive", True) and any(p):
        ones = F.pad(torch.ones_like(x[:1, :1]), pad)
        return {"Out": [summed / F.avg_pool3d(ones, k, s,
                                              divisor_override=1)]}
    return {"Out": [summed / float(k[0] * k[1] * k[2])]}
