"""Long-tail op families: ROI pooling variants, CTR and ranking ops,
sampled softmax, im2sequence, correlation, host-side utility ops and
composition aliases.

Port of ``paddle_tpu/ops/misc_ops.py``. Notes:

- ``cudnn_lstm`` runs torch's own LSTM (cuDNN on the card) on the
  reference's structured WeightList ([Wx, Wh, B] a layer and direction,
  gate order i, f, g, o in both); torch's second bias is zero. With
  SequenceLength the batch is packed, which freezes each row's state
  past its length and zeroes its outputs there, as the reference's
  masked scan does (the lengths are read on the host).
- ``save``, ``load``, ``save_combine`` and ``load_combine`` read and
  write the reference's files: ``np.save`` / ``np.savez`` of the host
  arrays.
- ``shuffle_batch`` and ``sample_logits`` draw from ``core/rng``'s
  seeded generators, seeded as the reference seeds its keys (a Seed
  input, read on the host, else the seed attr plus the op's call
  count): torch's numbers, not threefry's.
- ``run_program`` runs its sub-program through a fresh port Executor
  and Scope on the inputs' device.
- ``py_func``, ``print``, ``filter_by_instag`` and the IO ops read
  their inputs on the host.
"""
from __future__ import annotations

import json
import os
from typing import Callable, Dict

import numpy as np
import torch
import torch.nn.functional as F

from ..core import dtype as dtypes, rng
from ..core.enforce import InvalidArgumentError, enforce, host_only
from ..core.registry import OpInfoMap, register_op
from ..device import creation_device
from ._sampling import bilinear_gather

_CALL_COUNTS: Dict[str, int] = {}


def next_call(tag: str) -> int:
    """Per-op call counter for ops whose reference kernels draw from a
    stateful engine: repeated calls must not replay one stream."""
    n = _CALL_COUNTS.get(tag, 0)
    _CALL_COUNTS[tag] = n + 1
    return n


def _rois_batch_idx(rois, rois_num, n):
    r = rois.shape[0]
    if rois_num is None:
        return torch.zeros(r, dtype=torch.int64, device=rois.device)
    return torch.repeat_interleave(
        torch.arange(n, device=rois.device), rois_num.to(torch.int64),
        output_size=r)


def _bin_bounds(start, size, bins, limit):
    """[R, bins] lower and upper pixel bounds of each bin: floor and
    ceil of the bin's edges, clipped to [0, limit]."""
    i = torch.arange(bins, dtype=torch.float32, device=start.device)
    lo = torch.floor(start[:, None] + i * size[:, None]).clamp(0, limit)
    hi = torch.ceil(start[:, None] + (i + 1) * size[:, None]).clamp(0, limit)
    return lo, hi


def _bin_masks(y_lo, y_hi, x_lo, x_hi, h, w):
    """[R, ph, pw, H, W] membership of each pixel in each bin."""
    ys = torch.arange(h, dtype=torch.float32, device=y_lo.device)
    xs = torch.arange(w, dtype=torch.float32, device=y_lo.device)
    my = (ys >= y_lo[..., None]) & (ys < y_hi[..., None])       # [R,ph,H]
    mx = (xs >= x_lo[..., None]) & (xs < x_hi[..., None])       # [R,pw,W]
    return my[:, :, None, :, None] & mx[:, None, :, None, :]


# ------------------------------------------------------------- roi_pool
@register_op("roi_pool", intermediate_outputs=("Argmax",),
             non_differentiable_inputs=("ROIs", "RoisNum"))
def roi_pool(inputs, attrs):
    """Quantized max pooling over ROI bins: X [N, C, H, W], ROIs [R, 4]
    -> Out [R, C, ph, pw]; the roi corners are rounded, each bin is the
    max of its pixels, 0 for an empty bin."""
    x, rois = inputs["X"][0], inputs["ROIs"][0]
    rois_num = (inputs.get("RoisNum") or [None])[0]
    ph = int(attrs.get("pooled_height", 1))
    pw = int(attrs.get("pooled_width", 1))
    scale = float(attrs.get("spatial_scale", 1.0))
    n, c, h, w = x.shape
    x0, y0, x1, y1 = (torch.round(rois[:, k] * scale) for k in range(4))
    bin_h = (y1 - y0 + 1).clamp_min(1.0) / ph
    bin_w = (x1 - x0 + 1).clamp_min(1.0) / pw
    y_lo, y_hi = _bin_bounds(y0, bin_h, ph, h)
    x_lo, x_hi = _bin_bounds(x0, bin_w, pw, w)
    m = _bin_masks(y_lo, y_hi, x_lo, x_hi, h, w)[:, None]
    img = x[_rois_batch_idx(rois, rois_num, n)][:, :, None, None]
    v = torch.where(m, img, torch.full((), -torch.inf, dtype=x.dtype,
                                       device=x.device)).amax((-2, -1))
    return {"Out": [torch.where(m.any((-2, -1)), v, torch.zeros(
        (), dtype=x.dtype, device=x.device))]}


@register_op("psroi_pool", non_differentiable_inputs=("ROIs", "RoisNum"))
def psroi_pool(inputs, attrs):
    """Position-sensitive average pooling: input channels are
    output_channels * ph * pw; bin (i, j) of output channel c averages
    input channel (c * ph + i) * pw + j over the bin."""
    x, rois = inputs["X"][0], inputs["ROIs"][0]
    rois_num = (inputs.get("RoisNum") or [None])[0]
    ph = int(attrs.get("pooled_height", 1))
    pw = int(attrs.get("pooled_width", 1))
    oc = int(attrs.get("output_channels"))
    scale = float(attrs.get("spatial_scale", 1.0))
    n, c, h, w = x.shape
    enforce(c == oc * ph * pw, f"psroi_pool: C={c} must equal "
            f"output_channels*ph*pw={oc * ph * pw}", InvalidArgumentError)
    y0 = torch.round(rois[:, 1]) * scale
    x0 = torch.round(rois[:, 0]) * scale
    y1 = torch.round(rois[:, 3] + 1.0) * scale
    x1 = torch.round(rois[:, 2] + 1.0) * scale
    y_lo, y_hi = _bin_bounds(y0, (y1 - y0).clamp_min(0.1) / ph, ph, h)
    x_lo, x_hi = _bin_bounds(x0, (x1 - x0).clamp_min(0.1) / pw, pw, w)
    m = _bin_masks(y_lo, y_hi, x_lo, x_hi, h, w).to(torch.float32)
    img = x.reshape(n, oc, ph, pw, h, w)[_rois_batch_idx(rois, rois_num, n)]
    s = torch.einsum("rcijhw,rijhw->rcij", img.to(torch.float32), m)
    cnt = m.sum((-2, -1)).clamp_min(1.0)[:, None]
    return {"Out": [(s / cnt).to(x.dtype)]}


@register_op("prroi_pool", non_differentiable_inputs=("ROIs", "RoisNum",
                                                      "BatchRoINums"))
def prroi_pool(inputs, attrs):
    """Precise RoI pooling as the reference computes it: the mean of a
    fixed ``sample_num`` x ``sample_num`` grid of bilinear samples a bin
    (differentiable in the features and the roi coordinates)."""
    x, rois = inputs["X"][0], inputs["ROIs"][0]
    rois_num = (inputs.get("RoisNum") or inputs.get("BatchRoINums")
                or [None])[0]
    ph = int(attrs.get("pooled_height", 1))
    pw = int(attrs.get("pooled_width", 1))
    scale = float(attrs.get("spatial_scale", 1.0))
    sr = int(attrs.get("sample_num", 4))
    n, c, h, w = x.shape
    r = rois.shape[0]
    y0, x0 = rois[:, 1] * scale, rois[:, 0] * scale
    bin_h = (rois[:, 3] - rois[:, 1]).clamp_min(0.0) * scale / ph
    bin_w = (rois[:, 2] - rois[:, 0]).clamp_min(0.0) * scale / pw
    f32 = dict(dtype=torch.float32, device=x.device)
    sg = (torch.arange(sr, **f32)[None, :] + 0.5) / sr
    gy = torch.arange(ph, **f32)[:, None] + sg                # [ph, sr]
    gx = torch.arange(pw, **f32)[:, None] + sg
    ys = (y0[:, None, None] + gy * bin_h[:, None, None]).reshape(r, -1)
    xs = (x0[:, None, None] + gx * bin_w[:, None, None]).reshape(r, -1)
    yy = ys.clamp(0.0, h - 1.0)[:, :, None].expand(r, ph * sr, pw * sr)
    xx = xs.clamp(0.0, w - 1.0)[:, None, :].expand(r, ph * sr, pw * sr)
    vals = bilinear_gather(x[_rois_batch_idx(rois, rois_num, n)], yy, xx,
                           False)
    return {"Out": [vals.reshape(r, c, ph, sr, pw, sr).mean((3, 5))]}


# --------------------------------------------------------- CTR/ranking
@register_op("cvm", non_differentiable_inputs=())
def cvm(inputs, attrs):
    """X [N, 2 + D], cols 0/1 (show, click): use_cvm replaces them by
    log(show + 1) and log(click + 1) - log(show + 1); else strips
    them."""
    x = inputs["X"][0]
    if not bool(attrs.get("use_cvm", True)):
        return {"Y": [x[:, 2:]]}
    show = torch.log(x[:, 0:1] + 1.0)
    click = torch.log(x[:, 1:2] + 1.0) - show
    return {"Y": [torch.cat([show, click, x[:, 2:]], 1)]}


@register_op("batch_fc")
def batch_fc(inputs, attrs):
    """Slot-batched FC: Input [S, B, Din] @ W [S, Din, Dout] + Bias
    ([S, Dout] or [S, 1, Dout])."""
    out = torch.einsum("sbi,sio->sbo", inputs["Input"][0], inputs["W"][0])
    if inputs.get("Bias"):
        b = inputs["Bias"][0]
        out = out + b.reshape(b.shape[0], 1, b.shape[-1])
    return {"Out": [out]}


def _seed_of(inputs, attrs, attr, tag):
    """A Seed input (read on the host), else attr ``attr`` plus the op's
    call count, as the reference seeds its key."""
    if inputs.get("Seed"):
        return int(host_only(inputs["Seed"][0], tag).reshape(-1)[0])
    return int(attrs.get(attr, 0)) + next_call(tag)


@register_op("shuffle_batch", intermediate_outputs=("ShuffleIdx",
                                                    "SeedOut"),
             non_differentiable_inputs=("Seed",))
def shuffle_batch(inputs, attrs):
    """A random row permutation of X, the permutation (so the gradient
    unshuffles) and the next seed."""
    x = inputs["X"][0]
    seed = _seed_of(inputs, attrs, "startup_seed", "shuffle_batch") \
        % (2 ** 32)
    perm = torch.randperm(x.shape[0],
                          generator=rng.seeded_generator(seed)).to(x.device)
    return {"Out": [x.index_select(0, perm)], "ShuffleIdx": [perm],
            "SeedOut": [torch.full((1,), seed + 1, dtype=torch.int64,
                                   device=x.device)]}


@register_op("filter_by_instag", non_differentiable_inputs=("Ins_tag",
                                                            "Filter_tag"))
def filter_by_instag(inputs, attrs):
    """Rows whose tag is in the filter set, their indices and a
    LossWeight of ones (one row of ``out_val_if_empty`` and a zero
    weight when none matches). Tags are read on the host (ragged
    output)."""
    ins = inputs["Ins"][0]
    tags = host_only(inputs["Ins_tag"][0], "filter_by_instag").reshape(-1)
    flt = set(host_only(inputs["Filter_tag"][0],
                        "filter_by_instag").reshape(-1).tolist())
    keep = [i for i, t in enumerate(tags.tolist()) if t in flt]
    dev = ins.device
    if not keep:
        fill = float(attrs.get("out_val_if_empty", 0.0))
        return {"Out": [torch.full((1,) + tuple(ins.shape[1:]), fill,
                                   dtype=ins.dtype, device=dev)],
                "LossWeight": [torch.zeros((1, 1), device=dev)],
                "IndexMap": [torch.zeros(1, dtype=torch.int64,
                                         device=dev)]}
    idx = torch.tensor(keep, dtype=torch.int64).to(dev)
    return {"Out": [ins.index_select(0, idx)],
            "LossWeight": [torch.ones((len(keep), 1), device=dev)],
            "IndexMap": [idx]}


# ------------------------------------------------------ sampled softmax
@register_op("sample_logits",
             intermediate_outputs=("Samples", "Probabilities",
                                   "LogitsDim", "LabelsDim"),
             non_differentiable_inputs=("Labels", "CustomizedSamples",
                                        "CustomizedProbabilities"))
def sample_logits(inputs, attrs):
    """Sampled-softmax helper: the logits of the true labels and of
    ``num_samples`` negatives drawn uniformly with replacement (or
    CustomizedSamples), minus log q; accidental hits of a true label
    among the negatives pushed to -1e20."""
    logits = inputs["Logits"][0]
    labels = inputs["Labels"][0].to(torch.int64)
    n, k = logits.shape
    nt = labels.shape[1]
    s = int(attrs.get("num_samples", 1))
    if inputs.get("CustomizedSamples"):
        samples = inputs["CustomizedSamples"][0].to(torch.int64)
        probs = inputs["CustomizedProbabilities"][0]
    else:
        seed = _seed_of(inputs, attrs, "seed", "sample_logits") % (2 ** 32)
        neg = torch.randint(0, k, (n, s),
                            generator=rng.seeded_generator(seed)).to(
            logits.device)
        samples = torch.cat([labels, neg], 1)
        probs = torch.full((n, nt + s), 1.0 / k, dtype=logits.dtype,
                           device=logits.device)
    picked = torch.gather(logits, 1, samples)
    if bool(attrs.get("remove_accidental_hits", True)):
        hit = (samples[:, None, :] == labels[:, :, None]).any(1)
        col = torch.arange(samples.shape[1], device=logits.device)[None, :]
        picked = torch.where(hit & (col >= nt), picked - 1e20, picked)
    i64 = dict(dtype=torch.int64, device=logits.device)
    return {"SampledLogits": [picked - torch.log(probs)],
            "SampledLabels": [torch.arange(nt, **i64)[None, :].expand(
                n, nt)],
            "Samples": [samples],
            "Probabilities": [probs],
            "LogitsDim": [torch.tensor([n, k], **i64)],
            "LabelsDim": [torch.tensor([n, nt], **i64)]}


# --------------------------------------------------------- im2sequence
@register_op("im2sequence")
def im2sequence(inputs, attrs):
    """Image -> patch sequence: X [N, C, H, W] -> Out [N, oh * ow,
    kh * kw * C], each patch in [kh, kw, C] order."""
    x = inputs["X"][0]
    kh, kw = [int(v) for v in attrs["kernels"]]
    sh, sw = [int(v) for v in attrs.get("strides", [1, 1])]
    pads = [int(v) for v in attrs.get("paddings", [0, 0, 0, 0])]
    n, c = x.shape[:2]
    xp = F.pad(x, (pads[1], pads[3], pads[0], pads[2]))
    p = F.unfold(xp, (kh, kw), stride=(sh, sw))          # [N, C*kh*kw, L]
    p = p.reshape(n, c, kh * kw, -1).permute(0, 3, 2, 1)
    return {"Out": [p.reshape(n, p.shape[1], kh * kw * c)]}


# ---------------------------------------------------------- correlation
@register_op("correlation")
def correlation(inputs, attrs):
    """FlowNet's cost volume: for each displacement of the
    (2 * max_displacement / stride2 + 1)^2 grid, the mean over channels
    and the kernel window of x1(p) . x2(p + d)."""
    x1, x2 = inputs["Input1"][0], inputs["Input2"][0]
    pad = int(attrs.get("pad_size", 0))
    ks = int(attrs.get("kernel_size", 1))
    md = int(attrs.get("max_displacement", 1))
    s1 = int(attrs.get("stride1", 1))
    s2 = int(attrs.get("stride2", 1))
    enforce(ks % 2 == 1, "correlation: kernel_size must be odd",
            InvalidArgumentError)
    h, w = x1.shape[2:]
    x1p = F.pad(x1, (pad, pad, pad, pad))
    x2p = F.pad(x2, (pad, pad, pad, pad))
    d = md // s2
    disp = [k * s2 for k in range(-d, d + 1)]
    kr = ks // 2
    dev = x1.device
    oy = torch.arange(md + kr, h + 2 * pad - md - kr, s1, device=dev)
    ox = torch.arange(md + kr, w + 2 * pad - md - kr, s1, device=dev)
    maps = []
    for dy in disp:
        for dx in disp:
            acc = 0.
            for ky in range(-kr, kr + 1):
                for kx in range(-kr, kr + 1):
                    a = x1p[:, :, oy[:, None] + ky, ox[None, :] + kx]
                    b = x2p[:, :, oy[:, None] + dy + ky,
                            ox[None, :] + dx + kx]
                    acc = acc + (a * b).mean(1)
            maps.append(acc / (ks * ks))
    return {"Output": [torch.stack(maps, 1)]}


# ------------------------------------------------------------- host ops
_PY_FUNCS: Dict[int, Callable] = {}


def register_py_func(fn: Callable) -> int:
    """Register a python callable for the py_func op; returns its id."""
    fid = len(_PY_FUNCS)
    _PY_FUNCS[fid] = fn
    return fid


@register_op("py_func", non_differentiable_inputs=("X",))
def py_func(inputs, attrs):
    """Call back into python on the inputs' host copies; the results
    come back on the current device."""
    fid = int(attrs["forward_callable_id"])
    fn = _PY_FUNCS.get(fid)
    enforce(fn is not None, f"py_func id {fid} not registered",
            InvalidArgumentError)
    out = fn(*[host_only(v, "py_func") for v in inputs.get("X", [])])
    if out is None:
        return {"Out": []}
    if not isinstance(out, (list, tuple)):
        out = [out]
    return {"Out": [dtypes.from_host(np.asarray(o)).to(creation_device())
                    for o in out]}


@register_op("print", non_differentiable_inputs=())
def print_op(inputs, attrs):
    """Pass-through that prints ``message`` and the value (a host copy)
    for the first ``first_n`` calls of a message (every call when
    negative)."""
    x = inputs["In"][0] if "In" in inputs else inputs["X"][0]
    msg = attrs.get("message", "")
    first_n = int(attrs.get("first_n", -1))
    if first_n != 0 and x.device.type != "meta":
        count = next_call(f"print:{msg}")
        if first_n < 0 or count < first_n:
            print(msg + str(host_only(x, "print")))
    return {"Out": [x]}


@register_op("save", non_differentiable_inputs=("X",))
def save_op(inputs, attrs):
    """One var to ``file_path`` (npy)."""
    x = host_only(inputs["X"][0], "save")
    path = attrs["file_path"]
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.save(path, x)
    return {}


@register_op("load", non_differentiable_inputs=())
def load_op(inputs, attrs):
    path = attrs["file_path"]
    if not path.endswith(".npy"):
        path = path + ".npy"
    return {"Out": [dtypes.from_host(np.load(path)).to(creation_device())]}


@register_op("save_combine", non_differentiable_inputs=("X",))
def save_combine(inputs, attrs):
    """Many vars, one file (npz); names from attr ``names`` or
    positional."""
    xs = [host_only(v, "save_combine") for v in inputs["X"]]
    names = attrs.get("names") or [f"var_{i}" for i in range(len(xs))]
    path = attrs["file_path"]
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **dict(zip(names, xs)))
    return {}


@register_op("load_combine", non_differentiable_inputs=())
def load_combine(inputs, attrs):
    path = attrs["file_path"]
    if not path.endswith(".npz"):
        path = path + ".npz"
    data = np.load(path)
    names = attrs.get("names") or list(data.files)
    dev = creation_device()
    return {"Out": [dtypes.from_host(data[n]).to(dev) for n in names]}


# --------------------------------------------------- composition aliases
@register_op("deformable_conv_v1")
def deformable_conv_v1(inputs, attrs):
    """ref: operators/deformable_conv_v1_op.cc — ``deformable_conv``
    without the modulation mask."""
    inner = dict(inputs)
    inner.pop("Mask", None)
    return OpInfoMap.instance().get("deformable_conv").compute(inner, attrs)


@register_op("inplace_abn",
             intermediate_outputs=("MeanOut", "VarianceOut", "SavedMean",
                                   "SavedVariance", "ReserveSpace"),
             non_differentiable_inputs=("Mean", "Variance"))
def inplace_abn(inputs, attrs):
    """batch_norm, then the activation (identity, leaky_relu or elu)."""
    out = OpInfoMap.instance().get("batch_norm").compute(inputs, attrs)
    act = attrs.get("activation", "identity")
    y = out["Y"][0]
    if act in ("leaky_relu", "leakyrelu"):
        y = torch.where(y > 0, y, float(attrs.get("alpha", 0.01)) * y)
    elif act == "elu":
        y = torch.where(y > 0, y, float(attrs.get("alpha", 1.0)) *
                        (torch.exp(y) - 1.0))
    elif act not in ("identity", "", None):
        raise InvalidArgumentError(
            f"inplace_abn: unsupported activation {act!r}")
    out["Y"] = [y]
    return out


@register_op("cudnn_lstm", intermediate_outputs=("Reserve", "StateOut"),
             non_differentiable_inputs=("SequenceLength",))
def cudnn_lstm(inputs, attrs):
    """Multi-layer, optionally bidirectional LSTM over the whole
    sequence on torch's LSTM: Input [T, N, D] (time-major), InitH / InitC
    [L * dirs, N, H], WeightList [Wx [Din, 4H], Wh [H, 4H], B [4H]] a
    layer and direction -> Out [T, N, H * dirs], LastH, LastC."""
    from torch.nn.utils.rnn import (PackedSequence, pack_padded_sequence,
                                    pad_packed_sequence)
    x = inputs["Input"][0]
    h0, c0 = inputs["InitH"][0], inputs["InitC"][0]
    weights = inputs["WeightList"]
    seq_len = (inputs.get("SequenceLength") or [None])[0]
    layers = int(attrs.get("num_layers", 1))
    bidirec = bool(attrs.get("is_bidirec", False))
    dirs = 2 if bidirec else 1
    enforce(len(weights) == 3 * layers * dirs,
            f"cudnn_lstm: WeightList needs {3 * layers * dirs} tensors "
            f"([Wx, Wh, B] per layer per direction), got {len(weights)}",
            InvalidArgumentError)
    flat = []
    for k in range(layers * dirs):
        wx, wh, b = weights[3 * k:3 * k + 3]
        flat += [wx.t().contiguous(), wh.t().contiguous(), b,
                 torch.zeros_like(b)]
    train = torch.is_grad_enabled()
    if seq_len is None:
        out, hn, cn = torch._VF.lstm(x, (h0, c0), flat, True, layers, 0.0,
                                     train, bidirec, False)
        return {"Out": [out], "LastH": [hn], "LastC": [cn]}
    lengths = host_only(seq_len, "cudnn_lstm").astype(np.int64)
    enforce(lengths.min() >= 1, "cudnn_lstm: every SequenceLength must be "
            "at least 1", InvalidArgumentError)
    packed = pack_padded_sequence(x, torch.from_numpy(lengths),
                                  enforce_sorted=False)
    order, back = packed.sorted_indices, packed.unsorted_indices
    data, hn, cn = torch._VF.lstm(
        packed.data, packed.batch_sizes,
        (h0.index_select(1, order), c0.index_select(1, order)), flat, True,
        layers, 0.0, train, bidirec)
    out, _ = pad_packed_sequence(
        PackedSequence(data, packed.batch_sizes, order, back),
        total_length=x.shape[0])
    return {"Out": [out], "LastH": [hn.index_select(1, back)],
            "LastC": [cn.index_select(1, back)]}


@register_op("expand_as")
def expand_as(inputs, attrs):
    """v1 semantics: X tiled so each dim matches the target's (each
    must divide evenly)."""
    x = inputs["X"][0]
    target = inputs["target_tensor" if "target_tensor" in inputs
                    else "Y"][0]
    times = []
    for xs, ts in zip(x.shape, target.shape):
        enforce(ts % xs == 0, f"expand_as: target dim {ts} not a "
                f"multiple of input dim {xs}", InvalidArgumentError)
        times.append(ts // xs)
    return {"Out": [x.repeat(times)]}


@register_op("split_byref")
def split_byref(inputs, attrs):
    """split sharing the input's buffer: split."""
    return OpInfoMap.instance().get("split").compute(inputs, attrs)


# ----------------------------------------------------- int8 quant trio
@register_op("quantize", non_differentiable_inputs=("Input",))
def quantize(inputs, attrs):
    x = inputs["Input"][0]
    q = torch.round(x * float(attrs.get("Scale", 1.0)) +
                    float(attrs.get("Shift", 0.0))).clamp(-128, 127)
    return {"Output": [q.to(torch.int8)]}


@register_op("dequantize", non_differentiable_inputs=("Input",))
def dequantize(inputs, attrs):
    x = inputs["Input"][0].to(torch.float32)
    return {"Output": [(x - float(attrs.get("Shift", 0.0))) /
                       float(attrs.get("Scale", 1.0))]}


@register_op("requantize", non_differentiable_inputs=("Input",))
def requantize(inputs, attrs):
    x = inputs["Input"][0].to(torch.float32)
    q = torch.round(x * float(attrs.get("Scale_out", 1.0)) /
                    float(attrs.get("Scale_in", 1.0))).clamp(-128, 127)
    return {"Output": [q.to(torch.int8)]}


@register_op("run_program", non_differentiable_inputs=("X", "Params"))
def run_program(inputs, attrs):
    """A sub-program as one op (the dy2static partial-program bridge):
    attrs ``program`` (Program JSON), ``feed_names``, ``fetch_names`` and
    ``param_names`` feeding the Params slot, run through a fresh
    Executor and Scope on the inputs' device."""
    from ..core.executor import Executor
    from ..core.program import Program
    from ..core.scope import Scope
    from ..core.tensor import TpuTensor
    prog_json = attrs.get("program")
    enforce(prog_json is not None, "run_program needs a 'program' attr",
            InvalidArgumentError)
    program = Program.from_json(prog_json if isinstance(prog_json, str)
                                else json.dumps(prog_json))
    feed_names = list(attrs.get("feed_names", []))
    param_names = list(attrs.get("param_names", []))
    xs, params = inputs.get("X", []), inputs.get("Params", [])
    enforce(len(xs) == len(feed_names),
            f"run_program: {len(feed_names)} feed names vs {len(xs)} "
            "inputs", InvalidArgumentError)
    enforce(len(params) == len(param_names),
            f"run_program: {len(param_names)} param names vs "
            f"{len(params)} param inputs", InvalidArgumentError)
    dev = (list(xs) + list(params))[0].device if xs or params \
        else creation_device()
    scope = Scope()
    for name, value in zip(param_names, params):
        scope.var(name).set(TpuTensor(value.detach()))
    outs = Executor(dev).run(program, feed=dict(zip(feed_names, xs)),
                             fetch_list=list(attrs.get("fetch_names", [])),
                             scope=scope, return_numpy=False)
    return {"Out": [o.value for o in outs]}
