"""Long-tail ops.

Port of ``paddle_tpu/ops/long_tail_ops.py``. Notes:

- ``hash`` is the reference's 32-bit multiplicative mix, computed in
  int64 and masked to 32 bits after each multiply (each multiply split
  into 16-bit halves, so no product leaves int64): bit-equal to the
  JAX package's uint32 arithmetic.
- ``sampling_id`` and ``random_crop`` draw from ``core/rng``'s seeded
  generators, seeded as the reference seeds its keys (a Seed input, read on the host, else
  the seed attr plus the op's call count): torch's numbers, not
  threefry's. ``sampling_id`` draws its uniforms on the CPU, moves them
  and inverts each row's CDF on the device.
- ``similarity_focus`` and ``chunk_eval`` are greedy or set logic: they
  read their inputs on the host, as the reference (CPU-only there).
- ``deformable_psroi_pooling`` samples through ``_sampling``'s bilinear
  gather, a bin of all RoIs at a time.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..core import rng
from ..core.enforce import InvalidArgumentError, enforce, host_only
from ..core.registry import register_op


def _adaptive_pool(inputs, attrs, nd):
    """Output cell i pools the input over [floor(i in / out), ceil((i + 1)
    in / out)) along each dim, the bins of the reference's double loop
    (``long_tail_ops.py:24-70``) and of torch's adaptive pools."""
    x = inputs["X"][0]
    size = [int(v) for v in attrs["pool_size"]]
    ptype = attrs.get("pooling_type", attrs.get("pool_type", "max"))
    if ptype == "max":
        fn = F.adaptive_max_pool2d if nd == 2 else F.adaptive_max_pool3d
    else:
        fn = F.adaptive_avg_pool2d if nd == 2 else F.adaptive_avg_pool3d
    return {"Out": [fn(x, size)]}


@register_op("adaptive_pool2d")
def adaptive_pool2d(inputs, attrs):
    """ref: fluid/layers/nn.py adaptive_pool2d (pool_op adaptive=true)."""
    return _adaptive_pool(inputs, attrs, 2)


@register_op("adaptive_pool3d")
def adaptive_pool3d(inputs, attrs):
    """ref: fluid/layers/nn.py adaptive_pool3d."""
    return _adaptive_pool(inputs, attrs, 3)


@register_op("brelu")
def brelu(inputs, attrs):
    """ref: operators/activation_op.cc BRelu: clip(x, t_min, t_max)."""
    return {"Out": [inputs["X"][0].clamp(float(attrs.get("t_min", 0.0)),
                                         float(attrs.get("t_max", 24.0)))]}


@register_op("bilinear_tensor_product")
def bilinear_tensor_product(inputs, attrs):
    """ref: operators/bilinear_tensor_product_op.cc: out[b, s] = x[b] W[s]
    y[b]^T (+ bias)."""
    out = torch.einsum("bm,smn,bn->bs", inputs["X"][0],
                       inputs["Weight"][0], inputs["Y"][0])
    if inputs.get("Bias"):
        out = out + inputs["Bias"][0].reshape(1, -1)
    return {"Out": [out]}


@register_op("unique", non_differentiable_inputs=("X",))
def unique(inputs, attrs):
    """ref: operators/unique_op.cc over the flattened input: the unique
    values in the order they first appear (``Out``), each element's row
    among them (``Index``), each value's first position (``Indices``) and
    count (``Counts``), all int64. The count of values depends on the
    data, so it is read on the host (one sync on the card)."""
    x = inputs["X"][0].reshape(-1)
    vals, inv, counts = torch.unique(x, sorted=True, return_inverse=True,
                                     return_counts=True)
    pos = torch.arange(x.shape[0], device=x.device)
    first = torch.full((vals.shape[0],), x.shape[0], dtype=torch.int64,
                       device=x.device).scatter_reduce(0, inv, pos, "amin")
    order = torch.argsort(first)
    remap = torch.empty_like(order)
    remap[order] = torch.arange(order.shape[0], device=x.device)
    return {"Out": [vals[order]], "Index": [remap[inv]],
            "Indices": [first[order]], "Counts": [counts[order]]}


# ------------------------------------------------------------------ hash
_MASK32 = 0xFFFFFFFF


def _mul32(h, k):
    """(h * k) mod 2**32 for h in [0, 2**32) held in int64, the product
    split into 16-bit halves of k so that nothing overflows int64."""
    lo, hi = k & 0xFFFF, k >> 16
    return (h * lo + (((h * hi) & 0xFFFF) << 16)) & _MASK32


@register_op("hash", non_differentiable_inputs=("X",))
def hash_op(inputs, attrs):
    """ref: operators/hash_op.cc — num_hash hashes of each row of int
    ids, modulo mod_by, [N, num_hash] int64. The JAX package's design
    (a multiplicative mix a seed in place of XXH32 over raw bytes),
    bit for bit."""
    x = inputs["X"][0].long() & _MASK32
    num_hash = int(attrs.get("num_hash", 1))
    mod_by = int(attrs.get("mod_by", 1))
    if x.ndim == 1:
        x = x[:, None]

    def mix(h):
        h = _mul32(h ^ (h >> 16), 0x85EBCA6B)
        h = _mul32(h ^ (h >> 13), 0xC2B2AE35)
        return h ^ (h >> 16)

    outs = []
    for s in range(num_hash):
        h = torch.full(x.shape[:1], (s * 0x9E3779B9) & _MASK32,
                       dtype=torch.int64, device=x.device)
        for j in range(x.shape[1]):
            h = mix((_mul32(h, 31) + x[:, j]) & _MASK32)
        outs.append(h % mod_by)
    return {"Out": [torch.stack(outs, dim=1)]}


# ------------------------------------------------------------ sampling_id
@register_op("sampling_id", non_differentiable_inputs=("X",))
def sampling_id(inputs, attrs):
    """ref: operators/sampling_id_op.cc — one draw from each row of the
    probability matrix X [N, K] (each row taken as weights, as the JAX
    package's categorical over log(max(x, 1e-20))) -> ids [N] int64. The
    seed is the attr, else 1 + the op's call count, as the JAX
    package's."""
    from .misc_ops import next_call
    x = inputs["X"][0]
    seed = int(attrs.get("seed", 0)) or 1 + next_call("sampling_id")
    u = torch.rand((x.shape[0], 1), generator=rng.seeded_generator(seed),
                   dtype=torch.float64).to(x.device)
    cdf = torch.cumsum(torch.clamp_min(x.double(), 1e-20), dim=1)
    ids = (cdf < u * cdf[:, -1:]).sum(1)
    return {"Out": [torch.clamp_max(ids, x.shape[1] - 1)]}


# --------------------------------------------------------------- mean_iou
@register_op("mean_iou", non_differentiable_inputs=("Predictions",
                                                    "Labels"))
def mean_iou(inputs, attrs):
    """ref: operators/mean_iou_op.cc — the mean IoU over the classes
    present in the labels or the predictions: OutMeanIou (0-d float32),
    OutWrong [C] and OutCorrect [C] (int32). Ids outside [0, C) count in
    no class, as the JAX package's segment sums drop them."""
    pred = inputs["Predictions"][0].reshape(-1).long()
    label = inputs["Labels"][0].reshape(-1).long()
    c = int(attrs["num_classes"])

    def count(ids, weight):
        ok = (ids >= 0) & (ids < c)
        return torch.zeros(c, dtype=torch.float32, device=ids.device) \
            .index_add_(0, torch.where(ok, ids, 0),
                        (weight & ok).float())

    ones = torch.ones_like(pred, dtype=torch.bool)
    correct = count(label, pred == label)
    union = count(pred, ones) + count(label, ones) - correct
    present = union > 0
    iou = torch.where(present, correct / torch.clamp_min(union, 1.0), 0.0)
    mean = iou.sum() / torch.clamp_min(present.sum(), 1)
    return {"OutMeanIou": [mean.float()],
            "OutWrong": [(count(label, ones) - correct).int()],
            "OutCorrect": [correct.int()]}


# ------------------------------------------------- add_position_encoding
@register_op("add_position_encoding")
def add_position_encoding(inputs, attrs):
    """ref: operators/add_position_encoding_op.h:85 — the transformer's
    sinusoid: the first half of the channels get alpha x + beta sin, the
    second alpha x + beta cos, frequency 10000^(k / (half - 1)); an odd
    last channel gets alpha x."""
    x = inputs["X"][0]
    alpha = float(attrs.get("alpha", 1.0))
    beta = float(attrs.get("beta", 1.0))
    _, t, d = x.shape
    half = d // 2
    enforce(half >= 1, "add_position_encoding needs dim >= 2",
            InvalidArgumentError)
    pos = torch.arange(t, dtype=torch.float32, device=x.device)[:, None]
    k = torch.arange(half, dtype=torch.float32, device=x.device)[None, :]
    angle = pos / torch.pow(10000.0, k / max(half - 1, 1))
    enc = F.pad(torch.cat([torch.sin(angle), torch.cos(angle)], 1),
                (0, d - 2 * half))
    return {"Out": [x * alpha + enc[None].to(x.dtype) * beta]}


@register_op("soft_relu")
def soft_relu(inputs, attrs):
    """ref: activation_op.cc SoftRelu — log(1 + exp(clip(x, -t, t)))."""
    t = float(attrs.get("threshold", 40.0))
    return {"Out": [torch.log1p(torch.exp(inputs["X"][0].clamp(-t, t)))]}


# ------------------------------------------------------------ random_crop
@register_op("random_crop", non_differentiable_inputs=("Seed",))
def random_crop(inputs, attrs):
    """ref: operators/random_crop_op.cc — a crop of the trailing dims to
    attr ``shape``, at one random start a dim for the whole batch (as
    the JAX package), and SeedOut = the seed + 1. The seed is the Seed
    input (read on the host), else ``startup_seed`` (or ``seed``) plus
    the op's call count."""
    from .misc_ops import next_call
    x = inputs["X"][0]
    crop = [int(v) for v in attrs["shape"]]
    if inputs.get("Seed"):
        seed = int(host_only(inputs["Seed"][0],
                             "random_crop").reshape(-1)[0]) & _MASK32
    else:
        seed = (int(attrs.get("startup_seed", attrs.get("seed", 0)))
                + next_call("random_crop")) & _MASK32
    gen = rng.seeded_generator(seed)
    lead = x.ndim - len(crop)
    out = x
    for i, cs in enumerate(crop):
        full = x.shape[lead + i]
        enforce(cs <= full, f"random_crop: crop dim {cs} > input {full}",
                InvalidArgumentError)
        start = int(torch.randint(0, full - cs + 1, (), generator=gen))
        out = out.narrow(lead + i, start, cs)
    return {"Out": [out], "SeedOut": [torch.full(
        (1,), seed + 1, dtype=torch.int64, device=x.device)]}


# ------------------------------------------------------- similarity_focus
@register_op("similarity_focus", non_differentiable_inputs=("X",))
def similarity_focus(inputs, attrs):
    """ref: operators/similarity_focus_op.cc — for each indexed channel,
    greedily mark maxima with rows and columns not taken yet (min(B, C)
    of them), OR the masks and broadcast them over the channels. Read on
    the host (a greedy, sequential selection; the reference is
    CPU-only)."""
    x = host_only(inputs["X"][0], "similarity_focus")
    axis = int(attrs.get("axis", 1))
    indexes = [int(v) for v in attrs.get("indexes", [0])]
    enforce(x.ndim == 4, "similarity_focus expects a 4-D input",
            InvalidArgumentError)
    enforce(axis in (1, 2, 3), "similarity_focus: axis must be 1, 2 "
            "or 3", InvalidArgumentError)
    mask = np.zeros_like(x, np.float32)
    for b in range(x.shape[0]):
        for idx in indexes:
            t = np.take(x[b], idx, axis=axis - 1)     # the 2-D slice
            rows, cols = t.shape
            used_r, used_c = np.zeros(rows, bool), np.zeros(cols, bool)
            m2 = np.zeros_like(t, np.float32)
            picked = 0
            for f in np.argsort(-t, axis=None):
                r, c_ = divmod(int(f), cols)
                if used_r[r] or used_c[c_]:
                    continue
                m2[r, c_] = 1.0
                used_r[r] = used_c[c_] = True
                picked += 1
                if picked == min(rows, cols):
                    break
            mask[b] = np.maximum(mask[b], np.broadcast_to(
                np.expand_dims(m2, axis - 1), x[b].shape))
    return {"Out": [torch.from_numpy(mask).to(inputs["X"][0].device)]}


# -------------------------------------------------------------- chunk_eval
def _extract_chunks(tags, scheme: str, num_types: int):
    """The (start, end, type) chunks of a tag sequence under IOB / IOE /
    IOBES / plain. Tag = type * tag_num + position, where position
    enumerates the scheme's states (IOB: B=0, I=1; IOE: I=0, E=1; IOBES:
    B, I, E, S; plain: 0)."""
    tag_num = {"iob": 2, "ioe": 2, "iobes": 4, "plain": 1}[scheme]
    chunks = set()
    start = cur_type = None
    for i, t in enumerate(tags):
        if t < 0 or t >= num_types * tag_num:   # outside / padding
            if start is not None:
                chunks.add((start, i - 1, cur_type))
                start = None
            continue
        ctype, pos = divmod(int(t), tag_num)
        if scheme == "plain":
            is_begin, is_end = cur_type != ctype or start is None, False
        elif scheme == "iob":
            is_begin, is_end = pos == 0 or ctype != cur_type, False
        elif scheme == "ioe":
            is_begin, is_end = start is None or ctype != cur_type, pos == 1
        else:                                   # iobes
            is_begin, is_end = pos in (0, 3), pos in (2, 3)
        if is_begin:
            if start is not None:
                chunks.add((start, i - 1, cur_type))
            start, cur_type = i, ctype
        if is_end and start is not None:
            chunks.add((start, i, cur_type))
            start = None
            cur_type = None if scheme != "plain" else cur_type
    if start is not None:
        chunks.add((start, len(tags) - 1, cur_type))
    return chunks


@register_op("chunk_eval", non_differentiable_inputs=("Inference",
                                                      "Label", "Length"))
def chunk_eval(inputs, attrs):
    """ref: operators/metrics/chunk_eval_op.cc — chunking (NER)
    precision, recall and F1 over IOB / IOE / IOBES / plain: Inference
    and Label [B, T] with Length [B], read on the host (set
    arithmetic)."""
    inf = host_only(inputs["Inference"][0], "chunk_eval")
    lab = host_only(inputs["Label"][0], "chunk_eval")
    dev = inputs["Inference"][0].device
    length = (host_only(inputs["Length"][0], "chunk_eval").reshape(-1)
              if inputs.get("Length")
              else np.full((inf.shape[0],), inf.shape[1], np.int64))
    scheme = attrs.get("chunk_scheme", "iob").lower()
    num_types = int(attrs.get("num_chunk_types", 1))
    n_inf = n_lab = n_correct = 0
    for b in range(inf.shape[0]):
        ln = int(length[b])
        ci = _extract_chunks(inf[b, :ln].reshape(-1).tolist(), scheme,
                             num_types)
        cl = _extract_chunks(lab[b, :ln].reshape(-1).tolist(), scheme,
                             num_types)
        n_inf, n_lab = n_inf + len(ci), n_lab + len(cl)
        n_correct += len(ci & cl)
    p = n_correct / n_inf if n_inf else 0.0
    r = n_correct / n_lab if n_lab else 0.0
    f1 = 2 * p * r / (p + r) if p + r else 0.0

    def as_f(v):
        return torch.full((), np.float32(v), dtype=torch.float32,
                          device=dev)

    def as_i(v):
        return torch.full((), v, dtype=torch.int64, device=dev)

    return {"Precision": [as_f(p)], "Recall": [as_f(r)],
            "F1-Score": [as_f(f1)], "NumInferChunks": [as_i(n_inf)],
            "NumLabelChunks": [as_i(n_lab)],
            "NumCorrectChunks": [as_i(n_correct)]}


# -------------------------------------------------------------- scatter_nd
@register_op("scatter_nd", non_differentiable_inputs=("Index",))
def scatter_nd(inputs, attrs):
    """ref: operators/scatter_nd_add_op.cc (scatter_nd = zeros +
    scatter_nd_add, the fluid layer's contract): repeated indices add."""
    index = inputs["Index"][0].long()
    updates = inputs["Updates"][0]
    shape = [int(v) for v in attrs["shape"]]
    zeros = updates.new_zeros(shape)
    return {"Out": [zeros.index_put(tuple(index.movedim(-1, 0)), updates,
                                    accumulate=True)]}


# ---------------------------------------------------- deformable_psroi_pool
@register_op("deformable_psroi_pooling",
             intermediate_outputs=("TopCount",),
             non_differentiable_inputs=("ROIs", "RoisNum"))
def deformable_psroi_pooling(inputs, attrs):
    """ref: operators/deformable_psroi_pooling_op.cc — position-sensitive
    RoI pooling whose bins are shifted by learned normalized offsets
    (Trans [R, 2 * ph * pw]): each bin averages a sample_per_part^2
    grid of bilinear samples (taps clamped to the border) from its own
    channel group. As the JAX package, every RoI reads image 0."""
    from ._sampling import bilinear_gather
    x = inputs["Input"][0]
    rois = inputs["ROIs"][0]
    trans = (inputs.get("Trans") or [None])[0]
    ph = int(attrs.get("pooled_height", 1))
    pw = int(attrs.get("pooled_width", 1))
    oc = int(attrs.get("output_dim"))
    scale = float(attrs.get("spatial_scale", 1.0))
    sample = int(attrs.get("sample_per_part", 4))
    trans_std = float(attrs.get("trans_std", 0.1))
    no_trans = bool(attrs.get("no_trans", trans is None))
    _, c, h, w = x.shape
    enforce(c == oc * ph * pw, "deformable_psroi_pooling: C must be "
            f"output_dim*ph*pw ({oc * ph * pw}), got {c}",
            InvalidArgumentError)
    r = rois.shape[0]
    x0 = rois[:, 0] * scale - 0.5
    y0 = rois[:, 1] * scale - 0.5
    bin_w = torch.clamp_min(rois[:, 2] * scale + 0.5 - x0, 0.1) / pw
    bin_h = torch.clamp_min(rois[:, 3] * scale + 0.5 - y0, 0.1) / ph
    if no_trans or trans is None:
        off = x.new_zeros((r, 2, ph, pw))
    else:
        off = trans.reshape(r, 2, ph, pw) * trans_std
    img = x[0].reshape(oc, ph, pw, h, w)
    sg = (torch.arange(sample, dtype=torch.float32, device=x.device)
          + 0.5) / sample
    out = []
    for i in range(ph):
        for j in range(pw):
            ys = y0[:, None] + (i + sg[None, :]) * bin_h[:, None]   # [R,S]
            xs = x0[:, None] + (j + sg[None, :]) * bin_w[:, None]
            yy = ys + (off[:, 1, i, j] * bin_h * ph)[:, None]
            xx = xs + (off[:, 0, i, j] * bin_w * pw)[:, None]
            yy = yy[:, :, None].expand(r, sample, sample).clamp(0.0, h - 1.0)
            xx = xx[:, None, :].expand(r, sample, sample).clamp(0.0, w - 1.0)
            vals = bilinear_gather(img[:, i, j], yy, xx, False)  # [oc,R,S,S]
            out.append(vals.mean(dim=(2, 3)).T)                  # [R, oc]
    out = torch.stack(out, dim=2).reshape(r, oc, ph, pw)
    return {"Output": [out], "TopCount": [torch.ones_like(out)]}
