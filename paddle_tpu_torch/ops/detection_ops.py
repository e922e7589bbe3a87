"""Detection ops: yolo_box, prior_box, anchor_generator, box_coder,
iou_similarity, box_clip, roi_align, bipartite_match, multiclass_nms,
matrix_nms, density_prior_box and yolov3_loss.

Port of ``paddle_tpu/ops/detection_ops.py`` (ref:
paddle/fluid/operators/detection/). The same slots, attributes and
fixed-shape outputs: a suppressed or empty slot is zeroed or set to -1,
and a count reports the true length. The JAX package left these ops to
XLA; here they are torch's own kernels, no hand kernel.

What the port keeps exactly, because the outputs are decided by it:
- every top-k is a stable descending sort, so equal scores keep the
  lower index first, as ``lax.top_k`` does (``torch.topk`` promises no
  order among ties on the card). A YOLOv3 head at random weights scores
  many boxes exactly 1.0, and then tie order alone decides the output;
- each op's float32 arithmetic in the reference's order (one-sided box
  clipping, zeroing by ``* keep`` after the clip, IoU with the +1 pixel
  convention when unnormalized);
- the greedy NMS of ``multiclass_nms``. The reference runs it as a
  ``lax.fori_loop`` of k dependent steps inside one XLA program; eager
  torch would pay k rounds of launches for that. The greedy keep is the
  unique fixed point of ``keep_i = valid_i and not any(j < i: keep_j and
  iou_ji > th_i)``, because keep_i depends only on keep_j for j < i. So
  ``_greedy_keep`` starts from ``keep = valid`` and applies that rule to
  all (image, class) rows at once (one batched product a round) until
  ``keep`` stops changing: after round t the first t candidates are
  right, so it ends in at most k + 1 rounds, and in practice after the
  longest chain of suppressions. Each round ends in one host sync (the
  convergence test); ``chip_smoke.py`` prints how many a predict takes.

Small constant tensors (anchors, thresholds) are made on the device
once (``_const``): a tensor built from host data on every call is
copied to the card, and torch waits for the stream after such a copy.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..core.enforce import InvalidArgumentError, enforce
from ..core.registry import register_infer_meta, register_op

_NONDIFF = ("ImgSize", "RoisNum", "ImInfo")


# ---------------------------------------------------------------- helpers
@functools.lru_cache(maxsize=256)
def _const(values: tuple, device: torch.device) -> torch.Tensor:
    """A float32 constant on ``device``, made once (read-only)."""
    return torch.tensor(values, dtype=torch.float32, device=device)


def _div(x, d):
    """x / d for a Python number d, rounded as a true quotient on every
    device: torch's CUDA kernels multiply by a Python divisor's
    reciprocal, 1 ulp off the quotient the CPU and the reference compute
    (a yolo_box edge of (12 + 1) * 416 / 13 came out 416.00003)."""
    return x / _const((float(d),), x.device)


def _box_wh(boxes, normalized: bool):
    """Width/height of [..., 4] corner boxes; +1 when unnormalized
    (pixel-coordinate convention, ref bbox_util.h JaccardOverlap)."""
    off = 0.0 if normalized else 1.0
    return (boxes[..., 2] - boxes[..., 0] + off,
            boxes[..., 3] - boxes[..., 1] + off)


def _pairwise_iou(a, b, normalized: bool = True):
    """IoU of [..., M, 4] x [..., K, 4] -> [..., M, K]."""
    off = 0.0 if normalized else 1.0
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (rb - lt + off).clamp_min(0.0)
    inter = wh[..., 0] * wh[..., 1]
    aw, ah = _box_wh(a, normalized)
    bw, bh = _box_wh(b, normalized)
    area_a = aw.clamp_min(0.0) * ah.clamp_min(0.0)
    area_b = bw.clamp_min(0.0) * bh.clamp_min(0.0)
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return torch.where(union > 0, inter / union, 0.0)


def _top_k(x, k):
    """(values, indices) of the k largest along the last dim, equal
    values in index order (``lax.top_k``'s tie rule)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _pad_rows(row, sel_idx, valid, keep_top_k):
    """Pad [N, kk, ...] outputs to keep_top_k rows with -1 (False)."""
    extra = keep_top_k - row.shape[1]
    if extra <= 0:
        return row, sel_idx, valid
    n = row.shape[0]
    return (torch.cat([row, row.new_full((n, extra, row.shape[2]), -1.0)], 1),
            torch.cat([sel_idx, sel_idx.new_full((n, extra), -1)], 1),
            torch.cat([valid, valid.new_zeros((n, extra))], 1))


def _detections(bboxes, scr, idx, k, keep_top_k, thresh):
    """Cross-class top ``keep_top_k`` of the class-major flattened scores
    ``scr`` [N, C*k] (original box index ``idx``): rows (label, score,
    x1, y1, x2, y2) for scores above ``thresh``, -1 elsewhere; the
    selected box index (-1 padded) and the count."""
    kk = min(keep_top_k, scr.shape[1])
    top_scr, top_i = _top_k(scr, kk)
    valid = top_scr > thresh
    sel = idx.gather(1, top_i)
    box = bboxes.gather(1, sel[..., None].expand(-1, -1, 4))
    label = torch.div(top_i, k, rounding_mode="floor").to(bboxes.dtype)
    row = torch.cat([label[..., None], top_scr[..., None], box], -1)
    row = torch.where(valid[..., None], row, -1.0)
    sel_idx = torch.where(valid, sel, -1).to(torch.int32)
    row, sel_idx, valid = _pad_rows(row, sel_idx, valid, keep_top_k)
    return row, sel_idx, valid.sum(-1).to(torch.int32)


def _per_class_candidates(bboxes, scores, bg, top_k):
    """Per (image, class): the top_k scores, their box indices and boxes.
    A background class in range scores -inf."""
    n, m, _ = bboxes.shape
    c = scores.shape[1]
    if 0 <= bg < c:
        scores = scores.clone()
        scores[:, bg] = float("-inf")
    k = min(top_k, m)
    sc, order = _top_k(scores, k)                          # [N, C, k]
    cand = bboxes.gather(1, order.reshape(n, c * k, 1).expand(-1, -1, 4))
    return sc, order, cand.reshape(n, c, k, 4), k


# ---------------------------------------------------------------- yolo_box
@register_op("yolo_box", non_differentiable_inputs=_NONDIFF)
def yolo_box(inputs, attrs):
    """Decode a YOLOv3 head (ref: yolo_box_op.h). X: [N, an*(5+C), H, W],
    ImgSize: [N, 2] (h, w) int32. Boxes: [N, an*H*W, 4] and Scores:
    [N, an*H*W, C] in (anchor, h, w) order; cells with conf <
    conf_thresh give zeros. The input is taken as square (``input_size
    = downsample * H``); ``exp(tw)`` may overflow to inf, which the
    one-sided clip (x0, y0 from below, x1, y1 from above) makes finite
    before the product with ``keep`` zeroes suppressed cells."""
    x = inputs["X"][0]
    img_size = inputs["ImgSize"][0]
    anchors = tuple(float(a) for a in attrs["anchors"])
    class_num = int(attrs["class_num"])
    conf_thresh = float(attrs.get("conf_thresh", 0.01))
    downsample = int(attrs.get("downsample_ratio", 32))
    clip_bbox = bool(attrs.get("clip_bbox", True))
    scale = float(attrs.get("scale_x_y", 1.0))
    bias = -0.5 * (scale - 1.0)

    n, _, h, w = x.shape
    an_num = len(anchors) // 2
    input_size = downsample * h
    dev = x.device
    x = x.reshape(n, an_num, 5 + class_num, h, w).float()
    tx, ty, tw, th = x[:, :, 0], x[:, :, 1], x[:, :, 2], x[:, :, 3]
    conf = torch.sigmoid(x[:, :, 4])                       # [N, an, H, W]
    cls = torch.sigmoid(x[:, :, 5:])                       # [N, an, C, H, W]

    img_h = img_size[:, 0].float()[:, None, None, None]
    img_w = img_size[:, 1].float()[:, None, None, None]
    grid_x = torch.arange(w, dtype=torch.float32, device=dev)
    grid_y = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    anc = _const(anchors, dev).reshape(-1, 2)
    aw = anc[:, 0][None, :, None, None]
    ah = anc[:, 1][None, :, None, None]

    cx = _div((grid_x + torch.sigmoid(tx) * scale + bias) * img_w, w)
    cy = _div((grid_y + torch.sigmoid(ty) * scale + bias) * img_h, h)
    bw = _div(torch.exp(tw) * aw * img_w, input_size)
    bh = _div(torch.exp(th) * ah * img_h, input_size)

    x0, y0 = cx - bw / 2.0, cy - bh / 2.0
    x1, y1 = cx + bw / 2.0, cy + bh / 2.0
    if clip_bbox:
        x0 = x0.clamp_min(0.0)
        y0 = y0.clamp_min(0.0)
        x1 = torch.minimum(x1, img_w - 1.0)
        y1 = torch.minimum(y1, img_h - 1.0)

    keep = (conf >= conf_thresh)[..., None]               # [N, an, H, W, 1]
    boxes = torch.stack([x0, y0, x1, y1], dim=-1) * keep
    scores = (conf[..., None] * cls.movedim(2, -1)) * keep
    return {"Boxes": [boxes.reshape(n, an_num * h * w, 4)],
            "Scores": [scores.reshape(n, an_num * h * w, class_num)]}


# ---------------------------------------------------------------- prior_box
@functools.lru_cache(maxsize=64)
def _expand_aspect_ratios(ars, flip: bool):
    out = [1.0]
    for ar in ars:
        if all(abs(ar - o) > 1e-6 for o in out):
            out.append(ar)
            if flip and abs(ar) > 1e-6:
                out.append(1.0 / ar)
    return tuple(out)


def _cell_centers(fh, fw, step_h, step_w, offset, dev):
    """Centres (cx [1, W, 1], cy [H, 1, 1]) of a prior grid, float32."""
    cx = (torch.arange(fw, dtype=torch.float32, device=dev) + offset) * step_w
    cy = (torch.arange(fh, dtype=torch.float32, device=dev) + offset) * step_h
    return cx[None, :, None], cy[:, None, None]


def _corners(x0, y0, x1, y1, clip):
    boxes = torch.stack(torch.broadcast_tensors(x0, y0, x1, y1), dim=-1)
    return boxes.clamp(0.0, 1.0) if clip else boxes


def _variances(attrs, shape, dev):
    var = tuple(float(v) for v in attrs.get("variances",
                                            [0.1, 0.1, 0.2, 0.2]))
    return _const(var, dev).expand(shape)


@register_op("prior_box", non_differentiable_inputs=("Input", "Image"))
def prior_box(inputs, attrs):
    """SSD anchors (ref: prior_box_op.h). Input: feature map [N,C,H,W],
    Image: [N,C,imH,imW]. Boxes/Variances: [H, W, num_priors, 4]."""
    feat = inputs["Input"][0]
    image = inputs["Image"][0]
    min_sizes = [float(s) for s in attrs["min_sizes"]]
    max_sizes = [float(s) for s in attrs.get("max_sizes", []) or []]
    ars = tuple(float(a) for a in attrs.get("aspect_ratios", [1.0]) or [1.0])
    flip = bool(attrs.get("flip", False))
    clip = bool(attrs.get("clip", False))
    mm_order = bool(attrs.get("min_max_aspect_ratios_order", False))
    offset = float(attrs.get("offset", 0.5))
    if max_sizes:
        enforce(len(max_sizes) == len(min_sizes),
                "prior_box: len(max_sizes) must equal len(min_sizes)",
                InvalidArgumentError)

    fh, fw = feat.shape[2], feat.shape[3]
    img_h, img_w = image.shape[2], image.shape[3]
    step_w = float(attrs.get("step_w", 0) or 0) or img_w / fw
    step_h = float(attrs.get("step_h", 0) or 0) or img_h / fh
    aspect = _expand_aspect_ratios(ars, flip)

    wh = []                      # per-cell prior (w, h) in reference order
    for i, ms in enumerate(min_sizes):
        if mm_order:
            wh.append((ms, ms))
            if max_sizes:
                s = (ms * max_sizes[i]) ** 0.5
                wh.append((s, s))
            wh += [(ms * ar ** 0.5, ms / ar ** 0.5) for ar in aspect
                   if abs(ar - 1.0) >= 1e-6]
        else:
            wh += [(ms * ar ** 0.5, ms / ar ** 0.5) for ar in aspect]
            if max_sizes:
                s = (ms * max_sizes[i]) ** 0.5
                wh.append((s, s))
    dev = feat.device
    wh = _const(tuple(v for p in wh for v in p), dev).reshape(-1, 2)
    cx, cy = _cell_centers(fh, fw, step_h, step_w, offset, dev)
    half_w = wh[None, None, :, 0] / 2.0
    half_h = wh[None, None, :, 1] / 2.0
    boxes = _corners(_div(cx - half_w, img_w), _div(cy - half_h, img_h),
                     _div(cx + half_w, img_w), _div(cy + half_h, img_h),
                     clip)
    return {"Boxes": [boxes],
            "Variances": [_variances(attrs, boxes.shape, dev)]}


@register_op("anchor_generator", non_differentiable_inputs=("Input",))
def anchor_generator(inputs, attrs):
    """RPN anchors (ref: anchor_generator_op.h:56-83): per cell, one
    anchor per (aspect_ratio, size) pair in pixel coords, with rounded
    base extents, centres at i*stride + offset*(stride-1) and
    half-extents (w-1)/2. Anchors: [H, W, A, 4]."""
    feat = inputs["Input"][0]
    sizes = [float(s) for s in attrs["anchor_sizes"]]
    ars = [float(a) for a in attrs.get("aspect_ratios", [1.0])]
    stride = [float(s) for s in attrs.get("stride", [16.0, 16.0])]
    offset = float(attrs.get("offset", 0.5))
    fh, fw = feat.shape[2], feat.shape[3]
    wh = []
    for ar in ars:
        for s in sizes:
            base_w = round((stride[0] * stride[1] / ar) ** 0.5)
            base_h = round(base_w * ar)
            wh += [s / stride[0] * base_w, s / stride[1] * base_h]
    dev = feat.device
    wh = _const(tuple(wh), dev).reshape(-1, 2)
    cx = torch.arange(fw, dtype=torch.float32, device=dev) * stride[0] + \
        offset * (stride[0] - 1)
    cy = torch.arange(fh, dtype=torch.float32, device=dev) * stride[1] + \
        offset * (stride[1] - 1)
    cx, cy = cx[None, :, None], cy[:, None, None]
    hw_ = (wh[None, None, :, 0] - 1) / 2.0
    hh_ = (wh[None, None, :, 1] - 1) / 2.0
    anchors = _corners(cx - hw_, cy - hh_, cx + hw_, cy + hh_, False)
    return {"Anchors": [anchors],
            "Variances": [_variances(attrs, anchors.shape, dev)]}


@register_op("density_prior_box", non_differentiable_inputs=("Input", "Image"))
def density_prior_box(inputs, attrs):
    """Density prior boxes (ref: density_prior_box_op.h): for each
    (fixed_size, density) pair and ratio, a density x density grid of
    shifted priors per cell."""
    feat = inputs["Input"][0]
    image = inputs["Image"][0]
    fixed_sizes = [float(s) for s in attrs.get("fixed_sizes", [])]
    fixed_ratios = [float(r) for r in attrs.get("fixed_ratios", [1.0])]
    densities = [int(d) for d in attrs.get("densities", [])]
    clip = bool(attrs.get("clip", False))
    offset = float(attrs.get("offset", 0.5))
    fh, fw = feat.shape[2], feat.shape[3]
    img_h, img_w = image.shape[2], image.shape[3]
    step_w = float(attrs.get("step_w", 0) or 0) or img_w / fw
    step_h = float(attrs.get("step_h", 0) or 0) or img_h / fh

    shifts = []          # (dx, dy, w, h) per prior, pixels from the cell
    for size, density in zip(fixed_sizes, densities):
        for ratio in fixed_ratios:
            bw, bh = size * ratio ** 0.5, size / ratio ** 0.5
            step_x, step_y = step_w / density, step_h / density
            for di in range(density):
                for dj in range(density):
                    shifts += [-step_w / 2.0 + step_x / 2.0 + dj * step_x,
                               -step_h / 2.0 + step_y / 2.0 + di * step_y,
                               bw, bh]
    dev = feat.device
    sh = _const(tuple(shifts), dev).reshape(-1, 4)
    cx, cy = _cell_centers(fh, fw, step_h, step_w, offset, dev)
    ccx = cx + sh[None, None, :, 0]
    ccy = cy + sh[None, None, :, 1]
    hw_ = sh[None, None, :, 2] / 2.0
    hh_ = sh[None, None, :, 3] / 2.0
    boxes = _corners(_div(ccx - hw_, img_w), _div(ccy - hh_, img_h),
                     _div(ccx + hw_, img_w), _div(ccy + hh_, img_h), clip)
    return {"Boxes": [boxes],
            "Variances": [_variances(attrs, boxes.shape, dev)]}


# ---------------------------------------------------------------- box_coder
@register_op("box_coder")
def box_coder(inputs, attrs):
    """Encode/decode center-size boxes against priors (ref:
    box_coder_op.h). encode: TargetBox [M,4] x PriorBox [K,4] -> [M,K,4];
    decode: TargetBox [M,K,4] (or [M,4], broadcast) -> [M,K,4], the
    priors along dim ``axis``."""
    prior = inputs["PriorBox"][0]
    prior_var = (inputs.get("PriorBoxVar") or [None])[0]
    target = inputs["TargetBox"][0]
    code_type = attrs.get("code_type", "encode_center_size")
    normalized = bool(attrs.get("box_normalized", True))
    axis = int(attrs.get("axis", 0))
    attr_var = attrs.get("variance", []) or []
    off = 0.0 if normalized else 1.0

    pw, ph = _box_wh(prior, normalized)
    pcx = prior[:, 0] + pw / 2.0
    pcy = prior[:, 1] + ph / 2.0
    if prior_var is not None:
        pv = prior_var                                     # [K, 4]
    elif attr_var:
        pv = torch.tensor([float(v) for v in attr_var], dtype=prior.dtype,
                          device=prior.device).expand(prior.shape)
    else:
        pv = torch.ones_like(prior)

    if code_type == "encode_center_size":
        tw, th = _box_wh(target, normalized)
        tcx = (target[:, 0] + target[:, 2]) / 2.0
        tcy = (target[:, 1] + target[:, 3]) / 2.0
        ex = (tcx[:, None] - pcx[None, :]) / pw[None, :]
        ey = (tcy[:, None] - pcy[None, :]) / ph[None, :]
        ew = torch.log(torch.abs(tw[:, None] / pw[None, :]))
        eh = torch.log(torch.abs(th[:, None] / ph[None, :]))
        out = torch.stack([ex, ey, ew, eh], dim=-1) / pv[None, :, :]
        return {"OutputBox": [out]}

    enforce(code_type == "decode_center_size",
            f"box_coder: bad code_type {code_type!r}", InvalidArgumentError)
    t = target[:, None, :] if target.ndim == 2 else target
    shape = (1, -1) if axis == 0 else (-1, 1)
    pw_, ph_ = pw.reshape(shape), ph.reshape(shape)
    pcx_, pcy_ = pcx.reshape(shape), pcy.reshape(shape)
    pv_ = pv[None, :, :] if axis == 0 else pv[:, None, :]
    dcx = pv_[..., 0] * t[..., 0] * pw_ + pcx_
    dcy = pv_[..., 1] * t[..., 1] * ph_ + pcy_
    dw = torch.exp(pv_[..., 2] * t[..., 2]) * pw_
    dh = torch.exp(pv_[..., 3] * t[..., 3]) * ph_
    out = torch.stack([dcx - dw / 2.0, dcy - dh / 2.0,
                       dcx + dw / 2.0 - off, dcy + dh / 2.0 - off], dim=-1)
    return {"OutputBox": [out]}


# ---------------------------------------------------------------- iou / clip
@register_op("iou_similarity")
def iou_similarity(inputs, attrs):
    """Pairwise IoU (ref: iou_similarity_op.h). X [M,4], Y [K,4] ->
    [M,K]."""
    return {"Out": [_pairwise_iou(inputs["X"][0], inputs["Y"][0],
                                  bool(attrs.get("box_normalized", True)))]}


@register_op("box_clip", non_differentiable_inputs=("ImInfo",))
def box_clip(inputs, attrs):
    """Clip boxes to the image (ref: box_clip_op.h): ImInfo [N,3] is
    (h, w, scale); boxes [N, R, 4] (or [R, 4] with one image) clipped to
    [0, round(dim / scale) - 1]."""
    boxes = inputs["Input"][0]
    im_info = inputs["ImInfo"][0]
    if boxes.ndim == 2:
        enforce(im_info.shape[0] == 1,
                f"box_clip with 2D Input needs ImInfo batch 1, got "
                f"{im_info.shape[0]} (per-image LoD box lists are not "
                "supported — pass [N, R, 4] boxes)", InvalidArgumentError)
        b = boxes.reshape(1, -1, 4)
    else:
        b = boxes
    h = (torch.round(im_info[:, 0] / im_info[:, 2]) - 1.0)[:, None]
    w = (torch.round(im_info[:, 1] / im_info[:, 2]) - 1.0)[:, None]
    zero = torch.zeros((), dtype=b.dtype, device=b.device)
    out = torch.stack([
        torch.clamp(b[..., 0], zero, w), torch.clamp(b[..., 1], zero, h),
        torch.clamp(b[..., 2], zero, w), torch.clamp(b[..., 3], zero, h)],
        dim=-1)
    return {"Output": [out.reshape(boxes.shape)]}


# ---------------------------------------------------------------- roi_align
def _bilinear_clamped(img, batch_idx, yy, xx):
    """4-tap bilinear sample of img [N, C, H, W] at yy, xx [R, P, Q]
    (already clamped into the image), row r of the samples reading image
    ``batch_idx[r]`` -> [R, C, P, Q]; a tap past the last row or column
    takes the border pixel. The taps gather pixel rows of a channels-last
    copy of img, so no image is copied a RoI."""
    n, c, h, w = img.shape
    r = yy.shape[0]
    y0, x0 = torch.floor(yy), torch.floor(xx)
    ly = (yy - y0).to(img.dtype)[:, None]
    lx = (xx - x0).to(img.dtype)[:, None]
    pixels = img.permute(0, 2, 3, 1).reshape(n * h * w, c)
    base = (batch_idx * (h * w))[:, None, None]

    def at(yi, xi):
        yc = yi.to(torch.int64).clamp(0, h - 1)
        xc = xi.to(torch.int64).clamp(0, w - 1)
        rows = pixels[(base + yc * w + xc).reshape(-1)]
        return rows.reshape(r, *yy.shape[1:], c).permute(0, 3, 1, 2)

    return (at(y0, x0) * (1 - ly) * (1 - lx)
            + at(y0, x0 + 1) * (1 - ly) * lx
            + at(y0 + 1, x0) * ly * (1 - lx)
            + at(y0 + 1, x0 + 1) * ly * lx)


@register_op("roi_align", non_differentiable_inputs=("ROIs", "RoisNum"))
def roi_align(inputs, attrs):
    """ROI Align (ref: roi_align_op.cc): X [N,C,H,W], ROIs [R,4] in image
    coords + RoisNum [N] (rois per image) -> [R, C, ph, pw]. Averages a
    static sr x sr grid of bilinear samples per bin (sr = sampling_ratio,
    or 2 when it is not positive). A sample outside [-1, size] adds 0;
    one inside is clamped into the image first (ref roi_align_op.h:49)."""
    x = inputs["X"][0]
    rois = inputs["ROIs"][0]
    rois_num = (inputs.get("RoisNum") or [None])[0]
    ph = int(attrs.get("pooled_height", 1))
    pw = int(attrs.get("pooled_width", 1))
    spatial_scale = float(attrs.get("spatial_scale", 1.0))
    sampling = int(attrs.get("sampling_ratio", -1))
    aligned = bool(attrs.get("aligned", False))

    n, c, h, w = x.shape
    r = rois.shape[0]
    dev = x.device
    if rois_num is None:
        batch_idx = torch.zeros(r, dtype=torch.int64, device=dev)
    else:
        batch_idx = torch.repeat_interleave(
            torch.arange(n, device=dev), rois_num.to(torch.int64),
            output_size=r)

    roi_off = 0.5 if aligned else 0.0
    x0 = rois[:, 0] * spatial_scale - roi_off
    y0 = rois[:, 1] * spatial_scale - roi_off
    x1 = rois[:, 2] * spatial_scale - roi_off
    y1 = rois[:, 3] * spatial_scale - roi_off
    rw, rh = x1 - x0, y1 - y0
    if not aligned:
        rw, rh = rw.clamp_min(1.0), rh.clamp_min(1.0)
    bin_w, bin_h = _div(rw, pw), _div(rh, ph)
    sr = sampling if sampling > 0 else 2

    iy = torch.arange(ph, dtype=torch.float32, device=dev)[None, :, None]
    ix = torch.arange(pw, dtype=torch.float32, device=dev)[None, :, None]
    sy = torch.arange(sr, dtype=torch.float32, device=dev)[None, None, :]
    ys = (y0[:, None, None] + (iy + _div(sy + 0.5, sr))
          * bin_h[:, None, None]).reshape(r, -1)           # [R, ph*sr]
    xs = (x0[:, None, None] + (ix + _div(sy + 0.5, sr))
          * bin_w[:, None, None]).reshape(r, -1)           # [R, pw*sr]
    vy = (ys >= -1.0) & (ys <= h)
    vx = (xs >= -1.0) & (xs <= w)
    yg = ys.clamp(0.0, h - 1.0)[:, :, None].expand(-1, -1, xs.shape[1])
    xg = xs.clamp(0.0, w - 1.0)[:, None, :].expand(-1, ys.shape[1], -1)
    vals = _bilinear_clamped(x, batch_idx, yg, xg)
    vals = vals * (vy[:, None, :, None] & vx[:, None, None, :])
    return {"Out": [vals.reshape(r, c, ph, sr, pw, sr).mean(dim=(3, 5))]}


# ---------------------------------------------------------- bipartite_match
@register_op("bipartite_match", non_differentiable_inputs=("DistMat",))
def bipartite_match(inputs, attrs):
    """Greedy bipartite matching (ref: bipartite_match_op.cc): min(M, K)
    rounds, each taking the largest positive entry of DistMat [M, K] and
    striking its row and column. Outputs ColToRowMatchIndices [1, K]
    (-1 unmatched) and ColToRowMatchDist [1, K]; match_type
    'per_prediction' also matches an unmatched column to its best row
    when that distance is >= dist_threshold. Runs on the device with no
    host sync (argmax takes the first of equal maxima, as jnp.argmax)."""
    dist = inputs["DistMat"][0]
    match_type = attrs.get("match_type", "bipartite")
    thresh = float(attrs.get("dist_threshold", 0.5))
    m, k = dist.shape
    dev = dist.device
    rows = torch.arange(m, device=dev)[:, None]
    cols = torch.arange(k, device=dev)[None, :]
    d = dist
    idx = torch.full((k,), -1, dtype=torch.int32, device=dev)
    val = torch.zeros(k, dtype=dist.dtype, device=dev)
    for _ in range(min(m, k)):
        flat = torch.argmax(d)
        i, j = flat // k, flat % k
        best = d.reshape(-1)[flat]
        take = best > 0
        hit = take & (cols[0] == j)
        idx = torch.where(hit, i.to(torch.int32), idx)
        val = torch.where(hit, best, val)
        d = torch.where(take & ((rows == i) | (cols == j)), -1.0, d)

    if match_type == "per_prediction":
        best_row = torch.argmax(dist, dim=0)
        best_val = dist.max(dim=0).values
        fill = (idx < 0) & (best_val >= thresh)
        idx = torch.where(fill, best_row.to(torch.int32), idx)
        val = torch.where(fill, best_val, val)
    return {"ColToRowMatchIndices": [idx[None, :]],
            "ColToRowMatchDist": [val[None, :]]}


@register_infer_meta("bipartite_match")
def _bipartite_match_meta(inputs, attrs):
    """The matching indexes by its argmax on the host: static shape
    inference takes [1, K] from DistMat [M, K]."""
    dist = inputs["DistMat"][0]
    k = dist.shape[-1]
    return {"ColToRowMatchIndices": [dist.new_empty((1, k),
                                                    dtype=torch.int32)],
            "ColToRowMatchDist": [dist.new_empty((1, k))]}


# ---------------------------------------------------------- multiclass_nms
def _nms_thresholds(iou_thresh, eta, k):
    """th_c, the threshold after c kept boxes, c = 0..k: th_0 =
    float32(iou_thresh), and each keep multiplies it by eta while it is
    above 0.5 (ref multiclass_nms_op.cc; the reference's fori_loop), in
    float32."""
    th = [np.float32(iou_thresh)]
    for _ in range(k):
        t = th[-1]
        th.append(t * np.float32(eta) if eta < 1.0 and t > 0.5 else t)
    return tuple(float(t) for t in th)


def _greedy_keep(iou, valid, iou_thresh, eta):
    """The greedy NMS keep mask [B, k] of B rows of k score-sorted
    candidates (iou [B, k, k], valid [B, k]): candidate i is kept when
    it is valid and no kept j < i has iou_ji above the threshold, which
    with eta < 1 depends on how many were kept before i. Iterates the
    rule from keep = valid to its fixed point (module docstring)."""
    b, k, _ = iou.shape
    earlier = torch.ones(k, k, dtype=torch.bool, device=iou.device).triu_(1)
    if eta >= 1.0:
        over = ((iou > float(np.float32(iou_thresh))) & earlier).float()
    else:
        table = _const(_nms_thresholds(iou_thresh, eta, k), iou.device)
    keep = valid
    for _ in range(k + 1):
        if eta < 1.0:
            kept = keep.to(torch.int64)
            th = table[kept.cumsum(-1) - kept]             # [B, k]
            over = ((iou > th[:, None, :]) & earlier).float()
        sup = torch.bmm(keep.float()[:, None, :], over)[:, 0] > 0
        new = valid & ~sup
        if torch.equal(new, keep):
            return keep
        keep = new
    raise AssertionError("greedy NMS did not reach its fixed point")


@register_op("multiclass_nms", non_differentiable_inputs=("BBoxes", "Scores"))
def multiclass_nms(inputs, attrs):
    """Multi-class NMS (ref: multiclass_nms_op.cc). BBoxes [N, M, 4],
    Scores [N, C, M]. Out: [N, keep_top_k, 6] rows (label, score, x1,
    y1, x2, y2), padded with -1; Index [N, keep_top_k] = the box's index
    into M (-1 padded); NmsedNum [N] = the real count. Per class: the
    top nms_top_k scores (ties: lower index first), greedy suppression
    of those above score_threshold; then the top keep_top_k over the
    class-major list of kept scores, those above max(score_threshold, 0).
    A background_label in range scores -inf."""
    bboxes = inputs["BBoxes"][0]
    scores = inputs["Scores"][0]
    bg = int(attrs.get("background_label", 0))
    score_thresh = float(attrs.get("score_threshold", 0.0))
    nms_thresh = float(attrs.get("nms_threshold", 0.3))
    nms_top_k = int(attrs.get("nms_top_k", 100))
    keep_top_k = int(attrs.get("keep_top_k", 100))
    eta = float(attrs.get("nms_eta", 1.0))
    normalized = bool(attrs.get("normalized", True))
    n, m, _ = bboxes.shape
    c = scores.shape[1]
    # <=0 means "no limit" (ref multiclass_nms_op.cc SetDefault(-1))
    eff_top_k = nms_top_k if nms_top_k > 0 else m
    if keep_top_k <= 0:
        keep_top_k = eff_top_k * c

    sc, order, cand, k = _per_class_candidates(bboxes, scores, bg, eff_top_k)
    iou = _pairwise_iou(cand, cand, normalized)            # [N, C, k, k]
    keep = _greedy_keep(iou.reshape(n * c, k, k),
                        (sc > score_thresh).reshape(n * c, k),
                        nms_thresh, eta).reshape(n, c, k)
    scr = torch.where(keep, sc, -1.0).reshape(n, c * k)
    out, index, num = _detections(bboxes, scr, order.reshape(n, c * k), k,
                                  keep_top_k, max(score_thresh, 0.0))
    return {"Out": [out], "Index": [index], "NmsedNum": [num]}


@register_infer_meta("multiclass_nms")
def _multiclass_nms_meta(inputs, attrs):
    """The greedy keep reads its convergence on the host: static shape
    inference takes the padded shapes from the attrs."""
    bboxes, scores = inputs["BBoxes"][0], inputs["Scores"][0]
    n, m = bboxes.shape[0], bboxes.shape[1]
    nms_top_k = int(attrs.get("nms_top_k", 100))
    keep_top_k = int(attrs.get("keep_top_k", 100))
    if keep_top_k <= 0:
        keep_top_k = (nms_top_k if nms_top_k > 0 else m) * scores.shape[1]
    return {"Out": [bboxes.new_empty((n, keep_top_k, 6))],
            "Index": [bboxes.new_empty((n, keep_top_k), dtype=torch.int32)],
            "NmsedNum": [bboxes.new_empty((n,), dtype=torch.int32)]}


@register_op("matrix_nms", non_differentiable_inputs=("BBoxes", "Scores"))
def matrix_nms(inputs, attrs):
    """Matrix NMS (ref: matrix_nms_op.cc; SOLOv2): each candidate's score
    decays by min over higher-scored same-class i of decay(iou_ij), with
    no sequential loop. Outputs as multiclass_nms, the count in
    RoisNum; rows whose decayed score is above post_threshold."""
    bboxes = inputs["BBoxes"][0]
    scores = inputs["Scores"][0]
    bg = int(attrs.get("background_label", 0))
    score_thresh = float(attrs.get("score_threshold", 0.0))
    post_thresh = float(attrs.get("post_threshold", 0.0))
    nms_top_k = int(attrs.get("nms_top_k", 100))
    keep_top_k = int(attrs.get("keep_top_k", 100))
    use_gaussian = bool(attrs.get("use_gaussian", False))
    sigma = float(attrs.get("gaussian_sigma", 2.0))
    normalized = bool(attrs.get("normalized", True))
    n, m, _ = bboxes.shape
    c = scores.shape[1]
    eff_top_k = nms_top_k if nms_top_k > 0 else m
    if keep_top_k <= 0:
        keep_top_k = eff_top_k * c

    sc, order, cand, k = _per_class_candidates(bboxes, scores, bg, eff_top_k)
    iou = _pairwise_iou(cand, cand, normalized)            # [N, C, k, k]
    upper = torch.tril(iou, diagonal=-1)                   # i < j pairs
    max_iou = upper.max(dim=-1).values                     # comp_iou per i
    if use_gaussian:
        # ref matrix_nms_op.cc:83: exp((max_iou^2 - iou^2) * sigma)
        decay = torch.exp((max_iou[..., None, :] ** 2 - upper ** 2) * sigma)
    else:
        # exact-duplicate candidates have max_iou == 1; the clamped
        # denominator makes 0/0 a full suppression, not NaN
        decay = (1.0 - upper) / (1.0 - max_iou[..., None, :]).clamp_min(
            1e-10)
    decay = torch.where(upper > 0, decay, 1.0)
    new_sc = torch.where(sc > score_thresh, sc * decay.min(dim=-1).values,
                         -1.0)
    scr = torch.where(torch.isfinite(new_sc), new_sc, -1.0).reshape(n, c * k)
    out, index, num = _detections(bboxes, scr, order.reshape(n, c * k), k,
                                  keep_top_k, post_thresh)
    return {"Out": [out], "Index": [index], "RoisNum": [num]}


# ---------------------------------------------------------------- yolov3_loss
def _sce(x, label):
    """SigmoidCrossEntropy(x, z) = max(x,0) - x*z + log(1+exp(-|x|))
    (ref yolov3_loss_op.h SigmoidCrossEntropy)."""
    return x.clamp_min(0.0) - x * label + torch.log1p(torch.exp(-x.abs()))


def _centerwise_iou(x1, y1, w1, h1, x2, y2, w2, h2):
    l1, r1 = x1 - w1 / 2, x1 + w1 / 2
    t1, b1 = y1 - h1 / 2, y1 + h1 / 2
    l2, r2 = x2 - w2 / 2, x2 + w2 / 2
    t2, b2 = y2 - h2 / 2, y2 + h2 / 2
    iw = (torch.minimum(r1, r2) - torch.maximum(l1, l2)).clamp_min(0.0)
    ih = (torch.minimum(b1, b2) - torch.maximum(t1, t2)).clamp_min(0.0)
    inter = iw * ih
    return inter / (w1 * h1 + w2 * h2 - inter).clamp_min(1e-10)


@register_op("yolov3_loss",
             non_differentiable_inputs=("GTBox", "GTLabel", "GTScore"),
             intermediate_outputs=("ObjectnessMask", "GTMatchMask"))
def yolov3_loss(inputs, attrs):
    """YOLOv3 training loss (ref: detection/yolov3_loss_op.h, per-term
    arithmetic). X [N, M*(5+C), H, W]; GTBox [N, B, 4] normalized
    center-size; GTLabel [N, B]; optional GTScore [N, B] (mixup). Loss
    [N] in X's dtype (computed in float32), ObjectnessMask [N, M, H, W],
    GTMatchMask [N, B] (-1 for a box whose best anchor is not in
    anchor_mask, or an invalid box). Torch autograd gives the gradient
    the reference's hand-written grad kernel computes."""
    x = inputs["X"][0]
    gt_box = inputs["GTBox"][0]
    gt_label = inputs["GTLabel"][0].to(torch.int64)
    class_num = int(attrs["class_num"])
    anchors = [int(a) for a in attrs["anchors"]]
    anchor_mask = [int(a) for a in attrs.get(
        "anchor_mask", list(range(len(anchors) // 2)))]
    downsample = int(attrs.get("downsample_ratio", 32))
    ignore_thresh = float(attrs.get("ignore_thresh", 0.7))
    use_label_smooth = bool(attrs.get("use_label_smooth", True))
    scale_xy = float(attrs.get("scale_x_y", 1.0))
    bias_xy = -0.5 * (scale_xy - 1.0)

    n, _, h, w = x.shape
    an_num = len(anchors) // 2
    mask_num = len(anchor_mask)
    b = gt_box.shape[1]
    input_size = downsample * h
    dev = x.device
    xv = x.reshape(n, mask_num, 5 + class_num, h, w).float()

    label_pos, label_neg = 1.0, 0.0
    if use_label_smooth:
        delta = min(1.0 / class_num, 1.0 / 40.0)
        label_pos, label_neg = 1.0 - delta, delta

    gt_valid = (gt_box[..., 2] > 0) & (gt_box[..., 3] > 0)     # [N, B]

    # ---- decoded predictions for the ignore mask ----
    gi_ = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    gj_ = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    px = _div(gi_ + torch.sigmoid(xv[:, :, 0]) * scale_xy + bias_xy, w)
    py = _div(gj_ + torch.sigmoid(xv[:, :, 1]) * scale_xy + bias_xy, h)
    masked = torch.tensor([[anchors[2 * a], anchors[2 * a + 1]]
                           for a in anchor_mask], dtype=torch.float32,
                          device=dev)
    pw = _div(torch.exp(xv[:, :, 2]) * masked[None, :, 0, None, None],
              input_size)
    ph = _div(torch.exp(xv[:, :, 3]) * masked[None, :, 1, None, None],
              input_size)

    # IoU of every predicted cell with every gt: [N, M, H, W, B]
    g = gt_box[:, None, None, None, :, :]
    iou = _centerwise_iou(px[..., None], py[..., None], pw[..., None],
                          ph[..., None], g[..., 0], g[..., 1], g[..., 2],
                          g[..., 3])
    iou = torch.where(gt_valid[:, None, None, None, :], iou, 0.0)
    best_iou = iou.max(dim=-1).values                          # [N, M, H, W]
    obj_mask = torch.where(best_iou > ignore_thresh, -1.0, 0.0)

    # ---- per-gt best anchor (shape-only IoU over ALL anchors) ----
    all_anchors = torch.tensor(anchors, dtype=torch.float32,
                               device=dev).reshape(an_num, 2)
    scaled = _div(all_anchors, input_size)
    a_iou = _centerwise_iou(0.0, 0.0, scaled[None, None, :, 0],
                            scaled[None, None, :, 1], 0.0, 0.0,
                            gt_box[..., 2:3], gt_box[..., 3:4])  # [N, B, A]
    best_n = torch.argmax(a_iou, dim=-1)                       # [N, B]
    lut = torch.full((an_num,), -1, dtype=torch.int64, device=dev)
    for pos, a in enumerate(anchor_mask):
        lut[a] = pos
    mask_idx = torch.where(gt_valid, lut[best_n], -1)          # [N, B]

    gi = (gt_box[..., 0] * w).to(torch.int32).clamp(0, w - 1).long()
    gj = (gt_box[..., 1] * h).to(torch.int32).clamp(0, h - 1).long()
    score = (inputs["GTScore"][0].float() if inputs.get("GTScore")
             else torch.ones((n, b), dtype=torch.float32, device=dev))
    active = mask_idx >= 0                                     # [N, B]
    safe_mask = mask_idx.clamp_min(0)
    batch_ix = torch.arange(n, device=dev)[:, None].expand(n, b)
    pred_cell = xv[batch_ix, safe_mask, :, gj, gi]             # [N, B, 5+C]

    tx = gt_box[..., 0] * w - gi
    ty = gt_box[..., 1] * h - gj
    sel_an = all_anchors[best_n]                               # [N, B, 2]
    tw = torch.log((gt_box[..., 2] * input_size / sel_an[..., 0])
                   .clamp_min(1e-10))
    th = torch.log((gt_box[..., 3] * input_size / sel_an[..., 1])
                   .clamp_min(1e-10))
    loc_scale = (2.0 - gt_box[..., 2] * gt_box[..., 3]) * score
    loc = (_sce(pred_cell[..., 0], tx) + _sce(pred_cell[..., 1], ty)
           + torch.abs(pred_cell[..., 2] - tw)
           + torch.abs(pred_cell[..., 3] - th)) * loc_scale
    cls_ids = torch.arange(class_num, device=dev)[None, None, :]
    cls_target = torch.where(cls_ids == gt_label[..., None], label_pos,
                             label_neg)
    cls = _sce(pred_cell[..., 5:], cls_target).sum(-1) * score  # [N, B]
    loss = torch.where(active, loc + cls, 0.0).sum(dim=1)      # [N]

    # positive cells into the objectness mask; an inactive (padded) gt
    # writes into an extra anchor slot that is cut off after, so no
    # mask of the gts (a host sync) is needed
    drop_idx = torch.where(active, safe_mask, mask_num)
    padded = torch.cat([obj_mask, obj_mask.new_zeros(n, 1, h, w)], 1)
    padded = padded.index_put((batch_ix, drop_idx, gj, gi),
                              score.to(padded.dtype))
    obj_mask = padded[:, :mask_num]

    obj_logit = xv[:, :, 4]                                    # [N, M, H, W]
    obj_pos = torch.where(obj_mask > 1e-5,
                          _sce(obj_logit, 1.0) * obj_mask, 0.0)
    obj_neg = torch.where((obj_mask <= 1e-5) & (obj_mask > -0.5),
                          _sce(obj_logit, 0.0), 0.0)
    loss = loss + (obj_pos + obj_neg).sum(dim=(1, 2, 3))
    return {"Loss": [loss.to(x.dtype)],
            "ObjectnessMask": [obj_mask],
            "GTMatchMask": [mask_idx.to(torch.int32)]}
