"""Two-stage and anchor-based detection training ops: proposals, target
assignment, sampling, FPN routing, hard-example mining, the NMS variants,
the mAP metric and the perspective RoI warp.

Port of ``paddle_tpu/ops/rcnn_ops.py`` (ref:
paddle/fluid/operators/detection/). The reference computes all of them
in numpy on the host, between its dense stages. Here the dense,
data-independent work runs in torch on the inputs' device (the IoU
tables, the delta decode and encode, the clipping, the per-class target
rows, the bilinear taps), and the host keeps only what decides an index:

- every sort that orders boxes is ``np.argsort`` of the same values, as
  the reference's: its default sort is not stable, so only the same
  call keeps the same order under ties, and the kept and sampled
  indices equal the reference's;
- the sampling draws from ``np.random.RandomState(seed or None)``, the
  reference's stream, so equal seeds sample equal indices;
- the greedy NMS of ``generate_proposals`` reads the suppression state
  once: the device computes every pair's IoU against the threshold, a
  bit a pair, and the host walks the candidates in the reference's order
  over those bits, dropping what a kept box suppresses (the reference's
  ``_nms_np`` keeps the same boxes, one IoU row a kept box);
- the arithmetic is the reference's, in its order: ``+1`` widths in the
  delta code, none in the IoU, the straddle filter of
  ``rpn_target_assign`` and the thresholds compared in float32.

Inputs are read on the host through ``core.enforce.host_only`` (a list
of tensors in one wait for the stream), so static shape inference leaves
the outputs of the host-side types unknown, as in the JAX package; host
arrays go back to the device through pinned memory without a wait.
Host syncs of one call on the card: ``generate_proposals`` 2 (the
scores, then the size filter and the suppression bits of every image);
``rpn_target_assign``, ``retinanet_target_assign``,
``generate_proposal_labels``, ``generate_mask_labels``,
``collect_fpn_proposals``, ``distribute_fpn_proposals``,
``mine_hard_examples``, ``locality_aware_nms``, ``detection_map``,
``roi_perspective_transform`` and ``retinanet_detection_output`` 1 each;
``target_assign`` and ``box_decoder_and_assign`` none;
``multiclass_nms2`` those of ``multiclass_nms``.
``locality_aware_nms``, ``detection_map``, ``generate_mask_labels`` and
``retinanet_detection_output`` are sequential scans over few boxes and
run whole on the host, as in the reference: the last decodes there
because its NMS reads the boxes, where a decode on the device would
cost a second wait.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..core.enforce import eager_only, host_only
from ..core.registry import OpInfoMap, register_infer_meta, register_op
from .detection_ops import _div


# ---------------------------------------------------------------- helpers
def _to(arr, like: torch.Tensor) -> torch.Tensor:
    """A host array as a tensor on ``like``'s device: on the card through
    pinned memory, asynchronously (no wait for the stream)."""
    t = torch.from_numpy(np.asarray(arr, order="C"))
    if like.device.type == "cuda":
        return t.pin_memory().to(like.device, non_blocking=True)
    return t.to(like.device)


def _iou(a, b):
    """IoU of [M, 4] x [K, 4] corner boxes -> [M, K], no +1 (the
    reference's ``_np_iou``, op for op)."""
    iw = (torch.minimum(a[:, None, 2], b[None, :, 2])
          - torch.maximum(a[:, None, 0], b[None, :, 0])).clamp_min(0.0)
    ih = (torch.minimum(a[:, None, 3], b[None, :, 3])
          - torch.maximum(a[:, None, 1], b[None, :, 1])).clamp_min(0.0)
    inter = iw * ih
    area_a = (a[:, 2] - a[:, 0]).clamp_min(0.0) * \
        (a[:, 3] - a[:, 1]).clamp_min(0.0)
    area_b = (b[:, 2] - b[:, 0]).clamp_min(0.0) * \
        (b[:, 3] - b[:, 1]).clamp_min(0.0)
    union = area_a[:, None] + area_b[None, :] - inter
    return torch.where(union > 0, inter / union.clamp_min(1e-10), 0.0)


def _decode(anchors, deltas, variances=None):
    """(dx, dy, dw, dh) deltas on [..., 4] anchors -> corner boxes, the
    RPN / Fast R-CNN convention (+1 widths, dw and dh clipped at 10)."""
    w = anchors[..., 2] - anchors[..., 0] + 1.0
    h = anchors[..., 3] - anchors[..., 1] + 1.0
    cx = anchors[..., 0] + 0.5 * w
    cy = anchors[..., 1] + 0.5 * h
    d = deltas if variances is None else deltas * variances
    pcx = d[..., 0] * w + cx
    pcy = d[..., 1] * h + cy
    pw = torch.exp(d[..., 2].clamp_max(10.0)) * w
    ph = torch.exp(d[..., 3].clamp_max(10.0)) * h
    return torch.stack([pcx - 0.5 * pw, pcy - 0.5 * ph,
                        pcx + 0.5 * pw - 1.0, pcy + 0.5 * ph - 1.0], -1)


def _encode(a, g):
    """Regression targets of boxes ``g`` against ``a`` (both [K, 4])."""
    aw = a[:, 2] - a[:, 0] + 1
    ah = a[:, 3] - a[:, 1] + 1
    gw = g[:, 2] - g[:, 0] + 1
    gh = g[:, 3] - g[:, 1] + 1
    return torch.stack([((g[:, 0] + gw / 2) - (a[:, 0] + aw / 2)) / aw,
                        ((g[:, 1] + gh / 2) - (a[:, 1] + ah / 2)) / ah,
                        torch.log(gw / aw), torch.log(gh / ah)], 1)


def _np_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """The host IoU of [M, 4] x [K, 4] corner boxes (no +1)."""
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = np.clip(a[:, 2] - a[:, 0], 0, None) * \
        np.clip(a[:, 3] - a[:, 1], 0, None)
    area_b = np.clip(b[:, 2] - b[:, 0], 0, None) * \
        np.clip(b[:, 3] - b[:, 1], 0, None)
    union = area_a[:, None] + area_b[None, :] - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-10), 0.0)


def _np_decode(anchors: np.ndarray, deltas: np.ndarray) -> np.ndarray:
    """The host form of :func:`_decode` (no variances)."""
    w = anchors[:, 2] - anchors[:, 0] + 1.0
    h = anchors[:, 3] - anchors[:, 1] + 1.0
    cx = anchors[:, 0] + 0.5 * w
    cy = anchors[:, 1] + 0.5 * h
    dw = np.clip(deltas[:, 2], None, 10.0)
    dh = np.clip(deltas[:, 3], None, 10.0)
    pcx = deltas[:, 0] * w + cx
    pcy = deltas[:, 1] * h + cy
    pw = np.exp(dw) * w
    ph = np.exp(dh) * h
    return np.stack([pcx - 0.5 * pw, pcy - 0.5 * ph,
                     pcx + 0.5 * pw - 1.0, pcy + 0.5 * ph - 1.0], 1)


def _np_nms(boxes: np.ndarray, scores: np.ndarray,
            thresh: float) -> List[int]:
    """Greedy NMS on the host in ``np.argsort(-scores)`` order."""
    order = np.argsort(-scores)
    keep = []
    while order.size:
        i = order[0]
        keep.append(int(i))
        if order.size == 1:
            break
        iou = _np_iou(boxes[i:i + 1], boxes[order[1:]])[0]
        order = order[1:][iou <= thresh]
    return keep


def _suppression_bits(boxes, thresh: float):
    """uint8 [K, ceil(K / 8)]: bit j % 8 of byte j // 8 of row i is set
    where IoU(box i, box j) > thresh, computed on the boxes' device in
    blocks of rows."""
    k = boxes.shape[0]
    k8 = -(-k // 8)
    out = torch.empty((k, k8), dtype=torch.uint8, device=boxes.device)
    weights = 2 ** torch.arange(8, dtype=torch.int32, device=boxes.device)
    rows = max(1, (1 << 24) // max(k, 1))
    for r0 in range(0, k, rows):
        over = _iou(boxes[r0:r0 + rows], boxes) > thresh
        if k8 * 8 != k:
            over = torch.cat([over, over.new_zeros(
                (over.shape[0], k8 * 8 - k))], 1)
        out[r0:r0 + rows] = (over.view(-1, k8, 8).to(torch.int32)
                             * weights).sum(-1).to(torch.uint8)
    return out


def _greedy_keep(order, pos, bits, limit: int) -> np.ndarray:
    """The greedy NMS over suppression bits: candidates in ``order``
    (positions into ``pos``, the boxes' rows in ``bits``); a candidate
    that no kept box suppresses is kept. Stops at ``limit`` kept boxes,
    as the reference's NMS sliced to its first ``limit``."""
    removed = np.zeros(bits.shape[1], np.uint8)
    keep = []
    for p in order:
        i = int(pos[p])
        if (removed[i >> 3] >> (i & 7)) & 1:
            continue
        keep.append(int(p))
        if limit > 0 and len(keep) == limit:
            break
        removed |= bits[i]
    return np.asarray(keep, np.int64)[:limit]


def _subsample(mask_idx, count, rs, use_random=True):
    if len(mask_idx) <= count:
        return mask_idx
    if not use_random:
        return mask_idx[:count]
    return rs.choice(mask_idx, size=count, replace=False)


def _i32(values, like):
    return _to(np.asarray(values, np.int32), like)


# ---------------------------------------------------- generate_proposals
@register_op("generate_proposals",
             non_differentiable_inputs=("Scores", "BboxDeltas", "ImInfo",
                                        "Anchors", "Variances"))
def generate_proposals(inputs, attrs):
    """RPN outputs -> proposal RoIs (ref: generate_proposals_op.cc): a
    score's top ``pre_nms_topN``, the delta decode, the clip to the
    image, the size filter, NMS and the top ``post_nms_topN``, image by
    image; outputs concatenated with RpnRoisNum."""
    scores = inputs["Scores"][0]
    deltas = inputs["BboxDeltas"][0]
    im_info = inputs["ImInfo"][0]
    anchors = inputs["Anchors"][0].reshape(-1, 4)
    variances = inputs["Variances"][0].reshape(-1, 4) \
        if inputs.get("Variances") else None
    for t in (deltas, im_info, anchors):
        eager_only(t, "generate_proposals")
    pre_n = int(attrs.get("pre_nms_topN", 6000))
    post_n = int(attrs.get("post_nms_topN", 1000))
    nms_thresh = float(attrs.get("nms_thresh", 0.7))
    min_size = float(attrs.get("min_size", 0.1))

    host_scores = host_only([scores], "generate_proposals")[0]
    images = []
    for b in range(scores.shape[0]):
        sc = host_scores[b].transpose(1, 2, 0).reshape(-1)
        order = np.argsort(-sc)[:pre_n]
        o = _to(order, anchors)
        dl = deltas[b].permute(1, 2, 0).reshape(-1, 4)
        props = _decode(anchors[o], dl[o],
                        variances[o] if variances is not None else None)
        h, w = im_info[b, 0], im_info[b, 1]
        props[:, 0::2] = torch.minimum(props[:, 0::2].clamp_min(0.0), w - 1)
        props[:, 1::2] = torch.minimum(props[:, 1::2].clamp_min(0.0), h - 1)
        ws = props[:, 2] - props[:, 0] + 1
        hs = props[:, 3] - props[:, 1] + 1
        keep_sz = (ws >= min_size) & (hs >= min_size)
        images.append((sc[order], props, keep_sz,
                       _suppression_bits(props, nms_thresh)))
    host = host_only([t for _, _, k, bits in images for t in (k, bits)],
                     "generate_proposals")
    rois, probs, nums = [], [], []
    for b, (sc_o, props, _, _) in enumerate(images):
        keep_sz, bits = host[2 * b], host[2 * b + 1]
        pos = np.where(keep_sz)[0]
        sc_k = sc_o[keep_sz]
        keep = _greedy_keep(np.argsort(-sc_k), pos, bits, post_n)
        rois.append(props[_to(pos[keep], anchors)])
        probs.append(sc_k[keep])
        nums.append(len(keep))
    rois = torch.cat(rois) if rois else anchors.new_zeros((0, 4))
    probs = np.concatenate(probs) if probs else np.zeros((0,), np.float32)
    return {"RpnRois": [rois.to(torch.float32)],
            "RpnRoiProbs": [_to(probs.astype(np.float32), anchors)],
            "RpnRoisNum": [_i32(nums, anchors)]}


# ---------------------------------------------------- rpn_target_assign
def _best_gt(anchors, gt):
    """IoU [A, G], each anchor's best IoU and the first gt reaching it."""
    iou = _iou(anchors, gt)
    return iou, iou.amax(1), iou.argmax(1)


@register_op("rpn_target_assign",
             non_differentiable_inputs=("Anchor", "GtBoxes", "IsCrowd",
                                        "ImInfo"))
def rpn_target_assign(inputs, attrs):
    """Label anchors 1 (fg), 0 (bg) or -1 (ignored), subsample to
    ``rpn_batch_size_per_im`` with ``rpn_fg_fraction``, and emit the
    regression targets (ref: rpn_target_assign_op.cc). One image, as the
    reference kernel; the builder handles the batch."""
    anchors = inputs["Anchor"][0].reshape(-1, 4)
    gt = inputs["GtBoxes"][0].reshape(-1, 4)
    eager_only(gt, "rpn_target_assign")
    batch = int(attrs.get("rpn_batch_size_per_im", 256))
    fg_frac = float(attrs.get("rpn_fg_fraction", 0.5))
    pos_th = float(attrs.get("rpn_positive_overlap", 0.7))
    neg_th = float(attrs.get("rpn_negative_overlap", 0.3))
    straddle = float(attrs.get("rpn_straddle_thresh", 0.0))
    use_random = bool(attrs.get("use_random", True))
    rs = np.random.RandomState(int(attrs.get("seed", 0)) or None)

    a_n, g_n = anchors.shape[0], gt.shape[0]
    dev = anchors.device
    iou = _iou(anchors, gt)                                 # [A, G]
    # ref FilterStraddleAnchor: an anchor crossing the image boundary by
    # more than the threshold never matches and is never sampled; its
    # IoU row is -1 before any argmax. The bounds are the reference's
    # float64 sums, compared in float32.
    inside = torch.ones(a_n, dtype=torch.bool, device=dev)
    if straddle >= 0 and a_n and inputs.get("ImInfo"):
        info = inputs["ImInfo"][0].reshape(-1).to(torch.float32)
        eager_only(info, "rpn_target_assign")
        im_h = (info[0].double() + straddle).float()
        im_w = (info[1].double() + straddle).float()
        inside = ((anchors[:, 0] >= -straddle)
                  & (anchors[:, 1] >= -straddle)
                  & (anchors[:, 2] < im_w) & (anchors[:, 3] < im_h))
        if g_n:
            iou = torch.where(inside[:, None], iou, -1.0)
    # masks by torch.where and index_fill_: a boolean index reads its
    # count on the host, and a Python value set by index is copied there
    labels = torch.full((a_n,), -1, dtype=torch.int64, device=dev)
    if g_n:
        max_iou, argmax = iou.amax(1), iou.argmax(1)
        labels = torch.where(max_iou < neg_th, 0, labels)
    elif neg_th > 0:                          # no gt: every IoU is 0
        labels.fill_(0)
    labels = torch.where(inside, labels, -1)  # straddlers: never sampled
    if g_n:
        labels.index_fill_(0, iou.argmax(0), 1)   # each gt's best anchor
        labels = torch.where(max_iou >= pos_th, 1, labels)
    lab = host_only([labels], "rpn_target_assign")[0].copy()

    fg_idx = np.where(lab == 1)[0]
    fg_keep = _subsample(fg_idx, int(batch * fg_frac), rs, use_random)
    lab[np.setdiff1d(fg_idx, fg_keep)] = -1
    bg_idx = np.where(lab == 0)[0]
    bg_keep = _subsample(bg_idx, batch - len(fg_keep), rs, use_random)
    lab[np.setdiff1d(bg_idx, bg_keep)] = -1

    loc_idx = np.where(lab == 1)[0]
    score_idx = np.where(lab >= 0)[0]
    if g_n and loc_idx.size:
        loc = _to(loc_idx, anchors)
        tgt = _encode(anchors[loc], gt[argmax[loc]]).to(torch.float32)
    else:
        tgt = torch.zeros((0, 4), dtype=torch.float32, device=dev)
    return {"LocationIndex": [_i32(loc_idx, anchors)],
            "ScoreIndex": [_i32(score_idx, anchors)],
            "TargetLabel": [_to(lab[score_idx].astype(np.int64)[:, None],
                                anchors)],
            "TargetBBox": [tgt],
            "BBoxInsideWeight": [torch.ones_like(tgt)]}


@register_op("retinanet_target_assign",
             non_differentiable_inputs=("Anchor", "GtBoxes", "GtLabels",
                                        "IsCrowd", "ImInfo"))
def retinanet_target_assign(inputs, attrs):
    """The focal-loss variant (ref: rpn_target_assign_op.cc
    RetinanetTargetAssign): every anchor that is not ignored is labeled,
    with no subsampling; positives carry their gt's class."""
    anchors = inputs["Anchor"][0].reshape(-1, 4)
    gt = inputs["GtBoxes"][0].reshape(-1, 4)
    gt_labels = inputs["GtLabels"][0].reshape(-1)
    eager_only(gt, "retinanet_target_assign")
    pos_th = float(attrs.get("positive_overlap", 0.5))
    neg_th = float(attrs.get("negative_overlap", 0.4))
    a_n, g_n = anchors.shape[0], gt.shape[0]
    dev = anchors.device
    labels = torch.full((a_n,), -1, dtype=torch.int64, device=dev)
    if g_n:
        iou, max_iou, argmax = _best_gt(anchors, gt)
        labels = torch.where(max_iou < neg_th, 0, labels)
        labels.index_fill_(0, iou.argmax(0), 1)
        labels = torch.where(max_iou >= pos_th, 1, labels)
    elif neg_th > 0:                          # no gt: every IoU is 0
        labels.fill_(0)
    lab = host_only([labels], "retinanet_target_assign")[0]
    loc_idx = np.where(lab == 1)[0]
    score_idx = np.where(lab >= 0)[0]
    cls = torch.zeros(len(score_idx), dtype=torch.int64, device=dev)
    sel = np.where(lab[score_idx] == 1)[0]
    if g_n and sel.size:
        rows = _to(score_idx[sel], anchors)
        cls[_to(sel, anchors)] = gt_labels[argmax[rows]].to(torch.int64)
    if g_n and loc_idx.size:
        loc = _to(loc_idx, anchors)
        tgt = _encode(anchors[loc], gt[argmax[loc]]).to(torch.float32)
    else:
        tgt = torch.zeros((len(loc_idx), 4), dtype=torch.float32,
                          device=dev)
    return {"LocationIndex": [_i32(loc_idx, anchors)],
            "ScoreIndex": [_i32(score_idx, anchors)],
            "TargetLabel": [cls[:, None]],
            "TargetBBox": [tgt],
            "BBoxInsideWeight": [torch.ones_like(tgt)],
            "ForegroundNumber": [_i32([max(len(loc_idx), 1)], anchors)]}


# ---------------------------------------------- generate_proposal_labels
@register_op("generate_proposal_labels",
             non_differentiable_inputs=("RpnRois", "GtClasses", "IsCrowd",
                                        "GtBoxes", "ImInfo",
                                        "RpnRoisNum"))
def generate_proposal_labels(inputs, attrs):
    """Sample fg and bg RoIs against the gt boxes and emit the per-class
    regression targets (ref: generate_proposal_labels_op.cc; one image).
    The candidates are the proposals and the gt boxes; the sampling
    always draws (the reference's ``use_random`` is not read)."""
    rois = inputs["RpnRois"][0].reshape(-1, 4)
    gt = inputs["GtBoxes"][0].reshape(-1, 4)
    gt_cls = inputs["GtClasses"][0].reshape(-1)
    eager_only(gt, "generate_proposal_labels")
    batch = int(attrs.get("batch_size_per_im", 512))
    fg_frac = float(attrs.get("fg_fraction", 0.25))
    fg_th = float(attrs.get("fg_thresh", 0.5))
    bg_hi = float(attrs.get("bg_thresh_hi", 0.5))
    bg_lo = float(attrs.get("bg_thresh_lo", 0.0))
    num_classes = int(attrs.get("class_nums", 81))
    rs = np.random.RandomState(int(attrs.get("seed", 0)) or None)

    g_n = gt.shape[0]
    cand = torch.cat([rois, gt]) if g_n else rois
    if g_n:
        _, max_iou, argmax = _best_gt(cand, gt)
    else:
        max_iou = torch.zeros(cand.shape[0], device=cand.device)
    # 1: fg, 2: bg, as one code to read
    code = (max_iou >= fg_th).to(torch.int8) + 2 * (
        (max_iou < bg_hi) & (max_iou >= bg_lo)).to(torch.int8)
    code = host_only([code], "generate_proposal_labels")[0]
    fg_idx = np.where(code & 1)[0]
    bg_idx = np.where(code & 2)[0]
    n_fg = min(int(batch * fg_frac), len(fg_idx))
    fg_keep = _subsample(fg_idx, n_fg, rs)
    bg_keep = _subsample(bg_idx, batch - n_fg, rs)
    keep = np.concatenate([fg_keep, bg_keep]).astype(np.int64)
    nf = len(fg_keep)

    out_rois = cand[_to(keep, rois)].to(torch.float32)
    tgt = torch.zeros((len(keep), 4 * num_classes), dtype=torch.float32,
                      device=rois.device)
    w_in = torch.zeros_like(tgt)
    labels = torch.zeros(len(keep), dtype=torch.int64, device=rois.device)
    if g_n and nf:
        match = argmax[_to(fg_keep.astype(np.int64), rois)]
        labels[:nf] = gt_cls[match].to(torch.int64)
        cols = 4 * labels[:nf, None] + torch.arange(4, device=rois.device)
        tgt[:nf] = tgt[:nf].scatter(1, cols, _encode(
            out_rois[:nf], gt[match]).to(torch.float32))
        w_in[:nf] = w_in[:nf].scatter(1, cols, 1.0)
    return {"Rois": [out_rois],
            "LabelsInt32": [labels.to(torch.int32)],
            "BboxTargets": [tgt],
            "BboxInsideWeights": [w_in],
            "BboxOutsideWeights": [(w_in > 0).to(torch.float32)],
            "RoisNum": [_i32([len(keep)], rois)]}


# -------------------------------------------------- generate_mask_labels
def _rasterize_polygon(poly: np.ndarray, m: int, roi) -> np.ndarray:
    """Even-odd scanline rasterization of one polygon (2k floats) into
    an [M, M] grid over the roi (x1, y1, x2, y2), in float64."""
    x1, y1, x2, y2 = roi
    pts = poly.reshape(-1, 2).astype(np.float64)
    px = (pts[:, 0] - x1) * (m / max(x2 - x1, 1e-6))
    py = (pts[:, 1] - y1) * (m / max(y2 - y1, 1e-6))
    ys, xs = np.mgrid[0:m, 0:m]
    cx = xs + 0.5
    cy = ys + 0.5
    inside = np.zeros((m, m), bool)
    j = len(px) - 1
    for i in range(len(px)):
        cond = (py[i] > cy) != (py[j] > cy)
        slope = (px[j] - px[i]) / (py[j] - py[i] + 1e-12)
        inside ^= cond & (cx < px[i] + slope * (cy - py[i]))
        j = i
    return inside.astype(np.uint8)


@register_op("generate_mask_labels",
             non_differentiable_inputs=("ImInfo", "GtClasses", "IsCrowd",
                                        "GtSegms", "Rois", "LabelsInt32",
                                        "RoisNum"))
def generate_mask_labels(inputs, attrs):
    """Rasterize each fg RoI's matched gt polygon into a resolution^2
    binary target in its class's slot (ref: generate_mask_labels_op.cc).
    GtSegms [G, P*2] holds one polygon a gt row; a RoI takes the polygon
    whose bounding box it overlaps most."""
    rois, labels, segms = host_only(
        [inputs["Rois"][0], inputs["LabelsInt32"][0],
         inputs["GtSegms"][0]], "generate_mask_labels")
    rois, labels = rois.reshape(-1, 4), labels.reshape(-1)
    like = inputs["Rois"][0]
    m = int(attrs.get("resolution", 14))
    num_classes = int(attrs.get("num_classes", 81))
    fg = np.where(labels > 0)[0]
    masks = np.full((len(fg), num_classes * m * m), -1.0, np.float32)
    out_rois = rois[fg] if len(fg) else np.zeros((0, 4), np.float32)
    if segms.size and len(fg):
        polys = segms.reshape(segms.shape[0], -1)
        poly_boxes = np.stack([
            polys[:, 0::2].min(1), polys[:, 1::2].min(1),
            polys[:, 0::2].max(1), polys[:, 1::2].max(1)], 1)
        match = _np_iou(out_rois, poly_boxes).argmax(axis=1)
        for i in range(len(fg)):
            c = int(labels[fg[i]])
            masks[i] = 0.0
            masks[i, c * m * m:(c + 1) * m * m] = _rasterize_polygon(
                polys[match[i]], m, out_rois[i]).reshape(-1)
    return {"MaskRois": [_to(out_rois.astype(np.float32), like)],
            "RoiHasMaskInt32": [_to(np.arange(len(fg), dtype=np.int32),
                                    like)],
            "MaskInt32": [_to(masks.astype(np.int32), like)]}


# ------------------------------------------------------ FPN distribution
@register_op("collect_fpn_proposals",
             non_differentiable_inputs=("MultiLevelRois",
                                        "MultiLevelScores",
                                        "MultiLevelRoIsNum"))
def collect_fpn_proposals(inputs, attrs):
    """Concatenate the levels' proposals and keep the top
    ``post_nms_topN`` by score (ref: collect_fpn_proposals_op.cc)."""
    rois = [r.reshape(-1, 4) for r in inputs["MultiLevelRois"]]
    for r in rois:
        eager_only(r, "collect_fpn_proposals")
    scores = host_only(list(inputs["MultiLevelScores"]),
                       "collect_fpn_proposals")
    post_n = int(attrs.get("post_nms_topN", 1000))
    like = inputs["MultiLevelScores"][0]
    all_rois = torch.cat(rois) if rois else \
        torch.zeros((0, 4), device=like.device)
    all_scores = np.concatenate([s.reshape(-1) for s in scores])
    order = np.argsort(-all_scores)[:post_n]
    return {"FpnRois": [all_rois[_to(order, like)].to(torch.float32)],
            "RoisNum": [_i32([len(order)], like)]}


@register_op("distribute_fpn_proposals",
             non_differentiable_inputs=("FpnRois", "RoisNum"))
def distribute_fpn_proposals(inputs, attrs):
    """Route each RoI to its pyramid level, floor(refer_level +
    log2(sqrt(area) / refer_scale)) clamped to [min, max] (ref:
    distribute_fpn_proposals_op.cc); RestoreIndex puts them back."""
    rois = inputs["FpnRois"][0].reshape(-1, 4)
    min_l = int(attrs.get("min_level", 2))
    max_l = int(attrs.get("max_level", 5))
    refer_l = int(attrs.get("refer_level", 4))
    refer_s = float(attrs.get("refer_scale", 224))
    w = (rois[:, 2] - rois[:, 0]).clamp_min(0.0)
    h = (rois[:, 3] - rois[:, 1]).clamp_min(0.0)
    lvl = torch.floor(refer_l + torch.log2(
        _div(torch.sqrt(w * h), refer_s) + 1e-6)).clamp(min_l, max_l)
    lvl = host_only([lvl], "distribute_fpn_proposals")[0].astype(int)
    outs, nums, restore = [], [], []
    for lv in range(min_l, max_l + 1):
        idx = np.where(lvl == lv)[0]
        outs.append(rois[_to(idx, rois)].to(torch.float32))
        nums.append(_i32([len(idx)], rois))
        restore.extend(idx.tolist())
    restore_idx = np.empty(len(lvl), np.int32)
    restore_idx[np.asarray(restore, int)] = np.arange(len(lvl))
    return {"MultiFpnRois": outs,
            "RestoreIndex": [_to(restore_idx[:, None], rois)],
            "MultiLevelRoIsNum": nums}


# --------------------------------------------------- SSD-style training
@register_op("target_assign",
             non_differentiable_inputs=("X", "MatchIndices", "NegIndices"))
def target_assign(inputs, attrs):
    """Gather each prior's target row by its match index; an unmatched
    prior gets ``mismatch_value`` and weight 0, a prior listed in
    NegIndices weight 1 (ref: target_assign_op.cc). Static shapes."""
    x = inputs["X"][0]
    match = inputs["MatchIndices"][0].to(torch.int64)       # [N, P]
    mismatch = float(attrs.get("mismatch_value", 0.0))
    p = match.shape[1]
    x2 = x.reshape(-1, x.shape[-1])
    valid = match >= 0
    gathered = x2[match.clamp(0, x2.shape[0] - 1)]          # [N, P, D]
    out = torch.where(valid[:, :, None], gathered,
                      gathered.new_full((), mismatch))
    w = valid[:, :, None].to(torch.float32)
    if inputs.get("NegIndices"):
        neg = inputs["NegIndices"][0].reshape(-1).to(torch.int64)
        neg_mask = torch.zeros(p, dtype=torch.float32, device=x.device)
        neg_mask.index_fill_(0, neg.clamp(0, p - 1), 1.0)
        w = torch.maximum(w, neg_mask[None, :, None])
    return {"Out": [out], "OutWeight": [w]}


@register_op("mine_hard_examples",
             non_differentiable_inputs=("ClsLoss", "LocLoss",
                                        "MatchIndices", "MatchDist"))
def mine_hard_examples(inputs, attrs):
    """OHEM (ref: mine_hard_examples_op.cc, max_negative): rank each
    image's unmatched priors by loss and keep neg_pos_ratio times its
    positives."""
    slots = [inputs["ClsLoss"][0], inputs["MatchIndices"][0]]
    if inputs.get("LocLoss"):
        slots.append(inputs["LocLoss"][0])
    host = host_only(slots, "mine_hard_examples")
    cls_loss, match = host[0], host[1].astype(int)
    loc_loss = host[2] if len(host) > 2 else np.zeros_like(cls_loss)
    ratio = float(attrs.get("neg_pos_ratio", 3.0))
    neg_rows, counts = [], []
    for b in range(match.shape[0]):
        pos = match[b] >= 0
        loss = cls_loss[b] + loc_loss[b]
        neg_cand = np.where(~pos)[0]
        n_neg = int(min(len(neg_cand), ratio * max(pos.sum(), 1)))
        order = neg_cand[np.argsort(-loss[neg_cand])][:n_neg]
        neg_rows.append(np.sort(order))
        counts.append(n_neg)
    flat = np.concatenate(neg_rows) if neg_rows else np.zeros(0, int)
    like = inputs["ClsLoss"][0]
    return {"NegIndices": [_to(flat.astype(np.int32)[:, None], like)],
            "UpdatedMatchIndices": [_to(match.astype(np.int32), like)],
            "NegIndicesNum": [_i32(counts, like)]}


@register_op("box_decoder_and_assign",
             non_differentiable_inputs=("PriorBox", "PriorBoxVar",
                                        "TargetBox", "BoxScore"))
def box_decoder_and_assign(inputs, attrs):
    """Decode each class's deltas against the priors, then take each
    RoI's best-scoring class box (ref: box_decoder_and_assign_op.cc)."""
    prior = inputs["PriorBox"][0].reshape(-1, 4)
    var = inputs["PriorBoxVar"][0].reshape(-1, 4) \
        if inputs.get("PriorBoxVar") else None
    deltas = inputs["TargetBox"][0]                          # [N, 4*C]
    scores = inputs["BoxScore"][0]                           # [N, C]
    for t in (prior, deltas, scores):
        eager_only(t, "box_decoder_and_assign")
    n, c = scores.shape
    decoded = _decode(prior[:, None], deltas.reshape(n, c, 4),
                      var[:, None] if var is not None else None
                      ).to(torch.float32)                    # [N, C, 4]
    assigned = decoded[torch.arange(n, device=scores.device),
                       scores.argmax(1)]
    return {"DecodeBox": [decoded.reshape(n, 4 * c)],
            "OutputAssignBox": [assigned]}


# --------------------------------------------------------- NMS variants
def _nms2(out):
    n = out["Out"][0].shape[0]
    dev = out["Out"][0].device
    out["Index"] = [torch.arange(n, dtype=torch.int32, device=dev)[:, None]]
    if "NmsRoisNum" not in out:
        out["NmsRoisNum"] = [torch.full((1,), n, dtype=torch.int32,
                                        device=dev)]
    return out


@register_op("multiclass_nms2",
             non_differentiable_inputs=("BBoxes", "Scores"))
def multiclass_nms2(inputs, attrs):
    """``multiclass_nms`` with the kept-index output (ref:
    multiclass_nms_op.cc, REGISTER multiclass_nms2): Index is the row
    range, as in the JAX package."""
    return _nms2(OpInfoMap.instance().get("multiclass_nms").compute(
        inputs, attrs))


@register_infer_meta("multiclass_nms2")
def _multiclass_nms2_meta(inputs, attrs):
    return _nms2(OpInfoMap.instance().get("multiclass_nms").infer_meta(
        inputs, attrs))


@register_op("locality_aware_nms",
             non_differentiable_inputs=("BBoxes", "Scores"))
def locality_aware_nms(inputs, attrs):
    """EAST's NMS (ref: locality_aware_nms_op.cc): each box above the
    IoU threshold against the last merged box is merged into it,
    weighted by score, then standard NMS; a sequential scan, on the
    host."""
    boxes, scores = host_only([inputs["BBoxes"][0], inputs["Scores"][0]],
                              "locality_aware_nms")
    boxes = boxes.reshape(-1, 4)
    scores = scores.reshape(-1) if scores.ndim > 1 else scores
    iou_th = float(attrs.get("nms_threshold", 0.3))
    score_th = float(attrs.get("score_threshold", 0.0))
    keep0 = scores > score_th
    boxes, scores = boxes[keep0], scores[keep0]
    merged_b, merged_s = [], []
    for i in range(len(boxes)):
        if merged_b and _np_iou(boxes[i:i + 1],
                                np.asarray([merged_b[-1]]))[0, 0] > iou_th:
            w1, w2 = merged_s[-1], scores[i]
            merged_b[-1] = (merged_b[-1] * w1 + boxes[i] * w2) / (w1 + w2)
            merged_s[-1] = w1 + w2
        else:
            merged_b.append(boxes[i].copy())
            merged_s.append(float(scores[i]))
    mb = np.asarray(merged_b, np.float32).reshape(-1, 4)
    ms = np.asarray(merged_s, np.float32)
    keep = _np_nms(mb, ms, iou_th)
    out = np.concatenate([np.zeros((len(keep), 1), np.float32),
                          ms[keep][:, None], mb[keep]], axis=1)
    return {"Out": [_to(out, inputs["BBoxes"][0])]}


# ------------------------------------------------------------ metric op
@register_op("detection_map",
             non_differentiable_inputs=("DetectRes", "Label", "HasState",
                                        "PosCount", "TruePos",
                                        "FalsePos"))
def detection_map(inputs, attrs):
    """mAP over one batch of detections (ref: detection_map_op.cc), on
    the host. DetectRes rows [label, score, x1, y1, x2, y2]; Label rows
    [label, x1, y1, x2, y2] (a difficult column is accepted and not
    read)."""
    det, gt = host_only([inputs["DetectRes"][0], inputs["Label"][0]],
                        "detection_map")
    overlap = float(attrs.get("overlap_threshold", 0.5))
    ap_type = attrs.get("ap_type", "integral")
    classes = sorted(set(gt[:, 0].astype(int).tolist()) |
                     set(det[:, 0].astype(int).tolist()))
    aps = []
    for c in classes:
        gtc = gt[gt[:, 0].astype(int) == c][:, -4:]
        detc = det[det[:, 0].astype(int) == c]
        if len(gtc) == 0:
            continue
        detc = detc[np.argsort(-detc[:, 1])]
        used = np.zeros(len(gtc), bool)
        tp = np.zeros(len(detc))
        fp = np.zeros(len(detc))
        for i in range(len(detc)):
            iou = _np_iou(detc[i:i + 1, -4:], gtc)[0]
            j = iou.argmax()
            if iou[j] >= overlap and not used[j]:
                tp[i] = 1
                used[j] = True
            else:
                fp[i] = 1
        ctp = np.cumsum(tp)
        cfp = np.cumsum(fp)
        rec = ctp / len(gtc)
        prec = ctp / np.maximum(ctp + cfp, 1e-9)
        if ap_type == "11point":
            ap = np.mean([prec[rec >= t].max() if (rec >= t).any() else 0.0
                          for t in np.linspace(0, 1, 11)])
        else:
            ap = 0.0
            for i in range(len(rec)):
                ap += (rec[i] - (rec[i - 1] if i else 0.0)) * prec[i]
        aps.append(ap)
    like = inputs["DetectRes"][0]
    return {"MAP": [_to(np.asarray(np.mean(aps) if aps else 0.0,
                                   np.float32), like)],
            "AccumPosCount": [_to(np.zeros((1,), np.int32), like)],
            "AccumTruePos": [_to(np.zeros((1, 2), np.float32), like)],
            "AccumFalsePos": [_to(np.zeros((1, 2), np.float32), like)]}


# ------------------------------------------------- perspective transform
def _homography(quad: np.ndarray, w_out: int, h_out: int, scale: float):
    """The 3x3 map from the output rectangle's corners to the quad's
    (float64 least squares, as the reference)."""
    src = np.asarray([[0, 0], [w_out - 1, 0], [w_out - 1, h_out - 1],
                      [0, h_out - 1]], np.float64)
    dst = quad.reshape(4, 2).astype(np.float64) * scale
    a, b = [], []
    for (sx, sy), (dx, dy) in zip(src, dst):
        a.append([sx, sy, 1, 0, 0, 0, -dx * sx, -dx * sy])
        a.append([0, 0, 0, sx, sy, 1, -dy * sx, -dy * sy])
        b.extend([dx, dy])
    hvec = np.linalg.lstsq(np.asarray(a), np.asarray(b), rcond=None)[0]
    return np.append(hvec, 1.0).reshape(3, 3)


@register_op("roi_perspective_transform",
             intermediate_outputs=("Out2InIdx", "Out2InWeights", "Mask",
                                   "TransformMatrix"),
             non_differentiable_inputs=("ROIs",))
def roi_perspective_transform(inputs, attrs):
    """Warp each quadrilateral RoI (8 coords) to a rectangle through its
    homography, bilinear taps of image 0 (ref:
    roi_perspective_transform_op.cc). The homographies and the sample
    positions are solved on the host in float64; the taps run on the
    device in float64, as the reference's products."""
    x = inputs["X"][0]
    rois = host_only([inputs["ROIs"][0]],
                     "roi_perspective_transform")[0].reshape(-1, 8)
    h_out = int(attrs.get("transformed_height", 8))
    w_out = int(attrs.get("transformed_width", 8))
    scale = float(attrs.get("spatial_scale", 1.0))
    _, c, h, w = x.shape
    r = len(rois)
    ys, xs = np.mgrid[0:h_out, 0:w_out]
    grid = np.stack([xs, ys, np.ones_like(xs)], -1).reshape(-1, 3).T
    sx = np.zeros((r, h_out * w_out))
    sy = np.zeros((r, h_out * w_out))
    for i in range(r):
        src = _homography(rois[i], w_out, h_out, scale) @ grid
        sx[i] = src[0] / np.maximum(src[2], 1e-9)
        sy[i] = src[1] / np.maximum(src[2], 1e-9)
    x0 = np.floor(sx).astype(np.int64)
    y0 = np.floor(sy).astype(np.int64)
    valid = (x0 >= 0) & (x0 < w - 1) & (y0 >= 0) & (y0 < h - 1)
    x0c, y0c = np.clip(x0, 0, w - 2), np.clip(y0, 0, h - 2)
    fx, fy, valid = (_to(v, x) for v in (sx - x0, sy - y0, valid))
    x0c, y0c = _to(x0c, x), _to(y0c, x)
    img = x[0]

    def tap(yi, xi):
        return img[:, yi, xi].double()                    # [C, R, P]

    val = (tap(y0c, x0c) * (1 - fx) * (1 - fy) +
           tap(y0c, x0c + 1) * fx * (1 - fy) +
           tap(y0c + 1, x0c) * (1 - fx) * fy +
           tap(y0c + 1, x0c + 1) * fx * fy) * valid
    out = val.to(torch.float32).reshape(c, r, h_out, w_out).transpose(0, 1)
    return {"Out": [out.contiguous()],
            "Mask": [torch.ones((r, 1, h_out, w_out), dtype=torch.int32,
                                device=x.device)],
            "TransformMatrix": [torch.zeros((r, 9), dtype=torch.float32,
                                            device=x.device)],
            "Out2InIdx": [torch.zeros((1,), dtype=torch.int32,
                                      device=x.device)],
            "Out2InWeights": [torch.zeros((1,), dtype=torch.float32,
                                          device=x.device)]}


# ----------------------------------------------- retinanet detection out
@register_op("retinanet_detection_output",
             non_differentiable_inputs=("BBoxes", "Scores", "Anchors",
                                        "ImInfo"))
def retinanet_detection_output(inputs, attrs):
    """Per level: the top ``nms_top_k`` scores above the threshold, their
    deltas decoded against the anchors; then NMS class by class and the
    top ``keep_top_k`` rows [label, score, x1, y1, x2, y2] (ref:
    retinanet_detection_output_op.cc). On the host."""
    score_th = float(attrs.get("score_threshold", 0.05))
    nms_top_k = int(attrs.get("nms_top_k", 1000))
    keep_top_k = int(attrs.get("keep_top_k", 100))
    nms_th = float(attrs.get("nms_threshold", 0.3))
    levels = list(zip(inputs["BBoxes"], inputs["Scores"],
                      inputs["Anchors"]))
    host = host_only([t for lv in levels for t in lv],
                     "retinanet_detection_output")
    all_boxes, all_scores, all_cls = [], [], []
    for i in range(len(levels)):
        deltas = host[3 * i].reshape(-1, 4)
        scores = host[3 * i + 1].reshape(deltas.shape[0], -1)
        anchors = host[3 * i + 2].reshape(-1, 4)
        flat = scores.reshape(-1)
        order = np.argsort(-flat)[:nms_top_k]
        rows, cls = np.unravel_index(order, scores.shape)
        keep = flat[order] > score_th
        rows, cls = rows[keep], cls[keep]
        all_boxes.append(_np_decode(anchors[rows], deltas[rows]))
        all_scores.append(scores[rows, cls])
        all_cls.append(cls)
    boxes = np.concatenate(all_boxes) if all_boxes else np.zeros((0, 4))
    scores = np.concatenate(all_scores) if all_scores else np.zeros(0)
    cls = np.concatenate(all_cls) if all_cls else np.zeros(0, int)
    outs = []
    for c in sorted(set(cls.tolist())):
        m = cls == c
        where = np.where(m)[0]
        for k in _np_nms(boxes[m], scores[m], nms_th):
            idx = where[k]
            outs.append([c, scores[idx], *boxes[idx]])
    outs.sort(key=lambda row: -row[1])
    outs = np.asarray(outs[:keep_top_k], np.float32) if outs else \
        np.zeros((0, 6), np.float32)
    return {"Out": [_to(outs, inputs["BBoxes"][0])]}
