"""Small cases of the 15 op types of the two-stage detection slice
(``ops/rcnn_ops.py``): the numpy inputs and attrs that
``tests/test_torch_rcnn_ops.py`` runs through both packages' registries on
the CPU, and that ``chip_smoke.py`` phase ``rcnn_ops`` runs through the
port on the card and on the CPU. :class:`Case` and its kinds are
``op_cases``'s; none of these types has a gradient to hold (their inputs
are not differentiable, or their JAX kernels read them on the host).

Every sampling case has a nonzero ``seed`` attr: the ops draw from
``np.random.RandomState(seed or None)``, so equal seeds sample equal
indices in both packages and on both devices.

Bounds: integer outputs equal; float outputs at rtol 1e-5 / atol 1e-6
where they are IoU tables, copies or gathers (the same float32 operations
in the same order); at ``DECODE`` where they pass through ``exp`` or
``log`` (the delta decode and encode), whose last bit differs between
numpy, torch's CPU and the card.

Besides the cases: the Faster R-CNN training program
(:func:`faster_rcnn_program`), built with either package's static API,
at full width (:data:`FRCNN`) or test size (:data:`FRCNN_TINY`), and its
seeded synthetic images and boxes (:func:`frcnn_feed`).
"""
from __future__ import annotations

from typing import List

import numpy as np

from .op_cases import Case, f32, ints, uniform

DECODE = (1e-5, 1e-5)

# reference module -> the op types this slice takes from it
SLICE = {"paddle_tpu.ops.rcnn_ops": 15}


def _rs(seed):
    return np.random.RandomState(seed)


def boxes(seed, n, width, height, lo=4.0, hi=40.0):
    """[n, 4] float32 pixel corner boxes inside a width x height image."""
    rs = _rs(seed)
    wh = rs.uniform(lo, hi, (n, 2))
    x1 = rs.uniform(0, width - wh[:, 0])
    y1 = rs.uniform(0, height - wh[:, 1])
    return np.stack([x1, y1, x1 + wh[:, 0], y1 + wh[:, 1]], 1).astype(
        np.float32)


def grid_anchors(fh, fw, sizes, stride=16.0):
    """[fh, fw, len(sizes), 4] square anchors centred on each cell."""
    ys, xs = np.mgrid[0:fh, 0:fw].astype(np.float32)
    c = np.stack([xs, ys], -1)[:, :, None, :] * stride + stride / 2
    half = np.asarray(sizes, np.float32)[None, None, :, None] / 2
    return np.concatenate([c - half, c + half - 1], -1).astype(np.float32)


def _quantized(seed, *shape, step=0.125):
    """Scores on a grid of ``step``: many ties, which only the
    reference's own sort orders as it does."""
    return (np.round(uniform(seed, 0, 1, *shape) / step) * step).astype(
        np.float32)


def _polygons():
    """A square (its last vertex repeated to six) and an L."""
    square = [2, 2, 12, 2, 12, 12, 2, 12, 2, 12, 2, 12]
    ell = [20, 20, 40, 20, 40, 28, 28, 28, 28, 40, 20, 40]
    return np.asarray([square, ell], np.float32)


def _rcnn_cases() -> List[Case]:
    anchors = grid_anchors(4, 5, (16.0, 32.0, 48.0))       # 60 anchors
    gt = boxes(1, 3, 80, 64, 12.0, 40.0)
    im_info = np.asarray([[64.0, 80.0, 1.0]], np.float32)
    proposals = np.concatenate([boxes(2, 26, 80, 64), gt + f32(
        3, 3, 4, scale=1.5)]).astype(np.float32)
    rpn = {"Anchor": [anchors.reshape(-1, 4)], "GtBoxes": [gt],
           "IsCrowd": [np.zeros((3, 1), np.int32)], "ImInfo": [im_info]}
    rpn_attrs = {"rpn_batch_size_per_im": 16, "rpn_fg_fraction": 0.5,
                 "rpn_positive_overlap": 0.5, "rpn_negative_overlap": 0.3,
                 "rpn_straddle_thresh": 0.0, "seed": 7}
    gp = {"Scores": [uniform(4, 0, 1, 2, 3, 4, 5)],
          "BboxDeltas": [f32(5, 2, 12, 4, 5, scale=0.2)],
          "ImInfo": [np.asarray([[64, 80, 1], [56, 72, 1]], np.float32)],
          "Anchors": [anchors],
          "Variances": [np.ones_like(anchors)]}
    gp_attrs = {"pre_nms_topN": 40, "post_nms_topN": 12,
                "nms_thresh": 0.5, "min_size": 2.0}
    # detections: class 1 hits gt 0, class 2 misses, class 3 finds the
    # difficult box; Label rows [label, difficult, x1, y1, x2, y2]
    label = np.asarray([[1, 0, 10, 10, 30, 30], [2, 0, 40, 40, 60, 60],
                        [3, 1, 5, 40, 25, 60]], np.float32)
    dets = np.asarray([[1, 0.9, 11, 10, 30, 31], [1, 0.6, 12, 11, 29, 30],
                       [2, 0.8, 0, 0, 8, 8], [3, 0.7, 5, 41, 25, 60],
                       [1, 0.3, 60, 5, 70, 20]], np.float32)
    quads = np.asarray([[1, 1, 8, 1, 8, 6, 1, 6],
                        [2, 3, 9, 1, 10, 7, 3, 9],
                        [-2, 4, 6, 2, 14, 8, 4, 11]], np.float32)
    lvl_rois = [boxes(10 + i, n, 64, 64) for i, n in enumerate((4, 3, 5))]
    lvl_scores = [uniform(13, 0, 1, 4), np.asarray([0.5, 0.25, 0.5],
                                                   np.float32),
                  uniform(14, 0, 1, 5)]
    match = np.asarray([[0, -1, 2, -1, -1, 1, -1, -1],
                        [-1, 4, -1, -1, 3, -1, -1, -1]], np.int32)
    priors = boxes(20, 6, 60, 60, 8.0, 20.0)
    east = np.concatenate([boxes(21, 3, 40, 40, 8, 12),
                           boxes(21, 3, 40, 40, 8, 12) + 1.0,
                           boxes(22, 2, 40, 40)])[None]
    retina_anchors = [grid_anchors(2, 3, (16.0, 24.0)).reshape(-1, 4),
                      grid_anchors(1, 2, (32.0, 48.0), 32.0).reshape(-1, 4)]
    return [
        Case("generate_proposals", "generate_proposals", gp, gp_attrs,
             grad=False, tol=DECODE),
        # quantized scores: tied scores sorted as the reference sorts them;
        # no variances; a larger top-n
        Case("generate_proposals_ties", "generate_proposals",
             {"Scores": [_quantized(6, 1, 3, 4, 5)],
              "BboxDeltas": [f32(7, 1, 12, 4, 5, scale=0.1)],
              "ImInfo": [np.asarray([[64, 80, 1]], np.float32)],
              "Anchors": [anchors]},
             {"pre_nms_topN": 60, "post_nms_topN": 30, "nms_thresh": 0.3,
              "min_size": 0.0}, grad=False, tol=DECODE),
        Case("rpn_target_assign", "rpn_target_assign", rpn, rpn_attrs,
             grad=False, tol=DECODE),
        Case("rpn_target_assign_no_random", "rpn_target_assign", rpn,
             dict(rpn_attrs, use_random=False), grad=False, tol=DECODE),
        # no straddle filter, and every anchor a candidate
        Case("rpn_target_assign_no_straddle", "rpn_target_assign", rpn,
             dict(rpn_attrs, rpn_straddle_thresh=-1.0,
                  rpn_batch_size_per_im=64, seed=11),
             grad=False, tol=DECODE),
        Case("retinanet_target_assign", "retinanet_target_assign",
             {"Anchor": [anchors.reshape(-1, 4)], "GtBoxes": [gt],
              "GtLabels": [np.asarray([[3], [1], [2]], np.int32)],
              "IsCrowd": [np.zeros((3, 1), np.int32)], "ImInfo": [im_info]},
             {"positive_overlap": 0.5, "negative_overlap": 0.4},
             grad=False, tol=DECODE),
        Case("generate_proposal_labels", "generate_proposal_labels",
             {"RpnRois": [proposals],
              "GtClasses": [np.asarray([3, 1, 4], np.int32)],
              "IsCrowd": [np.zeros((3,), np.int32)], "GtBoxes": [gt],
              "ImInfo": [im_info]},
             {"batch_size_per_im": 16, "fg_fraction": 0.25,
              "fg_thresh": 0.5, "bg_thresh_hi": 0.5, "bg_thresh_lo": 0.0,
              "class_nums": 5, "seed": 5}, grad=False, tol=DECODE),
        # a square and an L-shaped polygon; the third roi is background
        Case("generate_mask_labels", "generate_mask_labels",
             {"ImInfo": [im_info],
              "GtClasses": [np.asarray([2, 1], np.int32)],
              "IsCrowd": [np.zeros((2,), np.int32)],
              "GtSegms": [_polygons()],
              "Rois": [np.asarray([[0, 0, 14, 14], [18, 18, 42, 42],
                                   [50, 50, 60, 60]], np.float32)],
              "LabelsInt32": [np.asarray([2, 1, 0], np.int32)]},
             {"resolution": 8, "num_classes": 3}, grad=False),
        Case("collect_fpn_proposals", "collect_fpn_proposals",
             {"MultiLevelRois": lvl_rois, "MultiLevelScores": lvl_scores},
             {"post_nms_topN": 7}, grad=False),
        Case("distribute_fpn_proposals", "distribute_fpn_proposals",
             {"FpnRois": [np.concatenate([
                 boxes(15, 4, 900, 900, 8, 40),
                 boxes(16, 4, 900, 900, 100, 250),
                 boxes(17, 4, 900, 900, 300, 800)])]},
             {"min_level": 2, "max_level": 5, "refer_level": 4,
              "refer_scale": 224}, grad=False),
        Case("target_assign", "target_assign",
             {"X": [f32(18, 6, 4)], "MatchIndices": [match]},
             {"mismatch_value": -1.0}, grad=False),
        # integer labels and mined negatives, as ssd_loss assigns them
        Case("target_assign_negatives", "target_assign",
             {"X": [ints(19, 0, 5, 6, 1, dtype=np.int32)],
              "MatchIndices": [match],
              "NegIndices": [np.asarray([[1], [3], [6]], np.int32)]},
             {"mismatch_value": 0.0}, grad=False),
        Case("mine_hard_examples", "mine_hard_examples",
             {"ClsLoss": [uniform(23, 0, 3, 2, 8)],
              "LocLoss": [uniform(24, 0, 1, 2, 8)],
              "MatchIndices": [match]},
             {"neg_pos_ratio": 2.0}, grad=False),
        Case("box_decoder_and_assign", "box_decoder_and_assign",
             {"PriorBox": [priors],
              "PriorBoxVar": [np.tile(np.asarray(
                  [[0.1, 0.1, 0.2, 0.2]], np.float32), (6, 1))],
              "TargetBox": [f32(25, 6, 12)],
              "BoxScore": [uniform(26, 0, 1, 6, 3)]},
             {"box_clip": 4.135}, grad=False, tol=DECODE),
        Case("multiclass_nms2", "multiclass_nms2",
             {"BBoxes": [(boxes(27, 6, 1, 1, 0.1, 0.5))[None]],
              "Scores": [uniform(28, 0, 1, 1, 3, 6)]},
             {"score_threshold": 0.1, "nms_top_k": 6, "keep_top_k": 8,
              "nms_threshold": 0.4, "background_label": 0}, grad=False),
        Case("locality_aware_nms", "locality_aware_nms",
             {"BBoxes": [east],
              "Scores": [uniform(29, 0.2, 1, 1, 1, 8)]},
             {"nms_threshold": 0.3, "score_threshold": 0.25}, grad=False),
        # a hit, a duplicate, a miss, the difficult box and a stray
        Case("detection_map", "detection_map",
             {"DetectRes": [dets], "Label": [label]},
             {"overlap_threshold": 0.5}, grad=False),
        Case("detection_map_11point", "detection_map",
             {"DetectRes": [dets], "Label": [label]},
             {"overlap_threshold": 0.3, "ap_type": "11point"}, grad=False),
        # an axis-aligned, a rotated and a partly outside quad
        Case("roi_perspective_transform", "roi_perspective_transform",
             {"X": [f32(30, 1, 2, 10, 12)], "ROIs": [quads]},
             {"transformed_height": 4, "transformed_width": 5,
              "spatial_scale": 1.0}, grad=False),
        Case("retinanet_detection_output", "retinanet_detection_output",
             {"BBoxes": [f32(31, 1, 12, 4, scale=0.2),
                         f32(32, 1, 4, 4, scale=0.2)],
              "Scores": [uniform(33, 0, 1, 1, 12, 3),
                         uniform(34, 0, 1, 1, 4, 3)],
              "Anchors": retina_anchors,
              "ImInfo": [np.asarray([[64, 96, 1]], np.float32)]},
             {"score_threshold": 0.3, "nms_top_k": 10, "keep_top_k": 9,
              "nms_threshold": 0.3}, grad=False, tol=DECODE),
    ]


RCNN_CASES = _rcnn_cases()
RCNN_TYPES = frozenset(c.op for c in RCNN_CASES)


# ------------------------------------------------------ Faster R-CNN
# PaddleDetection (release/0.x) configs/faster_rcnn_r50_1x.yml, the
# two-stage baseline: ResNet-50 to res4 (stride 16, 1024 channels,
# affine_channel norms frozen, the stem and res2 frozen: freeze_at 2),
# an RPN head (3x3 conv of 1024 and ReLU, 1x1 convs to 15 scores and 60
# deltas) over anchors of sizes 32-512 and ratios 0.5, 1, 2 (stride 16,
# variances 1), rpn_target_assign (256 anchors, fg 0.5, 0.7 / 0.3,
# straddle 0), training proposals (pre-NMS 12,000, post 2,000, NMS 0.7,
# min size 0), generate_proposal_labels (512 RoIs, fg 0.25, fg 0.5, bg
# 0.0-0.5, 81 classes), RoIAlign 14x14 (sampling ratio 0, scale 1/16),
# the res5 stage on the RoIs (stride 2, 2048 channels), a 7x7 average
# pool, fc 81 (softmax) and fc 324 (bbox); the RPN losses sigmoid
# cross-entropy and smooth L1 (sigma 3), the R-CNN losses softmax
# cross-entropy and smooth L1 with the inside and outside weights;
# Momentum 0.9 with L2 1e-4 at the warm-up's first rate, 0.01 / 3; one
# image a card at 800 x 1333 (ResizeImage target 800, max 1333). Test
# settings: proposals pre 6,000, post 1,000, NMS 0.7; MultiClassNMS score
# 0.05, keep 100, NMS 0.5.
FRCNN = dict(
    depth=(3, 4, 6), width=64, stem=64, res5_blocks=3, image=(800, 1333),
    classes=81, anchor_sizes=(32.0, 64.0, 128.0, 256.0, 512.0),
    aspect_ratios=(0.5, 1.0, 2.0), stride=16.0,
    rpn_batch=256, rpn_fg=0.5, rpn_pos=0.7, rpn_neg=0.3, straddle=0.0,
    pre_nms=12000, post_nms=2000, rpn_nms=0.7, min_size=0.0,
    test_pre_nms=6000, test_post_nms=1000, test_rpn_nms=0.7,
    rois=512, fg_fraction=0.25, fg_thresh=0.5, bg_hi=0.5, bg_lo=0.0,
    reg_weights=(0.1, 0.1, 0.2, 0.2), roi_size=14, sampling_ratio=0,
    lr=0.01 / 3, momentum=0.9, l2=1e-4, nms_score=0.05, nms_keep=100,
    nms_thresh=0.5, gt_boxes=(3, 20), residual_scale=0.2, seed=1)
# test size: a block a stage, narrow widths, 64 x 96 images, small
# anchors, 32 anchors and 32 RoIs an image, 5 classes
FRCNN_TINY = dict(
    FRCNN, depth=(1, 1, 1), width=4, stem=8, res5_blocks=1, image=(64, 96),
    classes=5, anchor_sizes=(8.0, 16.0, 24.0, 32.0, 48.0), rpn_batch=32,
    pre_nms=200, post_nms=60, test_pre_nms=100, test_post_nms=30, rois=32,
    gt_boxes=(3, 6))

# the ops whose draws the program seeds (the builders pass no seed)
SAMPLING_OPS = ("rpn_target_assign", "generate_proposal_labels")


def _affine(api, x, channels, name, scale=1.0):
    """A frozen affine_channel (a folded BatchNorm): scale and bias made
    by the startup program and never trained."""
    st = api.static
    s = st.create_parameter([channels], "float32", name=name + "_scale",
                            default_initializer=api.Constant(scale))
    b = st.create_parameter([channels], "float32", name=name + "_offset",
                            default_initializer=api.Constant(0.0))
    s.stop_gradient = True
    b.stop_gradient = True
    return st.nn.affine_channel(x, s, b)


def _conv_affine(api, x, filters, size, stride, name, act=None, scale=1.0):
    nn = api.static.nn
    conv = nn.conv2d(x, num_filters=filters, filter_size=size, stride=stride,
                     padding=(size - 1) // 2, param_attr=name + "_weights",
                     bias_attr=False)
    bn = "bn_" + name if name == "conv1" else "bn" + name[3:]
    out = _affine(api, conv, filters, bn, scale)
    return nn.relu(out) if act == "relu" else out


def _bottleneck(api, x, filters, stride, name, cfg):
    """ResNet-b bottleneck (the stride on the 3x3 conv); the last
    affine scale is ``residual_scale``, the frozen statistics standing in
    for pretrained ones, so that random weights keep the residual stream
    in range over the depth."""
    nn = api.static.nn
    a = _conv_affine(api, x, filters, 1, 1, name + "_branch2a", "relu")
    b = _conv_affine(api, a, filters, 3, stride, name + "_branch2b", "relu")
    c = _conv_affine(api, b, filters * 4, 1, 1, name + "_branch2c",
                     scale=cfg["residual_scale"])
    if int(x.shape[1]) != filters * 4 or stride != 1:
        x = _conv_affine(api, x, filters * 4, 1, stride, name + "_branch1")
    return nn.elementwise_add(x, c, act="relu")


def _normal(api, name, std):
    return api.ParamAttr(name=name, initializer=api.Normal(0.0, std))


def _zero(api, name):
    return api.ParamAttr(name=name, initializer=api.Constant(0.0))


def _backbone(api, image, cfg):
    """ResNet-50 to res4: (res4, its channels)."""
    nn = api.static.nn
    x = _conv_affine(api, image, cfg["stem"], 7, 2, "conv1", "relu")
    x = nn.pool2d(x, pool_size=3, pool_stride=2, pool_padding=1,
                  pool_type="max")
    for stage, n in enumerate(cfg["depth"]):
        for i in range(n):
            x = _bottleneck(api, x, cfg["width"] * 2 ** stage,
                            2 if i == 0 and stage else 1,
                            f"res{stage + 2}{chr(97 + i)}", cfg)
        if stage + 2 <= 2:                       # freeze_at 2
            x.stop_gradient = True
    return x, cfg["width"] * 4 * 2 ** (len(cfg["depth"]) - 1)


def _rpn_head(api, feat, channels, cfg):
    nn = api.static.nn
    a = len(cfg["anchor_sizes"]) * len(cfg["aspect_ratios"])
    conv = nn.conv2d(feat, num_filters=channels, filter_size=3, padding=1,
                     act="relu", param_attr=_normal(api, "conv_rpn_w", 0.01),
                     bias_attr=_zero(api, "conv_rpn_b"))
    score = nn.conv2d(conv, num_filters=a, filter_size=1,
                      param_attr=_normal(api, "rpn_cls_logits_w", 0.01),
                      bias_attr=_zero(api, "rpn_cls_logits_b"))
    delta = nn.conv2d(conv, num_filters=4 * a, filter_size=1,
                      param_attr=_normal(api, "rpn_bbox_pred_w", 0.01),
                      bias_attr=_zero(api, "rpn_bbox_pred_b"))
    anchors, variances = api.det.anchor_generator(
        conv, list(cfg["anchor_sizes"]), list(cfg["aspect_ratios"]),
        variance=[1.0, 1.0, 1.0, 1.0], stride=[cfg["stride"]] * 2)
    return score, delta, anchors, variances


def _roi_head(api, feat, rois, channels, cfg):
    """RoIAlign, the res5 stage, the 7x7 average pool and the two fcs:
    (cls_score, bbox_pred). The RoI features' VarDesc gets its shape
    declared: a host-side op's outputs have none, in either package."""
    nn, st = api.static.nn, api.static
    size = cfg["roi_size"]
    pooled = api.det.roi_align(feat, rois, size, size, 1.0 / cfg["stride"],
                               cfg["sampling_ratio"])
    st.default_main_program().global_block().var(pooled.name).shape = \
        (-1, channels, size, size)
    x = pooled
    for i in range(cfg["res5_blocks"]):
        x = _bottleneck(api, x, cfg["width"] * 8, 2 if i == 0 else 1,
                        f"res5{chr(97 + i)}", cfg)
    x = nn.pool2d(x, pool_type="avg", global_pooling=True)
    cls = nn.fc(x, size=cfg["classes"], param_attr=_normal(
        api, "cls_score_w", 0.01), bias_attr=_zero(api, "cls_score_b"))
    box = nn.fc(x, size=4 * cfg["classes"], param_attr=_normal(
        api, "bbox_pred_w", 0.001), bias_attr=_zero(api, "bbox_pred_b"))
    return cls, box


def _weighted_smooth_l1(nn, x, y, weight, sigma):
    """Smooth L1 of ``weight * (x - y)`` times ``weight``, summed over a
    row: the inside and outside weights of the fluid loss, which are
    the same 0/1 mask in both of its uses here."""
    return nn.smooth_l1(nn.elementwise_mul(x, weight),
                        nn.elementwise_mul(y, weight), sigma=sigma)


def faster_rcnn_program(api, cfg, mode="train"):
    """The Faster R-CNN R50-C4 of ``cfg`` (:data:`FRCNN` or
    :data:`FRCNN_TINY`) built with ``api``, either package's static API
    (``pt``, ``static``, ``det`` = its ``static.detection``, ``ParamAttr``,
    ``Normal``, ``Constant``, ``Momentum``, ``L2Decay``; :func:`port_api`
    gives the port's). ``mode`` "train": the training program (losses,
    backward, Momentum with L2); "loss": its forward alone; "test": the
    forward with the test settings: proposals, the head, the box_coder
    decode of each RoI's best class, multiclass_nms and detection_map
    against the gt. The sampling ops' seeds are set after the build
    (their builders pass none). Returns (main, startup, {role: variable
    name})."""
    pt, st = api.pt, api.static
    nn = st.nn
    h, w = cfg["image"]
    train = mode != "test"
    main, startup = pt.Program(), pt.Program()
    names = {}
    with st.program_guard(main, startup):
        image = st.data("image", [1, 3, h, w], "float32")
        im_info = st.data("im_info", [1, 3], "float32")
        gt_box = st.data("gt_box", [-1, 4], "float32")
        gt_label = st.data("gt_label", [-1, 1], "int32")
        is_crowd = st.data("is_crowd", [-1, 1], "int32")
        feat, channels = _backbone(api, image, cfg)
        score, delta, anchors, variances = _rpn_head(api, feat, channels,
                                                     cfg)
        prob = nn.sigmoid(score)
        pre, post, thresh = (
            (cfg["pre_nms"], cfg["post_nms"], cfg["rpn_nms"]) if train else
            (cfg["test_pre_nms"], cfg["test_post_nms"], cfg["test_rpn_nms"]))
        rois, _ = nn.generate_proposals(
            prob, delta, im_info, anchors, variances, pre_nms_top_n=pre,
            post_nms_top_n=post, nms_thresh=thresh,
            min_size=cfg["min_size"])
        names.update(feat=feat.name, rpn_prob=prob.name,
                     rpn_delta=delta.name, anchors=anchors.name,
                     variances=variances.name, proposals=rois.name)
        if train:
            a_n = len(cfg["anchor_sizes"]) * len(cfg["aspect_ratios"])
            score_t = nn.reshape(nn.transpose(score, axis=[0, 2, 3, 1]),
                                 shape=[1, -1, 1])
            delta_t = nn.reshape(nn.transpose(delta, axis=[0, 2, 3, 1]),
                                 shape=[1, -1, 4])
            s_pred, l_pred, s_tgt, l_tgt, l_w = nn.rpn_target_assign(
                delta_t, score_t, nn.reshape(anchors, shape=[-1, 4]),
                nn.reshape(variances, shape=[-1, 4]), gt_box, is_crowd,
                im_info,
                rpn_batch_size_per_im=cfg["rpn_batch"],
                rpn_straddle_thresh=cfg["straddle"],
                rpn_fg_fraction=cfg["rpn_fg"],
                rpn_positive_overlap=cfg["rpn_pos"],
                rpn_negative_overlap=cfg["rpn_neg"])
            s_tgt_f = nn.cast(s_tgt, out_dtype="float32")
            s_tgt_f.stop_gradient = True
            rpn_cls = nn.reduce_mean(
                nn.sigmoid_cross_entropy_with_logits(s_pred, s_tgt_f))
            # the count of sampled anchors (PaddleDetection takes the
            # product of shape(score_tgt); the fluid shape builder writes
            # slot X where the shape op reads Input, in both packages)
            norm = nn.reduce_sum(nn.ones_like(s_tgt_f))
            norm.stop_gradient = True
            rpn_reg = nn.elementwise_div(nn.reduce_sum(_weighted_smooth_l1(
                nn, l_pred, l_tgt, l_w, 3.0)), norm)
            r_rois, labels, tgts, w_in, _ = nn.generate_proposal_labels(
                rois, gt_label, is_crowd, gt_box, im_info,
                batch_size_per_im=cfg["rois"],
                fg_fraction=cfg["fg_fraction"], fg_thresh=cfg["fg_thresh"],
                bg_thresh_hi=cfg["bg_hi"], bg_thresh_lo=cfg["bg_lo"],
                bbox_reg_weights=list(cfg["reg_weights"]),
                class_nums=cfg["classes"])
            cls, box = _roi_head(api, feat, r_rois, channels, cfg)
            label64 = nn.reshape(nn.cast(labels, out_dtype="int64"),
                                 shape=[-1, 1])
            label64.stop_gradient = True
            rcnn_cls = nn.reduce_mean(nn.softmax_with_cross_entropy(
                cls, label64))
            rcnn_reg = nn.reduce_mean(_weighted_smooth_l1(
                nn, box, tgts, w_in, 1.0))
            loss = nn.sum([rpn_cls, rpn_reg, rcnn_cls, rcnn_reg])
            if mode == "train":
                api.Momentum(
                    learning_rate=cfg["lr"], momentum=cfg["momentum"],
                    regularization=api.L2Decay(cfg["l2"])).minimize(loss)
            names.update(loss=loss.name, rpn_cls=rpn_cls.name,
                         rpn_reg=rpn_reg.name, rcnn_cls=rcnn_cls.name,
                         rcnn_reg=rcnn_reg.name, rois=r_rois.name,
                         labels=labels.name, targets=tgts.name,
                         score_target=s_tgt.name, loc_target=l_tgt.name)
        else:
            cls, box = _roi_head(api, feat, rois, channels, cfg)
            prob_c = nn.softmax(cls)
            decoded = api.det.box_coder(
                rois, list(cfg["reg_weights"]),
                nn.reshape(box, shape=[-1, cfg["classes"], 4]),
                "decode_center_size", box_normalized=False, axis=1)
            clipped = api.det.box_clip(decoded, im_info)
            best = nn.one_hot(nn.argmax(prob_c, axis=1),
                              depth=cfg["classes"])
            boxes = nn.reduce_sum(nn.elementwise_mul(
                clipped, nn.unsqueeze(best, axes=[2])), dim=[1])
            dets, num = api.det.multiclass_nms(
                nn.unsqueeze(boxes, axes=[0]),
                nn.unsqueeze(nn.transpose(prob_c, axis=[1, 0]), axes=[0]),
                cfg["nms_score"], -1, cfg["nms_keep"], cfg["nms_thresh"],
                normalized=False)
            gt_rows = nn.concat([nn.cast(gt_label, out_dtype="float32"),
                                 gt_box], axis=1)
            mean_ap = nn.detection_map(nn.reshape(dets, shape=[-1, 6]),
                                       gt_rows)
            names.update(dets=dets.name, num=num.name, map=mean_ap[0].name,
                         cls_prob=prob_c.name)
    for op in main.global_block().ops:
        if op.type in SAMPLING_OPS:
            op.attrs["seed"] = cfg["seed"]
    return main, startup, names


def conv_flops(program, rois):
    """Forward FLOPs (two a multiply-add) of the program's convolutions,
    a RoI batch (-1) counted as ``rois``: (backbone and RPN, RoI head)."""
    block = program.global_block()
    out = [0, 0]
    for op in block.ops:
        if op.type == "conv2d":
            w = block.vars[op.inputs["Filter"][0]].shape
            o = block.vars[op.outputs["Output"][0]].shape
            n = rois if o[0] == -1 else o[0]
            out[o[0] == -1] += 2 * n * o[1] * o[2] * o[3] * w[1] * w[2] * w[3]
    return tuple(out)


def port_api():
    """The port's static API as :func:`faster_rcnn_program` takes it."""
    import sys
    import types
    from .. import static
    from ..nn import ParamAttr
    from ..nn.initializer import Constant, Normal
    from ..optimizer import L2Decay, Momentum
    from ..static import detection
    return types.SimpleNamespace(
        pt=sys.modules[__name__.split(".")[0]], static=static, det=detection,
        ParamAttr=ParamAttr, Normal=Normal, Constant=Constant,
        Momentum=Momentum, L2Decay=L2Decay)


def frcnn_feed(cfg, seed):
    """One seeded synthetic image (a normalized image's scale) with
    ``gt_boxes`` = (lo, hi) gt boxes, 4-50% of each side, and classes
    1 .. classes - 1, none crowded: the feed of either program."""
    rs = _rs(seed)
    h, w = cfg["image"]
    g = rs.randint(cfg["gt_boxes"][0], cfg["gt_boxes"][1] + 1)
    bw = rs.uniform(0.04, 0.5, g) * w
    bh = rs.uniform(0.04, 0.5, g) * h
    x1 = rs.uniform(0, w - bw)
    y1 = rs.uniform(0, h - bh)
    return {"image": rs.randn(1, 3, h, w).astype(np.float32),
            "im_info": np.asarray([[h, w, 1.0]], np.float32),
            "gt_box": np.stack([x1, y1, x1 + bw - 1, y1 + bh - 1],
                               1).astype(np.float32),
            "gt_label": rs.randint(1, cfg["classes"], (g, 1)).astype(
                np.int32),
            "is_crowd": np.zeros((g, 1), np.int32)}
