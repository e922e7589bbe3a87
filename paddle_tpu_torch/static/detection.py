"""Static-graph detection layer builders: the fluid
``layers/detection.py`` surface (ref:
python/paddle/fluid/layers/detection.py: yolo_box :1010, prior_box
:1715, box_coder :621, multiclass_nms :2390, matrix_nms, iou_similarity
:573, bipartite_match :1102, roi_align via layers/nn.py, box_clip
:2277, anchor_generator :1850, density_prior_box :1815).

Port of ``paddle_tpu/static/detection.py``, builder for builder: each
appends one registered detection op (``ops/detection_ops.py``) to the
current block, and ``static._op`` infers its outputs' shapes from the
op's compute on ``meta`` tensors (or its ``infer_meta`` rule)."""
from __future__ import annotations

from typing import List, Optional, Sequence


def _front():
    from . import _new_tmp, _op
    return _new_tmp, _op


def yolo_box(x, img_size, anchors: Sequence[int], class_num: int,
             conf_thresh: float, downsample_ratio: int,
             clip_bbox: bool = True, scale_x_y: float = 1.0, name=None):
    _new_tmp, _op = _front()
    boxes = _new_tmp(x.block, name or "yolo_boxes")
    scores = _new_tmp(x.block, name or "yolo_scores")
    _op(x.block, "yolo_box",
        {"X": [x.name], "ImgSize": [img_size.name]},
        {"Boxes": [boxes.name], "Scores": [scores.name]},
        {"anchors": list(anchors), "class_num": int(class_num),
         "conf_thresh": float(conf_thresh),
         "downsample_ratio": int(downsample_ratio),
         "clip_bbox": bool(clip_bbox), "scale_x_y": float(scale_x_y)})
    return boxes, scores


def prior_box(input, image, min_sizes, max_sizes=None, aspect_ratios=(1.0,),
              variance=(0.1, 0.1, 0.2, 0.2), flip=False, clip=False,
              steps=(0.0, 0.0), offset=0.5,
              min_max_aspect_ratios_order=False, name=None):
    _new_tmp, _op = _front()
    boxes = _new_tmp(input.block, name or "prior_boxes")
    var = _new_tmp(input.block, name or "prior_vars")
    _op(input.block, "prior_box",
        {"Input": [input.name], "Image": [image.name]},
        {"Boxes": [boxes.name], "Variances": [var.name]},
        {"min_sizes": [float(s) for s in min_sizes],
         "max_sizes": [float(s) for s in (max_sizes or [])],
         "aspect_ratios": [float(a) for a in aspect_ratios],
         "variances": [float(v) for v in variance],
         "flip": bool(flip), "clip": bool(clip),
         "step_w": float(steps[0]), "step_h": float(steps[1]),
         "offset": float(offset),
         "min_max_aspect_ratios_order": bool(min_max_aspect_ratios_order)})
    return boxes, var


def density_prior_box(input, image, densities, fixed_sizes, fixed_ratios,
                      variance=(0.1, 0.1, 0.2, 0.2), clip=False,
                      steps=(0.0, 0.0), offset=0.5, name=None):
    _new_tmp, _op = _front()
    boxes = _new_tmp(input.block, name or "dprior_boxes")
    var = _new_tmp(input.block, name or "dprior_vars")
    _op(input.block, "density_prior_box",
        {"Input": [input.name], "Image": [image.name]},
        {"Boxes": [boxes.name], "Variances": [var.name]},
        {"densities": [int(d) for d in densities],
         "fixed_sizes": [float(s) for s in fixed_sizes],
         "fixed_ratios": [float(r) for r in fixed_ratios],
         "variances": [float(v) for v in variance], "clip": bool(clip),
         "step_w": float(steps[0]), "step_h": float(steps[1]),
         "offset": float(offset)})
    return boxes, var


def anchor_generator(input, anchor_sizes, aspect_ratios,
                     variance=(0.1, 0.1, 0.2, 0.2), stride=(16.0, 16.0),
                     offset=0.5, name=None):
    _new_tmp, _op = _front()
    anchors = _new_tmp(input.block, name or "anchors")
    var = _new_tmp(input.block, name or "anchor_vars")
    _op(input.block, "anchor_generator", {"Input": [input.name]},
        {"Anchors": [anchors.name], "Variances": [var.name]},
        {"anchor_sizes": [float(s) for s in anchor_sizes],
         "aspect_ratios": [float(a) for a in aspect_ratios],
         "variances": [float(v) for v in variance],
         "stride": [float(s) for s in stride], "offset": float(offset)})
    return anchors, var


def box_coder(prior_box, prior_box_var, target_box,
              code_type="encode_center_size", box_normalized=True,
              axis=0, name=None):
    _new_tmp, _op = _front()
    out = _new_tmp(target_box.block, name or "box_coder")
    inputs = {"PriorBox": [prior_box.name], "TargetBox": [target_box.name]}
    attrs = {"code_type": code_type, "box_normalized": bool(box_normalized),
             "axis": int(axis)}
    if prior_box_var is not None:
        if isinstance(prior_box_var, (list, tuple)):
            attrs["variance"] = [float(v) for v in prior_box_var]
        else:
            inputs["PriorBoxVar"] = [prior_box_var.name]
    _op(target_box.block, "box_coder", inputs,
        {"OutputBox": [out.name]}, attrs)
    return out


def iou_similarity(x, y, box_normalized=True, name=None):
    _new_tmp, _op = _front()
    out = _new_tmp(x.block, name or "iou")
    _op(x.block, "iou_similarity", {"X": [x.name], "Y": [y.name]},
        {"Out": [out.name]}, {"box_normalized": bool(box_normalized)})
    return out


def box_clip(input, im_info, name=None):
    _new_tmp, _op = _front()
    out = _new_tmp(input.block, name or "box_clip")
    _op(input.block, "box_clip",
        {"Input": [input.name], "ImInfo": [im_info.name]},
        {"Output": [out.name]}, {})
    return out


def bipartite_match(dist_matrix, match_type="bipartite",
                    dist_threshold=0.5, name=None):
    _new_tmp, _op = _front()
    idx = _new_tmp(dist_matrix.block, name or "match_idx")
    dist = _new_tmp(dist_matrix.block, name or "match_dist")
    _op(dist_matrix.block, "bipartite_match",
        {"DistMat": [dist_matrix.name]},
        {"ColToRowMatchIndices": [idx.name],
         "ColToRowMatchDist": [dist.name]},
        {"match_type": match_type, "dist_threshold": float(dist_threshold)})
    return idx, dist


def roi_align(input, rois, pooled_height=1, pooled_width=1,
              spatial_scale=1.0, sampling_ratio=-1, rois_num=None,
              name=None):
    _new_tmp, _op = _front()
    out = _new_tmp(input.block, name or "roi_align")
    inputs = {"X": [input.name], "ROIs": [rois.name]}
    if rois_num is not None:
        inputs["RoisNum"] = [rois_num.name]
    _op(input.block, "roi_align", inputs, {"Out": [out.name]},
        {"pooled_height": int(pooled_height),
         "pooled_width": int(pooled_width),
         "spatial_scale": float(spatial_scale),
         "sampling_ratio": int(sampling_ratio)})
    return out


def multiclass_nms(bboxes, scores, score_threshold, nms_top_k, keep_top_k,
                   nms_threshold=0.3, normalized=True, nms_eta=1.0,
                   background_label=0, name=None,
                   return_index=False):
    """Fixed-shape NMS: Out [N, keep_top_k, 6] padded with -1 plus
    NmsedNum [N] (design departure from the reference's LoD output —
    see ops/detection_ops.py)."""
    _new_tmp, _op = _front()
    out = _new_tmp(bboxes.block, name or "nms_out")
    num = _new_tmp(bboxes.block, name or "nms_num")
    idx = _new_tmp(bboxes.block, name or "nms_idx")
    _op(bboxes.block, "multiclass_nms",
        {"BBoxes": [bboxes.name], "Scores": [scores.name]},
        {"Out": [out.name], "Index": [idx.name], "NmsedNum": [num.name]},
        {"score_threshold": float(score_threshold),
         "nms_top_k": int(nms_top_k), "keep_top_k": int(keep_top_k),
         "nms_threshold": float(nms_threshold),
         "normalized": bool(normalized), "nms_eta": float(nms_eta),
         "background_label": int(background_label)})
    if return_index:
        return out, idx, num
    return out, num


def matrix_nms(bboxes, scores, score_threshold, post_threshold,
               nms_top_k, keep_top_k, use_gaussian=False,
               gaussian_sigma=2.0, background_label=0, normalized=True,
               name=None):
    _new_tmp, _op = _front()
    out = _new_tmp(bboxes.block, name or "mnms_out")
    idx = _new_tmp(bboxes.block, name or "mnms_idx")
    num = _new_tmp(bboxes.block, name or "mnms_num")
    _op(bboxes.block, "matrix_nms",
        {"BBoxes": [bboxes.name], "Scores": [scores.name]},
        {"Out": [out.name], "Index": [idx.name], "RoisNum": [num.name]},
        {"score_threshold": float(score_threshold),
         "post_threshold": float(post_threshold),
         "nms_top_k": int(nms_top_k), "keep_top_k": int(keep_top_k),
         "use_gaussian": bool(use_gaussian),
         "gaussian_sigma": float(gaussian_sigma),
         "background_label": int(background_label),
         "normalized": bool(normalized)})
    return out, idx
