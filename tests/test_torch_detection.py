"""The port's detection ops (``paddle_tpu_torch/ops/detection_ops.py``)
and the ops YOLOv3 adds (leaky_relu, concat, transpose2, interpolate)
against the JAX package's, from the same numpy inputs.

Each registered op is run through both packages' ``OpInfoMap`` (the
port on the CPU); the shapes are those of ``tests/test_detection_ops.py``
and ``tests/test_yolov3_loss.py``, plus yolo_box at YOLOv3-416's
stride-32 head (13x13, 255 channels) and multiclass_nms at larger and
saturated inputs.

Tolerances, each beside what it reads on this CPU (the JAX op jitted,
as the bench runs it, apart from ``EAGER``):
- Ops whose float32 arithmetic is the same op for op in both packages
  (prior_box, anchor_generator, density_prior_box, box_clip,
  iou_similarity, transpose2, concat, leaky_relu, nearest interpolate,
  bipartite_match): exact; read 0.
- yolo_box: boxes (pixels, up to 416) rtol 1e-6 / atol 1e-4, scores
  rtol / atol 1e-6 (exp and sigmoid differ in the last bit between XLA
  and torch: boxes read 6.1e-5 absolute at the 416 head, 3.1e-5 on the
  saturated one, scores 1.2e-7); box_coder and matrix_nms's decayed
  scores rtol / atol 1e-6 (read 9.5e-7 and 6.0e-8).
- roi_align, bilinear / bicubic interpolate (sums in another order):
  rtol / atol 1e-5 (read 5.1e-7 and 2.4e-7 absolute).
- multiclass_nms: ``Index`` and ``NmsedNum`` exact, rows within 1e-6
  (gathered inputs: read 0), on random boxes, with nms_eta < 1, with
  padding, and on the saturated tie case; matrix_nms likewise.
- yolov3_loss: loss rtol 1e-6 (reads 1.0e-7), ObjectnessMask and
  GTMatchMask exact, the gradient of the summed loss with respect to X
  (torch autograd against ``jax.grad``) rtol / atol 1e-6 (reads 6.0e-8).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpt
from paddle_tpu.core.registry import OpInfoMap as JaxOpInfoMap
from paddle_tpu.nn import functional as JF

import chip_smoke
import paddle_tpu_torch as tpt
from paddle_tpu_torch.core.registry import OpInfoMap
from paddle_tpu_torch.nn import functional as F

EXACT = dict(rtol=0, atol=0)
YOLO_TOL = {"Boxes": dict(rtol=1e-6, atol=1e-4),
            "Scores": dict(rtol=1e-6, atol=1e-6)}
TRANSCENDENTAL_TOL = dict(rtol=1e-6, atol=1e-6)
SUM_ORDER_TOL = dict(rtol=1e-5, atol=1e-5)
ROW_TOL = dict(rtol=1e-6, atol=1e-6)
LOSS_RTOL = 1e-6
GRAD_TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(autouse=True)
def _cpu():
    tpt.set_device("cpu")


# run eagerly: concat reads its AxisTensor on the host, and under jit
# XLA turns the prior generators' division by the image size into a
# product with its reciprocal (1 ulp on 45 of 288 prior_box values)
EAGER = ("concat", "prior_box", "density_prior_box")


def jax_op(op_type, inputs, attrs):
    """The JAX op, jitted as one program (one compile, where eager
    dispatch compiles each of its jnp operations) unless in EAGER."""
    opdef = JaxOpInfoMap.instance().get(op_type)
    raw = {s: [jnp.asarray(v) for v in vs] for s, vs in inputs.items()}
    run = (lambda r: opdef.compute(r, attrs))
    if op_type not in EAGER:
        run = jax.jit(run)
    return {s: [np.asarray(v) for v in vs] for s, vs in run(raw).items()}


def port_op(op_type, inputs, attrs):
    opdef = OpInfoMap.instance().get(op_type)
    raw = {s: [torch.from_numpy(np.array(v)) for v in vs]
           for s, vs in inputs.items()}
    return {s: [v.detach().numpy() for v in vs]
            for s, vs in opdef.compute(raw, attrs).items()}


def both(op_type, inputs, attrs, slots, tol=EXACT):
    want = jax_op(op_type, inputs, attrs)
    got = port_op(op_type, inputs, attrs)
    for slot in slots:
        g, w = got[slot][0], want[slot][0]
        assert g.shape == w.shape, (slot, g.shape, w.shape)
        np.testing.assert_allclose(g, w, err_msg=slot,
                                   **(tol[slot] if slot in tol else tol))
    return got, want


# ------------------------------------------------- leaky_relu / concat / ...
@pytest.mark.parametrize("alpha", [None, 0.1])
def test_leaky_relu(alpha):
    x = np.random.RandomState(0).randn(3, 5, 4).astype(np.float32)
    x[0, 0, :2] = 0.0
    attrs = {} if alpha is None else {"alpha": alpha}
    both("leaky_relu", {"X": [x]}, attrs, ["Out"])
    got = tpt.nn.LeakyReLU(0.1)(torch.from_numpy(x)).numpy()
    want = np.asarray(JF.leaky_relu(jpt.to_tensor(x), 0.1)._jax_value())
    np.testing.assert_array_equal(got, want)


def test_concat_and_axis_tensor():
    rs = np.random.RandomState(1)
    xs = [rs.randn(2, c, 3).astype(np.float32) for c in (1, 4, 2)]
    both("concat", {"X": xs}, {"axis": 1}, ["Out"])
    both("concat", {"X": xs}, {"axis": -2}, ["Out"])
    both("concat", {"X": xs, "AxisTensor": [np.array(1, np.int32)]},
         {"axis": 0}, ["Out"])


def test_transpose2():
    x = np.random.RandomState(2).randn(2, 3, 5).astype(np.float32)
    got, want = both("transpose2", {"X": [x]}, {"axis": [0, 2, 1]},
                     ["Out", "XShape"])
    assert got["XShape"][0].shape == (0, 2, 3, 5)


@pytest.mark.parametrize("mode,size,factor", [
    ("nearest", None, 2),             # the YOLOv3 neck's upsample
    ("nearest", None, 2.5),           # non-integer factor
    ("nearest", (25, 7), None),       # 4 -> 25 (torch's nearest-exact differs)
    ("nearest", (3, 2), None),        # downsampling
    ("bilinear", None, 2),
    ("bilinear", None, 1.5),
    ("bilinear", (3, 2), None),       # antialiased downsampling
    ("bicubic", None, 2),
    ("bicubic", (6, 11), None),
])
def test_interpolate(mode, size, factor):
    x = np.random.RandomState(3).randn(2, 3, 4, 5).astype(np.float32)
    want = np.asarray(JF.interpolate(jpt.to_tensor(x), size=size,
                                     scale_factor=factor,
                                     mode=mode)._jax_value())
    got = F.interpolate(torch.from_numpy(x), size=size, scale_factor=factor,
                        mode=mode).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(
        got, want, **(EXACT if mode == "nearest" else SUM_ORDER_TOL))


# ---------------------------------------------------------------- yolo_box
def _yolo_attrs(anchors, c, conf, down, clip=True, scale=1.0):
    return {"anchors": anchors, "class_num": c, "conf_thresh": conf,
            "downsample_ratio": down, "clip_bbox": clip, "scale_x_y": scale}


YOLO_CASES = {
    # tests/test_detection_ops.py's two cases
    "test_shape": (0, (2, 2, 3, 4, 4), [10, 13, 16, 30], 0.3, 32, True, 1.0,
                   [[416, 416], [320, 480]], 1.0),
    "scale_xy": (1, (1, 2, 2, 2, 2), [6, 8, 10, 12], 0.0, 16, False, 1.2,
                 [[128, 128]], 1.0),
    # YOLOv3-416's stride-32 head: 3 anchors x (5 + 80) channels, 13x13
    "head416": (2, (1, 3, 80, 13, 13), [116, 90, 156, 198, 373, 326], 0.005,
                32, True, 1.0, [[416, 416]], 3.0),
    # saturated logits as at random weights: exp(tw) overflows to inf
    "saturated": (3, (1, 3, 80, 13, 13), [116, 90, 156, 198, 373, 326],
                  0.005, 32, True, 1.0, [[416, 416]], 4e4),
}


@pytest.mark.parametrize("case", sorted(YOLO_CASES))
def test_yolo_box(case):
    seed, (n, an, c, h, w), anchors, conf, down, clip, scale, img, mul = \
        YOLO_CASES[case]
    x = (np.random.RandomState(seed).randn(n, an * (5 + c), h, w)
         * mul).astype(np.float32)
    got, _ = both("yolo_box", {"X": [x], "ImgSize": [np.array(img, np.int32)]},
                  _yolo_attrs(anchors, c, conf, down, clip, scale),
                  ["Boxes", "Scores"], YOLO_TOL)
    assert np.isfinite(got["Boxes"][0]).all()


# ------------------------------------------------- prior / anchor generators
@pytest.mark.parametrize("mm_order", [False, True])
def test_prior_box(mm_order):
    feat = np.zeros((1, 8, 3, 2), np.float32)
    image = np.zeros((1, 3, 32, 24), np.float32)
    attrs = {"min_sizes": [4.0, 6.0], "max_sizes": [8.0, 9.0],
             "aspect_ratios": [2.0, 3.0], "flip": True, "clip": True,
             "variances": [0.1, 0.1, 0.2, 0.2], "offset": 0.5,
             "min_max_aspect_ratios_order": mm_order}
    both("prior_box", {"Input": [feat], "Image": [image]}, attrs,
         ["Boxes", "Variances"])


def test_anchor_generator():
    feat = np.zeros((1, 8, 3, 4), np.float32)
    both("anchor_generator", {"Input": [feat]},
         {"anchor_sizes": [32.0, 64.0], "aspect_ratios": [0.5, 1.0, 2.0],
          "stride": [16.0, 16.0], "offset": 0.5,
          "variances": [0.1, 0.1, 0.2, 0.2]}, ["Anchors", "Variances"])


def test_density_prior_box():
    feat = np.zeros((1, 8, 2, 3), np.float32)
    image = np.zeros((1, 3, 16, 24), np.float32)
    both("density_prior_box", {"Input": [feat], "Image": [image]},
         {"fixed_sizes": [4.0, 8.0], "fixed_ratios": [1.0, 2.0],
          "densities": [2, 1], "clip": True, "offset": 0.5},
         ["Boxes", "Variances"])


# ---------------------------------------------------------------- box_coder
def _boxes(rs, n):
    b = np.abs(rs.rand(n, 4).astype(np.float32))
    b[:, 2:] += b[:, :2] + 0.1
    return b


@pytest.mark.parametrize("normalized", [True, False])
def test_box_coder_encode_decode(normalized):
    rs = np.random.RandomState(2)
    prior, target = _boxes(rs, 5), _boxes(rs, 3)
    var = [0.1, 0.1, 0.2, 0.2]
    got, _ = both("box_coder", {"PriorBox": [prior], "TargetBox": [target]},
                  {"code_type": "encode_center_size",
                   "box_normalized": normalized, "variance": var},
                  ["OutputBox"], TRANSCENDENTAL_TOL)
    for axis in (0, 1):
        t = got["OutputBox"][0] if axis == 0 else \
            np.ascontiguousarray(got["OutputBox"][0].transpose(1, 0, 2))
        both("box_coder", {"PriorBox": [prior], "TargetBox": [t]},
             {"code_type": "decode_center_size",
              "box_normalized": normalized, "axis": axis, "variance": var},
             ["OutputBox"], TRANSCENDENTAL_TOL)


def test_box_coder_prior_var_tensor():
    rs = np.random.RandomState(3)
    prior = _boxes(rs, 4)
    pvar = rs.rand(4, 4).astype(np.float32) + 0.1
    t = rs.randn(2, 4).astype(np.float32) * 0.2
    both("box_coder", {"PriorBox": [prior], "PriorBoxVar": [pvar],
                       "TargetBox": [t]},
         {"code_type": "decode_center_size", "box_normalized": True,
          "axis": 0}, ["OutputBox"], TRANSCENDENTAL_TOL)


# --------------------------------------------------------- iou / box_clip
@pytest.mark.parametrize("normalized", [True, False])
def test_iou_similarity(normalized):
    rs = np.random.RandomState(4)
    x, y = _boxes(rs, 6) * 10, _boxes(rs, 5) * 10
    x[0] = y[0]                                  # an exact match
    x[1] = [3, 3, 2, 2]                          # an inverted box
    both("iou_similarity", {"X": [x], "Y": [y]},
         {"box_normalized": normalized}, ["Out"])


def test_box_clip():
    rs = np.random.RandomState(5)
    boxes = (rs.randn(2, 6, 4) * 60 + 20).astype(np.float32)
    im_info = np.array([[64.0, 48.0, 1.0], [100.0, 81.0, 2.0]], np.float32)
    both("box_clip", {"Input": [boxes], "ImInfo": [im_info]}, {}, ["Output"])
    both("box_clip", {"Input": [boxes[0]], "ImInfo": [im_info[:1]]}, {},
         ["Output"])


# ------------------------------------------------------------- roi_align
@pytest.mark.parametrize("aligned,sampling", [(False, 2), (True, -1),
                                              (False, 3)])
def test_roi_align(aligned, sampling):
    rs = np.random.RandomState(3)
    x = rs.randn(2, 3, 8, 8).astype(np.float32)
    rois = np.array([[0.0, 0.0, 7.0, 7.0], [2.0, 2.0, 6.0, 6.0],
                     [1.0, 0.0, 5.0, 7.0], [-3.0, 5.0, 12.0, 9.5]],
                    np.float32)
    both("roi_align", {"X": [x], "ROIs": [rois],
                       "RoisNum": [np.array([2, 2], np.int32)]},
         {"pooled_height": 2, "pooled_width": 3, "spatial_scale": 0.8,
          "sampling_ratio": sampling, "aligned": aligned}, ["Out"],
         SUM_ORDER_TOL)


# -------------------------------------------------------- bipartite_match
@pytest.mark.parametrize("match_type,shape", [("bipartite", (4, 6)),
                                              ("per_prediction", (5, 3)),
                                              ("per_prediction", (3, 7))])
def test_bipartite_match(match_type, shape):
    dist = np.random.RandomState(4).rand(*shape).astype(np.float32)
    dist[0, 1] = dist[1, 0] = dist.max()         # a tie for the first pick
    both("bipartite_match", {"DistMat": [dist]},
         {"match_type": match_type, "dist_threshold": 0.3},
         ["ColToRowMatchIndices", "ColToRowMatchDist"])


# -------------------------------------------------------- multiclass_nms
def _random_boxes(rs, n, m, extent, size):
    centers = rs.rand(n, m, 2) * extent
    wh = rs.rand(n, m, 2) * size + 1
    return np.concatenate([centers - wh / 2, centers + wh / 2],
                          axis=-1).astype(np.float32)


NMS_CASES = {
    # tests/test_detection_ops.py's case
    "test_shape": dict(seed=5, n=1, m=12, c=3, extent=10, size=2,
                       attrs={"background_label": 0, "score_threshold": 0.3,
                              "nms_threshold": 0.4, "nms_top_k": 10,
                              "keep_top_k": 8, "normalized": True}),
    # YOLOv3's attributes (pixel boxes, no background class)
    "yolo_attrs": dict(seed=6, n=2, m=300, c=8, extent=100, size=30,
                       attrs={"background_label": -1, "score_threshold": 0.005,
                              "nms_threshold": 0.45, "nms_top_k": 100,
                              "keep_top_k": 50, "normalized": False}),
    "eta": dict(seed=7, n=2, m=120, c=4, extent=40, size=20,
                attrs={"background_label": 1, "score_threshold": 0.1,
                       "nms_threshold": 0.7, "nms_top_k": 60,
                       "keep_top_k": 30, "nms_eta": 0.9,
                       "normalized": True}),
    # keep_top_k beyond C * k pads; nms_top_k -1 keeps every box
    "pad": dict(seed=8, n=2, m=7, c=2, extent=10, size=5,
                attrs={"background_label": -1, "score_threshold": 0.2,
                       "nms_threshold": 0.3, "nms_top_k": -1,
                       "keep_top_k": 20, "normalized": False}),
    # why this case exists: at bench.py's seed-0 weights and initial BN
    # statistics YOLOv3's heads saturate and every kept row scores exactly
    # 1.0, so the output is decided by tie order alone
    # (chip_smoke.saturated_nms_inputs)
    "saturated": dict(seed=9, n=2, m=400, c=12, saturated=True,
                      attrs={"background_label": -1,
                             "score_threshold": 0.005, "nms_threshold": 0.45,
                             "nms_top_k": 100, "keep_top_k": 100,
                             "normalized": False}),
}


def _nms_inputs(case):
    cfg = NMS_CASES[case]
    rs = np.random.RandomState(cfg["seed"])
    if cfg.get("saturated"):
        return tuple(t.numpy() for t in chip_smoke.saturated_nms_inputs(
            rs, cfg["n"], cfg["m"], cfg["c"]))
    boxes = _random_boxes(rs, cfg["n"], cfg["m"], cfg["extent"], cfg["size"])
    return boxes, rs.rand(cfg["n"], cfg["c"], cfg["m"]).astype(np.float32)


@pytest.mark.parametrize("case", sorted(NMS_CASES))
def test_multiclass_nms(case):
    boxes, scores = _nms_inputs(case)
    got, want = both("multiclass_nms", {"BBoxes": [boxes], "Scores": [scores]},
                     NMS_CASES[case]["attrs"], ["Index", "NmsedNum", "Out"],
                     {"Index": EXACT, "NmsedNum": EXACT, "Out": ROW_TOL})
    assert got["NmsedNum"][0].min() > 0


@pytest.mark.parametrize("gaussian", [False, True])
def test_matrix_nms(gaussian):
    rs = np.random.RandomState(10)
    boxes = _random_boxes(rs, 2, 40, 1.0, 0.3) * 0.5
    boxes[:, 1] = boxes[:, 0]                    # an exact duplicate
    scores = rs.rand(2, 3, 40).astype(np.float32)
    both("matrix_nms", {"BBoxes": [boxes], "Scores": [scores]},
         {"background_label": 0, "score_threshold": 0.1,
          "post_threshold": 0.05, "nms_top_k": 30, "keep_top_k": 25,
          "use_gaussian": gaussian, "gaussian_sigma": 2.0,
          "normalized": True},
         ["Index", "RoisNum", "Out"],
         {"Index": EXACT, "RoisNum": EXACT, "Out": TRANSCENDENTAL_TOL})


# ---------------------------------------------------------------- yolov3_loss
def _loss_inputs(dtype, mixup):
    rs = np.random.RandomState(0)
    n, h, w, c = 2, 4, 4, 3
    x = (rs.randn(n, 3 * (5 + c), h, w) * 0.5).astype(dtype)
    gt = np.zeros((n, 3, 4), dtype)
    gt[:, :2] = rs.rand(n, 2, 4) * 0.5 + 0.25
    gt[:, :2, 2:] = rs.rand(n, 2, 2) * 0.3 + 0.05
    inputs = {"X": [x], "GTBox": [gt],
              "GTLabel": [rs.randint(0, c, (n, 3)).astype(np.int64)]}
    if mixup:
        inputs["GTScore"] = [rs.rand(n, 3).astype(np.float32)]
    attrs = {"class_num": c, "anchors": [10, 14, 23, 27, 37, 58, 81, 82],
             "anchor_mask": [1, 2, 3], "downsample_ratio": 32,
             "ignore_thresh": 0.5, "use_label_smooth": not mixup}
    return inputs, attrs


@pytest.mark.parametrize("dtype,mixup", [(np.float64, False),
                                         (np.float32, True)])
def test_yolov3_loss_and_grad(dtype, mixup):
    inputs, attrs = _loss_inputs(dtype, mixup)
    both("yolov3_loss", inputs, attrs,
         ["Loss", "ObjectnessMask", "GTMatchMask"],
         {"Loss": dict(rtol=LOSS_RTOL, atol=0), "ObjectnessMask": EXACT,
          "GTMatchMask": EXACT})
    jdef = JaxOpInfoMap.instance().get("yolov3_loss")
    rest = {s: [jnp.asarray(v) for v in vs] for s, vs in inputs.items()
            if s != "X"}
    want = np.asarray(jax.jit(jax.grad(lambda x: jdef.compute(
        dict(rest, X=[x]), attrs)["Loss"][0].sum()))(
            jnp.asarray(inputs["X"][0])))
    x = torch.from_numpy(inputs["X"][0]).requires_grad_()
    raw = {s: [torch.from_numpy(v) for v in vs] for s, vs in inputs.items()
           if s != "X"}
    OpInfoMap.instance().get("yolov3_loss").compute(
        dict(raw, X=[x]), attrs)["Loss"][0].sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), want, **GRAD_TOL)
