"""Small cases of the 63 op types the rest of ``paddle.nn`` brought to
the port (``ops/nn_ops.py``, ``loss_ops.py``, ``vision_ops.py`` and four
of ``long_tail_ops.py``): the numpy inputs and attrs that
``tests/test_torch_{nn,loss,vision}_ops.py`` run through both packages'
registries on the CPU, and that ``chip_smoke.py`` phase ``nn_api`` runs
through the port on the card and on the CPU. :class:`Case` and its
kinds are ``op_cases``'s, with one more:

- ``"draws"``: ``nce``, whose negatives the port draws from its own
  generators. The tests hold it against the reference's formula on the
  port's draws (the reference's ``jax.random.randint`` made to return
  them); the port draws on the CPU and moves the draws, so the card and
  the CPU hold it as a value.

fp32 cases hold at rtol 1e-5 / atol 1e-6, as ``op_cases``'s do; a case
that states its own bound says why.

:data:`LAYER_CASES` and :data:`FUNC_CASES` are the ``nn`` classes and
``nn.functional`` functions of the slice at small sizes, as
``tests/test_torch_nn_layers.py`` holds them against the JAX package and
``chip_smoke.py`` phase ``nn_layers`` holds the card against the CPU:
``(id, make(api), inputs)`` with ``api`` a namespace of the package's
``nn`` and ``dygraph`` (the layer is called on the inputs), and ``(id,
inputs, call(F, *tensors))``.
"""
from __future__ import annotations

from typing import List

import numpy as np

from .op_cases import Case, f32, ints, uniform

# sums of a few hundred products (convolutions, their gradients, the
# norms' statistics): the two libraries order the sums differently
CONV = (1e-4, 2e-5)


def _softmax(x, axis=-1):
    e = np.exp(x - x.max(axis=axis, keepdims=True))
    return (e / e.sum(axis=axis, keepdims=True)).astype(np.float32)


def _log_softmax(x, axis=1):
    return np.log(_softmax(x, axis)).astype(np.float32)


def _ties(seed, *shape):
    """Small integers as floats: windows hold tied maxima."""
    return np.round(f32(seed, *shape)).astype(np.float32)


def _unpool_indices(seed, n, c, h, w, k):
    """One position in each k x k window of an [h, w] grid, as
    max_pool2d_with_index would record it (flat, int32)."""
    rs = np.random.RandomState(seed)
    oh, ow = h // k, w // k
    out = np.zeros((n, c, oh, ow), np.int32)
    for i in range(oh):
        for j in range(ow):
            r = i * k + rs.randint(0, k, (n, c))
            q = j * k + rs.randint(0, k, (n, c))
            out[:, :, i, j] = r * w + q
    return out


def _nn_cases():
    x1 = f32(300, 1, 4, 5, 5)
    return [
        # conv2d_transpose: CycleGAN's uk (3x3, stride 2, padding 1,
        # output_padding 1); output_padding past max(stride, dilation),
        # both under and past the padding; groups 2 with dilation in NHWC
        Case("conv2d_transpose_cyclegan", "conv2d_transpose",
             {"Input": [x1], "Filter": [f32(301, 4, 3, 3, 3)]},
             {"strides": [2, 2], "paddings": [1, 1],
              "output_padding": [1, 1]}, tol=CONV, grad_tol=CONV),
        Case("conv2d_transpose_big_output_padding", "conv2d_transpose",
             {"Input": [f32(302, 2, 3, 4, 3)],
              "Filter": [f32(303, 3, 2, 3, 2)]},
             {"strides": [1, 2], "paddings": [2, 0],
              "output_padding": [2, 3]}, tol=CONV, grad_tol=CONV),
        Case("conv2d_transpose_groups_nhwc", "conv2d_transpose",
             {"Input": [f32(304, 1, 5, 4, 4)],
              "Filter": [f32(305, 4, 3, 3, 3)]},
             {"strides": [2, 1], "paddings": [1, 0], "dilations": [2, 1],
              "groups": 2, "data_format": "NHWC"}, tol=CONV, grad_tol=CONV),
        Case("depthwise_conv2d_transpose", "depthwise_conv2d_transpose",
             {"Input": [f32(306, 1, 3, 4, 4)],
              "Filter": [f32(307, 3, 1, 3, 3)]},
             {"strides": [2, 2], "paddings": [1, 1]}, tol=CONV,
             grad_tol=CONV),
        Case("conv3d", "conv3d",
             {"Input": [f32(308, 1, 2, 4, 5, 5)],
              "Filter": [f32(309, 3, 2, 3, 3, 3)]},
             {"strides": [1, 2, 1], "paddings": [1, 1, 0]}, tol=CONV,
             grad_tol=CONV),
        Case("conv3d_asym_ndhwc_groups", "conv3d",
             {"Input": [f32(310, 1, 3, 4, 4, 4)],
              "Filter": [f32(311, 4, 2, 2, 3, 2)]},
             {"paddings": [0, 1, 1, 0, 1, 1], "groups": 2,
              "dilations": [1, 1, 2], "data_format": "NDHWC"}, tol=CONV,
             grad_tol=CONV),
        Case("conv3d_transpose", "conv3d_transpose",
             {"Input": [f32(312, 1, 4, 3, 3, 4)],
              "Filter": [f32(313, 4, 2, 3, 3, 3)]},
             {"strides": [2, 2, 2], "paddings": [1, 1, 1],
              "output_padding": [1, 0, 1], "groups": 2}, tol=CONV,
             grad_tol=CONV),
        Case("deformable_conv_mask", "deformable_conv",
             {"Input": [f32(314, 1, 3, 6, 6)],
              "Offset": [f32(315, 1, 18, 6, 6, scale=1.5)],
              "Mask": [uniform(316, 0.0, 1.0, 1, 9, 6, 6)],
              "Filter": [f32(317, 4, 3, 3, 3)]},
             {"strides": [1, 1], "paddings": [1, 1]}, tol=CONV,
             grad_tol=CONV),
        Case("deformable_conv_stride", "deformable_conv",
             {"Input": [f32(318, 2, 2, 7, 7)],
              "Offset": [f32(319, 2, 8, 3, 3, scale=0.8)],
              "Filter": [f32(320, 3, 2, 2, 2)]},
             {"strides": [2, 2], "paddings": [0, 0], "dilations": [2, 2]},
             tol=CONV, grad_tol=CONV),
        # batch 1: the saved statistics drop the batch dim ([C])
        Case("instance_norm_batch1", "instance_norm",
             {"X": [f32(321, 1, 4, 5, 6, scale=2.0, shift=0.5)],
              "Scale": [f32(322, 4)], "Bias": [f32(323, 4)]},
             {"epsilon": 1e-5}, tol=CONV, grad_tol=CONV),
        Case("instance_norm_plain", "instance_norm",
             {"X": [f32(324, 2, 3, 4, 4)]}, {}, tol=CONV, grad_tol=CONV),
        Case("group_norm", "group_norm",
             {"X": [f32(325, 2, 6, 4, 4)], "Scale": [f32(326, 6)],
              "Bias": [f32(327, 6)]}, {"groups": 3, "epsilon": 1e-5},
             tol=CONV, grad_tol=CONV),
        Case("data_norm", "data_norm",
             {"X": [f32(328, 4, 5)],
              "BatchSize": [uniform(329, 5.0, 10.0, 5)],
              "BatchSum": [f32(330, 5)],
              "BatchSquareSum": [uniform(331, 1.0, 5.0, 5)]}, {}),
        Case("spectral_norm", "spectral_norm",
             {"Weight": [f32(332, 4, 3, 2, 2)], "U": [f32(333, 3)],
              "V": [f32(334, 16)]},
             {"dim": 1, "power_iters": 2, "eps": 1e-12}, tol=CONV,
             grad_tol=CONV),
        Case("lrn", "lrn", {"X": [f32(335, 2, 6, 3, 3)]},
             {"n": 5, "alpha": 1e-2, "beta": 0.75, "k": 2.0}),
        Case("log_softmax", "log_softmax", {"X": [f32(336, 3, 5)]}, {}),
        Case("log_softmax_axis1", "log_softmax",
             {"X": [f32(337, 2, 3, 4)]}, {"axis": 1}),
        Case("cross_entropy", "cross_entropy",
             {"X": [_softmax(f32(338, 4, 5))],
              "Label": [ints(339, 0, 5, 4, 1)]}, {}),
        Case("cross_entropy_soft", "cross_entropy",
             {"X": [_softmax(f32(340, 4, 5))],
              "Label": [_softmax(f32(341, 4, 5))]}, {"soft_label": True}),
        Case("cross_entropy2", "cross_entropy2",
             {"X": [_softmax(f32(342, 3, 6))],
              "Label": [ints(343, 0, 6, 3, 1)]}, {}),
        Case("sigmoid_cross_entropy_with_logits",
             "sigmoid_cross_entropy_with_logits",
             {"X": [f32(344, 4, 5)], "Label": [uniform(345, 0, 1, 4, 5)]},
             {}),
        Case("sigmoid_cross_entropy_ignore_normalize",
             "sigmoid_cross_entropy_with_logits",
             {"X": [f32(346, 3, 4)],
              "Label": [np.where(uniform(347, 0, 1, 3, 4) < 0.3, -100.0,
                                 uniform(348, 0, 1, 3, 4))
                        .astype(np.float32)]},
             {"ignore_index": -100, "normalize": True}),
        Case("embedding", "embedding",
             {"W": [f32(349, 10, 4)], "Ids": [ints(350, 0, 10, 2, 3)]},
             {"padding_idx": 2}),
        Case("prelu_all", "prelu",
             {"X": [f32(351, 2, 3, 4)],
              "Alpha": [np.array([0.2], np.float32)]}, {"mode": "all"}),
        Case("prelu_channel", "prelu",
             {"X": [f32(352, 2, 3, 4)], "Alpha": [f32(353, 3)]},
             {"mode": "channel"}),
        Case("prelu_element", "prelu",
             {"X": [f32(354, 2, 3)], "Alpha": [f32(355, 2, 3)]},
             {"mode": "element"}),
        Case("huber_loss", "huber_loss",
             {"X": [f32(356, 4, 3)], "Y": [f32(357, 4, 3)]},
             {"delta": 0.7}),
        Case("mse_loss", "mse_loss",
             {"X": [f32(358, 4, 3)], "Label": [f32(359, 4, 3)]}, {}),
        Case("smooth_l1_loss", "smooth_l1_loss",
             {"X": [f32(360, 3, 4)], "Y": [f32(361, 3, 4)],
              "InsideWeight": [uniform(362, 0.5, 1.5, 3, 4)],
              "OutsideWeight": [uniform(363, 0.5, 1.5, 3, 4)]},
             {"sigma": 2.0}),
    ]


def _loss_cases():
    target = uniform(372, -0.2, 1.0, 3, 4)
    labels_ll = ints(375, 0, 2, 4, 1).astype(np.float32)
    return [
        Case("bce_loss", "bce_loss",
             {"X": [uniform(370, 0.05, 0.95, 3, 4)],
              "Label": [uniform(371, 0.0, 1.0, 3, 4)]}, {}),
        *[Case(f"kldiv_loss_{r}", "kldiv_loss",
               {"X": [f32(373, 3, 4)], "Target": [target]},
               {"reduction": r})
          for r in ("none", "sum", "mean", "batchmean")],
        Case("log_loss", "log_loss",
             {"Predicted": [uniform(374, 0.05, 0.95, 4, 1)],
              "Labels": [labels_ll]}, {"epsilon": 1e-4}),
        Case("hinge_loss", "hinge_loss",
             {"Logits": [f32(376, 4, 1)], "Labels": [labels_ll]}, {}),
        Case("rank_loss", "rank_loss",
             {"Label": [uniform(377, 0, 1, 4, 1)],
              "Left": [f32(378, 4, 1)], "Right": [f32(379, 4, 1)]}, {}),
        Case("margin_rank_loss", "margin_rank_loss",
             {"Label": [np.sign(f32(380, 4, 1)).astype(np.float32)],
              "X1": [f32(381, 4, 1)], "X2": [f32(382, 4, 1)]},
             {"margin": 0.1}),
        Case("bpr_loss", "bpr_loss",
             {"X": [f32(383, 4, 5)], "Label": [ints(384, 0, 5, 4, 1)]}, {}),
        *[Case(f"nll_loss_{r}", "nll_loss",
               {"X": [_log_softmax(f32(385, 6, 5))],
                "Label": [np.array([0, 1, 4, 1, 3, 2], np.int64)],
                "Weight": [uniform(386, 0.5, 2.0, 5)]},
               {"reduction": r, "ignore_index": 1})
          for r in ("mean", "sum", "none")],
        Case("nll_loss_4d", "nll_loss",
             {"X": [_log_softmax(f32(387, 2, 3, 2, 2))],
              "Label": [ints(388, 0, 3, 2, 2, 2)]}, {}),
        Case("sigmoid_focal_loss", "sigmoid_focal_loss",
             {"X": [f32(389, 5, 3)],
              "Label": [np.array([[0], [1], [3], [-1], [2]], np.int32)],
              "FgNum": [np.array([3], np.int32)]},
             {"gamma": 2.0, "alpha": 0.25}),
        Case("center_loss", "center_loss",
             {"X": [f32(390, 4, 3)], "Label": [ints(391, 0, 3, 4, 1)],
              "Centers": [f32(392, 3, 3)],
              "CenterUpdateRate": [np.array([0.5], np.float32)]},
             {"cluster_num": 3, "need_update": True}),
        Case("minus", "minus", {"X": [f32(393, 3, 4)],
                                "Y": [f32(394, 3, 4)]}, {}),
        Case("label_smooth", "label_smooth",
             {"X": [np.eye(4, dtype=np.float32)[[0, 2, 3]]]},
             {"epsilon": 0.1}),
        Case("label_smooth_prior", "label_smooth",
             {"X": [np.eye(4, dtype=np.float32)[[1, 1, 0]]],
              "PriorDist": [_softmax(f32(395, 4))]}, {"epsilon": 0.2}),
        Case("hierarchical_sigmoid", "hierarchical_sigmoid",
             {"X": [f32(396, 4, 3)], "W": [f32(397, 5, 3)],
              "Label": [ints(398, 0, 6, 4, 1)], "Bias": [f32(399, 5, 1)]},
             {"num_classes": 6}),
        Case("hierarchical_sigmoid_path", "hierarchical_sigmoid",
             {"X": [f32(400, 4, 3)], "W": [f32(401, 5, 3)],
              "Label": [ints(402, 0, 6, 4, 1)],
              "PathTable": [np.array([[0, 1, -1], [0, 2, 4], [0, 1, 3],
                                      [0, -1, -1]], np.int64)],
              "PathCode": [np.array([[1, 0, 0], [0, 1, 1], [1, 1, 0],
                                     [0, 0, 0]], np.int64)]},
             {"num_classes": 6}),
        Case("nce", "nce",
             {"Input": [f32(403, 4, 3)], "Label": [ints(404, 0, 10, 4, 1)],
              "Weight": [f32(405, 10, 3)], "Bias": [f32(406, 10)],
              "SampleWeight": [uniform(407, 0.5, 1.5, 4, 1)]},
             {"num_neg_samples": 5, "num_total_classes": 10, "seed": 7},
             kind="draws"),
    ]


def _interp_cases():
    x4 = f32(420, 1, 2, 4, 5)
    out = []
    for op in ("bilinear_interp", "bilinear_interp_v2"):
        out += [
            Case(f"{op}_aligned", op, {"X": [x4]},
                 {"out_h": 7, "out_w": 9, "align_corners": True}),
            Case(f"{op}_half_pixel", op, {"X": [x4]},
                 {"out_h": 7, "out_w": 9, "align_corners": False,
                  "align_mode": 0}),
            Case(f"{op}_legacy_down", op, {"X": [f32(421, 2, 1, 6, 7)]},
                 {"out_h": 4, "out_w": 3, "align_corners": False,
                  "align_mode": 1}),
            Case(f"{op}_scale_nhwc", op, {"X": [f32(422, 1, 3, 5, 2)]},
                 {"scale": 1.5, "align_corners": False, "align_mode": 0,
                  "data_layout": "NHWC"}),
        ]
    for op in ("linear_interp", "linear_interp_v2"):
        out += [Case(f"{op}", op, {"X": [f32(423, 2, 3, 6)]},
                     {"out_w": 9, "align_corners": False, "align_mode": 0}),
                Case(f"{op}_aligned", op, {"X": [f32(424, 1, 2, 5)]},
                     {"out_w": 3, "align_corners": True})]
    for op in ("trilinear_interp", "trilinear_interp_v2"):
        out += [Case(f"{op}", op, {"X": [f32(425, 1, 2, 3, 4, 5)]},
                     {"out_d": 5, "out_h": 6, "out_w": 4,
                      "align_corners": False, "align_mode": 0}),
                Case(f"{op}_aligned", op, {"X": [f32(426, 1, 1, 3, 3, 4)]},
                     {"out_d": 4, "out_h": 2, "out_w": 7,
                      "align_corners": True})]
    for op in ("nearest_interp", "nearest_interp_v2"):
        out += [Case(f"{op}_aligned", op, {"X": [f32(427, 1, 2, 5, 5)]},
                     {"out_h": 8, "out_w": 7, "align_corners": True}),
                Case(f"{op}_floor", op, {"X": [f32(428, 1, 2, 5, 5)]},
                     {"out_h": 8, "out_w": 3, "align_corners": False}),
                Case(f"{op}_scale", op, {"X": [f32(429, 2, 1, 3, 4)]},
                     {"scale": 2.0, "align_corners": False})]
    for op in ("bicubic_interp", "bicubic_interp_v2"):
        out += [Case(f"{op}_aligned", op, {"X": [f32(430, 1, 2, 5, 6)]},
                     {"out_h": 9, "out_w": 11, "align_corners": True}),
                Case(f"{op}_half_pixel", op, {"X": [f32(431, 1, 2, 5, 6)]},
                     {"out_h": 4, "out_w": 10, "align_corners": False})]
    return out


def _vision_cases():
    grid = uniform(441, -1.2, 1.2, 2, 4, 3, 2)
    xg = f32(440, 2, 3, 5, 6)
    return _interp_cases() + [
        Case("affine_grid_aligned", "affine_grid",
             {"Theta": [f32(442, 2, 2, 3)]},
             {"output_shape": [2, 1, 4, 5], "align_corners": True}),
        Case("affine_grid", "affine_grid", {"Theta": [f32(443, 1, 2, 3)]},
             {"output_shape": [1, 3, 3, 6], "align_corners": False}),
        *[Case(f"grid_sampler_{mode}_{pad}_{int(align)}", "grid_sampler",
               {"X": [xg], "Grid": [grid]},
               {"mode": mode, "padding_mode": pad, "align_corners": align})
          for mode, pad, align in [
              ("bilinear", "zeros", True), ("bilinear", "zeros", False),
              ("bilinear", "border", False), ("bilinear", "reflection", True),
              ("bilinear", "reflection", False), ("nearest", "zeros", True),
              ("nearest", "border", False)]],
        Case("affine_channel", "affine_channel",
             {"X": [f32(444, 2, 3, 4, 4)], "Scale": [f32(445, 3)],
              "Bias": [f32(446, 3)]}, {}),
        Case("affine_channel_nhwc", "affine_channel",
             {"X": [f32(447, 2, 4, 4, 3)], "Scale": [f32(448, 3)],
              "Bias": [f32(449, 3)]}, {"data_layout": "NHWC"}),
        Case("pixel_shuffle", "pixel_shuffle", {"X": [f32(450, 1, 8, 3, 3)]},
             {"upscale_factor": 2}),
        Case("pixel_shuffle_nhwc", "pixel_shuffle",
             {"X": [f32(451, 1, 3, 2, 18)]},
             {"upscale_factor": 3, "data_format": "NHWC"}),
        Case("shuffle_channel", "shuffle_channel",
             {"X": [f32(452, 2, 6, 2, 2)]}, {"group": 3}),
        Case("space_to_depth", "space_to_depth",
             {"X": [f32(453, 1, 2, 4, 6)]}, {"blocksize": 2}),
        Case("temporal_shift", "temporal_shift",
             {"X": [f32(454, 4, 8, 2, 2)]},
             {"seg_num": 2, "shift_ratio": 0.25}),
        Case("crop", "crop", {"X": [f32(455, 3, 5, 6)]},
             {"shape": [2, 3, 4], "offsets": [1, 1, 2]}),
        Case("crop_like_y", "crop", {"X": [f32(456, 3, 5)],
                                     "Y": [f32(457, 2, 2)]},
             {"offsets": [1, 2]}),
        Case("crop_tensor", "crop_tensor", {"X": [f32(458, 3, 5, 6)]},
             {"shape": [2, -1, 3], "offsets": [0, 0, 1]}),
        Case("reverse", "reverse", {"X": [f32(459, 3, 4, 2)]},
             {"axis": [0, 2]}),
        Case("pad_constant_like", "pad_constant_like",
             {"X": [f32(460, 4, 5)], "Y": [f32(461, 2, 3)]},
             {"pad_value": 1.5}),
        Case("unfold", "unfold", {"X": [f32(462, 1, 2, 5, 6)]},
             {"kernel_sizes": [2, 3], "strides": [1, 2],
              "paddings": [1, 0, 0, 1], "dilations": [1, 1]}),
        Case("unfold_dilated", "unfold", {"X": [f32(463, 2, 1, 6, 6)]},
             {"kernel_sizes": [2, 2], "strides": [1, 1],
              "paddings": [1, 1], "dilations": [2, 2]}),
        Case("max_pool2d_with_index", "max_pool2d_with_index",
             {"X": [f32(464, 1, 2, 5, 5)]},
             {"ksize": [3, 3], "strides": [2, 2], "paddings": [1, 1]}),
        # tied maxima in overlapping windows: the first one's index, the
        # gradient split between the tied ones
        Case("max_pool2d_with_index_ties", "max_pool2d_with_index",
             {"X": [_ties(465, 2, 2, 5, 4)]},
             {"ksize": [2, 2], "strides": [1, 1]}),
        Case("max_pool2d_with_index_global", "max_pool2d_with_index",
             {"X": [f32(466, 2, 3, 4, 3)]},
             {"ksize": [1, 1], "global_pooling": True}),
        Case("max_pool3d_with_index", "max_pool3d_with_index",
             {"X": [f32(467, 1, 2, 4, 4, 4)]},
             {"ksize": [2, 2, 2], "strides": [2, 2, 2]}),
        Case("max_pool3d_with_index_ties", "max_pool3d_with_index",
             {"X": [_ties(468, 1, 2, 3, 4, 4)]},
             {"ksize": [2, 3, 2], "strides": [1, 1, 2],
              "paddings": [1, 0, 1]}),
        Case("unpool", "unpool",
             {"X": [f32(469, 1, 2, 2, 3)],
              "Indices": [_unpool_indices(470, 1, 2, 4, 6, 2)]},
             {"unpooled_size": [4, 6]}),
        Case("pool3d_max", "pool3d", {"X": [f32(471, 1, 2, 4, 4, 4)]},
             {"ksize": [2, 2, 2], "strides": [2, 2, 2]}),
        Case("pool3d_avg_exclusive", "pool3d",
             {"X": [f32(472, 1, 2, 4, 5, 4)]},
             {"pooling_type": "avg", "ksize": [3, 3, 3],
              "strides": [2, 2, 2], "paddings": [1, 1, 1]}),
        Case("pool3d_avg_inclusive", "pool3d",
             {"X": [f32(473, 1, 1, 4, 4, 4)]},
             {"pooling_type": "avg", "ksize": [2, 3, 2],
              "strides": [1, 1, 2], "paddings": [0, 1, 0],
              "exclusive": False}),
        Case("pool3d_global", "pool3d", {"X": [f32(474, 2, 2, 3, 2, 2)]},
             {"pooling_type": "avg", "global_pooling": True}),
        Case("pool3d_adaptive", "pool3d", {"X": [f32(475, 1, 2, 4, 6, 4)]},
             {"pooling_type": "max", "adaptive": True, "ksize": [2, 3, 2]}),
    ]


def _long_tail_cases():
    return [
        Case("adaptive_pool2d_max", "adaptive_pool2d",
             {"X": [f32(480, 2, 3, 7, 5)]},
             {"pool_size": [3, 2], "pooling_type": "max"}),
        Case("adaptive_pool2d_avg", "adaptive_pool2d",
             {"X": [f32(481, 1, 2, 5, 7)]},
             {"pool_size": [2, 3], "pool_type": "avg"}),
        Case("adaptive_pool3d", "adaptive_pool3d",
             {"X": [f32(482, 1, 2, 5, 4, 6)]},
             {"pool_size": [2, 3, 4], "pool_type": "avg"}),
        Case("adaptive_pool3d_max", "adaptive_pool3d",
             {"X": [f32(483, 1, 1, 3, 5, 4)]},
             {"pool_size": [2, 2, 3], "pool_type": "max"}),
        Case("brelu", "brelu", {"X": [f32(484, 3, 4, scale=3.0)]},
             {"t_min": -1.0, "t_max": 2.0}),
        Case("bilinear_tensor_product", "bilinear_tensor_product",
             {"X": [f32(485, 3, 4)], "Y": [f32(486, 3, 5)],
              "Weight": [f32(487, 2, 4, 5)], "Bias": [f32(488, 1, 2)]}, {}),
    ]


def _log_probs(seed, *shape):
    return _log_softmax(f32(seed, *shape), axis=1)


LAYER_CASES = [
    ("Conv2DTranspose", lambda a: a.nn.Conv2DTranspose(
        4, 6, 3, stride=2, padding=1, output_padding=1), [f32(1, 1, 4, 5, 5)]),
    ("ConvTranspose2d_groups_nhwc", lambda a: a.nn.ConvTranspose2d(
        4, 6, 3, stride=2, groups=2, data_format="NHWC"),
     [f32(2, 1, 3, 4, 4)]),
    ("GroupNorm", lambda a: a.nn.GroupNorm(2, 4), [f32(3, 2, 4, 3, 3)]),
    ("InstanceNorm2D", lambda a: a.nn.InstanceNorm2D(4), [f32(4, 1, 4, 5, 5)]),
    ("InstanceNorm1d", lambda a: a.nn.InstanceNorm1d(3), [f32(5, 2, 3, 6)]),
    ("InstanceNorm3d", lambda a: a.nn.InstanceNorm3d(2),
     [f32(6, 1, 2, 3, 3, 3)]),
    *[(name, (lambda n: lambda a: getattr(a.nn, n)())(name), [f32(7, 2, 3, 4)])
      for name in ("Sigmoid", "Tanh", "GELU", "Softplus", "Silu", "Mish",
                   "Hardswish", "ReLU6", "Softsign", "Tanhshrink",
                   "LogSigmoid", "SELU")],
    ("Softmax", lambda a: a.nn.Softmax(axis=1), [f32(8, 2, 3, 4)]),
    ("PReLU_channel", lambda a: a.nn.PReLU(3, 0.1), [f32(9, 2, 3, 4)]),
    ("PReLU_all", lambda a: a.nn.PReLU(), [f32(10, 2, 3)]),
    ("ELU", lambda a: a.nn.ELU(0.5), [f32(11, 3, 4)]),
    ("Hardshrink", lambda a: a.nn.Hardshrink(0.3), [f32(12, 3, 4)]),
    ("Softshrink", lambda a: a.nn.Softshrink(0.3), [f32(13, 3, 4)]),
    ("Hardtanh", lambda a: a.nn.Hardtanh(-0.5, 0.8), [f32(14, 3, 4)]),
    ("LogSoftmax", lambda a: a.nn.LogSoftmax(1), [f32(15, 2, 5)]),
    ("CrossEntropyLoss", lambda a: a.nn.CrossEntropyLoss(),
     [f32(16, 4, 5), ints(17, 0, 5, 4, 1)]),
    ("CrossEntropyLoss_soft_sum", lambda a: a.nn.CrossEntropyLoss(
        soft_label=True, reduction="sum"),
     [f32(18, 4, 5), uniform(19, 0.0, 0.4, 4, 5)]),
    ("MSELoss", lambda a: a.nn.MSELoss(), [f32(20, 3, 4), f32(21, 3, 4)]),
    ("BCEWithLogitsLoss", lambda a: a.nn.BCEWithLogitsLoss("sum"),
     [f32(22, 3, 4), uniform(23, 0.0, 1.0, 3, 4)]),
    ("Pool2D", lambda a: a.nn.Pool2D(2, "avg", 2), [f32(24, 1, 2, 4, 4)]),
    ("Conv3D", lambda a: a.nn.Conv3D(2, 3, 3, padding=1),
     [f32(25, 1, 2, 4, 4, 4)]),
    ("Conv3DTranspose", lambda a: a.nn.Conv3DTranspose(
        2, 4, 3, stride=2, padding=1, output_padding=1),
     [f32(26, 1, 2, 3, 3, 3)]),
    ("Upsample_bilinear", lambda a: a.nn.Upsample(size=[6, 7],
                                               mode="bilinear"),
     [f32(27, 1, 2, 3, 4)]),
    ("Upsample_nearest", lambda a: a.nn.Upsample(scale_factor=2),
     [f32(28, 1, 2, 3, 3)]),
    ("UpsamplingBilinear2D", lambda a: a.nn.UpsamplingBilinear2D(size=[5, 5]),
     [f32(29, 1, 1, 3, 4)]),
    ("UpsamplingNearest2D", lambda a: a.nn.UpsamplingNearest2D(
        scale_factor=2), [f32(30, 1, 1, 3, 2)]),
    ("PixelShuffle", lambda a: a.nn.PixelShuffle(2), [f32(31, 1, 8, 2, 2)]),
    ("Unfold", lambda a: a.nn.Unfold([2, 2]), [f32(32, 1, 2, 4, 4)]),
    ("MaxUnPool2D", lambda a: a.nn.MaxUnPool2D(2),
     [f32(33, 1, 2, 2, 3), _unpool_indices(34, 1, 2, 4, 6, 2)]),
    ("Pad2D_reflect", lambda a: a.nn.Pad2D([1, 2, 0, 1], mode="reflect"),
     [f32(35, 1, 2, 4, 4)]),
    ("ZeroPad2D", lambda a: a.nn.ZeroPad2D(1), [f32(36, 1, 2, 3, 3)]),
    ("LocalResponseNorm", lambda a: a.nn.LocalResponseNorm(3),
     [f32(37, 1, 5, 3, 3)]),
    ("SpectralNorm", lambda a: a.nn.SpectralNorm((4, 3, 2), dim=1,
                                              power_iters=2),
     [f32(38, 4, 3, 2)]),
    ("KLDivLoss", lambda a: a.nn.KLDivLoss("batchmean"),
     [f32(39, 3, 4), uniform(40, 0.0, 1.0, 3, 4)]),
    ("NLLLoss", lambda a: a.nn.NLLLoss(), [_log_probs(41, 4, 5),
                                       ints(42, 0, 5, 4)]),
    ("BCELoss", lambda a: a.nn.BCELoss(),
     [uniform(43, 0.05, 0.95, 3, 4), uniform(44, 0.0, 1.0, 3, 4)]),
    ("SmoothL1Loss", lambda a: a.nn.SmoothL1Loss(delta=0.5),
     [f32(45, 3, 4), f32(46, 3, 4)]),
    ("L1Loss", lambda a: a.nn.L1Loss("sum"), [f32(47, 3, 4), f32(48, 3, 4)]),
    ("MarginRankingLoss", lambda a: a.nn.MarginRankingLoss(0.1),
     [f32(49, 4, 1), f32(50, 4, 1),
      np.sign(f32(51, 4, 1)).astype(np.float32)]),
    ("CosineSimilarity", lambda a: a.nn.CosineSimilarity(axis=1),
     [f32(52, 3, 4), f32(53, 3, 4)]),
    ("PairwiseDistance", lambda a: a.nn.PairwiseDistance(),
     [f32(54, 3, 4), f32(55, 3, 4)]),
    ("LSTMCell", lambda a: a.nn.LSTMCell(3, 4), [f32(56, 2, 3)]),
    ("GRUCell", lambda a: a.nn.GRUCell(3, 4), [f32(57, 2, 3)]),
    ("Conv1d", lambda a: a.nn.Conv1d(2, 3, 3, padding=1), [f32(58, 2, 2, 6)]),
    ("ConvTranspose1d", lambda a: a.nn.ConvTranspose1d(2, 3, 3, stride=2,
                                                    padding=1),
     [f32(59, 1, 2, 5)]),
    ("MaxPool1d", lambda a: a.nn.MaxPool1d(2), [f32(60, 1, 2, 7)]),
    ("AvgPool1d", lambda a: a.nn.AvgPool1d(3, 2, 1), [f32(61, 1, 2, 7)]),
    ("MaxPool3d", lambda a: a.nn.MaxPool3d(2), [f32(62, 1, 2, 4, 4, 4)]),
    ("AvgPool3d", lambda a: a.nn.AvgPool3d(2), [f32(63, 1, 2, 4, 4, 4)]),
    ("AdaptiveAvgPool1d", lambda a: a.nn.AdaptiveAvgPool1d(3),
     [f32(64, 1, 2, 7)]),
    ("AdaptiveMaxPool1d", lambda a: a.nn.AdaptiveMaxPool1d(2),
     [f32(65, 1, 2, 7)]),
    ("AdaptiveAvgPool3d", lambda a: a.nn.AdaptiveAvgPool3d(2),
     [f32(66, 1, 2, 4, 5, 4)]),
    ("AdaptiveMaxPool3d", lambda a: a.nn.AdaptiveMaxPool3d([1, 2, 2]),
     [f32(67, 1, 2, 4, 4, 3)]),
    ("ConstantPad1d", lambda a: a.nn.ConstantPad1d([1, 2], 0.5),
     [f32(68, 1, 2, 4)]),
    ("ConstantPad2d", lambda a: a.nn.ConstantPad2d(1, 0.5),
     [f32(69, 1, 2, 3, 3)]),
    ("ConstantPad3d", lambda a: a.nn.ConstantPad3d(1, 0.5),
     [f32(70, 1, 1, 2, 2, 2)]),
    ("ReflectionPad1d", lambda a: a.nn.ReflectionPad1d([2, 1]),
     [f32(71, 1, 2, 4)]),
    ("ReflectionPad2d", lambda a: a.nn.ReflectionPad2d(3),
     [f32(72, 1, 2, 5, 5)]),
    ("ReplicationPad1d", lambda a: a.nn.ReplicationPad1d(1), [f32(73, 1, 2, 4)]),
    ("ReplicationPad2d", lambda a: a.nn.ReplicationPad2d([1, 0, 2, 1]),
     [f32(74, 1, 2, 3, 3)]),
    ("ReplicationPad3d", lambda a: a.nn.ReplicationPad3d(1),
     [f32(75, 1, 1, 2, 3, 2)]),
    ("Bilinear", lambda a: a.nn.Bilinear(3, 4, 2), [f32(76, 2, 3), f32(77, 2, 4)]),
    ("HSigmoid", lambda a: a.nn.HSigmoid(3, 6),
     [f32(78, 4, 3), ints(79, 0, 6, 4, 1)]),
    ("SimpleRNNCell", lambda a: a.nn.SimpleRNNCell(3, 4), [f32(80, 2, 3)]),
    ("SimpleRNNCell_relu", lambda a: a.nn.SimpleRNNCell(3, 4, "relu"),
     [f32(81, 2, 3)]),
    ("RNN", lambda a: a.nn.RNN(a.nn.SimpleRNNCell(3, 4)), [f32(82, 2, 5, 3)]),
    ("RNN_reverse_time_major", lambda a: a.nn.RNN(
        a.nn.GRUCell(3, 4), is_reverse=True, time_major=True),
     [f32(83, 5, 2, 3)]),
    ("BiRNN", lambda a: a.nn.BiRNN(a.nn.SimpleRNNCell(3, 4),
                                a.nn.SimpleRNNCell(3, 4)), [f32(84, 2, 4, 3)]),
    ("BilinearTensorProduct_1x", lambda a: a.dygraph.BilinearTensorProduct(
        3, 4, 2, act="sigmoid"),
     [f32(85, 2, 3), f32(86, 2, 4)]),
    ("PRelu_1x", lambda a: a.dygraph.PRelu(3),
     [f32(87, 2, 3, 4)]),
    ("InstanceNorm_1x", lambda a: a.dygraph.InstanceNorm(2),
     [f32(88, 1, 2, 4, 4)]),
]


X4 = f32(100, 1, 4, 5, 5)
FUNC_CASES = [
    ("conv2d_transpose", [X4, f32(101, 4, 3, 3, 3), f32(102, 3)],
     lambda f, x, w, b: f.conv2d_transpose(x, w, b, 2, 1, 1)),
    *[(name, [f32(103, 3, 4)], (lambda n: lambda f, x: getattr(f, n)(x))
       (name))
      for name in ("sigmoid", "softplus", "softsign", "silu", "mish",
                   "selu", "hardswish", "hardsigmoid", "swish")],
    ("elu", [f32(104, 3, 4)], lambda f, x: f.elu(x, 0.5)),
    ("prelu", [f32(105, 2, 3, 4), f32(106, 3)],
     lambda f, x, w: f.prelu(x, w)),
    ("softmax", [f32(107, 3, 4)], lambda f, x: f.softmax(x, 0)),
    ("log_softmax", [f32(108, 3, 4)], lambda f, x: f.log_softmax(x)),
    ("softmax_with_cross_entropy", [f32(109, 4, 5), ints(110, 0, 5, 4, 1)],
     lambda f, x, y: f.softmax_with_cross_entropy(
         x, y, return_softmax=True)),
    ("cross_entropy_soft", [f32(111, 4, 5), uniform(112, 0, 0.4, 4, 5)],
     lambda f, x, y: f.cross_entropy(x, y, soft_label=True)),
    ("mse_loss", [f32(113, 3, 4), f32(114, 3, 4)],
     lambda f, x, y: f.mse_loss(x, y, "sum")),
    ("binary_cross_entropy_with_logits",
     [f32(115, 3, 4), uniform(116, 0, 1, 3, 4)],
     lambda f, x, y: f.binary_cross_entropy_with_logits(x, y)),
    ("pad_2d", [f32(117, 1, 2, 3, 3)],
     lambda f, x: f.pad(x, [1, 1, 2, 0], mode="reflect")),
    ("pad_last_dim", [f32(118, 2, 3)], lambda f, x: f.pad(x, [1, 2],
                                                            value=0.5)),
    ("one_hot", [ints(119, 0, 5, 4)], lambda f, x: f.one_hot(x, 5)),
    ("interpolate_v2", [f32(120, 1, 2, 3, 4)],
     lambda f, x: f.interpolate_v2(x, size=[5, 7], mode="bilinear")),
    ("interpolate_v2_bicubic_aligned", [f32(121, 1, 1, 4, 4)],
     lambda f, x: f.interpolate_v2(x, scale_factor=1.5, mode="bicubic",
                                      align_corners=True)),
    ("upsample", [f32(122, 1, 2, 3, 3)],
     lambda f, x: f.upsample(x, scale_factor=2)),
    ("grid_sample", [f32(123, 1, 2, 4, 5), uniform(124, -1, 1, 1, 3, 3, 2)],
     lambda f, x, g: f.grid_sample(x, g, align_corners=False)),
    ("affine_grid", [f32(125, 1, 2, 3)],
     lambda f, t: f.affine_grid(t, [1, 1, 3, 4])),
    ("pixel_shuffle", [f32(126, 1, 4, 2, 3)],
     lambda f, x: f.pixel_shuffle(x, 2)),
    ("unfold", [f32(127, 1, 2, 4, 5)], lambda f, x: f.unfold(x, [2, 3])),
    ("max_unpool2d", [f32(128, 1, 2, 2, 2),
                      _unpool_indices(129, 1, 2, 4, 4, 2)],
     lambda f, x, i: f.max_unpool2d(x, i, 2)),
    ("local_response_norm", [f32(130, 1, 6, 2, 2)],
     lambda f, x: f.local_response_norm(x, 3)),
    ("l1_loss", [f32(131, 3, 4), f32(132, 3, 4)],
     lambda f, x, y: f.l1_loss(x, y)),
    ("smooth_l1_loss", [f32(133, 3, 4), f32(134, 3, 4)],
     lambda f, x, y: f.smooth_l1_loss(x, y, "sum", 0.7)),
    ("kl_div", [f32(135, 3, 4), uniform(136, -0.1, 1, 3, 4)],
     lambda f, x, y: f.kl_div(x, y, "sum")),
    ("nll_loss", [_log_probs(137, 4, 5), ints(138, 0, 5, 4),
                  uniform(139, 0.5, 2, 5)],
     lambda f, x, y, w: f.nll_loss(x, y, w, ignore_index=2)),
    ("binary_cross_entropy", [uniform(140, 0.05, 0.95, 3, 4),
                              uniform(141, 0, 1, 3, 4), f32(142, 3, 4)],
     lambda f, x, y, w: f.binary_cross_entropy(x, y, w, "sum")),
    ("margin_ranking_loss", [f32(143, 4), f32(144, 4),
                             np.sign(f32(145, 4)).astype(np.float32)],
     lambda f, x, y, lab: f.margin_ranking_loss(x, y, lab, 0.2)),
    ("cosine_similarity", [f32(146, 3, 4), f32(147, 3, 4)],
     lambda f, x, y: f.cosine_similarity(x, y, axis=0)),
    ("pairwise_distance", [f32(148, 3, 4), f32(149, 3, 4)],
     lambda f, x, y: f.pairwise_distance(x, y, p=3.0, keepdim=True)),
]



NN_CASES: List[Case] = (_nn_cases() + _loss_cases() + _vision_cases()
                        + _long_tail_cases())
