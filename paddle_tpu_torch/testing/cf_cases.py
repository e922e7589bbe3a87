"""Small cases of the 97 op types the control-flow slice brought to the
port: ``ops/control_flow_ops.py`` (4), ``ops/array_ops.py`` (11),
``ops/parity_ops.py`` (53 more), ``ops/misc_ops.py`` (24) and
``ops/special_ops.py`` (5). ``tests/test_torch_array_ops.py`` and
``tests/test_torch_parity_ops.py`` run them through both packages'
registries on the CPU; ``chip_smoke.py`` phase ``cf_api`` runs them
through the port on the card and on the CPU. :class:`Case` and its kinds
are ``op_cases``'s, with:

- ``program``: the control-flow ops' Program (JSON, which both packages
  load) whose sub-blocks the case's attrs name; the runner publishes it
  as the executing program;
- ``setup(ops, tmp)``: what an op looks up, registered in the package
  under test (``ops("misc_ops")`` is its module), and the files it reads,
  written into the run's directory ``tmp``; a string attr's ``{tmp}``
  is that directory;
- kind ``"error"``: the op raises, in both packages, an error whose
  message matches ``check`` (a regex);
- kind ``"draws"``: ``shuffle_batch`` and ``sample_logits``, whose draws
  come from torch's generators in the port and from threefry in the
  reference: the tests make the reference draw the port's numbers; the
  port draws on the CPU and moves them, so the card holds them as
  values.

fp32 cases hold at rtol 1e-5 / atol 1e-6 unless they say why not.
"""
from __future__ import annotations

import os
from typing import List

import numpy as np

from .op_cases import Case, f32, ints, uniform

# sums of a few hundred products (convolutions, LSTMs, their gradients)
CONV = (1e-4, 2e-5)
PY_FUNC_ID = 9001
READER = "cf_case_reader"

# reference module -> the op types this slice takes from it
SLICE = {"paddle_tpu.ops.control_flow_ops": 4,
         "paddle_tpu.ops.array_ops": 11,
         "paddle_tpu.ops.parity_ops": 53,
         "paddle_tpu.ops.misc_ops": 24,
         "paddle_tpu.ops.special_ops": 5}


def _program(*blocks):
    """Program JSON whose blocks 1, 2, ... hold ``blocks``, each a list
    of (type, inputs, outputs, attrs)."""
    from ..core.program import Program
    prog = Program()
    for ops in blocks:
        blk = prog.append_block(prog.global_block())
        for t, i, o, a in ops:
            blk.append_op(t, i, o, a)
    return prog.to_json()


def _i64(*vals):
    return np.asarray(vals, np.int64)


# ------------------------------------------------------------ control flow
_WHILE_PROGRAM = _program(
    [("less_than", {"X": ["i"], "Y": ["n"]}, {"Out": ["c"]}, {})],
    [("increment", {"X": ["i"]}, {"Out": ["i2"]}, {"step": 1.0}),
     ("elementwise_mul", {"X": ["s"], "Y": ["w"]}, {"Out": ["s2"]},
      {"axis": -1})])
_WHILE_ATTRS = dict(cond_block=1, body_block=2, carry_names=["i", "s"],
                    body_out_names=["i2", "s2"], cond_out_name="c",
                    captured_names=["n", "w"])
_WHILE_INPUTS = {"X": [_i64(0), f32(1, 3)],
                 "Captured": [_i64(3), uniform(2, 0.5, 1.5, 3)]}

_COND_PROGRAM = _program(
    [("elementwise_mul", {"X": ["x"], "Y": ["w"]}, {"Out": ["y"]},
      {"axis": -1})],
    [("elementwise_add", {"X": ["x"], "Y": ["w"]}, {"Out": ["z"]},
      {"axis": -1})])
_COND_ATTRS = dict(true_block=1, false_block=2, true_out_names=["y"],
                   false_out_names=["z"], captured_names=["x", "w"])

_SWITCH_PROGRAM = _program(
    [("scale", {"X": ["x"]}, {"Out": ["a"]}, {"scale": 2.0})],
    [("scale", {"X": ["x"]}, {"Out": ["b"]}, {"scale": 10.0})],
    [("scale", {"X": ["x"]}, {"Out": ["d"]}, {"scale": -1.0,
                                             "bias": 0.5})])
_SWITCH_ATTRS = dict(blocks=[1, 2, 3], out_names=[["a"], ["b"], ["d"]],
                     captured_names=["x"])

_RNN_PROGRAM = _program(
    [("matmul", {"X": ["h"], "Y": ["w"]}, {"Out": ["hw"]}, {}),
     ("elementwise_add", {"X": ["hw"], "Y": ["xt"]}, {"Out": ["pre"]},
      {"axis": -1}),
     ("tanh", {"X": ["pre"]}, {"Out": ["nh"]}, {})])
_RNN_ATTRS = dict(sub_block=1, seq_step_names=["xt"], mem_names=["h"],
                  mem_update_names=["nh"], step_out_names=["nh"],
                  captured_names=["w"], length=4)


def _control_flow_cases() -> List[Case]:
    cases = [
        Case("while_loop_bounded", "while_loop", _WHILE_INPUTS,
             dict(_WHILE_ATTRS, max_trip_count=5), program=_WHILE_PROGRAM),
        # the reference's lax.while_loop cannot be reversed: no gradient
        Case("while_loop_unbounded", "while_loop", _WHILE_INPUTS,
             dict(_WHILE_ATTRS, max_trip_count=None), grad=False,
             program=_WHILE_PROGRAM),
        Case("while_lowered", "while", _WHILE_INPUTS,
             dict(_WHILE_ATTRS, max_trip_count=4), program=_WHILE_PROGRAM),
        Case("while_raw", "while", {"X": [f32(3, 2)]}, {"sub_block": 1},
             kind="error", check="lowered at the builder layer"),
        Case("recurrent", "recurrent", {"X": [f32(3, 2)]}, {},
             kind="error", check="StaticRNN or while_loop"),
        Case("static_rnn", "static_rnn",
             {"Sequences": [f32(4, 4, 2, 3, scale=0.5)],
              "Inits": [f32(5, 2, 3, scale=0.5)],
              "Captured": [f32(6, 3, 3, scale=0.5)]}, _RNN_ATTRS,
             program=_RNN_PROGRAM),
    ]
    for pred in (True, False):
        for op in ("conditional_block", "conditional_block_infer"):
            cases.append(Case(
                f"{op}_{pred}", op,
                {"Cond": [np.asarray([pred])],
                 "Captured": [f32(7, 2, 3), f32(8, 2, 3)]},
                _COND_ATTRS, program=_COND_PROGRAM))
    for idx in (0, 1, 2, -3):
        cases.append(Case(f"switch_{idx}", "switch",
                          {"BranchIndex": [np.asarray([idx], np.int32)],
                           "Captured": [f32(9, 3)]},
                          _SWITCH_ATTRS, program=_SWITCH_PROGRAM))
    return cases


# --------------------------------------------------------------- arrays
def _array_cases() -> List[Case]:
    buf = f32(11, 4, 3)
    mask = np.asarray([1, 0, 0, 1], np.int32)
    return [
        Case("write_to_array_new", "write_to_array",
             {"X": [f32(10, 3)], "I": [_i64(1)]}, {"max_size": 4}),
        # indices past each end are clamped, as lax's dynamic updates do
        Case("write_to_array_past_end", "write_to_array",
             {"Array": [buf], "X": [f32(12, 3)], "I": [_i64(9)]}, {}),
        Case("write_to_array_negative", "write_to_array",
             {"Array": [buf], "X": [f32(12, 3)], "I": [_i64(-2)]}, {}),
        Case("read_from_array", "read_from_array",
             {"X": [buf], "I": [_i64(2)]}, {}),
        Case("read_from_array_past_end", "read_from_array",
             {"X": [buf], "I": [_i64(9)]}, {}),
        Case("read_from_array_negative", "read_from_array",
             {"X": [buf], "I": [_i64(-1)]}, {}),
        Case("array_length", "array_length", {"X": [f32(13, 5, 2)]}, {},
             grad=False),
        Case("lod_array_length", "lod_array_length",
             {"X": [f32(13, 5, 2)]}, {}, grad=False),
        Case("lod_tensor_to_array", "lod_tensor_to_array",
             {"X": [f32(14, 2, 3, 4)]}, {}),
        Case("array_to_lod_tensor", "array_to_lod_tensor",
             {"X": [f32(15, 3, 2, 4)], "Length": [_i64(3, 2)]}, {}),
        Case("shrink_rnn_memory", "shrink_rnn_memory",
             {"X": [f32(16, 3, 2)], "I": [_i64(1)],
              "Length": [_i64(3, 1, 2)]}, {}),
        # host-side in the reference (no jax.vjp through them)
        Case("split_lod_tensor", "split_lod_tensor",
             {"X": [f32(17, 4, 2)], "Mask": [mask]}, {}, grad=False),
        Case("merge_lod_tensor", "merge_lod_tensor",
             {"InTrue": [f32(18, 2, 2)], "InFalse": [f32(19, 2, 2)],
              "Mask": [mask]}, {}, grad=False),
        Case("merge_lod_tensor_infer", "merge_lod_tensor_infer",
             {"InTrue": [f32(18, 2, 2)], "InFalse": [f32(19, 2, 2)],
              "Mask": [mask]}, {}, grad=False),
        *[Case(f"select_input_{m}", "select_input",
               {"X": [f32(20, 2), f32(21, 2)],
                "Mask": [np.asarray([m], np.int32)]}, {})
          for m in (1, 5, -1)],
        Case("select_output", "select_output",
             {"X": [f32(22, 2, 3)], "Mask": [np.asarray([1], np.int32)]},
             {"num_outputs": 3}),
        Case("lod_reset_target", "lod_reset", {"X": [f32(23, 2, 4)]},
             {"target_lod": [2, 3]}),
        Case("lod_reset_y", "lod_reset",
             {"X": [f32(23, 2, 4)], "Y": [_i64(4, 1)]}, {}),
    ]


# ---------------------------------------------------------------- parity
def _tree_info():
    """A 7-node binary tree: rows [item_id, layer_id, ancestor_id,
    child_0, child_1]; node 0 is a padding row."""
    return np.asarray([[0, 0, 0, 0, 0], [1, 1, 0, 2, 3], [2, 2, 1, 4, 5],
                       [3, 2, 1, 6, 0], [4, 3, 2, 0, 0], [5, 3, 2, 0, 0],
                       [6, 3, 3, 0, 0]], np.int64)


def _read_setup(ops, tmp):
    ops("parity_ops").register_reader(READER, iter([
        [np.arange(6, dtype=np.float32).reshape(2, 3), _i64(4, 5)]]))


def _bn_inputs(seed, c=3):
    return {"X": [f32(seed, 2, c, 4, 4)],
            "Scale": [uniform(seed + 1, 0.5, 1.5, c)],
            "Bias": [f32(seed + 2, c)],
            "Mean": [np.zeros(c, np.float32)],
            "Variance": [np.ones(c, np.float32)]}


_BN_ATTRS = {"epsilon": 1e-5, "momentum": 0.9, "is_test": False,
             "data_layout": "NCHW"}


def _parity_cases() -> List[Case]:
    rank = _i64(2, 5, 5, 1, 3)
    table = np.stack([np.argsort(-rank, kind="stable"),
                      rank[np.argsort(-rank, kind="stable")]], 1)
    arr = f32(30, 3, 2, 4)
    x = f32(31, 3, 4)
    return [
        Case("diag_vec", "diag", {"Diagonal": [f32(32, 3)]}, {}),
        Case("diag_mat", "diag", {"Diagonal": [f32(33, 3, 3)]}, {}),
        *[Case(f"diag_embed_{o}", "diag_embed", {"Input": [f32(34, 2, 3)]},
               {"offset": o}) for o in (0, 1, -1)],
        Case("fill_f32", "fill", {},
             {"shape": [2, 3], "value": [float(v) for v in range(6)],
              "dtype": "float32"}, grad=False),
        Case("fill_i64", "fill", {}, {"shape": [3], "value": [1, 5, 7],
                                      "dtype": "int64"}, grad=False),
        Case("fill_zeros_like2", "fill_zeros_like2", {"X": [x]}, {}),
        Case("grad_add", "grad_add", {"X": [x], "Y": [f32(35, 3, 4)]}, {}),
        Case("is_empty_no", "is_empty", {"X": [x]}, {}, grad=False),
        Case("is_empty_yes", "is_empty",
             {"X": [np.zeros((2, 0), np.float32)]}, {}, grad=False),
        Case("seed_attr", "seed", {}, {"seed": 5}, grad=False),
        Case("seed_drawn", "seed", {}, {"seed": 0}, kind="random",
             grad=False, check=lambda v: v.shape == () and v >= 1),
        Case("squared_l2_distance", "squared_l2_distance",
             {"X": [x], "Y": [f32(36, 3, 4)]}, {}),
        Case("squared_l2_distance_bcast", "squared_l2_distance",
             {"X": [x], "Y": [f32(36, 1, 4)]}, {}),
        Case("modified_huber_loss", "modified_huber_loss",
             {"X": [np.asarray([[-2.5], [-0.4], [0.3], [1.7], [-1.3],
                                [0.8]], np.float32)],
              "Y": [np.asarray([[1], [0], [1], [0], [0], [1]],
                               np.float32)]}, {}),
        Case("maxout", "maxout", {"X": [f32(37, 2, 6, 3, 3)]},
             {"groups": 2, "axis": 1}),
        Case("maxout_last_axis", "maxout", {"X": [f32(37, 2, 3, 6)]},
             {"groups": 3, "axis": -1}),
        Case("teacher_student_sigmoid_loss", "teacher_student_sigmoid_loss",
             {"X": [f32(38, 5, 1, scale=3.0)],
              "Label": [np.asarray([[0.], [1.], [0.3], [0.7], [-1.]],
                                   np.float32)]}, {}),
        Case("precision_recall", "precision_recall",
             {"MaxProbs": [uniform(39, 0, 1, 6, 1)],
              "Indices": [ints(40, 0, 3, 6, 1)],
              "Labels": [ints(41, 0, 3, 6, 1)],
              "StatesInfo": [uniform(42, 0, 4, 3, 4).round()]},
             {"class_number": 3}, grad=False),
        Case("polygon_box_transform", "polygon_box_transform",
             {"Input": [f32(43, 1, 4, 3, 5)]}, {}, grad=False),
        Case("assert_true", "assert",
             {"Cond": [np.asarray([True, True])], "Data": [x]}, {},
             grad=False),
        Case("assert_false", "assert", {"Cond": [np.asarray([True, False])]},
             {"summarize": 3}, kind="error", check="Assert failed"),
        Case("delete_var", "delete_var", {"X": [x]}, {}, grad=False),
        # the device count: 8 virtual CPU devices in the JAX tests, the
        # port's own count here
        Case("get_places", "get_places", {}, {}, kind="shape", grad=False),
        Case("fc", "fc", {"Input": [f32(44, 2, 3, 4)], "W": [f32(45, 4, 5)],
                          "Bias": [f32(46, 5)]},
             {"in_num_col_dims": 2, "activation_type": "relu"}),
        Case("fc_flatten", "fc", {"Input": [f32(44, 2, 3, 4)],
                                  "W": [f32(47, 12, 5)]},
             {"in_num_col_dims": 1}),
        Case("feed", "feed", {"X": [x]}, {}),
        Case("fetch", "fetch", {"X": [x]}, {}),
        Case("lod_rank_table", "lod_rank_table", {"X": [rank]}, {},
             grad=False),
        Case("max_sequence_len", "max_sequence_len", {"RankTable": [table]},
             {}, grad=False),
        Case("reorder_lod_tensor_by_rank", "reorder_lod_tensor_by_rank",
             {"X": [f32(48, 5, 3)], "RankTable": [table]}, {}),
        Case("rnn_memory_helper", "rnn_memory_helper", {"X": [x]}, {}),
        *[Case(f"tensor_array_to_tensor_{axis}_{stack}",
               "tensor_array_to_tensor", {"X": [arr]},
               {"axis": axis, "use_stack": stack})
          for axis in (0, 1, -1) for stack in (False, True)],
        Case("read", "read", {}, {"reader_name": READER}, grad=False,
             setup=_read_setup),
        Case("create_custom_reader", "create_custom_reader", {}, {},
             grad=False),
        Case("conv2d_fusion", "conv2d_fusion",
             {"Input": [f32(49, 1, 3, 6, 6)], "Filter": [f32(50, 4, 3, 3, 3)],
              "Bias": [f32(51, 4)], "ResidualData": [f32(52, 1, 4, 4, 4)]},
             {"strides": [1, 1], "paddings": [0, 0], "dilations": [1, 1],
              "groups": 1, "activation": "relu"}, tol=CONV, grad_tol=CONV),
        Case("conv2d_fusion_identity", "conv2d_fusion",
             {"Input": [f32(49, 1, 3, 6, 6)], "Filter": [f32(50, 4, 3, 3, 3)]},
             {"strides": [2, 2], "paddings": [1, 1], "dilations": [1, 1],
              "groups": 1, "activation": "identity"}, tol=CONV,
             grad_tol=CONV),
        Case("conv2d_inception_fusion", "conv2d_inception_fusion",
             {"Input": [f32(53, 1, 3, 5, 5)],
              "Filter": [f32(54 + i, 2, 3, k, k)
                         for i, k in enumerate((1, 3, 5, 3))],
              "Bias": [f32(58 + i, 2) for i in range(4)]}, {},
             tol=CONV, grad_tol=CONV),
        Case("fused_batch_norm_act", "fused_batch_norm_act",
             _bn_inputs(60), dict(_BN_ATTRS, act_type="relu"),
             tol=CONV, grad_tol=CONV),
        Case("fused_bn_add_activation", "fused_bn_add_activation",
             dict(_bn_inputs(61), Z=[f32(65, 2, 3, 4, 4)]),
             dict(_BN_ATTRS, act_type="relu"), tol=CONV, grad_tol=CONV),
        Case("fused_elemwise_add_scale", "fused_elemwise_activation",
             {"X": [x], "Y": [f32(66, 3, 4)]},
             {"functor_list": ["elementwise_add", "scale"], "scale": 2.0}),
        Case("fused_elemwise_relu_mul", "fused_elemwise_activation",
             {"X": [x], "Y": [f32(67, 3, 4)]},
             {"functor_list": ["relu", "elementwise_mul"]}),
        Case("fused_embedding_seq_pool_pad", "fused_embedding_seq_pool",
             {"W": [f32(68, 10, 4)], "Ids": [ints(69, 0, 10, 3, 5)]},
             {"padding_idx": -1}),
        Case("fused_embedding_seq_pool_len", "fused_embedding_seq_pool",
             {"W": [f32(68, 10, 4)], "Ids": [ints(69, 0, 10, 3, 5, 1)],
              "Length": [_i64(5, 2, 0)]}, {}),
        Case("fused_fc_elementwise_layernorm",
             "fused_fc_elementwise_layernorm",
             {"X": [x], "W": [f32(70, 4, 5)], "Bias0": [f32(71, 5)],
              "Y": [f32(72, 3, 5)], "Scale": [f32(73, 5)],
              "Bias1": [f32(74, 5)]}, {"epsilon": 1e-5}),
        Case("fusion_transpose_flatten_concat",
             "fusion_transpose_flatten_concat",
             {"X": [f32(75, 2, 3, 4, 5), f32(76, 2, 3, 4, 5)]},
             {"trans_axis": [0, 2, 3, 1], "flatten_axis": 1,
              "concat_axis": 1}),
        Case("match_matrix_tensor", "match_matrix_tensor",
             {"X": [f32(77, 2, 3, 4)], "Y": [f32(78, 2, 5, 6)],
              "W": [f32(79, 4, 2, 6)]}, {}),
        Case("sequence_topk_avg_pooling", "sequence_topk_avg_pooling",
             {"X": [f32(80, 2, 3, 4, 5)]}, {"topks": [1, 3, 7]}),
        Case("sequence_expand_as", "sequence_expand_as",
             {"X": [f32(81, 3, 2)], "RefLength": [_i64(2, 0, 3)]}, {}),
        Case("sequence_expand_as_max_len", "sequence_expand_as",
             {"X": [f32(81, 3, 2)], "RefLength": [_i64(2, 0, 3)]},
             {"max_len": 4}),
        Case("spp_max", "spp", {"X": [f32(82, 1, 2, 8, 8)]},
             {"pyramid_height": 3, "pooling_type": "max"}),
        Case("spp_avg", "spp", {"X": [f32(82, 1, 2, 8, 8)]},
             {"pyramid_height": 2, "pooling_type": "avg"}),
        Case("tdm_child", "tdm_child",
             {"X": [_i64(1, 2, 3).reshape(3, 1)],
              "TreeInfo": [_tree_info()]}, {"child_nums": 2}, grad=False),
        Case("tdm_child_int32", "tdm_child",
             {"X": [_i64(2, 6)], "TreeInfo": [_tree_info()]},
             {"child_nums": 2, "dtype": "int32"}, grad=False),
        # numpy's RandomState(seed) draws in both packages
        Case("tdm_sampler", "tdm_sampler",
             {"X": [_i64(0, 1)], "Travel": [_i64(2, 4, 3, 0).reshape(2, 2)],
              "Layer": [_i64(2, 3, 4, 5, 6, 1).reshape(6, 1)]},
             {"neg_samples_num_list": [1, 2],
              "layer_offset_lod": [0, 2, 6], "seed": 7}, grad=False),
        Case("tdm_sampler_negatives_only", "tdm_sampler",
             {"X": [_i64(0, 1)], "Travel": [_i64(2, 4, 3, 5).reshape(2, 2)],
              "Layer": [_i64(2, 3, 4, 5, 6, 1).reshape(6, 1)]},
             {"neg_samples_num_list": [2], "layer_offset_lod": [0, 2, 6],
              "seed": 3, "output_positive": False}, grad=False),
        Case("fake_quantize_range_abs_max", "fake_quantize_range_abs_max",
             {"X": [x], "InScale": [np.asarray([3.0], np.float32)]},
             {"bit_length": 8}, grad=False),
        Case("fake_quantize_moving_average_abs_max",
             "fake_quantize_moving_average_abs_max",
             {"X": [x], "InScale": [np.asarray([1.0], np.float32)],
              "InState": [np.asarray([2.0], np.float32)],
              "InAccum": [np.asarray([3.0], np.float32)]},
             {"bit_length": 8, "moving_rate": 0.9}, grad=False),
        *[Case(f"fake_channel_wise_quantize_abs_max_{a}",
               "fake_channel_wise_quantize_abs_max",
               {"X": [f32(83, 3, 4, 2)]}, {"bit_length": 8, "quant_axis": a},
               grad=False) for a in (0, 1)],
        Case("fake_channel_wise_dequantize_max_abs",
             "fake_channel_wise_dequantize_max_abs",
             {"X": [x], "Scales": [uniform(84, 0.5, 2, 3)]},
             {"quant_bits": [8], "quant_axis": 0}),
        Case("fake_channel_wise_dequantize_max_abs_two",
             "fake_channel_wise_dequantize_max_abs",
             {"X": [x], "Scales": [uniform(85, 0.5, 2, 4),
                                   np.asarray([3.0], np.float32)]},
             {"quant_bits": [8, 4], "quant_axis": 1}),
        Case("dequantize_abs_max", "dequantize_abs_max",
             {"X": [ints(86, -127, 128, 3, 4, dtype=np.int8)],
              "Scale": [np.asarray([2.5], np.float32)]},
             {"max_range": 127.0}, grad=False),
        Case("dequantize_log", "dequantize_log",
             {"X": [ints(87, 0, 256, 3, 4, dtype=np.uint8)],
              "Dict": [uniform(88, 0, 1, 128)]}, {}, grad=False),
        Case("lookup_table_dequant", "lookup_table_dequant",
             {"W": [uniform(89, 0, 2, 10, 6)],
              "Ids": [ints(90, 0, 10, 3, 1)]}, {}),
        Case("sequence_enumerate", "sequence_enumerate",
             {"X": [ints(91, 1, 9, 2, 5)]}, {"win_size": 3, "pad_value": 0},
             grad=False),
    ]


# ------------------------------------------------------------------ misc
def _py_fn(x):
    return x * 2.0 + 1.0


def _py_setup(ops, tmp):
    ops("misc_ops")._PY_FUNCS[PY_FUNC_ID] = _py_fn


def _load_setup(ops, tmp):
    np.save(os.path.join(tmp, "load_x.npy"), f32(100, 3, 2))


def _load_combine_setup(ops, tmp):
    np.savez(os.path.join(tmp, "lc.npz"), a=f32(101, 2),
             b=ints(102, 0, 5, 3))


def _rois():
    return np.asarray([[0.0, 1.0, 5.0, 6.0], [2.0, 2.0, 7.0, 4.0],
                       [1.0, 0.0, 3.0, 7.0]], np.float32)


def _lstm_weights(seed, din, h, layers, dirs):
    out = []
    for layer in range(layers):
        d = din if layer == 0 else h * dirs
        for k in range(dirs):
            s = seed + 10 * layer + 3 * k
            out += [f32(s, d, 4 * h, scale=0.3), f32(s + 1, h, 4 * h,
                                                   scale=0.3),
                    f32(s + 2, 4 * h, scale=0.3)]
    return out


def _run_program_json():
    from ..core.program import Program
    prog = Program()
    prog.global_block().append_op(
        "elementwise_mul", {"X": ["x"], "Y": ["w"]}, {"Out": ["y"]},
        {"axis": -1})
    return prog.to_json()


def _misc_cases() -> List[Case]:
    lstm_in = f32(110, 4, 3, 5)
    return [
        Case("roi_pool", "roi_pool",
             {"X": [f32(103, 2, 3, 8, 8)], "ROIs": [_rois()],
              "RoisNum": [np.asarray([2, 1], np.int32)]},
             {"pooled_height": 2, "pooled_width": 2, "spatial_scale": 1.0}),
        Case("roi_pool_scaled", "roi_pool",
             {"X": [f32(103, 1, 3, 8, 8)], "ROIs": [_rois() * 2.0]},
             {"pooled_height": 3, "pooled_width": 2, "spatial_scale": 0.5}),
        Case("psroi_pool", "psroi_pool",
             {"X": [f32(104, 2, 8, 6, 6)], "ROIs": [_rois() * 0.7],
              "RoisNum": [np.asarray([2, 1], np.int32)]},
             {"pooled_height": 2, "pooled_width": 2, "output_channels": 2,
              "spatial_scale": 1.0}),
        Case("prroi_pool", "prroi_pool",
             {"X": [f32(105, 2, 3, 6, 6)], "ROIs": [_rois() * 0.7],
              "BatchRoINums": [np.asarray([1, 2], np.int64)]},
             {"pooled_height": 2, "pooled_width": 2, "spatial_scale": 1.0,
              "sample_num": 2}),
        Case("cvm", "cvm", {"X": [uniform(106, 0, 5, 4, 5)]},
             {"use_cvm": True}),
        Case("cvm_strip", "cvm", {"X": [uniform(106, 0, 5, 4, 5)]},
             {"use_cvm": False}),
        Case("batch_fc", "batch_fc",
             {"Input": [f32(107, 2, 3, 4)], "W": [f32(108, 2, 4, 5)],
              "Bias": [f32(109, 2, 5)]}, {}),
        Case("shuffle_batch", "shuffle_batch",
             {"X": [f32(111, 5, 3)], "Seed": [_i64(7)]},
             {"startup_seed": 0}, kind="draws"),
        Case("filter_by_instag", "filter_by_instag",
             {"Ins": [f32(112, 4, 3)], "Ins_tag": [_i64(1, 2, 3, 2)],
              "Filter_tag": [_i64(2)]}, {}, grad=False),
        Case("filter_by_instag_empty", "filter_by_instag",
             {"Ins": [f32(112, 4, 3)], "Ins_tag": [_i64(1, 2, 3, 2)],
              "Filter_tag": [_i64(9)]}, {"out_val_if_empty": 0.5},
             grad=False),
        Case("sample_logits", "sample_logits",
             {"Logits": [f32(113, 3, 6)], "Labels": [ints(114, 0, 6, 3, 1)],
              "Seed": [_i64(11)]}, {"num_samples": 4}, kind="draws"),
        Case("sample_logits_customized", "sample_logits",
             {"Logits": [f32(113, 3, 6)], "Labels": [ints(114, 0, 6, 3, 1)],
              "CustomizedSamples": [ints(115, 0, 6, 3, 3)],
              "CustomizedProbabilities": [uniform(116, 0.1, 0.9, 3, 3)]},
             {"num_samples": 2}),
        Case("im2sequence", "im2sequence", {"X": [f32(117, 2, 2, 5, 5)]},
             {"kernels": [2, 3], "strides": [1, 2],
              "paddings": [1, 0, 1, 1]}),
        Case("correlation", "correlation",
             {"Input1": [f32(118, 1, 2, 6, 6)],
              "Input2": [f32(119, 1, 2, 6, 6)]},
             {"pad_size": 2, "kernel_size": 1, "max_displacement": 2,
              "stride1": 1, "stride2": 1}),
        Case("correlation_k3", "correlation",
             {"Input1": [f32(118, 1, 2, 6, 6)],
              "Input2": [f32(119, 1, 2, 6, 6)]},
             {"pad_size": 2, "kernel_size": 3, "max_displacement": 1,
              "stride1": 1, "stride2": 1}),
        Case("py_func", "py_func", {"X": [f32(120, 3)]},
             {"forward_callable_id": PY_FUNC_ID}, grad=False,
             setup=_py_setup),
        Case("print", "print", {"In": [f32(121, 3)]},
             {"message": "cf_cases print: ", "first_n": 1}, grad=False),
        Case("save", "save", {"X": [f32(122, 3, 2)]},
             {"file_path": "{tmp}/save_x.npy"}, grad=False),
        Case("load", "load", {}, {"file_path": "{tmp}/load_x"},
             grad=False, setup=_load_setup),
        Case("save_combine", "save_combine",
             {"X": [f32(123, 2), ints(124, 0, 5, 3)]},
             {"names": ["a", "b"], "file_path": "{tmp}/sc.npz"},
             grad=False),
        Case("load_combine", "load_combine", {},
             {"names": ["b", "a"], "file_path": "{tmp}/lc"}, grad=False,
             setup=_load_combine_setup),
        Case("inplace_abn_leaky", "inplace_abn", _bn_inputs(125),
             dict(_BN_ATTRS, activation="leaky_relu", alpha=0.1),
             tol=CONV, grad_tol=CONV),
        Case("inplace_abn_elu", "inplace_abn", _bn_inputs(126),
             dict(_BN_ATTRS, activation="elu", alpha=1.0),
             tol=CONV, grad_tol=CONV),
        Case("cudnn_lstm", "cudnn_lstm",
             {"Input": [lstm_in], "InitH": [f32(127, 2, 3, 6)],
              "InitC": [f32(128, 2, 3, 6)],
              "WeightList": _lstm_weights(130, 5, 6, 2, 1)},
             {"num_layers": 2, "is_bidirec": False}, tol=CONV,
             grad_tol=CONV),
        Case("cudnn_lstm_bidirec", "cudnn_lstm",
             {"Input": [lstm_in], "InitH": [f32(127, 2, 3, 6)],
              "InitC": [f32(128, 2, 3, 6)],
              "WeightList": _lstm_weights(160, 5, 6, 1, 2)},
             {"num_layers": 1, "is_bidirec": True}, tol=CONV,
             grad_tol=CONV),
        # padded rows: state frozen past each row's length, outputs zero
        Case("cudnn_lstm_seq_len", "cudnn_lstm",
             {"Input": [lstm_in], "InitH": [f32(127, 2, 3, 6)],
              "InitC": [f32(128, 2, 3, 6)],
              "WeightList": _lstm_weights(190, 5, 6, 1, 2),
              "SequenceLength": [np.asarray([4, 2, 3], np.int32)]},
             {"num_layers": 1, "is_bidirec": True}, tol=CONV,
             grad_tol=CONV),
        Case("expand_as", "expand_as",
             {"X": [f32(129, 2, 3)], "target_tensor": [f32(131, 4, 6)]}, {}),
        Case("split_byref", "split_byref", {"X": [f32(132, 4, 6)]},
             {"num": 2, "axis": 1}),
        Case("split_byref_sections", "split_byref", {"X": [f32(132, 4, 6)]},
             {"sections": [1, 3], "axis": 0}),
        Case("quantize", "quantize", {"Input": [f32(133, 3, 4, scale=5.0)]},
             {"Scale": 10.0, "Shift": 0.5}, grad=False),
        Case("dequantize", "dequantize",
             {"Input": [ints(134, -128, 128, 3, 4, dtype=np.int8)]},
             {"Scale": 10.0, "Shift": 0.5}, grad=False),
        Case("requantize", "requantize",
             {"Input": [ints(135, -128, 128, 3, 4, dtype=np.int8)]},
             {"Scale_in": 10.0, "Scale_out": 5.0}, grad=False),
        Case("run_program", "run_program",
             {"X": [f32(136, 2, 3)], "Params": [f32(137, 2, 3)]},
             {"program": _run_program_json(), "feed_names": ["x"],
              "fetch_names": ["y"], "param_names": ["w"]}, grad=False),
    ]


# --------------------------------------------------------------- special
def _special_cases() -> List[Case]:
    offs = np.asarray([[1, 1, 0, 2, 2], [2, 2, 1, 1, 3], [0, 1, 0, 2, 1],
                       [2, 0, 0, 2, 3]], np.int64)
    edges = np.asarray([[[0, 1], [0, 2], [1, 3], [-1, -1]],
                        [[0, 4], [4, 1], [1, 2], [2, 3]]], np.int64)
    toks = np.asarray([[3, 7, 1, 0, 0], [2, 9, 9, 4, 8]], np.int32)
    return [
        Case("rank_attention", "rank_attention",
             {"X": [f32(140, 4, 3)], "RankOffset": [offs],
              "RankParam": [f32(141, 2 * 2 * 3, 5)]}, {"MaxRank": 2}),
        Case("tree_conv", "tree_conv",
             {"NodesVector": [f32(142, 2, 5, 3)], "EdgeSet": [edges],
              "Filter": [f32(143, 3, 3, 2, 2)]}, {"max_depth": 2}),
        Case("tree_conv_deep", "tree_conv",
             {"NodesVector": [f32(142, 2, 5, 3)], "EdgeSet": [edges],
              "Filter": [f32(143, 3, 3, 2, 2)]}, {"max_depth": 3}),
        *[Case(f"var_conv_2d_stride{s}", "var_conv_2d",
               {"X": [f32(144, 2, 2, 5, 5)], "ROW": [_i64(5, 3)],
                "COLUMN": [_i64(4, 5)], "W": [f32(145, 3, 2 * 3 * 3)]},
               {"OutputChannel": 3, "KernelH": 3, "KernelW": 3,
                "StrideH": s, "StrideW": s}, tol=CONV, grad_tol=CONV)
          for s in (1, 2)],
        Case("pyramid_hash", "pyramid_hash",
             {"X": [toks], "W": [f32(146, 16, 4)]},
             {"num_emb": 8, "space_len": 16, "pyramid_layer": 3,
              "rand_len": 4, "seed": 1}),
        # the guide's gradient sums the eight taps' weight derivatives
        # over every coefficient channel, with cancellation: the card
        # orders that sum otherwise (9.5e-6 apart, past 1e-6 + 1e-5 x |value|)
        *[Case(f"bilateral_slice_{o}", "bilateral_slice",
               {"Grid": [f32(147, 1, 6 if o else 4, 4, 3, 3)],
                "Guide": [uniform(148, 0, 1, 1, 5, 5)],
                "X": [f32(149, 1, 2, 5, 5)]}, {"has_offset": o},
               tol=CONV, grad_tol=CONV)
          for o in (True, False)],
    ]


CF_CASES: List[Case] = (_control_flow_cases() + _array_cases() +
                        _parity_cases() + _misc_cases() + _special_cases())
