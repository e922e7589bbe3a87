"""Small cases of the 19 op types the sequence slice brought to the port:
``ops/sequence_ops.py`` (11 more) and ``ops/rnn_ops.py`` (8 more).
``tests/test_torch_sequence_ops.py`` and ``tests/test_torch_rnn.py`` run
them through both packages' registries on the CPU; ``chip_smoke.py``
phase ``seq_ops`` runs them through the port on the card and on the CPU.
:class:`Case` and its kinds are ``op_cases``'s.

The ragged cases hold a full-length, a zero-length and a partial row
(lengths 5, 0, 3 of a window of 5). ``lstm`` runs ``is_reverse`` with
``Length`` (each row reversed within its own length) and without it
(the whole window). Elementwise and gather cases hold at fp32's rtol
1e-5 / atol 1e-6; the recurrences and their gradients, sums over the
steps of products through sigmoid and tanh, at rtol 1e-4 / atol 2e-5.
"""
from __future__ import annotations

from typing import List

import numpy as np

from .op_cases import Case, f32

# sums over the time steps of products through the gates
RECURRENT = (1e-4, 2e-5)

# reference module -> the op types this slice takes from it
SLICE = {"paddle_tpu.ops.sequence_ops": 11, "paddle_tpu.ops.rnn_ops": 8}

LENGTHS = np.asarray([5, 0, 3], np.int64)     # full, empty, partial


def _i64(*vals):
    return np.asarray(vals, np.int64)


def _sequence_cases() -> List[Case]:
    ln = [LENGTHS]
    return [
        Case("sequence_mask", "sequence_mask", {"X": ln},
             {"maxlen": 6, "out_dtype": "int64"}, grad=False),
        Case("sequence_mask_from_data", "sequence_mask", {"X": ln},
             {"maxlen": -1, "out_dtype": "float32"}, grad=False),
        Case("sequence_mask_maxlen_tensor", "sequence_mask",
             {"X": ln, "MaxLenTensor": [f32(1, 7, 3)]},
             {"maxlen": -1, "out_dtype": "int32"}, grad=False),
        Case("sequence_softmax", "sequence_softmax",
             {"X": [f32(2, 3, 5)], "Length": ln}, {}),
        Case("sequence_expand", "sequence_expand",
             {"X": [f32(3, 3, 4)], "RefLength": [_i64(2, 0, 3)]},
             {"maxlen": 4}),
        Case("sequence_expand_from_data", "sequence_expand",
             {"X": [f32(4, 3, 2, 2)], "RefLength": [_i64(1, 0, 3)]}, {}),
        Case("sequence_reverse", "sequence_reverse",
             {"X": [f32(5, 3, 5, 2)], "Length": ln}, {}),
        Case("sequence_pad_extend", "sequence_pad",
             {"X": [f32(6, 3, 5, 2)], "Length": ln},
             {"padded_length": 7, "pad_value": 0.5}),
        Case("sequence_pad_value_tensor", "sequence_pad",
             {"X": [f32(7, 3, 5, 2)], "Length": ln,
              "PadValue": [np.asarray([-2.0], np.float32)]},
             {"padded_length": 4}),
        Case("sequence_unpad", "sequence_unpad",
             {"X": [f32(8, 3, 5, 2)], "Length": ln}, {}),
        Case("sequence_concat", "sequence_concat",
             {"X": [f32(9, 3, 2, 2), f32(10, 3, 4, 2)]}, {}),
        # id 5 is past num_segments and is dropped, as is -1
        Case("segment_pool_sum", "segment_pool",
             {"X": [f32(11, 6, 3)], "SegmentIds": [_i64(0, 0, 2, 5, 2, -1)]},
             {"num_segments": 4, "pooltype": "SUM"}),
        Case("segment_pool_mean", "segment_pool",
             {"X": [f32(12, 6, 3)], "SegmentIds": [_i64(1, 0, 1, 1, 3, 0)]},
             {"num_segments": 4, "pooltype": "MEAN"}),
        Case("segment_pool_from_data", "segment_pool",
             {"X": [f32(13, 5, 2)], "SegmentIds": [_i64(2, 0, 2, 1, 0)]},
             {"pooltype": "SUM"}),
        Case("sequence_reshape", "sequence_reshape",
             {"X": [f32(14, 2, 3, 4)], "Length": [_i64(3, 2)]},
             {"new_dim": 6}),
        Case("sequence_reshape_indivisible", "sequence_reshape",
             {"X": [f32(15, 2, 3, 4)]}, {"new_dim": 5}, kind="error",
             check="not divisible"),
        # a repeated id accumulates; -1 counts from the end, 9 is dropped
        Case("sequence_scatter", "sequence_scatter",
             {"X": [f32(16, 2, 4, 2)], "Ids": [np.asarray(
                 [[0, 2, -1], [1, 1, 9]], np.int64)],
              "Updates": [f32(17, 2, 3, 2)]}, {}),
        Case("sequence_slice", "sequence_slice",
             {"X": [f32(18, 2, 6, 2)], "Offset": [_i64(1, 3)],
              "Length": [_i64(2, 3)]}, {"max_out_len": 4}),
        # row 0 overruns the window, row 1 the output width
        Case("sequence_slice_clamped", "sequence_slice",
             {"X": [f32(19, 2, 5)], "Offset": [_i64(3, 0)],
              "Length": [_i64(4, 6)]}, {"max_out_len": 4}),
    ]


_GATES = {"LSTM": 4, "GRU": 3, "RNN_TANH": 1, "RNN_RELU": 1}


def _rnn_scan_case(cid, mode, seed, bias=True, init=False, reverse=False):
    g, h, i = _GATES[mode], 5, 3
    ins = {"X": [f32(seed, 2, 4, i)],
           "WeightIh": [f32(seed + 1, g * h, i, scale=0.4)],
           "WeightHh": [f32(seed + 2, g * h, h, scale=0.4)]}
    if bias:
        ins["BiasIh"] = [f32(seed + 3, g * h, scale=0.2)]
        ins["BiasHh"] = [f32(seed + 4, g * h, scale=0.2)]
    if init:
        ins["InitH"] = [f32(seed + 5, 2, h, scale=0.5)]
        if mode == "LSTM":
            ins["InitC"] = [f32(seed + 6, 2, h, scale=0.5)]
    return Case(cid, "rnn_scan", ins, {"mode": mode, "is_reverse": reverse},
                tol=RECURRENT, grad_tol=RECURRENT)


def _lstm_case(cid, seed, peep=True, length=True, reverse=False,
               init=False):
    d = 3
    ins = {"Input": [f32(seed, 3, 5, 4 * d, scale=0.5)],
           "Weight": [f32(seed + 1, d, 4 * d, scale=0.4)],
           "Bias": [f32(seed + 2, 1, (7 if peep else 4) * d, scale=0.3)]}
    if length:
        ins["Length"] = [LENGTHS]
    if init:
        ins["H0"] = [f32(seed + 3, 3, d, scale=0.5)]
        ins["C0"] = [f32(seed + 4, 3, d, scale=0.5)]
    return Case(cid, "lstm", ins, {"use_peepholes": peep,
                                   "is_reverse": reverse},
                tol=RECURRENT, grad_tol=RECURRENT)


def _gru_case(cid, seed, origin=False, reverse=False):
    d = 3
    return Case(cid, "gru",
                {"Input": [f32(seed, 2, 4, 3 * d, scale=0.5)],
                 "Weight": [f32(seed + 1, d, 3 * d, scale=0.4)],
                 "Bias": [f32(seed + 2, 1, 3 * d, scale=0.3)],
                 "H0": [f32(seed + 3, 2, d, scale=0.5)]},
                {"origin_mode": origin, "is_reverse": reverse},
                tol=RECURRENT, grad_tol=RECURRENT)


def _rnn_cases() -> List[Case]:
    d, p = 3, 2
    return [
        _rnn_scan_case("rnn_scan_lstm", "LSTM", 30),
        _rnn_scan_case("rnn_scan_lstm_init_reverse", "LSTM", 40,
                       init=True, reverse=True),
        _rnn_scan_case("rnn_scan_gru", "GRU", 50, init=True),
        _rnn_scan_case("rnn_scan_gru_reverse_no_bias", "GRU", 60,
                       bias=False, reverse=True),
        _rnn_scan_case("rnn_scan_tanh", "RNN_TANH", 70, init=True),
        _rnn_scan_case("rnn_scan_relu", "RNN_RELU", 80),
        _lstm_case("lstm_peepholes_length", 90),
        _lstm_case("lstm_reverse_length", 100, reverse=True, init=True),
        _lstm_case("lstm_reverse_window", 110, length=False, reverse=True),
        _lstm_case("lstm_plain", 120, peep=False, length=False),
        Case("lstm_bias_shape", "lstm",
             {"Input": [f32(125, 2, 3, 12)], "Weight": [f32(126, 3, 12)],
              "Bias": [f32(127, 1, 12)]}, {"use_peepholes": True},
             kind="error", check="lstm Bias must be"),
        Case("lstmp", "lstmp",
             {"Input": [f32(130, 2, 4, 4 * d, scale=0.5)],
              "Weight": [f32(131, p, 4 * d, scale=0.4)],
              "ProjWeight": [f32(132, d, p, scale=0.4)],
              "Bias": [f32(133, 1, 4 * d, scale=0.3)]}, {},
             tol=RECURRENT, grad_tol=RECURRENT),
        Case("lstmp_reverse_init", "lstmp",
             {"Input": [f32(140, 2, 4, 4 * d, scale=0.5)],
              "Weight": [f32(141, p, 4 * d, scale=0.4)],
              "ProjWeight": [f32(142, d, p, scale=0.4)],
              "H0": [f32(143, 2, p, scale=0.5)],
              "C0": [f32(144, 2, d, scale=0.5)]},
             {"is_reverse": True, "proj_activation": "identity"},
             tol=RECURRENT, grad_tol=RECURRENT),
        _gru_case("gru", 150),
        _gru_case("gru_origin_reverse", 160, origin=True, reverse=True),
        Case("gru_unit", "gru_unit",
             {"Input": [f32(170, 3, 3 * d)],
              "HiddenPrev": [f32(171, 3, d)],
              "Weight": [f32(172, d, 3 * d, scale=0.5)],
              "Bias": [f32(173, 1, 3 * d, scale=0.3)]},
             {"gate_activation": 1, "activation": 2}),
        Case("gru_unit_origin_relu", "gru_unit",
             {"Input": [f32(180, 3, 3 * d)],
              "HiddenPrev": [f32(181, 3, d)],
              "Weight": [f32(182, d, 3 * d, scale=0.5)]},
             {"gate_activation": 1, "activation": 3, "origin_mode": True}),
        Case("lstm_unit", "lstm_unit",
             {"X": [f32(190, 3, 8)], "C_prev": [f32(191, 3, 2)]},
             {"forget_bias": 0.5}),
        Case("row_conv", "row_conv",
             {"X": [f32(200, 2, 5, 3)], "Filter": [f32(201, 3, 3)]}, {}),
        Case("conv_shift", "conv_shift",
             {"X": [f32(210, 2, 5)], "Y": [f32(211, 2, 3)]}, {}),
    ]


SEQ_CASES = _sequence_cases() + _rnn_cases()
SEQ_TYPES = frozenset(c.op for c in SEQ_CASES)
