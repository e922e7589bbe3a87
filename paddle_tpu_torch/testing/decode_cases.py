"""Small cases of the 27 op types the decoding slice brought to the port:
``ops/decode_ops.py`` (6 more), ``ops/fusion_ops.py`` (9),
``fusion_seqpool_cvm_concat`` (``ops/parity_ops.py``),
``deformable_conv_v1`` (``ops/misc_ops.py``) and ``ops/long_tail_ops.py``
(10 more). ``tests/test_torch_decode_ops.py``,
``tests/test_torch_fusion_ops.py`` and ``tests/test_torch_long_tail_ops.py``
run them through both packages' registries on the CPU; ``chip_smoke.py``
phase ``decode_ops`` runs them through the port on the card and on the
CPU. :class:`Case` and its kinds are ``op_cases``'s; ``"draws"`` cases
(``sampling_id``, ``random_crop``) draw from torch's generators on the
CPU, so the card and the CPU draw the same numbers, and the CPU tests
hold them to their contracts, not to the JAX package's draws.

Besides the cases: a true-LoD ``beam_search`` step (:data:`LOD_STEP`)
and ``beam_search_decode`` over tensor arrays of LoD entries
(:func:`lod_arrays`), and a static program that decodes with beam search
over LoD arrays in the shape of the book's machine-translation decode
(:func:`mt_decode_program`).

Bounds: integer outputs equal; fp32 ops at rtol 1e-5 / atol 1e-6; the
recurrences (a sum over the steps of products through sigmoid and tanh)
and CTC's forward algorithm (sums of T products in log space) at rtol
1e-4 / atol 2e-5; the bilinear samples and convolutions at ``CONV``.
"""
from __future__ import annotations

from typing import List

import numpy as np

from .op_cases import Case, f32, ints, uniform

RECURRENT = (1e-4, 2e-5)
CONV = (1e-4, 2e-5)

# reference module -> the op types this slice takes from it
SLICE = {"paddle_tpu.ops.decode_ops": 6, "paddle_tpu.ops.fusion_ops": 9,
         "paddle_tpu.ops.parity_ops": 1, "paddle_tpu.ops.misc_ops": 1,
         "paddle_tpu.ops.long_tail_ops": 10}


def _i64(*vals):
    return np.asarray(vals, np.int64)


def _decode_cases() -> List[Case]:
    # label [1, 1, 2] needs 4 steps (a blank between the repeats)
    label = np.asarray([[1, 1, 2], [3, 4, 0], [2, 0, 0]], np.int64)
    # a Viterbi decode over small integers: ties in every step
    tie_em = ints(20, 0, 3, 3, 5, 4).astype(np.float32)
    tie_tr = ints(21, 0, 2, 6, 4).astype(np.float32)
    return [
        Case("warpctc", "warpctc",
             {"Logits": [f32(1, 3, 6, 5)], "Label": [label],
              "LogitsLength": [_i64(6, 4, 6)],
              "LabelLength": [_i64(3, 2, 1)]}, {"blank": 0},
             tol=RECURRENT, grad_tol=RECURRENT),
        # blank 2: the labels hold no 2; no lengths; the loss divided by T
        Case("warpctc_blank_norm_by_times", "warpctc",
             {"Logits": [f32(2, 2, 5, 4, scale=2.0)],
              "Label": [np.asarray([[1, 3], [3, 3]], np.int64)]},
             {"blank": 2, "norm_by_times": True},
             tol=RECURRENT, grad_tol=RECURRENT),
        # row 0 needs 5 steps of 3 (1, 1, 1 with blanks between): no path
        Case("warpctc_infeasible", "warpctc",
             {"Logits": [f32(3, 2, 3, 4)],
              "Label": [np.asarray([[1, 1, 1], [2, 3, 0]], np.int64)],
              "LabelLength": [_i64(3, 2)]}, {}, grad=False,
             tol=RECURRENT),
        Case("ctc_align", "ctc_align",
             {"Input": [np.asarray([[0, 1, 1, 0, 2, 2, 0, 3],
                                    [4, 4, 4, 0, 0, 4, 1, 1],
                                    [0, 0, 0, 0, 0, 0, 0, 0]], np.int64)],
              "InputLength": [_i64(8, 6, 8)]},
             {"blank": 0, "padding_value": -1}, grad=False),
        Case("ctc_align_blank_last", "ctc_align",
             {"Input": [np.asarray([[4, 1, 1, 4, 4, 2, 3, 3]], np.int64)]},
             {"blank": 4}, grad=False),
        Case("edit_distance", "edit_distance",
             {"Hyps": [np.asarray([[1, 2, 3, 0, 0], [1, 1, 0, 0, 0],
                                   [5, 6, 7, 8, 9]], np.int64)],
              "Refs": [np.asarray([[1, 3, 3, 4], [2, 2, 2, 0],
                                   [9, 8, 7, 6]], np.int64)],
              "HypsLength": [_i64(3, 2, 0)],
              "RefsLength": [_i64(4, 3, 4)]}, {}, grad=False),
        # a zero-length reference divides by 1
        Case("edit_distance_normalized", "edit_distance",
             {"Hyps": [ints(22, 0, 4, 3, 6)], "Refs": [ints(23, 0, 4, 3, 5)],
              "HypsLength": [_i64(6, 4, 2)],
              "RefsLength": [_i64(5, 0, 3)]}, {"normalized": True},
             grad=False),
        Case("crf_decoding", "crf_decoding",
             {"Emission": [f32(24, 3, 5, 4)],
              "Transition": [f32(25, 6, 4, scale=0.5)],
              "Length": [_i64(5, 2, 3)]}, {}, grad=False),
        Case("crf_decoding_ties", "crf_decoding",
             {"Emission": [tie_em], "Transition": [tie_tr]}, {},
             grad=False),
        Case("crf_decoding_label", "crf_decoding",
             {"Emission": [tie_em], "Transition": [tie_tr],
              "Label": [ints(26, 0, 4, 3, 5)], "Length": [_i64(5, 4, 1)]},
             {}, grad=False),
        # batch 2, beam 2, K 4: beam 1 of source 0 has ended (id 3)
        Case("beam_search", "beam_search",
             {"pre_ids": [_i64(1, 3, 2, 1).reshape(4, 1)],
              "pre_scores": [f32(27, 4, 1, scale=0.5, shift=-1.0)],
              "scores": [f32(28, 4, 4, shift=-2.0)]},
             {"beam_size": 2, "end_id": 3}, grad=False),
        # accumulated scores with ties and candidate ids given
        Case("beam_search_ids_accumulated", "beam_search",
             {"pre_ids": [_i64(5, 6, 0, 7).reshape(4, 1)],
              "pre_scores": [np.asarray([[-1.0], [-1.0], [-0.5], [-2.0]],
                                        np.float32)],
              "ids": [ints(29, 10, 20, 4, 3)],
              "scores": [np.asarray([[-1.5, -1.5, -2.0], [-1.5, -3.0, -1.5],
                                     [-0.5, -0.7, -0.9], [-4.0, -2.5, -2.5]],
                                    np.float32)]},
             {"beam_size": 2, "end_id": 0, "is_accumulated": True},
             grad=False),
        Case("beam_search_decode", "beam_search_decode",
             {"Ids": [ints(30, 0, 9, 4, 2, 3)],
              "ParentIdx": [np.stack([ints(31 + t, 0, 3, 2, 3)
                                      + np.asarray([[0], [3]])
                                      for t in range(4)]).astype(np.int64)],
              "Scores": [f32(35, 4, 2, 3)]},
             {"beam_size": 3, "end_id": 0}, grad=False),
    ]


def _fusion_cases() -> List[Case]:
    d = 2
    return [
        Case("fusion_gru", "fusion_gru",
             {"X": [f32(40, 2, 4, 3)], "WeightX": [f32(41, 3, 3 * d)],
              "WeightH": [f32(42, d, 3 * d, scale=0.5)],
              "Bias": [f32(43, 1, 3 * d, scale=0.3)],
              "H0": [f32(44, 2, d, scale=0.5)]}, {"origin_mode": True},
             tol=RECURRENT, grad_tol=RECURRENT),
        Case("fusion_lstm_peepholes", "fusion_lstm",
             {"X": [f32(45, 2, 4, 3)], "WeightX": [f32(46, 3, 4 * d)],
              "WeightH": [f32(47, d, 4 * d, scale=0.5)],
              "Bias": [f32(48, 1, 7 * d, scale=0.3)],
              "H0": [f32(49, 2, d, scale=0.5)],
              "C0": [f32(50, 2, d, scale=0.5)]},
             {"use_peepholes": True, "is_reverse": True},
             tol=RECURRENT, grad_tol=RECURRENT),
        Case("fused_embedding_fc_lstm", "fused_embedding_fc_lstm",
             {"Ids": [ints(51, 0, 5, 2, 4, 1)],
              "Embeddings": [f32(52, 5, 4 * d)],
              "WeightH": [f32(53, d, 4 * d, scale=0.5)],
              "Bias": [f32(54, 1, 4 * d, scale=0.3)]}, {},
             tol=RECURRENT, grad_tol=RECURRENT),
        Case("attention_lstm", "attention_lstm",
             {"X": [f32(55, 2, 4, 3)], "C0": [f32(56, 2, d, scale=0.5)],
              "H0": [f32(57, 2, d, scale=0.5)],
              "AttentionWeight": [f32(58, 3 + d, 1)],
              "AttentionBias": [f32(59, 1, 1)],
              "AttentionScalar": [uniform(60, 0.5, 1.5, 1, 1)],
              "AttentionScalarBias": [f32(61, 1, 1)],
              "LSTMWeight": [f32(62, 3 + d, 4 * d, scale=0.5)],
              "LSTMBias": [f32(63, 1, 4 * d, scale=0.3)],
              "Length": [_i64(4, 2)]}, {},
             tol=RECURRENT, grad_tol=RECURRENT),
        Case("fusion_repeated_fc_relu", "fusion_repeated_fc_relu",
             {"X": [f32(64, 3, 4)], "W": [f32(65, 4, 5), f32(66, 5, 2)],
              "Bias": [f32(67, 5), f32(68, 2)]}, {}),
        Case("fusion_squared_mat_sub", "fusion_squared_mat_sub",
             {"X": [f32(69, 3, 4)], "Y": [f32(70, 4, 2)]}, {"scalar": 0.5}),
        Case("fusion_seqconv_eltadd_relu", "fusion_seqconv_eltadd_relu",
             {"X": [f32(71, 2, 5, 3)], "Filter": [f32(72, 9, 4)],
              "FilterBias": [f32(73, 1, 4)]},
             {"contextLength": 3, "contextStart": -1}),
        Case("fusion_seqexpand_concat_fc", "fusion_seqexpand_concat_fc",
             {"X": [f32(74, 2, 3, 2), f32(75, 2, 3)],
              "FCWeight": [f32(76, 5, 4)], "FCBias": [f32(77, 4)]},
             {"fc_activation": "tanh"}),
        Case("fusion_seqpool_concat", "fusion_seqpool_concat",
             {"X": [f32(78, 2, 4, 3), f32(79, 2, 4, 2)],
              "Length": [_i64(4, 2)]}, {"pooltype": "SQRT"}),
        Case("fusion_seqpool_cvm_concat", "fusion_seqpool_cvm_concat",
             {"X": [uniform(80, 0.1, 2.0, 2, 4, 3),
                    uniform(81, 0.1, 2.0, 2, 4, 4)],
              "CVM": [uniform(82, 0.1, 2.0, 2, 2)],
              "Length": [_i64(4, 2), _i64(3, 4)]},
             {"pooltype": "SUM", "use_cvm": True}),
        Case("deformable_conv_v1", "deformable_conv_v1",
             {"Input": [f32(83, 1, 3, 6, 6)],
              "Offset": [f32(84, 1, 18, 6, 6, scale=1.5)],
              "Filter": [f32(85, 4, 3, 3, 3)]},
             {"strides": [1, 1], "paddings": [1, 1]}, tol=CONV,
             grad_tol=CONV),
    ]


def _in_bounds(out, x, crop):
    """Whether ``out`` is a window of ``x`` of the trailing shape
    ``crop``, at one start for the whole batch."""
    lead = x.ndim - len(crop)
    if out.shape != x.shape[:lead] + tuple(crop):
        return False
    for start in np.ndindex(*[x.shape[lead + i] - c + 1
                              for i, c in enumerate(crop)]):
        win = x[(Ellipsis,) + tuple(slice(s, s + c)
                                    for s, c in zip(start, crop))]
        if np.array_equal(win, out):
            return True
    return False


CROP_X = f32(90, 2, 3, 6, 7)
CROP = (4, 5)


def _long_tail_cases() -> List[Case]:
    tags = np.asarray([[0, 1, 4, 2, 3, 3, 4], [2, 3, 0, 0, 1, 4, 4],
                       [1, 1, 0, 1, 2, 3, 1]], np.int64)
    return [
        Case("hash", "hash",
             {"X": [np.asarray([[1, -7], [123456789, 2 ** 40 + 5],
                                [0, 0], [-1, 31]], np.int64)]},
             {"num_hash": 3, "mod_by": 1000}, grad=False),
        Case("hash_1d", "hash", {"X": [_i64(3, 99, 2 ** 33)]},
             {"num_hash": 1, "mod_by": 97}, grad=False),
        Case("sampling_id", "sampling_id",
             {"X": [np.asarray([[0.1, 0.6, 0.3], [0.0, 0.0, 1.0],
                                [0.5, 0.5, 0.0]], np.float32)]},
             {"seed": 5}, kind="draws", grad=False),
        Case("mean_iou", "mean_iou",
             {"Predictions": [np.asarray([[0, 1, 1, 3], [3, 3, 0, 1]],
                                         np.int32)],
              "Labels": [np.asarray([[0, 1, 0, 3], [1, 3, 0, 1]],
                                    np.int32)]},
             {"num_classes": 5}, grad=False),
        Case("add_position_encoding", "add_position_encoding",
             {"X": [f32(91, 2, 5, 6)]}, {"alpha": 0.5, "beta": 2.0}),
        Case("add_position_encoding_odd", "add_position_encoding",
             {"X": [f32(92, 2, 3, 5)]}, {}),
        # threshold 2: some inputs clipped (none within 0.05 of it)
        Case("soft_relu", "soft_relu",
             {"X": [np.asarray([[-3.0, -1.2, 0.3, 2.6],
                                [1.9, -0.4, 4.0, -2.3]], np.float32)]},
             {"threshold": 2.0}),
        Case("random_crop", "random_crop",
             {"X": [CROP_X], "Seed": [_i64(7)]}, {"shape": list(CROP)},
             kind="draws", grad=False),
        Case("similarity_focus", "similarity_focus",
             {"X": [f32(93, 2, 3, 4, 5)]}, {"axis": 1, "indexes": [0, 2]},
             grad=False),
        Case("similarity_focus_axis3", "similarity_focus",
             {"X": [f32(94, 1, 3, 4, 2)]}, {"axis": 3, "indexes": [1]},
             grad=False),
        Case("chunk_eval_iob", "chunk_eval",
             {"Inference": [tags], "Label": [np.roll(tags, 1, axis=1)],
              "Length": [_i64(7, 5, 6)]},
             {"num_chunk_types": 2, "chunk_scheme": "IOB"}, grad=False),
        Case("chunk_eval_iobes", "chunk_eval",
             {"Inference": [ints(95, 0, 9, 3, 8)],
              "Label": [ints(96, 0, 9, 3, 8)], "Length": [_i64(8, 3, 6)]},
             {"num_chunk_types": 2, "chunk_scheme": "IOBES"}, grad=False),
        Case("scatter_nd", "scatter_nd",
             {"Index": [np.asarray([[0, 1], [2, 2], [0, 1], [1, 0]],
                                   np.int64)],
              "Updates": [f32(97, 4, 3)]}, {"shape": [3, 3, 3]}),
        Case("deformable_psroi_pooling", "deformable_psroi_pooling",
             {"Input": [f32(98, 1, 8, 7, 7)],
              "ROIs": [np.asarray([[1.2, 0.7, 4.6, 5.1],
                                   [0.9, 1.8, 5.3, 4.4],
                                   [2.1, 2.6, 4.9, 5.7]], np.float32)],
              "Trans": [f32(99, 3, 8, scale=0.5)]},
             {"pooled_height": 2, "pooled_width": 2, "output_dim": 2,
              "spatial_scale": 1.0, "sample_per_part": 2,
              "trans_std": 0.1}, tol=CONV, grad_tol=CONV),
    ]


DECODE_CASES = _decode_cases() + _fusion_cases() + _long_tail_cases()
DECODE_TYPES = frozenset(c.op for c in DECODE_CASES)

# the contract of each "draws" case: a function of (inputs, outputs) as
# numpy arrays
DRAW_CONTRACTS = {
    "sampling_id": lambda ins, outs: bool(
        ((outs["Out"][0] >= 0) & (outs["Out"][0] < 3)).all()
        and outs["Out"][0][1] == 2 and outs["Out"][0][2] != 2),
    "random_crop": lambda ins, outs: _in_bounds(
        outs["Out"][0], ins["X"][0], CROP)
    and outs["SeedOut"][0].tolist() == [8],
}


# --------------------------------------------------------- the LoD routes
# one true-LoD beam_search step: 2 sources of 2 parent rows each (level 1
# one sequence a row); row 1 has ended (end_id 9), row 3's continuations
# all lose; ties between row 2's two candidates and row 0's first
LOD_STEP = dict(
    inputs={"pre_ids": [_i64(3, 9, 5, 6).reshape(4, 1)],
            "pre_scores": [np.asarray([[-1.0], [-0.5], [-1.5], [-2.0]],
                                      np.float32)],
            "ids": [np.asarray([[11, 12], [0, 0], [13, 14], [15, 16]],
                               np.int64)],
            "scores": [np.asarray([[-1.6, -3.0], [0.0, 0.0], [-1.6, -1.7],
                                   [-5.0, -6.0]], np.float32)]},
    attrs={"beam_size": 2, "end_id": 9},
    lod=[[0, 2, 4], [0, 1, 2, 3, 4]])


def lod_step_op(program_module):
    """The OpDesc of :data:`LOD_STEP` in a package (its
    ``core.program``)."""
    return program_module.OpDesc(
        "beam_search", {"pre_ids": ["pi"], "pre_scores": ["ps"],
                        "ids": ["ci"], "scores": ["cs"]},
        {"selected_ids": ["si"], "selected_scores": ["ss"],
         "parent_idx": ["px"]}, dict(LOD_STEP["attrs"]))


def lod_arrays():
    """The step arrays of a 3-step beam decode of 2 sources, beam 2, as
    a true-LoD run grows them: entry t is (ids or scores [M_t, 1], its
    2-level LoD); entry 0 is the start. Source 1 ends after step 2 (its
    rows vanish at step 3)."""
    lods = [[[0, 1, 2], [0, 1, 2]],
            [[0, 1, 2], [0, 2, 4]],
            [[0, 2, 4], [0, 1, 2, 3, 4]],
            [[0, 2, 2], [0, 2, 2, 2, 2]]]
    ids = [_i64(1, 1), _i64(4, 5, 6, 7), _i64(8, 2, 3, 9), _i64(2, 9)]
    scores = [np.asarray(v, np.float32) for v in (
        [0.0, 0.0], [-0.1, -0.2, -0.3, -0.4],
        [-0.5, -0.6, -0.7, -0.8], [-0.9, -1.0])]
    return ([(v.reshape(-1, 1), lod) for v, lod in zip(ids, lods)],
            [(v.reshape(-1, 1), lod) for v, lod in zip(scores, lods)])


# ------------------------------------------------ the book's beam decode
MT = dict(dict_size=12, word_dim=4, hidden=6, beam=2, max_len=5, end_id=10,
          n_src=2)


def mt_params(cfg=MT, seed=0):
    """The decoder's weights by parameter name (numpy, from a seed)."""
    rs = np.random.RandomState(seed)
    v, w, h = cfg["dict_size"], cfg["word_dim"], cfg["hidden"]
    return {"mt_emb": rs.randn(v, w).astype(np.float32),
            "mt_state_w": (rs.randn(h, h) * 0.5).astype(np.float32),
            "mt_ids_w": (rs.randn(w, h) * 0.5).astype(np.float32),
            "mt_state_b": (rs.randn(h) * 0.1).astype(np.float32),
            "mt_out_w": (rs.randn(h, v) * 1.5).astype(np.float32),
            "mt_out_b": (rs.randn(v) * 0.1).astype(np.float32)}


def mt_decode_program(api, cfg=MT):
    """The decode side of the book's machine translation
    (tests/book/test_machine_translation.py ``decoder_decode``) at tiny
    widths, built with either package's static builders (``api`` as
    ``chip_smoke.port_static_api()`` gives it): a While loop that reads
    the previous ids, state and scores from tensor arrays, expands the
    state to the beam (``sequence_expand`` by the scores' LoD), embeds
    the ids, steps a tanh fc, scores the vocabulary (softmax, ``topk``),
    accumulates log-probs, runs ``beam_search`` over the 2-level LoD,
    writes the selection back, and stops at ``max_len`` or when
    ``is_empty``; then ``beam_search_decode``. The encoder's context is
    fed ([n_src, hidden]). Returns (main, startup, {:func:`mt_params` key:
    the parameter's name in the program}, fetch names)."""
    st = api.static
    nn = st.nn
    main, startup = api.pt.Program(), api.pt.Program()
    beam, end_id = cfg["beam"], cfg["end_id"]

    def attr(name):
        return api.ParamAttr(name=name)

    with st.program_guard(main, startup):
        context = st.data("context", [-1, cfg["hidden"]], "float32")
        init_ids = st.data("init_ids", [-1, 1], "int64", lod_level=2)
        init_scores = st.data("init_scores", [-1, 1], "float32",
                              lod_level=2)
        array_len = st.fill_constant([1], "int64", cfg["max_len"])
        counter = st.fill_constant([1], "int64", 0)
        state_array = nn.create_array("float32")
        nn.array_write(context, counter, array=state_array)
        ids_array = nn.create_array("int64")
        scores_array = nn.create_array("float32")
        nn.array_write(init_ids, counter, array=ids_array)
        nn.array_write(init_scores, counter, array=scores_array)
        cond = st.less_than(counter, array_len)
        loop = st.While(cond)
        with loop.block():
            pre_ids = nn.array_read(ids_array, counter)
            pre_state = nn.array_read(state_array, counter)
            pre_score = nn.array_read(scores_array, counter)
            pre_state_expanded = nn.sequence_expand(pre_state, pre_score)
            pre_ids_emb = nn.embedding(
                pre_ids, size=[cfg["dict_size"], cfg["word_dim"]],
                param_attr=attr("mt_emb"))
            current_state = nn.fc(
                [pre_state_expanded, pre_ids_emb], size=cfg["hidden"],
                act="tanh", bias_attr=attr("mt_state_b"))
            current_state_with_lod = nn.lod_reset(current_state, pre_score)
            current_score = nn.fc(current_state_with_lod,
                                  size=cfg["dict_size"], act="softmax",
                                  param_attr=attr("mt_out_w"),
                                  bias_attr=attr("mt_out_b"))
            topk_scores, topk_indices = nn.topk(current_score, k=beam)
            accu_scores = nn.elementwise_add(
                nn.log(topk_scores), nn.reshape(pre_score, shape=[-1]),
                axis=0)
            selected_ids, selected_scores = nn.beam_search(
                pre_ids, pre_score, topk_indices, accu_scores, beam,
                end_id=end_id, level=0)
            st.increment(counter, value=1, in_place=True)
            nn.array_write(current_state, counter, array=state_array)
            nn.array_write(selected_ids, counter, array=ids_array)
            nn.array_write(selected_scores, counter, array=scores_array)
            length_cond = st.less_than(counter, array_len)
            finish_cond = nn.logical_not(nn.is_empty(selected_ids))
            st.logical_and(length_cond, finish_cond, out=cond)
        ids, scores = nn.beam_search_decode(ids_array, scores_array, beam,
                                            end_id)
    # the two-input fc names its weights itself
    muls = [op.inputs["Y"][0] for op in main.blocks[1].ops
            if op.type == "mul"]
    names = dict(zip(("mt_state_w", "mt_ids_w"), muls[:2]))
    names.update({k: k for k in ("mt_emb", "mt_state_b", "mt_out_w",
                                 "mt_out_b")})
    return main, startup, names, [ids.name, scores.name]


def mt_feeds(cfg=MT, seed=1):
    """The feeds (numpy, with the LoD of the start ids and scores): each
    source starts from id 1 at score 1, as the book feeds them."""
    n = cfg["n_src"]
    rs = np.random.RandomState(seed)
    lod = [list(range(n + 1)), list(range(n + 1))]
    return {"context": rs.randn(n, cfg["hidden"]).astype(np.float32),
            "init_ids": (np.ones((n, 1), np.int64), lod),
            "init_scores": (np.ones((n, 1), np.float32), lod)}


def mt_decode_run(api, exe, tensor):
    """Build :func:`mt_decode_program` with ``api`` and run it once in
    ``exe`` from :func:`mt_params` on :func:`mt_feeds`; ``tensor(value,
    lod)`` makes the package's TpuTensor (on the executor's device).
    Returns (main, startup, [(sentence ids, LoD), (scores, LoD)]) as
    numpy arrays and lists."""
    main, startup, names, fetch = mt_decode_program(api)
    feed = {k: tensor(*v) if isinstance(v, tuple) else v
            for k, v in mt_feeds().items()}
    scope = api.pt.Scope()
    with api.pt.scope_guard(scope):
        exe.run(startup, feed={}, fetch_list=[], scope=scope)
        for k, v in mt_params().items():
            scope.var(names[k]).set(tensor(v, None))
        out = exe.run(main, feed=feed, fetch_list=fetch, scope=scope,
                      return_numpy=False)
    # a JAX fetch's lod is a method, the port's an attribute
    return main, startup, [(np.asarray(v.numpy()), v.lod() if callable(
        v.lod) else v.lod) for v in out]
