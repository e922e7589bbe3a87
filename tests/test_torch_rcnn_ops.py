"""The 15 op types of the two-stage detection slice
(``paddle_tpu/ops/rcnn_ops.py``) against the JAX package's ops: the
registry test of the slice, and every case of
``paddle_tpu_torch/testing/rcnn_cases.py`` through ``OpInfoMap`` in both
packages on the same numpy inputs. Indices, labels and counts equal; float
outputs within the case's bound (rtol 1e-5 / atol 1e-6 for IoU tables and
gathers, ``rcnn_cases.DECODE`` = 1e-5 / 1e-5 where a value passes through
``exp`` or ``log``, whose last bit differs between numpy and torch).

The sampling cases carry nonzero seeds: both packages draw from
``np.random.RandomState(seed)`` and sort with ``np.argsort``, so the
sampled and kept indices are the reference's, ties included
(``generate_proposals_ties``). The port's greedy NMS of
``generate_proposals`` walks suppression bits computed on the device;
``test_proposal_nms_is_the_reference_greedy`` holds it against the
reference's own ``_nms_np`` on boxes that overlap in chains.
"""
import collections
import importlib
import inspect
import re

import numpy as np
import pytest
import torch

from paddle_tpu.core.registry import OpInfoMap as JaxOpInfoMap
from paddle_tpu.ops import rcnn_ops as jax_rcnn

import paddle_tpu_torch as tpt
from paddle_tpu_torch.core.registry import OpInfoMap
from paddle_tpu_torch.ops import rcnn_ops
from paddle_tpu_torch.testing import rcnn_cases as rc
from test_torch_tensor_ops import assert_same, ref_module, run_both

PORTED_BEFORE = 434
CASES = rc.RCNN_CASES


@pytest.fixture(autouse=True)
def _cpu():
    tpt.set_device("cpu")


def test_registry_holds_the_slice_against_the_reference():
    """The port registers 434 + 15 = 449 types, none that the reference
    lacks; the 15 are the cases' types and the whole of the reference's
    ``rcnn_ops``, with its intermediate outputs and non-differentiable
    inputs; no compute among them reaches ``pallas_call``."""
    for mod in ("ops", "vision", "text", "static", "inference", "serving"):
        importlib.import_module("paddle_tpu." + mod)
        importlib.import_module("paddle_tpu_torch." + mod)
    jops, pops = JaxOpInfoMap.instance()._ops, OpInfoMap.instance()._ops
    assert not set(pops) - set(jops)
    assert len(rc.RCNN_TYPES) == 15 and \
        len(pops) == PORTED_BEFORE + 15 == 449
    assert collections.Counter(ref_module(t) for t in rc.RCNN_TYPES) \
        == rc.SLICE
    whole = {t for t, d in jops.items()
             if d.compute.__module__ == "paddle_tpu.ops.rcnn_ops"}
    assert whole == set(rc.RCNN_TYPES)
    for t in rc.RCNN_TYPES:
        jdef, pdef = jops[t], pops[t]
        assert pdef.compute.__module__ == rcnn_ops.__name__, t
        assert pdef.intermediate_outputs == jdef.intermediate_outputs, t
        assert set(pdef.non_differentiable_inputs) == \
            set(jdef.non_differentiable_inputs), t
        src = inspect.getsource(inspect.getmodule(jdef.compute))
        assert not re.search(r"pallas", src), t


@pytest.mark.parametrize("case", CASES, ids=[c.id for c in CASES])
def test_forward_matches_jax(case):
    got, want = run_both(case)
    assert set(got) == set(want), (set(got), set(want))
    for slot in want:
        assert len(got[slot]) == len(want[slot]), slot
        for i, (g, w) in enumerate(zip(got[slot], want[slot])):
            assert_same(g, w, case.tol, f"{case.id}.{slot}[{i}]")


def test_cases_sample_and_keep_what_they_should():
    """The cases exercise what they are for: the proposals keep fewer
    boxes than they decode, the sampled RPN labels hold both classes
    within the batch, the tied scores hold ties, the mask targets fill
    the square and the L, and detection_map sees a hit and a miss."""
    by_id = {c.id: c for c in CASES}
    got, _ = run_both(by_id["generate_proposals"])
    nums = got["RpnRoisNum"][0].tolist()
    assert 0 < min(nums) and max(nums) <= 12
    sc = by_id["generate_proposals_ties"].inputs["Scores"][0].ravel()
    assert len(np.unique(sc)) < len(sc) // 4
    got, _ = run_both(by_id["rpn_target_assign"])
    lab = got["TargetLabel"][0].ravel().tolist()
    assert set(lab) == {0, 1} and len(lab) == 16
    got, _ = run_both(by_id["generate_proposal_labels"])
    labels = got["LabelsInt32"][0]
    assert (labels > 0).any() and (labels == 0).any()
    got, _ = run_both(by_id["generate_mask_labels"])
    masks = got["MaskInt32"][0].reshape(2, 3, 8, 8)
    assert masks[0, 2].sum() == 36 and masks[1, 1].sum() == 20
    assert masks[1, 1, 1, 1] == 1 and masks[1, 1, 5, 5] == 0   # the L
    assert (masks[0, 0] == 0).all() and (masks[0, 1] == 0).all()
    got, _ = run_both(by_id["detection_map"])
    assert 0.0 < float(got["MAP"][0]) < 1.0


def test_proposal_nms_is_the_reference_greedy():
    """The suppression-bit walk keeps what the reference's ``_nms_np``
    keeps, in its order, on boxes in overlapping chains (a box
    suppressed by a kept box no longer suppresses the next), with tied
    scores and a cut at the first ``limit`` kept."""
    rs = np.random.RandomState(0)
    base = rc.boxes(40, 60, 100, 100, 10, 30)
    shift = np.concatenate([rs.uniform(0, 6, (60, 2))] * 2, 1)
    bx = np.concatenate([base, base + shift]).astype(np.float32)
    scores = np.round(rs.uniform(0, 1, 120) * 16) / 16
    scores = scores.astype(np.float32)
    for thresh in (0.3, 0.5, 0.7):
        want = jax_rcnn._nms_np(bx, scores, thresh)
        pos = np.arange(len(bx))
        bits = rcnn_ops._suppression_bits(torch.from_numpy(bx),
                                          thresh).numpy()
        got = rcnn_ops._greedy_keep(np.argsort(-scores), pos, bits, 0)
        assert got.tolist() == want[:0] == []
        got = rcnn_ops._greedy_keep(np.argsort(-scores), pos, bits, 10 ** 6)
        assert got.tolist() == want, thresh
        got = rcnn_ops._greedy_keep(np.argsort(-scores), pos, bits, 7)
        assert got.tolist() == want[:7], thresh


def test_host_side_types_stay_shapeless_in_static_inference():
    """A host-side type raises "eager only" on meta tensors, so static
    shape inference leaves its outputs unknown, as the JAX package's
    ``jax.eval_shape`` does; ``target_assign`` and ``multiclass_nms2``
    infer theirs."""
    from paddle_tpu_torch.core.registry import run_meta
    for case in CASES:
        meta = {s: [torch.empty(np.shape(v), dtype=torch.from_numpy(
            np.asarray(v)).dtype, device="meta") for v in vs]
            for s, vs in case.inputs.items()}
        opdef = OpInfoMap.instance().get(case.op)
        if case.op in ("target_assign", "multiclass_nms2"):
            outs = run_meta(opdef, meta, case.attrs)
            assert all(v.device.type == "meta" for vs in outs.values()
                       for v in vs), case.id
        else:
            with pytest.raises(Exception, match="eager only"):
                run_meta(opdef, meta, case.attrs)
