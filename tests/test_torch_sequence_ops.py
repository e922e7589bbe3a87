"""The 19 op types of the sequence slice, against the JAX package's
ops: the registry test of the slice, and here the 11 of
``ops/sequence_ops.py`` (the 8 of ``ops/rnn_ops.py`` in
``test_torch_rnn.py``), over the helpers of ``test_torch_parity_ops.py``.

Each case of ``paddle_tpu_torch/testing/seq_cases.py`` runs one op
through ``OpInfoMap`` in both packages on the same numpy inputs: the
forward outputs (integer and bool equal, float within the case's
tolerance: fp32 rtol 1e-5 / atol 1e-6 for these ops), then the
gradients for the same seeded cotangents, ``generic_vjp_grad`` on each
side. An "error" case raises in both with the same message. Then the
fluid ``sequence_expand(x, y)`` form, which reads y's LoD through the
eager side channel, and the three ``sequence_*`` cases of
tests/test_array_ops.py.
"""
import collections
import importlib
import inspect
import re

import numpy as np
import pytest

from paddle_tpu.core import lodctx as jax_lodctx
from paddle_tpu.core.registry import OpInfoMap as JaxOpInfoMap

import paddle_tpu_torch as tpt
from paddle_tpu_torch.core import lodctx
from paddle_tpu_torch.core.program import OpDesc
from paddle_tpu_torch.core.registry import OpInfoMap
from paddle_tpu_torch.device import op_device
from paddle_tpu_torch.testing.decode_cases import DECODE_TYPES
from paddle_tpu_torch.testing.rcnn_cases import RCNN_TYPES
from paddle_tpu_torch.testing.seq_cases import SEQ_CASES, SEQ_TYPES, SLICE
from test_torch_parity_ops import (cf_check_error, cf_check_forward,
                                   cf_check_gradient, cf_run_both)
from test_torch_tensor_ops import _jax_in, _port_in, ref_module

PORTED_BEFORE = 388
MODULES = ("paddle_tpu.ops.sequence_ops",)
CASES = [c for c in SEQ_CASES if ref_module(c.op) in MODULES]
VALUE = [c for c in CASES if c.kind == "value"]
GRAD = [c for c in VALUE if c.grad]
ERRORS = [c for c in CASES if c.kind == "error"]


@pytest.fixture(autouse=True)
def _cpu():
    tpt.set_device("cpu")


def test_registry_holds_the_slice_against_the_reference():
    """The port registers 388 + 19 = 407 types before the decoding
    slice's, none that the reference lacks; the 19 are the cases' types,
    all of ``sequence_ops`` and ``rnn_ops`` (11 and 8 more), with the
    reference's intermediate outputs and non-differentiable inputs; no
    compute among them reaches ``pallas_call``."""
    for mod in ("ops", "vision", "text", "static", "inference", "serving"):
        importlib.import_module("paddle_tpu." + mod)
        importlib.import_module("paddle_tpu_torch." + mod)
    jops, pops = JaxOpInfoMap.instance()._ops, OpInfoMap.instance()._ops
    assert not set(pops) - set(jops)
    assert len(SEQ_TYPES) == 19 and \
        len(set(pops) - DECODE_TYPES - RCNN_TYPES) == \
        PORTED_BEFORE + 19 == 407
    assert SEQ_TYPES <= set(pops)
    assert collections.Counter(ref_module(t) for t in SEQ_TYPES) == SLICE
    for mod in SLICE:
        whole = {t for t, d in jops.items() if d.compute.__module__ == mod}
        assert whole <= set(pops), mod
    for t in SEQ_TYPES:
        jdef, pdef = jops[t], pops[t]
        assert pdef.intermediate_outputs == jdef.intermediate_outputs, t
        assert set(pdef.non_differentiable_inputs) == \
            set(jdef.non_differentiable_inputs), t
        src = inspect.getsource(inspect.getmodule(jdef.compute))
        assert not re.search(r"pallas", src), t


@pytest.mark.parametrize("case", VALUE, ids=[c.id for c in VALUE])
def test_forward_matches_jax(case, tmp_path):
    cf_check_forward(case, tmp_path)


@pytest.mark.parametrize("case", GRAD, ids=[c.id for c in GRAD])
def test_gradient_matches_jax(case, tmp_path):
    cf_check_gradient(case, tmp_path)


@pytest.mark.parametrize("case", ERRORS, ids=[c.id for c in ERRORS])
def test_raises_as_jax_does(case, tmp_path):
    cf_check_error(case, tmp_path)


def test_lod_sequence_expand_matches_jax():
    """``sequence_expand(x, y)`` replicates x's rows by y's LoD widths
    (0, 2 and 3 here), read through each package's LoD side channel
    while the op runs; gradients of x by seeded cotangents, fp32."""
    from paddle_tpu.core.program import OpDesc as JaxOpDesc
    x = np.random.RandomState(0).randn(3, 2).astype(np.float32)
    y = np.zeros((5, 1), np.float32)
    lod = [[0, 0, 2, 5]]
    ins = {"X": [x], "Y": [y]}
    attrs = {"ref_level": -1}
    with jax_lodctx.lod_scope({"y": lod}), jax_lodctx.op_scope(
            JaxOpDesc("sequence_expand", {"X": ["x"], "Y": ["y"]},
                      {"Out": ["o"]}, attrs)):
        want = JaxOpInfoMap.instance().get("sequence_expand").compute(
            _jax_in(ins), attrs)["Out"][0]
    with lodctx.lod_scope({"y": lod}), lodctx.op_scope(
            OpDesc("sequence_expand", {"X": ["x"], "Y": ["y"]},
                   {"Out": ["o"]}, attrs)), op_device("cpu"):
        port_in = _port_in(ins)
        port_in["X"][0].requires_grad_()
        got = OpInfoMap.instance().get("sequence_expand").compute(
            port_in, attrs)["Out"][0]
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.detach().numpy(), x[[1, 1, 2, 2, 2]])
    ct = np.random.RandomState(1).randn(5, 2).astype(np.float32)
    got.backward(tpt.to_tensor(ct))
    want_dx = np.zeros_like(x)
    np.add.at(want_dx, [1, 1, 2, 2, 2], ct)
    np.testing.assert_allclose(port_in["X"][0].grad.numpy(), want_dx,
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("cid", ["sequence_reshape", "sequence_scatter",
                                 "sequence_slice_clamped"])
def test_array_ops_cases_of_the_reference(cid, tmp_path):
    """tests/test_array_ops.py's expectations, on the port: the reshape
    keeps each row's element count (lengths 3, 2 at width 4 -> 2, 1 at
    width 6), the scatter adds a repeated id twice, the slice clamps an
    overrun to the window and to max_out_len."""
    case = next(c for c in SEQ_CASES if c.id == cid)
    got, _ = cf_run_both(case, tmp_path)
    x = case.inputs["X"][0]
    if cid == "sequence_reshape":
        np.testing.assert_array_equal(got["Out"][0].numpy(),
                                      x.reshape(2, 2, 6))
        assert got["OutLength"][0].tolist() == [2, 1]
    elif cid == "sequence_scatter":
        want = x.copy()
        ids, upd = case.inputs["Ids"][0], case.inputs["Updates"][0]
        for b in range(2):
            for s in range(3):
                if -4 <= ids[b, s] < 4:
                    want[b, ids[b, s]] += upd[b, s]
        np.testing.assert_allclose(got["Out"][0].numpy(), want, rtol=1e-6)
    else:
        np.testing.assert_array_equal(got["Out"][0].numpy(),
                                      [[x[0, 3], x[0, 4], 0, 0], x[1, :4]])
        assert got["OutLength"][0].tolist() == [2, 4]
