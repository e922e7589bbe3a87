"""The 153 op types the 2.0 tensor API brought to the port, against the
JAX package's ops: the 45 of ``ops/tensor_ops.py`` here, with the nine
of ``parity_ops.py``, ``dist`` (``loss_ops.py``) and ``unique``
(``long_tail_ops.py``); the 75 of ``ops/math.py`` in
``test_torch_math_ops.py`` and the 22 of ``ops/linalg_ops.py`` in
``test_torch_linalg_ops.py``, over the helpers below.

Each case of ``paddle_tpu_torch/testing/op_cases.py`` runs one op through
``OpInfoMap`` in both packages on the same numpy inputs: the forward
outputs (integer and bool equal, float within the case's tolerance,
fp32 rtol 1e-5 / atol 1e-6 unless the case says why not), then the
gradients for the same seeded cotangents, the JAX package's
``generic_vjp_grad`` (``jax.vjp`` of the compute) on one side and the
port's (``torch.autograd.grad``) on the other. Random ops cannot match
draw for draw (threefry against Philox): each side is held by shape,
dtype, range and moments, and equal seeds must give the port equal
draws. ``empty`` is held by shape and dtype (the reference's stand-in
is zeros of the default float type whatever dtype is asked for; the
port's is torch.empty of that dtype).
"""
import collections

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.core.registry import OpInfoMap as JaxOpInfoMap
from paddle_tpu.core.registry import generic_vjp_grad as jax_vjp_grad

import paddle_tpu_torch as tpt
from paddle_tpu_torch.core.registry import OpInfoMap, generic_vjp_grad
from paddle_tpu_torch.device import op_device
from paddle_tpu_torch.testing.cf_cases import CF_CASES
from paddle_tpu_torch.testing.decode_cases import DECODE_TYPES
from paddle_tpu_torch.testing.nn_cases import NN_CASES
from paddle_tpu_torch.testing.op_cases import CASES
from paddle_tpu_torch.testing.rcnn_cases import RCNN_TYPES
from paddle_tpu_torch.testing.seq_cases import SEQ_TYPES

# reference module -> the op types this slice took from it
SLICE = {
    "paddle_tpu.ops.tensor_ops": 45, "paddle_tpu.ops.math": 75,
    "paddle_tpu.ops.linalg_ops": 22, "paddle_tpu.ops.parity_ops": 9,
    "paddle_tpu.ops.loss_ops": 1, "paddle_tpu.ops.long_tail_ops": 1}
OTHER = ("paddle_tpu.ops.tensor_ops", "paddle_tpu.ops.parity_ops",
         "paddle_tpu.ops.loss_ops", "paddle_tpu.ops.long_tail_ops")
PORTED_BEFORE = 75
# the op types later slices ported, by their case lists (the rest
# of paddle.nn, then control flow, sequences and decoding)
LATER = {c.op for c in NN_CASES} | {c.op for c in CF_CASES} | SEQ_TYPES \
    | DECODE_TYPES | RCNN_TYPES
PARITY_TYPES = {"allclose", "bernoulli", "diag_v2", "empty", "eye",
                "histogram", "isinf", "isnan", "randperm"}


def ref_module(op_type):
    return JaxOpInfoMap.instance().get(op_type).compute.__module__


def cases_of(modules):
    return [c for c in CASES if ref_module(c.op) in modules]


def _jax_in(inputs):
    return {s: [jnp.asarray(v) for v in vs] for s, vs in inputs.items()}


def _port_in(inputs):
    return {s: [torch.from_numpy(np.array(v)) for v in vs]
            for s, vs in inputs.items()}


def _np(v):
    return v.detach().numpy() if isinstance(v, torch.Tensor) \
        else np.asarray(v)


def assert_same(got, want, tol, what):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert str(got.dtype) == str(want.dtype), (what, got.dtype, want.dtype)
    if np.issubdtype(want.dtype, np.floating):
        np.testing.assert_allclose(got, want, rtol=tol[0], atol=tol[1],
                                   err_msg=what)
    else:
        np.testing.assert_array_equal(got, want, err_msg=what)


def run_both(case):
    want = JaxOpInfoMap.instance().get(case.op).compute(
        _jax_in(case.inputs), dict(case.attrs))
    with op_device("cpu"):
        got = OpInfoMap.instance().get(case.op).compute(
            _port_in(case.inputs), dict(case.attrs))
    return got, want


def check_forward(case):
    got, want = run_both(case)
    assert set(got) == set(want)
    for slot in want:
        assert len(got[slot]) == len(want[slot]), slot
        for i, (g, w) in enumerate(zip(got[slot], want[slot])):
            what = f"{case.op}.{slot}[{i}]"
            if case.kind == "shape":
                assert tuple(g.shape) == tuple(np.shape(w)), what
                assert str(g.dtype).split(".")[-1] == case.attrs["dtype"]
            else:
                assert_same(g, w, case.tol, what)


def _ct_slots(jdef, outs):
    return [s for s, vs in outs.items()
            if s not in jdef.intermediate_outputs and s != "XShape" and
            any(jnp.issubdtype(v.dtype, jnp.floating) for v in vs)]


def check_gradient(case):
    jdef = JaxOpInfoMap.instance().get(case.op)
    pdef = OpInfoMap.instance().get(case.op)
    jin = _jax_in(case.inputs)
    outs = jdef.compute(jin, dict(case.attrs))
    rs = np.random.RandomState(99)
    cts = {s: [np.asarray(rs.randn(*np.shape(v)), np.float32)
               for v in outs[s]]
           for s in _ct_slots(jdef, outs)}
    assert cts, f"{case.op}: no float output to differentiate"
    want = jax_vjp_grad(jdef, jin, outs,
                        {s: [jnp.asarray(c) for c in v]
                         for s, v in cts.items()}, dict(case.attrs))
    got = generic_vjp_grad(pdef, _port_in(case.inputs), {},
                           {s: [torch.from_numpy(c) for c in v]
                            for s, v in cts.items()}, dict(case.attrs))
    assert set(got) == set(want), (set(got), set(want))
    assert want, f"{case.op}: no differentiable input"
    for slot in want:
        for i, (g, w) in enumerate(zip(got[slot], want[slot])):
            if g is None:           # an integer element: float0 in JAX
                assert w.dtype == jax_float0(), (case.op, slot, i)
                continue
            assert_same(g, w, case.grad_tol, f"d{case.op}/d{slot}[{i}]")


def jax_float0():
    import jax
    return jax.dtypes.float0


def check_random(case):
    got, want = run_both(case)
    for slot in want:
        for g, w in zip(got[slot], want[slot]):
            assert tuple(g.shape) == tuple(np.shape(w))
            assert str(_np(g).dtype) == str(np.asarray(w).dtype), \
                (case.op, g.dtype, np.asarray(w).dtype)
            assert case.check(np.asarray(w)), f"JAX {case.op} draws"
            assert case.check(_np(g)), f"port {case.op} draws"
    again, _ = run_both(case)
    for slot in got:
        for a, b in zip(got[slot], again[slot]):
            assert torch.equal(a, b), f"{case.op}: equal seeds, other draws"


@pytest.fixture(autouse=True)
def _cpu():
    tpt.set_device("cpu")


def test_registry_holds_the_slice_against_the_reference():
    """Each op type of the reference files this slice takes is in both
    registries with the same intermediate outputs and non-differentiable
    inputs; the port registers 75 + 153 types before the later slices'
    (:data:`LATER`) and none that the reference lacks; every new type
    has a case."""
    import importlib
    for mod in ("ops", "vision", "text", "static", "inference", "serving"):
        importlib.import_module("paddle_tpu." + mod)
        importlib.import_module("paddle_tpu_torch." + mod)
    jops, pops = JaxOpInfoMap.instance()._ops, OpInfoMap.instance()._ops
    assert not set(pops) - set(jops)
    taken = collections.defaultdict(set)
    for t, jdef in jops.items():
        if t in pops:
            taken[jdef.compute.__module__].add(t)
    for mod in ("paddle_tpu.ops.tensor_ops", "paddle_tpu.ops.math",
                "paddle_tpu.ops.linalg_ops"):
        whole = {t for t, d in jops.items() if d.compute.__module__ == mod}
        assert taken[mod] == whole, (mod, sorted(whole - taken[mod]))
    assert taken["paddle_tpu.ops.parity_ops"] - LATER == PARITY_TYPES
    assert {"dist"} <= taken["paddle_tpu.ops.loss_ops"]
    assert taken["paddle_tpu.ops.long_tail_ops"] - LATER == {"unique"}
    new = {t for t in pops if ref_module(t) in SLICE} - LATER - {
        "cos_sim", "scale", "sum", "mul", "matmul_v2", "reduce_sum", "mean",
        "gelu", "relu", "relu6", "leaky_relu", "square", "tanh",
        "not_equal", "top_k", "accuracy", "elementwise_add",
        "elementwise_sub", "elementwise_mul", "elementwise_div",
        "elementwise_max", "fill_constant", "gaussian_random",
        "uniform_random", "assign", "cast", "reshape", "flatten2",
        "flatten_contiguous_range", "transpose2", "concat"}
    assert len(new) == 153 and \
        len(set(pops) - LATER) == PORTED_BEFORE + 153
    assert collections.Counter(ref_module(t) for t in new) == SLICE
    assert new == {c.op for c in CASES}
    for t in new:
        jdef, pdef = jops[t], pops[t]
        assert pdef.intermediate_outputs == jdef.intermediate_outputs, t
        assert set(pdef.non_differentiable_inputs) == \
            set(jdef.non_differentiable_inputs), t


VALUE = [c for c in cases_of(OTHER) if c.kind != "random"]
GRAD = [c for c in VALUE if c.grad]
RANDOM = [c for c in cases_of(OTHER) if c.kind == "random"]


@pytest.mark.parametrize("case", VALUE, ids=[c.id for c in VALUE])
def test_forward_matches_jax(case):
    check_forward(case)


@pytest.mark.parametrize("case", GRAD, ids=[c.id for c in GRAD])
def test_gradient_matches_jax(case):
    check_gradient(case)


@pytest.mark.parametrize("case", RANDOM, ids=[c.id for c in RANDOM])
def test_random_op_held_by_distribution(case):
    check_random(case)
