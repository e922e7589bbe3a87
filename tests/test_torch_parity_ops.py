"""The 97 op types of the control-flow slice, against the JAX package's
ops: the registry test of the slice, and here the 53 of
``ops/parity_ops.py``, the 24 of ``ops/misc_ops.py`` and the 5 of
``ops/special_ops.py``; the 4 of ``ops/control_flow_ops.py`` and the 11
of ``ops/array_ops.py`` in ``test_torch_array_ops.py``, over the helpers
below.

Each case of ``paddle_tpu_torch/testing/cf_cases.py`` runs one op through
``OpInfoMap`` in both packages on the same numpy inputs (a control-flow
op with its Program published as the executing one): the forward
outputs (integer and bool equal, float within the case's tolerance, fp32
rtol 1e-5 / atol 1e-6 unless the case says why not), then the gradients
for the same seeded cotangents, ``generic_vjp_grad`` on each side. An
"error" case raises in both with the same message; ``get_places`` is
held by shape and dtype (the JAX tests see 8 virtual CPU devices).
``shuffle_batch`` and ``sample_logits`` draw from torch's generators in
the port and from threefry in the reference: they are held against the
reference's code on the port's draws (its ``jax.random.permutation`` and
``randint`` made to return them), and equal seeds must give the port
equal draws.
"""
import collections
import contextlib
import importlib
import inspect
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.core import executor as jax_executor
from paddle_tpu.core.program import Program as JaxProgram
from paddle_tpu.core.registry import OpInfoMap as JaxOpInfoMap
from paddle_tpu.core.registry import generic_vjp_grad as jax_vjp_grad

import paddle_tpu_torch as tpt
from paddle_tpu_torch.core import executor as port_executor
from paddle_tpu_torch.core.program import Program
from paddle_tpu_torch.core.registry import OpInfoMap, generic_vjp_grad
from paddle_tpu_torch.device import op_device
from paddle_tpu_torch.testing.cf_cases import CF_CASES, SLICE
from paddle_tpu_torch.testing.decode_cases import DECODE_TYPES
from paddle_tpu_torch.testing.rcnn_cases import RCNN_TYPES
from paddle_tpu_torch.testing.seq_cases import SEQ_TYPES
from test_torch_tensor_ops import (_ct_slots, _jax_in, _port_in,
                                   assert_same, jax_float0, ref_module)

PORTED_BEFORE = 291
# the two types of the reference modules that waited for item 4e (the
# decoding slice took them)
WAITING = {"fusion_seqpool_cvm_concat", "deformable_conv_v1"}


def cf_cases_of(modules):
    return [c for c in CF_CASES if ref_module(c.op) in modules]


def _attrs(case, tmp):
    return {k: v.replace("{tmp}", str(tmp)) if isinstance(v, str) else v
            for k, v in case.attrs.items()}


@contextlib.contextmanager
def case_env(case, package, tmp):
    """The case's setup in ``package`` ("paddle_tpu" or
    "paddle_tpu_torch") and its program published as the executing
    one."""
    tmp.mkdir(parents=True, exist_ok=True)
    if case.setup is not None:
        case.setup(lambda m: importlib.import_module(
            f"{package}.ops.{m}"), str(tmp))
    if case.program is None:
        yield
        return
    if package == "paddle_tpu":
        ctx = jax_executor.program_ctx(JaxProgram.from_json(case.program))
    else:
        ctx = port_executor.program_ctx(Program.from_json(case.program))
    with ctx:
        yield


def cf_run_both(case, tmp):
    """(port outputs, JAX outputs) of the case on the CPU."""
    with case_env(case, "paddle_tpu", tmp / "jax"):
        want = JaxOpInfoMap.instance().get(case.op).compute(
            _jax_in(case.inputs), _attrs(case, tmp / "jax"))
    with case_env(case, "paddle_tpu_torch", tmp / "port"), \
            op_device("cpu"):
        got = OpInfoMap.instance().get(case.op).compute(
            _port_in(case.inputs), _attrs(case, tmp / "port"))
    return got, want


def cf_check_forward(case, tmp):
    got, want = cf_run_both(case, tmp)
    assert set(got) == set(want), (set(got), set(want))
    for slot in want:
        assert len(got[slot]) == len(want[slot]), slot
        for i, (g, w) in enumerate(zip(got[slot], want[slot])):
            what = f"{case.id}.{slot}[{i}]"
            if case.kind == "shape":
                assert tuple(g.shape) == tuple(np.shape(w)), what
                assert str(g.dtype).split(".")[-1] == \
                    str(np.asarray(w).dtype), what
            else:
                assert_same(g, w, case.tol, what)
    return got


def cf_check_gradient(case, tmp):
    jdef = JaxOpInfoMap.instance().get(case.op)
    pdef = OpInfoMap.instance().get(case.op)
    jin = _jax_in(case.inputs)
    with case_env(case, "paddle_tpu", tmp / "jax"):
        outs = jdef.compute(jin, dict(case.attrs))
        rs = np.random.RandomState(99)
        cts = {s: [np.asarray(rs.randn(*np.shape(v)), np.float32)
                   for v in outs[s]]
               for s in _ct_slots(jdef, outs)}
        assert cts, f"{case.id}: no float output to differentiate"
        want = jax_vjp_grad(jdef, jin, outs,
                            {s: [jnp.asarray(c) for c in v]
                             for s, v in cts.items()}, dict(case.attrs))
    with case_env(case, "paddle_tpu_torch", tmp / "port"), \
            op_device("cpu"):
        got = generic_vjp_grad(pdef, _port_in(case.inputs), {},
                               {s: [torch.from_numpy(c) for c in v]
                                for s, v in cts.items()}, dict(case.attrs))
    assert set(got) == set(want), (set(got), set(want))
    assert want, f"{case.id}: no differentiable input"
    for slot in want:
        for i, (g, w) in enumerate(zip(got[slot], want[slot])):
            if g is None:           # an integer element: float0 in JAX
                assert w.dtype == jax_float0(), (case.id, slot, i)
                continue
            assert_same(g, w, case.grad_tol, f"d{case.id}/d{slot}[{i}]")


def cf_check_error(case, tmp):
    for run in (lambda: JaxOpInfoMap.instance().get(case.op).compute(
            _jax_in(case.inputs), dict(case.attrs)),
            lambda: OpInfoMap.instance().get(case.op).compute(
                _port_in(case.inputs), dict(case.attrs))):
        with pytest.raises(Exception, match=case.check):
            run()


@pytest.fixture(autouse=True)
def _cpu():
    tpt.set_device("cpu")


def test_registry_holds_the_slice_against_the_reference():
    """The port registers 291 + 97 types before the later slices' (the
    sequence, decoding and two-stage detection slices'), none that the
    reference
    lacks; the 97 are the cases' types, in the counts of the slice
    (control_flow_ops, array_ops and special_ops whole, parity_ops and
    misc_ops but the two types that waited for item 4e), with the
    reference's intermediate outputs and non-differentiable inputs; no
    compute among them reaches ``pallas_call``."""
    for mod in ("ops", "vision", "text", "static", "inference", "serving"):
        importlib.import_module("paddle_tpu." + mod)
        importlib.import_module("paddle_tpu_torch." + mod)
    jops, pops = JaxOpInfoMap.instance()._ops, OpInfoMap.instance()._ops
    assert not set(pops) - set(jops)
    new = {c.op for c in CF_CASES}
    assert len(new) == 97 and \
        len(set(pops) - SEQ_TYPES - DECODE_TYPES - RCNN_TYPES) == \
        PORTED_BEFORE + 97 == 388
    assert new <= set(pops)
    assert collections.Counter(ref_module(t) for t in new) == SLICE
    for mod in SLICE:
        whole = {t for t, d in jops.items() if d.compute.__module__ == mod}
        assert whole - (set(pops) - DECODE_TYPES) == whole & WAITING, mod
    assert WAITING <= DECODE_TYPES
    for t in new:
        jdef, pdef = jops[t], pops[t]
        assert pdef.intermediate_outputs == jdef.intermediate_outputs, t
        assert set(pdef.non_differentiable_inputs) == \
            set(jdef.non_differentiable_inputs), t
        src = inspect.getsource(inspect.getmodule(jdef.compute))
        assert not re.search(r"pallas", src), t


MODULES = ("paddle_tpu.ops.parity_ops", "paddle_tpu.ops.misc_ops",
           "paddle_tpu.ops.special_ops")
CASES = cf_cases_of(MODULES)
VALUE = [c for c in CASES if c.kind in ("value", "shape")]
GRAD = [c for c in VALUE if c.grad]
ERRORS = [c for c in CASES if c.kind == "error"]
RANDOM = [c for c in CASES if c.kind == "random"]
DRAWS = [c for c in CASES if c.kind == "draws"]


@pytest.mark.parametrize("case", VALUE, ids=[c.id for c in VALUE])
def test_forward_matches_jax(case, tmp_path):
    cf_check_forward(case, tmp_path)


@pytest.mark.parametrize("case", GRAD, ids=[c.id for c in GRAD])
def test_gradient_matches_jax(case, tmp_path):
    cf_check_gradient(case, tmp_path)


@pytest.mark.parametrize("case", ERRORS, ids=[c.id for c in ERRORS])
def test_raises_as_jax_does(case, tmp_path):
    cf_check_error(case, tmp_path)


@pytest.mark.parametrize("case", RANDOM, ids=[c.id for c in RANDOM])
def test_random_ops_hold_their_range(case, tmp_path):
    got, want = cf_run_both(case, tmp_path)
    for slot in want:
        for g, w in zip(got[slot], want[slot]):
            assert str(g.dtype).split(".")[-1] == str(np.asarray(w).dtype)
            assert case.check(np.asarray(w)) and case.check(g.numpy())


@pytest.fixture
def port_draws(monkeypatch):
    """Make the reference draw what the port drew for ``case``."""
    def install(case, tmp):
        got, _ = cf_run_both(case, tmp)
        if case.op == "shuffle_batch":
            perm = got["ShuffleIdx"][0].numpy()
            monkeypatch.setattr(jax.random, "permutation",
                                lambda key, n: jnp.asarray(perm))
            return perm
        nt = case.inputs["Labels"][0].shape[1]
        neg = got["Samples"][0][:, nt:].numpy()
        monkeypatch.setattr(jax.random, "randint",
                            lambda key, shape, lo, hi, dtype=None:
                            jnp.asarray(neg, jnp.int32))
        return neg
    return install


@pytest.mark.parametrize("case", DRAWS, ids=[c.id for c in DRAWS])
def test_sampling_ops_match_jax_on_the_ports_draws(case, tmp_path,
                                                   port_draws):
    drawn = port_draws(case, tmp_path)
    if case.op == "shuffle_batch":
        assert sorted(drawn.tolist()) == list(range(len(drawn)))
    else:
        assert drawn.min() >= 0 and drawn.max() < \
            case.inputs["Logits"][0].shape[1]
    cf_check_forward(case, tmp_path)
    cf_check_gradient(case, tmp_path)
    again, _ = cf_run_both(case, tmp_path)
    slot = "ShuffleIdx" if case.op == "shuffle_batch" else "Samples"
    first, _ = cf_run_both(case, tmp_path)
    assert torch.equal(again[slot][0], first[slot][0])


def test_save_writes_the_reference_bytes(tmp_path):
    """``save`` writes the reference's file byte for byte; each
    package's ``load`` / ``load_combine`` reads the other's ``save`` /
    ``save_combine`` files."""
    case = next(c for c in CF_CASES if c.id == "save")
    cf_run_both(case, tmp_path)
    a = (tmp_path / "jax" / "save_x.npy").read_bytes()
    assert a == (tmp_path / "port" / "save_x.npy").read_bytes()
    combine = next(c for c in CF_CASES if c.id == "save_combine")
    cf_run_both(combine, tmp_path)
    with op_device("cpu"):
        loaded = OpInfoMap.instance().get("load").compute(
            {}, {"file_path": str(tmp_path / "jax" / "save_x")})["Out"][0]
        both = OpInfoMap.instance().get("load_combine").compute(
            {}, {"file_path": str(tmp_path / "jax" / "sc.npz"),
                 "names": ["a", "b"]})["Out"]
    np.testing.assert_array_equal(loaded.numpy(), case.inputs["X"][0])
    for got, want in zip(both, combine.inputs["X"]):
        np.testing.assert_array_equal(got.numpy(), want)
    back = JaxOpInfoMap.instance().get("load_combine").compute(
        {}, {"file_path": str(tmp_path / "port" / "sc"),
             "names": ["b", "a"]})["Out"]
    np.testing.assert_array_equal(np.asarray(back[0]),
                                  combine.inputs["X"][1])


def test_assert_error_is_the_references():
    """The failing Assert's message in both packages."""
    case = next(c for c in CF_CASES if c.id == "assert_false")
    msgs = []
    for compute, conv in ((JaxOpInfoMap.instance().get("assert").compute,
                           _jax_in),
                          (OpInfoMap.instance().get("assert").compute,
                           _port_in)):
        with pytest.raises(Exception) as info:
            compute(conv(case.inputs), dict(case.attrs))
        msgs.append(str(info.value).split("Assert failed")[-1])
    assert msgs[0] == msgs[1]


def test_tree_conv_layer_matches_jax():
    """dygraph.TreeConv (no longer deferred) from the JAX layer's
    weights: its forward and the gradients of its weight, its bias and
    the node vectors, rtol 1e-5."""
    import paddle_tpu as jpt
    from paddle_tpu import dygraph as jdy
    from paddle_tpu_torch import dygraph as pdy
    case = next(c for c in CF_CASES if c.id == "tree_conv")
    nodes, edges = case.inputs["NodesVector"][0], case.inputs["EdgeSet"][0]
    jl = jdy.TreeConv(3, 2, num_filters=2, max_depth=2)
    pl = pdy.TreeConv(3, 2, num_filters=2, max_depth=2)
    bias = np.asarray([0.1, -0.3], np.float32)
    w = np.asarray(jl.weight.numpy())
    pl.weight.set_value(w)
    pl.bias.set_value(bias)
    jl.bias.set_value(bias)
    g = np.random.RandomState(3).randn(2, 5, 2, 2).astype(np.float32)

    jx = jpt.to_tensor(nodes, stop_gradient=False)
    jout = jl(jx, jpt.to_tensor(edges))
    (jout * jpt.to_tensor(g)).sum().backward()
    px = tpt.to_tensor(nodes, stop_gradient=False)
    pout = pl(px, tpt.to_tensor(edges))
    (pout * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(pout.detach().numpy(), np.asarray(
        jout.numpy()), rtol=1e-5, atol=1e-6)
    for got, want in ((px.grad, jx.gradient()),
                      (pl.weight.grad, jl.weight.gradient()),
                      (pl.bias.grad, jl.bias.gradient())):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-6)
