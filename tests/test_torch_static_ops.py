"""The 16 op types the static graph added to the port, against the JAX
package's ops.

Each case runs one op through ``OpInfoMap`` in both packages on the
same numpy inputs: the forward outputs, then the gradients, the JAX
package's ``generic_vjp_grad`` (``jax.vjp`` of the compute) on one side
and the port's ``generic_vjp_grad`` (``torch.autograd.grad`` of the
compute) on the other, with the same numpy cotangents. Integer outputs
must be equal. Float outputs and gradients are held at rtol 1e-5 /
atol 1e-6 (fp32 on both sides, rounding only), except where a case
states its own. ``top_k`` and ``accuracy`` also run on ties, and
``sequence_pool`` and ``linear_chain_crf`` on ragged lengths. The two
random ops cannot match number for number (threefry against Philox):
they are held to their distribution instead.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.core.registry import OpInfoMap as JaxOpInfoMap
from paddle_tpu.core.registry import generic_vjp_grad as jax_vjp_grad

import paddle_tpu_torch as tpt
from paddle_tpu_torch.core.registry import OpInfoMap, generic_vjp_grad
from paddle_tpu_torch.device import op_device

NEW_OPS = ("fill_constant", "gaussian_random", "uniform_random", "assign",
           "flatten2", "mul", "sum", "square", "top_k", "accuracy",
           "softmax", "lookup_table", "cos_sim", "sequence_pool",
           "sequence_conv", "linear_chain_crf")
TOL = dict(rtol=1e-5, atol=1e-6)


def _rs(seed):
    return np.random.RandomState(seed)


def _f32(rs, *shape):
    return rs.randn(*shape).astype(np.float32)


def _ties():
    # rows with repeated values: lax.top_k keeps them in index order
    return np.array([[1.0, 3.0, 3.0, 0.5, 3.0],
                     [2.0, 2.0, 2.0, 2.0, 2.0],
                     [-1.0, 0.0, 0.0, -1.0, 4.0]], np.float32)


def _crf_inputs(ragged):
    rs = _rs(7)
    lab = rs.randint(0, 4, (5, 6)).astype(np.int64)
    length = (np.array([6, 1, 3, 0, 5], np.int64) if ragged
              else np.full((5,), 6, np.int64))
    return {"Emission": [_f32(rs, 5, 6, 4)],
            "Transition": [_f32(rs, 6, 4) * 0.5], "Label": [lab],
            "Length": [length]}


def _seq_inputs(ragged):
    rs = _rs(5)
    x = _f32(rs, 4, 6, 3)
    x[1, 2:4] = 1.5                      # ties inside a row's window
    length = (np.array([6, 2, 0, 4], np.int64) if ragged
              else np.full((4,), 6, np.int64))
    return {"X": [x], "Length": [length]}


# (id, op type, inputs, attrs, cotangent slots)
CASES = [
    ("fill_constant_f32", "fill_constant", {},
     {"shape": [2, 3], "value": 1.5, "dtype": "float32"}, ()),
    ("fill_constant_int64", "fill_constant", {},
     {"shape": [4], "value": 3.0, "dtype": "int64"}, ()),
    ("fill_constant_bool", "fill_constant", {},
     {"shape": [2], "value": 1.0, "dtype": "bool"}, ()),
    ("assign", "assign", {"X": [_f32(_rs(1), 3, 4)]}, {}, ("Out",)),
    ("flatten2", "flatten2", {"X": [_f32(_rs(2), 2, 3, 4, 5)]},
     {"axis": 2}, ("Out",)),
    ("mul", "mul", {"X": [_f32(_rs(3), 2, 3, 4)], "Y": [_f32(_rs(4), 12, 5)]},
     {"x_num_col_dims": 1, "y_num_col_dims": 1}, ("Out",)),
    ("mul_3d_out", "mul",
     {"X": [_f32(_rs(3), 2, 3, 4)], "Y": [_f32(_rs(4), 4, 5, 2)]},
     {"x_num_col_dims": 2, "y_num_col_dims": 1}, ("Out",)),
    ("sum", "sum", {"X": [_f32(_rs(5), 3, 4) for _ in range(3)]}, {},
     ("Out",)),
    ("square", "square", {"X": [_f32(_rs(6), 4, 5)]}, {}, ("Out",)),
    ("top_k", "top_k", {"X": [_f32(_rs(7), 4, 9)]}, {"k": 3}, ()),
    ("top_k_ties", "top_k", {"X": [_ties()]}, {"k": 3}, ()),
    ("accuracy", "accuracy",
     {"Out": [_f32(_rs(8), 6, 1)],
      "Indices": [np.array([[1], [0], [3], [2], [2], [1]], np.int64)],
      "Label": [np.array([[1], [2], [3], [2], [0], [1]], np.int64)]},
     {}, ()),
    ("accuracy_top2_ties", "accuracy",
     # Indices as top_k gives them on _ties() with k=2
     {"Out": [np.array([[3.0, 3.0], [2.0, 2.0], [4.0, 0.0]], np.float32)],
      "Indices": [np.array([[1, 2], [0, 1], [4, 1]], np.int64)],
      "Label": [np.array([[2], [3], [1]], np.int64)]}, {}, ()),
    ("softmax", "softmax", {"X": [_f32(_rs(9), 3, 7)]}, {"axis": -1},
     ("Out",)),
    ("softmax_axis1", "softmax", {"X": [_f32(_rs(10), 2, 5, 3)]},
     {"axis": 1}, ("Out",)),
    ("lookup_table", "lookup_table",
     {"W": [_f32(_rs(11), 10, 4)],
      "Ids": [np.array([[1], [3], [3], [9]], np.int64)]},
     {"padding_idx": -1}, ("Out",)),
    ("lookup_table_2d_padding", "lookup_table",
     {"W": [_f32(_rs(12), 10, 4)],
      "Ids": [np.array([[1, 0, 2], [0, 5, 5]], np.int64)]},
     {"padding_idx": 0}, ("Out",)),
    ("cos_sim", "cos_sim",
     {"X": [_f32(_rs(13), 5, 6)], "Y": [_f32(_rs(14), 5, 6)]}, {},
     ("Out",)),
    ("cos_sim_broadcast_y", "cos_sim",
     {"X": [_f32(_rs(13), 5, 6)], "Y": [_f32(_rs(14), 1, 6)]}, {},
     ("Out",)),
    *[(f"sequence_pool_{p.lower()}{'_ragged' if r else ''}", "sequence_pool",
       _seq_inputs(r), {"pooltype": p}, ("Out",))
      for p in ("SUM", "AVERAGE", "SQRT", "MAX", "MIN", "LAST", "FIRST")
      for r in (False, True)],
    ("sequence_conv", "sequence_conv",
     {"X": [_f32(_rs(15), 3, 7, 4)], "Filter": [_f32(_rs(16), 12, 5)]},
     {"contextLength": 3, "contextStart": -1, "contextStride": 1},
     ("Out",)),
    ("sequence_conv_ctx5_start0", "sequence_conv",
     {"X": [_f32(_rs(17), 2, 4, 3)], "Filter": [_f32(_rs(18), 15, 2)]},
     {"contextLength": 5, "contextStart": 0, "contextStride": 1},
     ("Out",)),
    ("linear_chain_crf", "linear_chain_crf", _crf_inputs(False), {},
     ("LogLikelihood",)),
    ("linear_chain_crf_ragged", "linear_chain_crf", _crf_inputs(True), {},
     ("LogLikelihood",)),
]


def _jax_in(inputs):
    return {s: [jnp.asarray(v) for v in vs] for s, vs in inputs.items()}


def _port_in(inputs):
    return {s: [torch.from_numpy(np.array(v)) for v in vs]
            for s, vs in inputs.items()}


def _assert_same(got, want, what):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert str(got.dtype) == str(want.dtype), (what, got.dtype, want.dtype)
    if np.issubdtype(want.dtype, np.floating):
        np.testing.assert_allclose(got, want, err_msg=what, **TOL)
    else:
        np.testing.assert_array_equal(got, want, err_msg=what)


@pytest.fixture(autouse=True)
def _cpu():
    tpt.set_device("cpu")


def test_port_registers_the_sixteen_ops():
    import paddle_tpu_torch.text  # noqa: F401
    import paddle_tpu_torch.vision  # noqa: F401
    ops = OpInfoMap.instance()
    assert all(ops.has(t) for t in NEW_OPS)
    assert len(ops._ops) == 75
    for t in NEW_OPS:
        jdef, pdef = JaxOpInfoMap.instance().get(t), ops.get(t)
        assert pdef.intermediate_outputs == jdef.intermediate_outputs, t
        assert pdef.non_differentiable_inputs == \
            jdef.non_differentiable_inputs, t


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_forward_matches_jax(case):
    _, op_type, inputs, attrs, _ = case
    want = JaxOpInfoMap.instance().get(op_type).compute(_jax_in(inputs),
                                                         dict(attrs))
    with op_device("cpu"):
        got = OpInfoMap.instance().get(op_type).compute(_port_in(inputs),
                                                        dict(attrs))
    assert set(got) == set(want)
    for slot in want:
        for i, (g, w) in enumerate(zip(got[slot], want[slot])):
            _assert_same(g, w, f"{op_type}.{slot}[{i}]")


@pytest.mark.parametrize("case", [c for c in CASES if c[4]],
                         ids=[c[0] for c in CASES if c[4]])
def test_gradient_matches_jax_generic_vjp(case):
    _, op_type, inputs, attrs, ct_slots = case
    jdef = JaxOpInfoMap.instance().get(op_type)
    pdef = OpInfoMap.instance().get(op_type)
    jin = _jax_in(inputs)
    outs = jdef.compute(jin, dict(attrs))
    rs = _rs(99)
    cts = {s: [rs.randn(*np.shape(v)).astype(np.float32) for v in outs[s]]
           for s in ct_slots}
    want = jax_vjp_grad(jdef, jin, outs,
                        {s: [jnp.asarray(c) for c in v]
                         for s, v in cts.items()}, dict(attrs))
    got = generic_vjp_grad(pdef, _port_in(inputs), {},
                           {s: [torch.from_numpy(c) for c in v]
                            for s, v in cts.items()}, dict(attrs))
    assert set(got) == set(want), (set(got), set(want))
    for slot in want:
        for i, (g, w) in enumerate(zip(got[slot], want[slot])):
            _assert_same(g, w, f"d{op_type}/d{slot}[{i}]")


def test_generic_grad_loss_seed_of_shape_one_against_scalar():
    """fluid's [1]-shaped loss grad against a 0-d output (``_fit_ct``),
    and zero gradients where no cotangent is given."""
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    mean = OpInfoMap.instance().get("mean")
    got = generic_vjp_grad(mean, {"X": [torch.from_numpy(x)]}, {},
                           {"Out": [torch.ones(1)]}, {})
    np.testing.assert_allclose(got["X"][0].numpy(), np.full((2, 3), 1 / 6),
                               rtol=1e-6)
    none = generic_vjp_grad(mean, {"X": [torch.from_numpy(x)]}, {}, {}, {})
    np.testing.assert_array_equal(none["X"][0].numpy(), np.zeros((2, 3)))


def test_generic_grad_skips_integer_and_nondifferentiable_slots():
    """``Ids`` (non-differentiable) and an integer element get no
    gradient: the JAX package hands them float0, the port None."""
    w = torch.randn(5, 3, generator=torch.Generator().manual_seed(0))
    ids = torch.tensor([[1], [4]])
    got = generic_vjp_grad(OpInfoMap.instance().get("lookup_table"),
                           {"W": [w], "Ids": [ids]}, {},
                           {"Out": [torch.ones(2, 3)]}, {})
    assert set(got) == {"W"}
    summed = generic_vjp_grad(OpInfoMap.instance().get("sum"),
                              {"X": [w, torch.ones(5, 3, dtype=torch.int64)]},
                              {}, {"Out": [torch.ones(5, 3)]}, {})
    assert summed["X"][1] is None
    np.testing.assert_array_equal(summed["X"][0].numpy(), np.ones((5, 3)))


@pytest.mark.parametrize("op_type,attrs,check", [
    ("gaussian_random", {"shape": [200, 100], "mean": 1.0, "std": 2.0,
                         "dtype": "float32"},
     lambda a: abs(a.mean() - 1.0) < 0.05 and abs(a.std() - 2.0) < 0.05),
    ("uniform_random", {"shape": [200, 100], "min": -0.5, "max": 1.5,
                        "dtype": "float32"},
     lambda a: a.min() >= -0.5 and a.max() < 1.5 and
     abs(a.mean() - 0.5) < 0.02),
])
def test_random_op_distribution(op_type, attrs, check):
    """20,000 draws: mean and spread within 1% of the range of what both
    packages are asked for (about 7 standard errors), and each package's
    dtype and shape."""
    jout = np.asarray(JaxOpInfoMap.instance().get(op_type).compute(
        {}, dict(attrs))["Out"][0])
    with op_device("cpu"):
        pout = OpInfoMap.instance().get(op_type).compute(
            {}, dict(attrs))["Out"][0]
    assert pout.shape == jout.shape and pout.dtype == torch.float32
    assert check(jout) and check(pout.numpy())
    with op_device("cpu"):
        again = OpInfoMap.instance().get(op_type).compute(
            {}, dict(attrs))["Out"][0]
    assert not torch.equal(again, pout)     # seed 0: a fresh draw
