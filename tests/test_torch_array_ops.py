"""The 11 op types of ``ops/array_ops.py`` and the 4 of
``ops/control_flow_ops.py`` against the JAX package's ops, and
``TensorArray`` against the JAX package's (tests/test_array_ops.py and
tests/test_tensor_array.py, case for case).

The op cases are ``paddle_tpu_torch/testing/cf_cases.py``'s, run by
``test_torch_parity_ops.py``'s helpers (fp32 rtol 1e-5 / atol 1e-6,
integers equal): the dense array form, whose ``array_length`` is the
capacity and whose indices count from the end when negative and are
clamped at each end, as ``lax.dynamic_update_index_in_dim`` and
``lax.dynamic_index_in_dim`` do; the control-flow ops on a published
Program, with the gradients of their captured inputs. Then the list form that both
packages take while the LoD side channel is active, and
tests/test_array_ops.py's cases. Its three ``sequence_*`` cases belong
to ``ops/sequence_ops.py``: ``test_torch_sequence_ops.py`` holds them.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpt
from paddle_tpu.core import lodctx as jax_lodctx
from paddle_tpu.core.registry import OpInfoMap as JaxOpInfoMap
from paddle_tpu.tensor_array import TensorArray as JaxTensorArray

import paddle_tpu_torch as tpt
from paddle_tpu_torch.core import lodctx
from paddle_tpu_torch.core.registry import OpInfoMap
from paddle_tpu_torch.ops.array_ops import LoDTensorArrayValue
from paddle_tpu_torch.tensor_array import (TensorArray, array_length,
                                           array_read, array_write,
                                           create_array, create_array_like)
from test_torch_parity_ops import (cf_cases_of, cf_check_forward,
                                   cf_check_gradient)

CASES = cf_cases_of(("paddle_tpu.ops.array_ops",
                     "paddle_tpu.ops.control_flow_ops"))
VALUE = [c for c in CASES if c.kind == "value"]
GRAD = [c for c in VALUE if c.grad]


@pytest.fixture(autouse=True)
def _cpu():
    tpt.set_device("cpu")


@pytest.mark.parametrize("case", VALUE, ids=[c.id for c in VALUE])
def test_forward_matches_jax(case, tmp_path):
    cf_check_forward(case, tmp_path)


@pytest.mark.parametrize("case", GRAD, ids=[c.id for c in GRAD])
def test_gradient_matches_jax(case, tmp_path):
    cf_check_gradient(case, tmp_path)


def test_clamped_indices_at_each_end(tmp_path):
    """Writes and reads past the end land on the last row, a negative
    index counts from the end (-2 of 4 rows is row 2), in both packages
    (the cases hold the values; this holds where)."""
    for cid, row in (("write_to_array_past_end", 3),
                     ("write_to_array_negative", 2)):
        case = next(c for c in CASES if c.id == cid)
        got = cf_check_forward(case, tmp_path)["Out"][0].numpy()
        np.testing.assert_array_equal(got[row], case.inputs["X"][0])
    for cid, row in (("read_from_array_past_end", 3),
                     ("read_from_array_negative", 3)):
        case = next(c for c in CASES if c.id == cid)
        got = cf_check_forward(case, tmp_path)["Out"][0].numpy()
        np.testing.assert_array_equal(got, case.inputs["X"][0][row])


def test_capacity_not_length_on_the_dense_path(tmp_path):
    """array_length of the dense form is its capacity, however many
    rows were written."""
    case = next(c for c in CASES if c.id == "array_length")
    got = cf_check_forward(case, tmp_path)["Out"][0]
    assert got.dtype == torch.int64 and int(got) == 5


def _list_form(compute, to, lod_scope):
    """Two writes and a read under an active LoD side channel."""
    with lod_scope():
        arr = compute("write_to_array")(
            {"X": [to(np.ones(3, np.float32))], "I": [to(np.asarray(0))]},
            {"max_size": 8})["Out"][0]
        arr = compute("write_to_array")(
            {"Array": [arr], "X": [to(np.full(5, 2.0, np.float32))],
             "I": [to(np.asarray(2))]}, {})["Out"][0]
        n = compute("array_length")({"X": [arr]}, {})["Out"][0]
        back = compute("read_from_array")(
            {"X": [arr], "I": [to(np.asarray(2))]}, {})["Out"][0]
        with pytest.raises(Exception, match="unwritten"):
            compute("read_from_array")(
                {"X": [arr], "I": [to(np.asarray(1))]}, {})
    return arr, int(n), np.asarray(back)


def test_list_form_under_the_lod_side_channel():
    """While the LoD side channel is active (the JAX executor's eager
    interpreter) an array is a growing list in both packages: elements
    of other shapes, length the number of slots, a hole unreadable."""
    jarr, jn, jback = _list_form(
        lambda t: JaxOpInfoMap.instance().get(t).compute, jnp.asarray,
        jax_lodctx.lod_scope)
    parr, pn, pback = _list_form(
        lambda t: OpInfoMap.instance().get(t).compute,
        lambda v: torch.from_numpy(np.asarray(v)), lodctx.lod_scope)
    assert isinstance(parr, LoDTensorArrayValue)
    assert [e is None for e in parr] == [e is None for e in jarr]
    assert pn == jn == 3
    np.testing.assert_array_equal(pback, jback)


def test_write_to_array_needs_capacity():
    with pytest.raises(Exception, match="max_size"):
        OpInfoMap.instance().get("write_to_array").compute(
            {"X": [torch.ones(2)], "I": [torch.tensor(0)]}, {})


def test_pivot_roundtrip_and_masks():
    """tests/test_array_ops.py's pivot, shrink, split/merge, select and
    lod_reset cases on the port."""
    ops = OpInfoMap.instance()
    x = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    buf = ops.get("lod_tensor_to_array").compute(
        {"X": [torch.from_numpy(x)]}, {})["Out"][0]
    assert tuple(buf.shape) == (3, 2, 4)
    back = ops.get("array_to_lod_tensor").compute(
        {"X": [buf], "Length": [torch.tensor([3, 2])]}, {})["Out"][0]
    expect = x.copy()
    expect[1, 2:] = 0
    np.testing.assert_allclose(back.numpy(), expect)
    out = ops.get("shrink_rnn_memory").compute(
        {"X": [torch.ones(3, 2)], "I": [torch.tensor(1)],
         "Length": [torch.tensor([3, 1, 2])]}, {})["Out"][0]
    np.testing.assert_allclose(out.numpy(), [[1, 1], [0, 0], [1, 1]])
    xs = torch.arange(8, dtype=torch.float32).reshape(4, 2)
    mask = torch.tensor([1, 0, 0, 1], dtype=torch.int32)
    parts = ops.get("split_lod_tensor").compute({"X": [xs], "Mask": [mask]},
                                                {})
    merged = ops.get("merge_lod_tensor").compute(
        {"InTrue": parts["OutTrue"], "InFalse": parts["OutFalse"],
         "Mask": [mask]}, {})["Out"][0]
    np.testing.assert_allclose(merged.numpy(), xs.numpy())
    picked = ops.get("select_input").compute(
        {"X": [torch.zeros(2), torch.ones(2)],
         "Mask": [torch.tensor(1)]}, {})["Out"][0]
    routed = ops.get("select_output").compute(
        {"X": [picked], "Mask": [torch.tensor(1)]},
        {"num_outputs": 2})["Out"]
    np.testing.assert_allclose(picked.numpy(), [1, 1])
    np.testing.assert_allclose(routed[0].numpy(), [0, 0])
    np.testing.assert_allclose(routed[1].numpy(), [1, 1])
    reset = ops.get("lod_reset").compute({"X": [torch.ones(2, 4)]},
                                         {"target_lod": [2, 3]})
    np.testing.assert_array_equal(reset["OutLength"][0].numpy(), [2, 3])


def test_control_flow_ops_raise_outside_a_run():
    for op in ("while_loop", "static_rnn"):
        with pytest.raises(Exception, match="outside an Executor.run"):
            OpInfoMap.instance().get(op).compute(
                {"X": [torch.ones(1)], "Sequences": [torch.ones(2, 1)]},
                {"sub_block": 1, "cond_block": 1, "body_block": 2,
                 "carry_names": ["a"], "body_out_names": ["a"],
                 "cond_out_name": "c"})


# ------------------------------------------------------------ TensorArray
def _jv(v):
    return np.asarray(v._value)


def test_tensor_array_write_read_length():
    """tests/test_tensor_array.py's first case in both packages."""
    ta = create_array(element_shape=(3,), max_size=5)
    ta = array_write(torch.ones(3), 0, ta)
    ta = array_write(torch.full((3,), 2.0), 1, ta)
    jta = JaxTensorArray((3,), 5)
    jta = jta.write(0, jpt.to_tensor(np.ones(3, np.float32)))
    jta = jta.write(1, jpt.to_tensor(np.full(3, 2.0, np.float32)))
    assert int(array_length(ta)) == int(jta.length()._value) == 2
    np.testing.assert_array_equal(array_read(ta, 1).numpy(),
                                  _jv(jta.read(1)))
    np.testing.assert_array_equal(ta.stack().numpy(), _jv(jta.stack()))
    assert array_length(ta).dtype == torch.int32


def test_tensor_array_append_tracks_size():
    ta = create_array(element_shape=(), max_size=4)
    jta = JaxTensorArray((), 4)
    for v in (1.0, 2.0, 3.0):
        ta = ta.append(torch.tensor(v))
        jta = jta.append(jpt.to_tensor(np.float32(v)))
    assert len(ta) == len(jta) == 3
    np.testing.assert_array_equal(ta.stack().numpy(), _jv(jta.stack()))


@pytest.mark.parametrize("index", [-1, -4, -100, 3])
def test_tensor_array_index_ends(index):
    """Negative writes count from the end (one still out of range is
    dropped); reads past either end clamp; both as the JAX array."""
    ta = TensorArray((2,), 4).write(index, torch.ones(2))
    jta = JaxTensorArray((2,), 4).write(
        index, jpt.to_tensor(np.ones(2, np.float32)))
    np.testing.assert_array_equal(ta.stack().numpy(), _jv(jta.stack()))
    assert len(ta) == len(jta)
    for r in (index, 7, -9):
        np.testing.assert_array_equal(ta.read(r).numpy(), _jv(jta.read(r)))


def test_tensor_array_write_past_capacity_raises():
    with pytest.raises(Exception, match="exceeds max_size"):
        TensorArray((2,), 4).write(4, torch.ones(2))


def test_tensor_array_as_a_loop_carry():
    """The lax.while_loop carry case: a TensorArray threaded through a
    python loop, then the same loop run for 2 (the JAX array through
    lax.while_loop in its own test)."""
    def run(n):
        i, ta = 0, TensorArray((), max_size=8)
        while i < n:
            ta = ta.write(i, torch.tensor(i * 10.0))
            i += 1
        return ta
    ta = run(5)
    assert int(ta.length()) == 5
    np.testing.assert_allclose(ta.stack().numpy()[:5], [0, 10, 20, 30, 40])
    assert int(run(2).length()) == 2


def test_tensor_array_decode_loop_matches_to_static():
    """tests/test_tensor_array.py's dy2static decode loop: the port's
    python loop run eagerly against the JAX package's to_static result
    (test_torch_dy2static.py holds the port's own to_static of it)."""
    from paddle_tpu.jit import to_static

    def jax_decode(x):
        ta = JaxTensorArray((2,), max_size=6)
        i = x.sum() * 0.0
        state = x
        while i < 4.0:
            state = state * 0.5
            ta = ta.write(i.astype("int32"), state)
            i = i + 1.0
        return ta.stack()

    want = np.asarray(to_static(jax_decode)(np.ones(2, np.float32))._value)
    ta, state = TensorArray((2,), max_size=6), torch.ones(2)
    for i in range(4):
        state = state * 0.5
        ta = ta.write(i, state)
    np.testing.assert_allclose(ta.stack().numpy(), want, rtol=1e-6)


def test_create_array_like_stacks():
    ta = create_array_like([torch.ones(2), torch.zeros(2)])
    assert len(ta) == 2 and ta.max_size == 2
    np.testing.assert_array_equal(ta.stack().numpy(), [[1, 1], [0, 0]])
