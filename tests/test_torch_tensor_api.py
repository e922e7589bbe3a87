"""The 2.0 tensor API (``paddle_tpu_torch.tensor_api``, re-exported at the
package top) against the JAX package's ``tensor_api``: every one of its
100 public functions is called in both packages on the same numpy
arguments. Integer and bool results must be equal, float results agree
at rtol 1e-5 / atol 1e-6 (fp32 on both sides; ``cholesky`` and
``inverse`` of a matrix of condition number under 10 at atol 1e-5), and
random functions are held by shape and dtype. Also: ``equal_all``'s
fallback to ``allclose``, the errors of the names this slice defers
(each naming its ROADMAP item), and the top-level exports (dtype names,
``to_tensor``, ``grad``, ``seed``)."""
import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu.tensor_api as jta

import paddle_tpu_torch as tpt
import paddle_tpu_torch.tensor_api as pta
from paddle_tpu_torch.core.enforce import (InvalidArgumentError,
                                           UnimplementedError)
from paddle_tpu_torch.testing.op_cases import f32, ints, uniform


def _spd(n):
    a = np.random.RandomState(5).randn(n, n)
    return (a @ a.T / n + 2 * np.eye(n)).astype(np.float32)


A, B = f32(1, 3, 4), f32(2, 3, 4)
POS = uniform(3, 0.5, 2.0, 3, 4)
NZ = np.where(np.abs(B) < 0.3, 0.5, B).astype(np.float32)
V4, V3 = f32(4, 4), f32(5, 3)
A6 = f32(6, 6, 4)
INT_A, INT_B = ints(7, -2, 3, 3, 4), ints(8, -2, 3, 3, 4)
COND = np.random.RandomState(9).rand(3, 4) > 0.5
IDX = np.array([2, 0, 1, 2], np.int64)

# (id, function, positional args, keyword args)
CALLS = [
    ("add", "add", (A, B), {}),
    ("multiply", "multiply", (A, B), {}),
    ("divide", "divide", (A, NZ), {}),
    ("floor_divide", "floor_divide", (A * 4, NZ), {}),
    ("remainder", "remainder",
     (INT_A, np.array([2, -3, 1, 2], np.int64)), {}),
    ("maximum", "maximum", (A, B), {}),
    ("minimum", "minimum", (A, V4), {}),
    ("tanh", "tanh", (A,), {}),
    ("sign", "sign", (NZ,), {}),
    ("log1p", "log1p", (POS,), {}),
    ("kron", "kron", (f32(10, 2, 3), f32(11, 2, 2)), {}),
    ("dot", "dot", (A, B), {}),
    ("cross", "cross", (f32(12, 4, 3), f32(13, 4, 3)), {}),
    ("sum", "sum", (A,), {"axis": 1}),
    ("sum_all", "sum", (A,), {}),
    ("mean", "mean", (A,), {"axis": [0, 1], "keepdim": True}),
    ("max", "max", (A,), {"axis": 0, "keepdim": True}),
    ("min", "min", (A,), {}),
    ("prod", "prod", (POS,), {"axis": [0, 1]}),
    ("pow_scalar", "pow", (POS, 2.5), {}),
    ("pow_tensor", "pow", (POS, uniform(14, -1.0, 1.0, 4)), {}),
    ("addcmul", "addcmul", (A, B, POS), {"value": 0.5}),
    ("addmm", "addmm", (f32(15, 3, 5), A, f32(16, 4, 5)),
     {"beta": 0.5, "alpha": 2.0}),
    ("logsumexp", "logsumexp", (A,), {"axis": 1}),
    ("logsumexp_all", "logsumexp", (A,), {}),
    ("clip", "clip", (A,), {"min": -0.5, "max": 0.5}),
    ("clip_min", "clip", (A,), {"min": 0.1}),
    ("trace", "trace", (f32(17, 4, 4),), {"offset": 1}),
    ("elementwise_sum", "elementwise_sum", ([A, B, A],), {}),
    ("equal", "equal", (INT_A, INT_B), {}),
    ("not_equal", "not_equal", (INT_A, INT_B), {}),
    ("less_than", "less_than", (INT_A, INT_B), {}),
    ("less_equal", "less_equal", (INT_A, INT_B), {}),
    ("greater_than", "greater_than", (INT_A, INT_B), {}),
    ("greater_equal", "greater_equal", (INT_A, INT_B), {}),
    ("allclose", "allclose", (A, A + 1e-7), {}),
    ("equal_all_same", "equal_all", (A, A.copy()), {}),
    ("equal_all_other", "equal_all", (A, B), {}),
    ("isfinite", "isfinite", (A,), {}),
    ("isinf", "isinf", (np.array([1.0, np.inf], np.float32),), {}),
    ("isnan", "isnan", (A,), {}),
    ("arange", "arange", (5,), {}),
    ("arange_float", "arange", (1, 2, 0.25), {"dtype": "float32"}),
    ("full", "full", ([2, 3], 1.5), {}),
    ("zeros", "zeros", ([2, 3],), {"dtype": "int32"}),
    ("ones", "ones", ([3],), {}),
    ("full_like", "full_like", (A, 2.0), {}),
    ("zeros_like", "zeros_like", (A,), {}),
    ("ones_like", "ones_like", (A,), {"dtype": "int32"}),
    ("eye", "eye", (3, 4), {}),
    ("diag_vector", "diag", (V3,), {"offset": 1}),
    ("diag_matrix", "diag", (A,), {"offset": 1}),
    ("meshgrid", "meshgrid", (V3, V4), {}),
    ("matmul", "matmul", (A, B), {"transpose_y": True}),
    ("mm", "mm", (A, f32(18, 4, 2)), {}),
    ("bmm", "bmm", (f32(19, 2, 3, 4), f32(20, 2, 4, 2)), {}),
    ("cholesky", "cholesky", (_spd(4),), {}),
    ("inverse", "inverse", (_spd(4),), {}),
    ("mv", "mv", (A, V4), {}),
    ("t", "t", (A,), {}),
    ("t_vector", "t", (V4,), {}),
    ("dist", "dist", (A, B), {"p": 3.0}),
    ("norm", "norm", (A,), {}),
    ("norm_fro", "norm", (A,), {"p": "fro"}),
    ("norm_axis", "norm", (A,), {"p": 1.0, "axis": 1}),
    ("norm_axes", "norm", (A,), {"p": 2, "axis": [0, 1]}),
    ("histogram", "histogram", (f32(21, 40),), {"bins": 5, "min": -1,
                                                "max": 1}),
    ("concat", "concat", ([A, B],), {"axis": 1}),
    ("stack", "stack", ([A, B],), {}),
    ("unbind", "unbind", (A,), {"axis": 1}),
    ("split", "split", (A6, 3), {}),
    ("split_sections", "split", (A, [1, -1, 2]), {"axis": 1}),
    ("chunk", "chunk", (A6, 2), {}),
    ("reshape", "reshape", (A, [2, 6]), {}),
    ("squeeze", "squeeze", (f32(22, 3, 1, 4),), {"axis": 1}),
    ("unsqueeze", "unsqueeze", (A, [0, 3]), {}),
    ("flatten", "flatten", (f32(23, 2, 3, 4),), {"start_axis": 1}),
    ("flip", "flip", (A, 1), {}),
    ("roll", "roll", (A, 1), {"axis": 0}),
    ("tile", "tile", (A, [2, 1]), {}),
    ("expand", "expand", (V4, [3, 4]), {}),
    ("expand_as", "expand_as", (V4, A), {}),
    ("gather", "gather", (A, np.array([2, 0], np.int64)), {}),
    ("gather_nd", "gather_nd", (A, np.array([[0, 1], [2, 3]], np.int64)),
     {}),
    ("scatter", "scatter", (A, np.array([2, 0], np.int64), f32(24, 2, 4)),
     {}),
    ("where", "where", (COND, A, B), {}),
    ("where_index", "where", (COND,), {}),
    ("argmax", "argmax", (A,), {}),
    ("argmax_axis", "argmax", (A,), {"axis": 0}),
    ("argmin", "argmin", (A,), {"axis": 1, "keepdim": True,
                                "dtype": "int32"}),
    ("argsort", "argsort", (A,), {"descending": True}),
    ("sort", "sort", (A,), {"axis": 0}),
    ("topk", "topk", (A, 2), {}),
    ("nonzero", "nonzero", (COND,), {}),
    ("index_select", "index_select", (A, IDX), {"axis": 1}),
    ("index_sample", "index_sample",
     (A, np.array([[0, 3], [1, 1], [2, 0]], np.int64)), {}),
    ("unique", "unique", (np.array([3, 1, 3, 7, 1], np.int64),),
     {"return_index": True, "return_inverse": True,
      "return_counts": True}),
    ("std", "std", (A,), {}),
    ("std_axis", "std", (A,), {"axis": 1, "unbiased": False}),
    ("var", "var", (A,), {"axis": [0, 1], "keepdim": True}),
    ("numel", "numel", (A,), {}),
    ("cumsum", "cumsum", (A,), {}),
    ("cumsum_axis", "cumsum", (A,), {"axis": 1, "dtype": "float64"}),
    ("tril", "tril", (A, 1), {}),
    ("triu", "triu", (A, -1), {}),
]
# (function, positional args, keyword args): held by shape and dtype
RANDOM = [
    ("empty", ([2, 3],), {"dtype": "float32"}),
    ("empty_like", (A,), {}),
    ("uniform", ([50, 40],), {"min": -1.0, "max": 2.0, "seed": 3}),
    ("rand", ([50, 40],), {}),
    ("normal", (0.0, 2.0, [50, 40]), {}),
    ("standard_normal", ([50, 40],), {}),
    ("gaussian", ([5, 4],), {}),
    ("randint", (0, 10, [50, 40]), {}),
    ("randperm", (20,), {}),
    ("bernoulli", (POS / 2.0,), {}),
]
LOOSE = {"cholesky": (1e-5, 1e-5), "inverse": (1e-5, 1e-5)}


def _np(v):
    return np.asarray(v.numpy())


def _same(got, want, tol, what):
    if isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, tol, f"{what}[{i}]")
        return
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    assert str(g.dtype) == str(w.dtype), (what, g.dtype, w.dtype)
    if np.issubdtype(w.dtype, np.floating):
        np.testing.assert_allclose(g, w, rtol=tol[0], atol=tol[1],
                                   err_msg=what)
    else:
        np.testing.assert_array_equal(g, w, err_msg=what)


@pytest.fixture(autouse=True)
def _cpu():
    tpt.set_device("cpu")


def test_the_same_public_names():
    assert sorted(pta.__all__) == sorted(jta.__all__)
    assert len(pta.__all__) == 100
    assert {c[1] for c in CALLS} | {r[0] for r in RANDOM} | {
        "masked_select"} == set(pta.__all__)
    for name in set(pta.__all__) - {"clip"}:
        assert getattr(tpt, name) is getattr(pta, name), name
    # the top-level clip is the fluid.clip module, callable as paddle.clip
    assert tpt.clip.ClipGradByNorm is not None
    np.testing.assert_array_equal(tpt.clip(A, -0.5, 0.5).numpy(),
                                  pta.clip(A, -0.5, 0.5).numpy())


@pytest.mark.parametrize("call", CALLS, ids=[c[0] for c in CALLS])
def test_function_matches_jax(call):
    what, name, args, kwargs = call
    want = getattr(jta, name)(*args, **kwargs)
    got = getattr(pta, name)(*args, **kwargs)
    _same(got, want, LOOSE.get(name, (1e-5, 1e-6)), what)


@pytest.mark.parametrize("call", RANDOM, ids=[r[0] for r in RANDOM])
def test_random_function_shape_and_dtype(call):
    name, args, kwargs = call
    want = getattr(jta, name)(*args, **kwargs).numpy()
    got = getattr(pta, name)(*args, **kwargs).numpy()
    assert got.shape == want.shape
    # the reference's empty is zeros of the default float type (float64
    # with 64-bit types on) whatever dtype it is asked for
    want_dtype = "float32" if name.startswith("empty") else str(want.dtype)
    assert str(got.dtype) == want_dtype


def test_masked_select_reads_the_op_output_the_reference_misses():
    """The reference's ``masked_select`` asks its op for an ``Out`` slot
    the op does not have (it returns ``Y``) and raises IndexError; the
    port's reads ``Y``: the masked elements, in row-major order."""
    with pytest.raises(IndexError):
        jta.masked_select(A, COND)
    got = pta.masked_select(A, COND)
    np.testing.assert_array_equal(got.numpy(), A[COND])


def test_equal_all_falls_back_to_allclose():
    """No op type ``equal_all`` is registered in either package, so both
    take ``allclose`` at zero tolerance: one bool, 0-d."""
    from paddle_tpu_torch.core.registry import OpInfoMap
    assert not OpInfoMap.instance().has("equal_all")
    x = f32(30, 2, 3)
    y = x.copy()
    y[1, 2] = np.nextafter(y[1, 2], np.float32(np.inf))
    for a, b in ((x, x.copy()), (x, y)):
        got, want = pta.equal_all(a, b), jta.equal_all(a, b)
        assert got.shape == () and got.dtype == torch.bool
        assert bool(got) == bool(want.numpy())
    assert bool(pta.equal_all(x, x.copy())) and not bool(pta.equal_all(x, y))


def test_deferred_and_refused_names_raise():
    """Complex data (item 12) and the 1.x alias still deferred
    (``DataParallel``, item 8) raise and name their ROADMAP item (the four
    of item 4b are held against the reference in test_torch_nn_layers.py,
    TreeConv of item 4d in test_torch_parity_ops.py, GRUUnit of item 4e-i
    in test_torch_rnn.py); the names item 5b brought (``TracedLayer``,
    ``declarative``, ``dygraph_to_static_func``) resolve to ``jit``'s
    (held against the reference in test_torch_dy2static.py);
    ``nonzero(as_tuple=True)`` and ``unique(axis=...)`` raise as in the
    reference."""
    from paddle_tpu_torch import dygraph, jit
    with pytest.raises(UnimplementedError, match="item 12"):
        tpt.to_tensor(np.array([1 + 2j]))
    with pytest.raises(UnimplementedError, match="item 12"):
        tpt.to_tensor([1.0, 2.0], dtype="complex64")
    with pytest.raises(UnimplementedError, match="item 8"):
        dygraph.DataParallel
    assert dygraph.TracedLayer is jit.TracedLayer
    assert dygraph.dygraph_to_static_func is dygraph.declarative
    with pytest.raises(InvalidArgumentError):
        pta.nonzero(COND, as_tuple=True)
    with pytest.raises(InvalidArgumentError):
        pta.unique(INT_A, axis=0)
    with pytest.raises(AttributeError):
        dygraph.no_such_name


def test_top_level_exports():
    """The dtype names, ``to_tensor`` (a copy, cast, on the device,
    ``stop_gradient`` as asked), ``grad`` and the learning-rate 1.x
    aliases of ``dygraph``."""
    from paddle_tpu_torch import dygraph, optimizer
    for name in ("bfloat16", "bool_", "complex64", "complex128", "float16",
                 "float32", "float64", "int8", "int16", "int32", "int64",
                 "uint8"):
        assert str(getattr(tpt, name)).split(".")[-1] == \
            str(getattr(jpt, name)), name
    src = torch.ones(2, 3)
    t = tpt.to_tensor(src, dtype="float64", stop_gradient=False)
    assert t.dtype == torch.float64 and t.requires_grad and not t.stop_gradient
    t2 = tpt.to_tensor(src)
    assert t2.data_ptr() != src.data_ptr() and t2.stop_gradient
    arr = np.arange(6, dtype=np.int32).reshape(2, 3)
    np.testing.assert_array_equal(tpt.to_tensor(arr).numpy(), arr)
    assert tpt.grad is dygraph.grad
    assert dygraph.NoamDecay is optimizer.NoamDecay
