"""Small cases of the 153 op types the 2.0 tensor API brought to the
port: the numpy inputs and attrs that ``tests/test_torch_tensor_ops.py``
runs through both packages' registries on the CPU, and that
``chip_smoke.py`` phase ``tensor_api`` runs through the port on the card
and on the CPU.

A case is a :class:`Case`: an id, the op type, its inputs (numpy arrays
made from a fixed seed, by slot), its attrs, and how its outputs are
held:

- ``"value"``: integer and bool outputs equal; float outputs within
  ``tol`` (rtol, atol); when ``grad`` is set, the gradients of the
  differentiable float inputs for seeded cotangents on the float
  outputs too, within ``grad_tol``;
- ``"random"``: a random op, held by its outputs' shape and dtype and by
  ``check`` (a function of the output as a numpy array that holds its
  range and moments); equal seeds give equal draws;
- ``"shape"``: ``empty``, held by shape and dtype only.

fp32 cases hold at rtol 1e-5 / atol 1e-6: the two libraries differ only
in the order of their sums and in transcendental rounding. Cases that
state their own bound say why.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np

FP32 = (1e-5, 1e-6)
EXACT = (0.0, 0.0)


class Case(NamedTuple):
    id: str
    op: str
    inputs: Dict[str, List[np.ndarray]]
    attrs: dict
    kind: str = "value"
    grad: bool = True
    tol: Tuple[float, float] = FP32
    grad_tol: Tuple[float, float] = FP32
    check: Optional[Callable] = None
    # a control-flow op's Program (JSON) whose sub-blocks its attrs name
    program: Optional[str] = None
    # setup(ops, tmp): registers what the op looks up (a reader, a py
    # callable) in a package's ops modules (ops("misc_ops") is the
    # module) and writes the files it reads into the directory tmp
    setup: Optional[Callable] = None


def _rs(seed):
    return np.random.RandomState(seed)


def f32(seed, *shape, scale=1.0, shift=0.0):
    return (_rs(seed).randn(*shape) * scale + shift).astype(np.float32)


def uniform(seed, lo, hi, *shape):
    return _rs(seed).uniform(lo, hi, shape).astype(np.float32)


def ints(seed, lo, hi, *shape, dtype=np.int64):
    return _rs(seed).randint(lo, hi, shape).astype(dtype)


def _away_from_zero(seed, *shape):
    x = f32(seed, *shape)
    return np.where(np.abs(x) < 0.3, np.sign(x + 1e-3) * 0.5, x) \
        .astype(np.float32)


def _spd(seed, n, batch=()):
    """A well-conditioned symmetric positive definite matrix (condition
    number under 10)."""
    a = _rs(seed).randn(*batch, n, n)
    m = a @ np.swapaxes(a, -1, -2) / n + np.eye(n) * 2.0
    return m.astype(np.float32)


X34 = {"X": [f32(1, 3, 4)]}

# ---------------------------------------------------------------- math.py
# unary ops on X [3, 4]: op -> (input, attrs); inputs kept inside each
# function's domain and off its kinks
_UNARY = {
    "sigmoid": (f32(2, 3, 4), {}),
    "sqrt": (uniform(3, 0.2, 3.0, 3, 4), {}),
    "rsqrt": (uniform(4, 0.2, 3.0, 3, 4), {}),
    "exp": (f32(5, 3, 4), {}),
    "log": (uniform(6, 0.2, 3.0, 3, 4), {}),
    "log2": (uniform(7, 0.2, 3.0, 3, 4), {}),
    "log10": (uniform(8, 0.2, 3.0, 3, 4), {}),
    "log1p": (uniform(9, -0.5, 3.0, 3, 4), {}),
    "abs": (_away_from_zero(10, 3, 4), {}),
    "reciprocal": (_away_from_zero(11, 3, 4), {}),
    "floor": (f32(12, 3, 4, scale=3.0), {}),
    "ceil": (f32(13, 3, 4, scale=3.0), {}),
    "round": (np.array([[0.5, 1.5, 2.5, -0.5], [-1.5, 0.4, 0.6, -2.6],
                        [3.2, -3.7, 0.0, 7.5]], np.float32), {}),
    "sin": (f32(14, 3, 4), {}),
    "cos": (f32(15, 3, 4), {}),
    "tan": (uniform(16, -1.2, 1.2, 3, 4), {}),
    "asin": (uniform(17, -0.9, 0.9, 3, 4), {}),
    "acos": (uniform(18, -0.9, 0.9, 3, 4), {}),
    "atan": (f32(19, 3, 4), {}),
    "sinh": (f32(20, 3, 4), {}),
    "cosh": (f32(21, 3, 4), {}),
    "softplus": (f32(22, 3, 4, scale=3.0), {}),
    "softsign": (f32(23, 3, 4), {}),
    "elu": (_away_from_zero(24, 3, 4), {"alpha": 0.7}),
    "selu": (_away_from_zero(25, 3, 4), {}),
    "silu": (f32(26, 3, 4), {}),
    "swish": (f32(27, 3, 4), {"beta": 1.5}),
    "hard_swish": (f32(28, 3, 4, scale=3.0), {}),
    "hard_sigmoid": (f32(29, 3, 4, scale=3.0), {}),
    "logsigmoid": (f32(30, 3, 4), {}),
    "erf": (f32(31, 3, 4), {}),
    "mish": (f32(32, 3, 4), {}),
    "thresholded_relu": (f32(33, 3, 4, scale=2.0), {"threshold": 0.7}),
    "hard_shrink": (f32(34, 3, 4), {"threshold": 0.4}),
    "soft_shrink": (f32(35, 3, 4), {"lambda": 0.4}),
    "tanh_shrink": (f32(36, 3, 4), {}),
    "stanh": (f32(37, 3, 4), {"scale_a": 0.5, "scale_b": 1.5}),
    "sign": (_away_from_zero(38, 3, 4), {}),
}

# op -> (X, Y, attrs) of the elementwise family not in the port before
_ELEMENTWISE = {
    "elementwise_min": (f32(40, 2, 3, 4), f32(41, 3, 4), {"axis": -1}),
    "elementwise_pow": (uniform(42, 0.5, 2.0, 2, 3, 4),
                        uniform(43, -1.5, 1.5, 3), {"axis": 1}),
    "elementwise_mod": (f32(44, 2, 3, scale=4.0),
                        np.array([1.5, -2.0, 0.75], np.float32), {}),
    "elementwise_floordiv": (f32(45, 2, 3, scale=4.0),
                             np.array([1.5, -2.0, 0.75], np.float32), {}),
}


def _reduce_cases():
    out = []
    for op in ("reduce_mean", "reduce_max", "reduce_min", "reduce_prod"):
        x = f32(50, 2, 3, 4) if op != "reduce_prod" else \
            uniform(51, 0.5, 1.5, 2, 3, 4)
        out += [Case(f"{op}_dim1", op, {"X": [x]}, {"dim": [1]}),
                Case(f"{op}_dims_keep", op, {"X": [x]},
                     {"dim": [0, -1], "keep_dim": True}),
                Case(f"{op}_all", op, {"X": [x]}, {"reduce_all": True})]
    # ties: jnp.max / jnp.min split the gradient between equal extremes
    ties = np.array([[1.0, 3.0, 3.0], [-2.0, -2.0, 0.5]], np.float32)
    out += [Case("reduce_max_ties", "reduce_max", {"X": [ties]},
                 {"dim": [1]}),
            Case("reduce_min_ties", "reduce_min", {"X": [ties]},
                 {"dim": [1]})]
    return out


def _compare_cases():
    a = ints(60, -2, 3, 3, 4).astype(np.float32)
    b = ints(61, -2, 3, 3, 4).astype(np.float32)
    out = [Case(op, op, {"X": [a], "Y": [b]}, {}, grad=False)
           for op in ("equal", "less_than", "less_equal", "greater_than",
                      "greater_equal")]
    la, lb = _rs(62).rand(3, 4) > 0.5, _rs(63).rand(3, 4) > 0.5
    out += [Case(op, op, {"X": [la], "Y": [lb]}, {}, grad=False)
            for op in ("logical_and", "logical_or", "logical_xor")]
    out.append(Case("logical_not", "logical_not", {"X": [la]}, {},
                    grad=False))
    special = np.array([[1.0, np.inf, -np.inf], [np.nan, 0.0, -2.0]],
                       np.float32)
    out += [Case(f"{op}_special", op, {"X": [special]}, {}, grad=False)
            for op in ("isfinite_v2", "isnan_v2", "isinf_v2", "isfinite")]
    out.append(Case("isfinite_all_finite", "isfinite", X34, {}, grad=False))
    return out


def _math_cases():
    out = [Case(op, op, {"X": [x]}, attrs) for op, (x, attrs)
           in _UNARY.items()]
    out += [Case(op, op, {"X": [x], "Y": [y]}, attrs)
            for op, (x, y, attrs) in _ELEMENTWISE.items()]
    # integer modulo and floor division of negatives: Python's floor
    # semantics (the divisor's sign)
    xi = np.array([-7, 7, -7, 7, -3, 5], np.int64)
    yi = np.array([2, 2, -2, -2, 3, -3], np.int64)
    out += [Case(f"{op}_int_negative", op, {"X": [xi], "Y": [yi]}, {},
                 grad=False)
            for op in ("elementwise_mod", "elementwise_floordiv")]
    out.append(Case("elementwise_min_scaled", "elementwise_min",
                    {"X": [f32(46, 3, 4)], "Y": [f32(47, 3, 4)]},
                    {"scale_x": 2.0, "scale_y": 0.5, "scale_out": 3.0}))
    out += _reduce_cases()
    out += [
        Case("matmul", "matmul", {"X": [f32(70, 2, 3, 4)],
                                  "Y": [f32(71, 2, 5, 4)]},
             {"transpose_Y": True, "alpha": 0.5}),
        Case("matmul_transpose_x", "matmul", {"X": [f32(72, 4, 3)],
                                              "Y": [f32(73, 4, 5)]},
             {"transpose_X": True}),
        Case("bmm", "bmm", {"X": [f32(74, 2, 3, 4)], "Y": [f32(75, 2, 4, 5)]},
             {}),
        Case("dot", "dot", {"X": [f32(76, 3, 5)], "Y": [f32(77, 3, 5)]}, {}),
        Case("dot_1d", "dot", {"X": [f32(78, 5)], "Y": [f32(79, 5)]}, {}),
        Case("addmm", "addmm", {"Input": [f32(80, 3, 5)],
                                "X": [f32(81, 3, 4)], "Y": [f32(82, 4, 5)]},
             {"Alpha": 0.5, "Beta": 2.0}),
        Case("squared_l2_norm", "squared_l2_norm", X34, {}),
        Case("p_norm", "p_norm", {"X": [f32(83, 3, 4)]},
             {"porder": 3.0, "axis": 1}),
        Case("p_norm_all_keep", "p_norm", {"X": [f32(84, 3, 4)]},
             {"porder": 2.0, "keepdim": True}),
        Case("p_norm_vector", "p_norm", {"X": [f32(85, 3, 4)]},
             {"porder": 1.5}),
        Case("pow", "pow", {"X": [uniform(86, 0.5, 2.0, 3, 4)]},
             {"factor": 2.5}),
        Case("pow_factor_tensor", "pow",
             {"X": [uniform(87, 0.5, 2.0, 3, 4)],
              "FactorTensor": [np.array([1.5], np.float32)]}, {}),
        Case("clip", "clip", {"X": [f32(88, 3, 4)]},
             {"min": -0.5, "max": 0.7}),
        Case("clip_tensors", "clip",
             {"X": [f32(89, 3, 4)], "Min": [np.array([-0.2], np.float32)],
              "Max": [np.array([0.4], np.float32)]}, {}),
        Case("clip_by_norm", "clip_by_norm", {"X": [f32(90, 3, 4)]},
             {"max_norm": 1.0}),
        Case("clip_by_norm_inside", "clip_by_norm", {"X": [f32(91, 3, 4)]},
             {"max_norm": 100.0}),
        Case("maximum", "maximum", {"X": [f32(92, 3, 4)],
                                    "Y": [f32(93, 4)]}, {}),
        Case("minimum", "minimum", {"X": [f32(94, 3, 4)],
                                    "Y": [f32(95, 3, 1)]}, {}),
        Case("arg_max", "arg_max", {"X": [f32(96, 3, 4, 5)]}, {"axis": 1},
             grad=False),
        Case("arg_max_keep_int32", "arg_max", {"X": [f32(97, 3, 4)]},
             {"axis": -1, "keepdims": True, "dtype": "int32"}, grad=False),
        Case("arg_max_ties", "arg_max",
             {"X": [np.array([[1.0, 3.0, 3.0], [2.0, 2.0, 2.0]],
                             np.float32)]}, {"axis": 1}, grad=False),
        Case("arg_min", "arg_min", {"X": [f32(98, 3, 4, 5)]}, {"axis": 0},
             grad=False),
        Case("arg_min_ties", "arg_min",
             {"X": [np.array([[1.0, -3.0, -3.0], [2.0, 2.0, 2.0]],
                             np.float32)]}, {"axis": 1}, grad=False),
        Case("top_k_v2", "top_k_v2", {"X": [f32(99, 3, 6)]}, {"k": 3},
             grad=False),
        Case("top_k_v2_smallest_axis0", "top_k_v2", {"X": [f32(100, 5, 3)]},
             {"k": 2, "axis": 0, "largest": False}, grad=False),
        Case("top_k_v2_ties", "top_k_v2",
             {"X": [np.array([[1.0, 3.0, 3.0, 0.5, 3.0],
                              [2.0, 2.0, 2.0, 2.0, 2.0]], np.float32)]},
             {"k": 3}, grad=False),
        Case("top_k_v2_smallest_ties", "top_k_v2",
             {"X": [np.array([[1.0, 0.5, 3.0, 0.5, 0.5]], np.float32)]},
             {"k": 2, "largest": False}, grad=False),
        Case("cumsum", "cumsum", {"X": [f32(101, 3, 4)]}, {"axis": 1}),
        Case("cumsum_flatten", "cumsum", {"X": [f32(102, 3, 4)]},
             {"flatten": True}),
        Case("cumsum_reverse_exclusive", "cumsum", {"X": [f32(103, 3, 4)]},
             {"axis": 0, "reverse": True, "exclusive": True}),
        Case("increment", "increment", {"X": [np.array([3.5], np.float32)]},
             {"step": 2.0}),
        Case("increment_int64", "increment",
             {"X": [np.array([7], np.int64)]}, {"step": 1.0}, grad=False),
    ]
    out += _compare_cases()
    return out


# ---------------------------------------------------------- tensor_ops.py
def _rand_check(lo=None, hi=None, mean=None, std=None, tol=0.05):
    """Draws within [lo, hi) and with the mean and standard deviation
    asked for, to ``tol`` of the range (about 7 standard errors at the
    sizes below)."""
    def check(a):
        a = np.asarray(a, np.float64)
        ok = True
        if lo is not None:
            ok &= bool(a.min() >= lo)
        if hi is not None:
            ok &= bool(a.max() < hi)
        if mean is not None:
            ok &= abs(a.mean() - mean) < tol
        if std is not None:
            ok &= abs(a.std() - std) < tol
        return ok
    return check


def _perm_check(n):
    return lambda a: sorted(np.asarray(a).tolist()) == list(range(n))


def _tensor_cases():
    idx3 = np.array([2, 0, 2, 1], np.int64)
    x5 = f32(110, 5, 3)
    return [
        Case("fill_constant_batch_size_like", "fill_constant_batch_size_like",
             {"Input": [f32(111, 4, 2)]},
             {"shape": [-1, 3], "value": 2.5, "dtype": "float32"},
             grad=False),
        Case("fill_constant_batch_size_like_idx",
             "fill_constant_batch_size_like", {"Input": [f32(112, 2, 6)]},
             {"shape": [5, -1], "value": 3.0, "dtype": "int64",
              "input_dim_idx": 1, "output_dim_idx": 1}, grad=False),
        Case("fill_zeros_like", "fill_zeros_like", X34, {}),
        Case("fill_any_like", "fill_any_like", X34, {"value": 1.5}),
        Case("fill_any_like_int", "fill_any_like", X34,
             {"value": 7.0, "dtype": "int32"}, grad=False),
        Case("uniform_random_batch_size_like",
             "uniform_random_batch_size_like", {"Input": [f32(113, 300, 2)]},
             {"shape": [-1, 100], "min": -2.0, "max": 1.0, "seed": 5},
             kind="random", grad=False,
             check=_rand_check(-2.0, 1.0, mean=-0.5, tol=0.06)),
        Case("gaussian_random_batch_size_like",
             "gaussian_random_batch_size_like", {"Input": [f32(114, 200, 2)]},
             {"shape": [-1, 100], "mean": 1.0, "std": 0.5, "seed": 5},
             kind="random", grad=False,
             check=_rand_check(mean=1.0, std=0.5, tol=0.03)),
        Case("truncated_gaussian_random", "truncated_gaussian_random", {},
             {"shape": [200, 100], "mean": 0.5, "std": 2.0, "seed": 3},
             kind="random", grad=False,
             # N(0, 1) cut to [-2, 2] has standard deviation 0.8796
             check=_rand_check(-3.5, 4.5, mean=0.5, std=2.0 * 0.8796,
                               tol=0.04)),
        Case("randint", "randint", {},
             {"shape": [200, 100], "low": -3, "high": 7, "seed": 2},
             kind="random", grad=False,
             check=_rand_check(-3, 7, mean=1.5, tol=0.06)),
        Case("range", "range", {},
             {"start": 1.0, "end": 2.0, "step": 0.1, "dtype": "float32"},
             grad=False),
        Case("range_int64_negative_step", "range", {},
             {"start": 10.0, "end": -3.0, "step": -3.0, "dtype": "int64"},
             grad=False),
        Case("range_tensors", "range",
             {"Start": [np.array(0.5, np.float32)],
              "End": [np.array(3.0, np.float32)],
              "Step": [np.array(0.7, np.float32)]},
             {"dtype": "float64"}, grad=False),
        Case("linspace", "linspace",
             {"Start": [np.array(-1.0, np.float32)],
              "Stop": [np.array(2.0, np.float32)],
              "Num": [np.array(7, np.int32)]},
             {"dtype": "float32"}, grad=False),
        Case("linspace_int", "linspace",
             {"Start": [np.array(0.0, np.float32)],
              "Stop": [np.array(10.0, np.float32)],
              "Num": [np.array(4, np.int32)]},
             {"dtype": "int32"}, grad=False),
        Case("assign_value", "assign_value", {},
             {"shape": [2, 3], "dtype": "float32",
              "fp32_values": [0.5, 1.0, -2.0, 3.25, 0.0, 1e-3]}, grad=False),
        Case("assign_value_int64", "assign_value", {},
             {"shape": [3], "dtype": "int64", "int64_values": [4, -1, 9]},
             grad=False),
        Case("shape", "shape", {"Input": [f32(115, 2, 3, 4)]}, {},
             grad=False),
        Case("size", "size", {"Input": [f32(116, 2, 3, 4)]}, {},
             grad=False),
        Case("reshape2", "reshape2", {"X": [f32(117, 2, 3, 4)]},
             {"shape": [0, -1, 2]}),
        Case("reshape2_shape_tensor", "reshape2",
             {"X": [f32(118, 2, 6)], "Shape": [np.array([3, 4], np.int32)]},
             {"shape": [1, 12]}),
        Case("transpose", "transpose", {"X": [f32(119, 2, 3, 4)]},
             {"axis": [2, 0, 1]}),
        Case("squeeze", "squeeze", {"X": [f32(120, 1, 3, 1, 4)]},
             {"axes": [0, 1, -2]}),
        Case("squeeze_all", "squeeze", {"X": [f32(121, 1, 3, 1, 4)]}, {}),
        Case("squeeze2", "squeeze2", {"X": [f32(122, 3, 1, 4)]},
             {"axes": [1]}),
        Case("unsqueeze", "unsqueeze", {"X": [f32(123, 3, 4)]},
             {"axes": [0, 2]}),
        Case("unsqueeze_negative", "unsqueeze", {"X": [f32(124, 3, 4)]},
             {"axes": [-1]}),
        Case("unsqueeze2", "unsqueeze2", {"X": [f32(125, 3, 4)]},
             {"axes": [1]}),
        Case("flatten", "flatten", {"X": [f32(126, 2, 3, 4)]}, {"axis": 2}),
        Case("split_num", "split", {"X": [f32(127, 6, 4)]},
             {"num": 3, "axis": 0}),
        Case("split_sections", "split", {"X": [f32(128, 3, 7)]},
             {"sections": [2, -1, 1], "axis": 1}),
        Case("stack", "stack", {"X": [f32(129, 3, 4), f32(130, 3, 4)]},
             {"axis": 1}),
        Case("unstack", "unstack", {"X": [f32(131, 3, 4)]}, {"axis": 1}),
        Case("slice", "slice", {"Input": [f32(132, 4, 5, 6)]},
             {"axes": [0, 2], "starts": [1, -4], "ends": [10, -1]}),
        Case("slice_decrease", "slice", {"Input": [f32(133, 4, 5)]},
             {"axes": [0], "starts": [2], "ends": [3],
              "decrease_axis": [0]}),
        Case("slice_tensors", "slice",
             {"Input": [f32(134, 4, 5)],
              "StartsTensor": [np.array([1], np.int32)],
              "EndsTensor": [np.array([4], np.int32)]},
             {"axes": [1], "starts": [0], "ends": [1]}),
        Case("strided_slice", "strided_slice", {"Input": [f32(135, 6, 7)]},
             {"axes": [0, 1], "starts": [1, 0], "ends": [6, 7],
              "strides": [2, 3]}),
        Case("strided_slice_negative_stride", "strided_slice",
             {"Input": [f32(136, 6, 7)]},
             {"axes": [1], "starts": [6], "ends": [0], "strides": [-2]}),
        Case("gather", "gather", {"X": [x5], "Index": [idx3]}, {}),
        Case("gather_axis1_2d_index", "gather",
             {"X": [f32(137, 2, 4, 3)],
              "Index": [np.array([[3, 0], [1, 1]], np.int32)]}, {"axis": 1}),
        Case("gather_nd", "gather_nd",
             {"X": [f32(138, 3, 4, 2)],
              "Index": [np.array([[0, 1], [2, 3], [0, 1]], np.int64)]}, {}),
        Case("scatter_overwrite", "scatter",
             {"X": [x5], "Ids": [np.array([3, 0], np.int64)],
              "Updates": [f32(139, 2, 3)]}, {"overwrite": True}),
        Case("scatter_add_repeated", "scatter",
             {"X": [x5], "Ids": [np.array([1, 4, 1], np.int64)],
              "Updates": [f32(140, 3, 3)]}, {"overwrite": False}),
        # a repeated id under overwrite: the last of its rows is kept (the
        # gradient of a row overwritten by a later one is ill-defined in
        # jax's scatter transpose, so only values are held)
        Case("scatter_overwrite_repeated", "scatter",
             {"X": [x5], "Ids": [np.array([1, 4, 1, 1], np.int64)],
              "Updates": [f32(141, 4, 3)]}, {"overwrite": True},
             grad=False),
        Case("scatter_nd_add", "scatter_nd_add",
             {"X": [f32(142, 3, 4)],
              "Index": [np.array([[0, 1], [2, 3], [0, 1]], np.int64)],
              "Updates": [f32(143, 3)]}, {}),
        Case("index_select", "index_select", {"X": [f32(144, 3, 5)],
                                              "Index": [idx3]}, {"dim": 1}),
        Case("expand", "expand", {"X": [f32(145, 2, 3)]},
             {"expand_times": [2, 3]}),
        Case("expand_v2", "expand_v2", {"X": [f32(146, 3, 1)]},
             {"shape": [2, -1, 4]}),
        Case("expand_as_v2", "expand_as_v2", {"X": [f32(147, 1, 4)]},
             {"target_shape": [3, 4]}),
        Case("tile", "tile", {"X": [f32(148, 2, 3)]},
             {"repeat_times": [2, 1, 2]}),
        Case("one_hot", "one_hot",
             {"X": [np.array([[1], [0], [3], [5]], np.int64)]},
             {"depth": 4}, grad=False),
        Case("one_hot_v2", "one_hot_v2",
             {"X": [np.array([[1, 0], [3, -1]], np.int64)]}, {"depth": 4},
             grad=False),
        Case("pad", "pad", {"X": [f32(149, 2, 3)]},
             {"paddings": [1, 0, 2, 1], "pad_value": 0.5}),
        Case("pad2d_reflect", "pad2d", {"X": [f32(150, 1, 2, 4, 5)]},
             {"paddings": [1, 2, 2, 1], "mode": "reflect"}),
        Case("pad2d_edge_nhwc", "pad2d", {"X": [f32(151, 1, 4, 5, 2)]},
             {"paddings": [2, 0, 1, 3], "mode": "edge",
              "data_format": "NHWC"}),
        Case("pad2d_constant", "pad2d", {"X": [f32(152, 1, 2, 3, 3)]},
             {"paddings": [1, 1, 0, 2], "pad_value": -1.0}),
        Case("pad3d_replicate", "pad3d", {"X": [f32(153, 1, 2, 3, 4, 5)]},
             {"paddings": [1, 0, 2, 1, 1, 1], "mode": "replicate"}),
        Case("pad3d_constant_ndhwc", "pad3d",
             {"X": [f32(154, 1, 3, 4, 5, 2)]},
             {"paddings": [0, 1, 1, 0, 2, 1], "value": 2.0,
              "data_format": "NDHWC"}),
        Case("where", "where",
             {"Condition": [_rs(155).rand(3, 4) > 0.5],
              "X": [f32(156, 3, 4)], "Y": [f32(157, 3, 4)]}, {}),
        Case("where_index", "where_index",
             {"Condition": [_rs(158).rand(3, 4, 2) > 0.6]}, {}, grad=False),
        Case("tril", "tril_triu", {"X": [f32(159, 4, 5)]},
             {"diagonal": 1, "lower": True}),
        Case("triu", "tril_triu", {"X": [f32(160, 2, 4, 5)]},
             {"diagonal": -1, "lower": False}),
        Case("meshgrid", "meshgrid", {"X": [f32(161, 3), f32(162, 4),
                                            f32(163, 2)]}, {}),
        Case("flip", "flip", {"X": [f32(164, 2, 3, 4)]}, {"axis": [0, 2]}),
        Case("flip_int_axis", "flip", {"X": [f32(165, 2, 3)]}, {"axis": 1}),
        Case("roll", "roll", {"X": [f32(166, 3, 4)]},
             {"shifts": [1, -2], "axis": [0, 1]}),
        Case("roll_flat", "roll", {"X": [f32(167, 3, 4)]}, {"shifts": [5]}),
        Case("coalesce_tensor", "coalesce_tensor",
             {"Input": [f32(168, 2, 3), f32(169, 4)]}, {}),
    ]


# ---------------------------------------------------------- linalg_ops.py
def _linalg_cases():
    return [
        Case("argsort", "argsort", {"X": [f32(170, 3, 5)]}, {"axis": -1}),
        Case("argsort_descending_axis0", "argsort", {"X": [f32(171, 4, 3)]},
             {"axis": 0, "descending": True}),
        Case("argsort_ties", "argsort",
             {"X": [np.array([[2.0, 1.0, 2.0, 1.0, 0.0]], np.float32)]},
             {"descending": True}, grad=False),
        # the reference's masked_select reads its mask on the host and
        # cannot run under jax.vjp: only values are held
        Case("masked_select", "masked_select",
             {"X": [f32(172, 3, 4)], "Mask": [_rs(173).rand(3, 4) > 0.4]}, {},
             grad=False),
        Case("index_sample", "index_sample",
             {"X": [f32(174, 3, 5)],
              "Index": [np.array([[4, 0], [1, 1], [2, 3]], np.int64)]}, {}),
        Case("multiplex", "multiplex",
             {"X": [f32(175, 4, 3), f32(176, 4, 3), f32(177, 4, 3)],
              "Ids": [np.array([[2], [0], [1], [2]], np.int32)]}, {}),
        Case("mv", "mv", {"X": [f32(178, 3, 4)], "Vec": [f32(179, 4)]}, {}),
        Case("kron", "kron", {"X": [f32(180, 2, 3)], "Y": [f32(181, 3, 2)]},
             {}),
        Case("kron_batched", "kron", {"X": [f32(182, 2, 2, 3)],
                                      "Y": [f32(183, 2, 3, 2)]}, {}),
        Case("cross", "cross", {"X": [f32(184, 4, 3)],
                                "Y": [f32(185, 4, 3)]}, {"dim": 1}),
        Case("cross_auto_dim", "cross", {"X": [f32(186, 3, 4)],
                                         "Y": [f32(187, 3, 4)]}, {}),
        Case("trace", "trace", {"Input": [f32(188, 4, 5)]}, {"offset": 1}),
        Case("trace_axes", "trace", {"Input": [f32(189, 2, 4, 4)]},
             {"offset": -1, "axis1": 1, "axis2": 2}),
        Case("unbind", "unbind", {"X": [f32(190, 3, 4)]}, {"axis": 1}),
        Case("cumprod", "cumprod", {"X": [uniform(191, 0.5, 1.5, 3, 4)]},
             {"dim": 1}),
        Case("shard_index", "shard_index",
             {"X": [np.array([[1], [6], [12], [19]], np.int64)]},
             {"index_num": 20, "nshards": 2, "shard_id": 1,
              "ignore_value": -1}, grad=False),
        Case("logsumexp", "logsumexp", {"X": [f32(192, 3, 4, 2)]},
             {"axis": [1], "keepdim": True}),
        Case("logsumexp_all", "logsumexp", {"X": [f32(193, 3, 4)]},
             {"reduce_all": True, "axis": []}),
        # LAPACK (torch) and XLA's own factorizations round differently;
        # on these matrices (condition number under 10) both stay within
        # 1e-5 of each other, and the inverse's gradient takes two more
        # products of the inverse
        Case("inverse", "inverse", {"Input": [_spd(194, 4, (2,))]}, {},
             tol=(1e-5, 1e-5), grad_tol=(1e-4, 1e-5)),
        Case("cholesky", "cholesky", {"X": [_spd(195, 4)]}, {},
             tol=(1e-5, 1e-5), grad_tol=(1e-4, 1e-5)),
        Case("cholesky_upper", "cholesky", {"X": [_spd(196, 3, (2,))]},
             {"upper": True}, tol=(1e-5, 1e-5), grad_tol=(1e-4, 1e-5)),
        Case("frobenius_norm", "frobenius_norm", {"X": [f32(197, 3, 4, 2)]},
             {"dim": [1, 2], "keep_dim": True}),
        Case("frobenius_norm_all", "frobenius_norm", X34,
             {"reduce_all": True}),
        Case("l1_norm", "l1_norm", {"X": [_away_from_zero(198, 3, 4)]}, {}),
        Case("norm", "norm", {"X": [f32(199, 3, 4)]}, {"axis": 1}),
        Case("partial_concat", "partial_concat",
             {"X": [f32(200, 3, 5), f32(201, 3, 5)]},
             {"start_index": 1, "length": 2}),
        Case("partial_sum", "partial_sum",
             {"X": [f32(202, 3, 5), f32(203, 3, 5)]},
             {"start_index": -3, "length": -1}),
        Case("fsp", "fsp", {"X": [f32(204, 2, 3, 4, 5)],
                            "Y": [f32(205, 2, 2, 4, 5)]}, {}),
        Case("unique_with_counts", "unique_with_counts",
             {"X": [np.array([3, 1, 3, 7, 1, 3], np.int64)]}, {},
             grad=False),
        Case("gather_tree", "gather_tree",
             {"Ids": [ints(206, 0, 9, 4, 2, 3)],
              "Parents": [ints(207, 0, 3, 4, 2, 3)]}, {}, grad=False),
    ]


# ------------------------------ parity_ops.py, loss_ops.py, long_tail_ops.py
def _other_cases():
    p = uniform(210, 0.0, 1.0, 200, 100)
    return [
        Case("allclose", "allclose",
             {"Input": [np.array([1.0, 2.0, np.nan], np.float32)],
              "Other": [np.array([1.0 + 1e-6, 2.0, np.nan], np.float32)]},
             {"rtol": 1e-5, "atol": 1e-8, "equal_nan": True}, grad=False),
        Case("allclose_false", "allclose",
             {"Input": [np.array([1.0, 2.0], np.float32)],
              "Other": [np.array([1.0, 2.1], np.float32)]}, {}, grad=False),
        Case("bernoulli", "bernoulli", {"X": [p]}, {"seed": 4},
             kind="random", grad=False,
             check=lambda a: set(np.unique(a)) <= {0.0, 1.0} and
             abs(float(np.mean(a)) - float(p.mean())) < 0.02),
        Case("diag_v2_vector", "diag_v2", {"X": [f32(211, 3)]},
             {"offset": 1, "padding_value": 0.5}),
        Case("diag_v2_matrix", "diag_v2", {"X": [f32(212, 4, 5)]},
             {"offset": -1}),
        Case("empty", "empty", {}, {"shape": [2, 3], "dtype": "float32"},
             kind="shape", grad=False),
        Case("eye", "eye", {}, {"num_rows": 3, "num_columns": 5,
                                "dtype": "float32"}, grad=False),
        Case("eye_square_int", "eye", {}, {"num_rows": 4, "dtype": "int32"},
             grad=False),
        Case("histogram", "histogram", {"X": [f32(213, 50)]},
             {"bins": 7, "min": -1.0, "max": 1.5}, grad=False),
        Case("histogram_data_range", "histogram", {"X": [f32(214, 4, 30)]},
             {"bins": 5}, grad=False),
        Case("isinf", "isinf",
             {"X": [np.array([1.0, -np.inf, 0.0], np.float32)]}, {},
             grad=False),
        Case("isnan", "isnan",
             {"X": [np.array([1.0, 2.0, 0.0], np.float32)]}, {}, grad=False),
        Case("randperm", "randperm", {}, {"n": 50, "seed": 6},
             kind="random", grad=False, check=_perm_check(50)),
        Case("dist", "dist", {"X": [f32(215, 3, 4)], "Y": [f32(216, 4)]},
             {"p": 2.0}),
        Case("dist_p3", "dist", {"X": [f32(217, 3, 4)],
                                 "Y": [f32(218, 3, 4)]}, {"p": 3.0}),
        Case("dist_inf", "dist", {"X": [f32(219, 3, 4)],
                                  "Y": [f32(220, 3, 4)]},
             {"p": math.inf}),
        Case("dist_zero", "dist", {"X": [f32(221, 3, 4)],
                                   "Y": [f32(222, 3, 4)]}, {"p": 0.0},
             grad=False),
        Case("unique", "unique",
             {"X": [np.array([[3, 1, 3], [7, 1, 2]], np.int64)]}, {},
             grad=False),
        Case("unique_float", "unique",
             {"X": [np.array([0.5, -1.0, 0.5, 2.0, -1.0], np.float32)]}, {},
             grad=False),
    ]


CASES: List[Case] = (_math_cases() + _tensor_cases() + _linalg_cases()
                     + _other_cases())
