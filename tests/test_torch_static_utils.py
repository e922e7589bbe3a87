"""``static.nest_utils``, ``static.analysis`` and ``static.contrib_layers``
in the port against the JAX package, on the CPU.

- ``nest_utils`` (plain Python in the port, ``jax.tree_util`` in the JAX
  package): the same results, types included, on nested lists, tuples,
  dicts (sorted keys), OrderedDicts, namedtuples and ``None`` (an empty
  subtree), and the same errors;
- ``analysis``: ``memory_usage``, ``op_freq_statistic`` and ``summary``
  of one Program JSON loaded by each package, equal (exact: the same
  integer arithmetic);
- ``contrib_layers``: each builder whose op type the port registers
  (``paddle_tpu_torch/testing/decoder_cases.CONTRIB``) writes the JAX
  builder's program JSON, and both executors run it from the same
  startup values: values within rtol 1e-5 / atol 1e-6 (integers equal);
  the random builders (``shuffle_batch``, ``tdm_sampler``) by what their
  seeds do not decide (a permutation of the rows; the shapes, positive
  column and labels). ``_pull_box_extended_sparse`` builds the same op
  and fails to run naming ROADMAP item 8; ``search_pyramid_hash`` raises
  in both packages.
"""
import collections
import types

import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu.static as jstatic
from paddle_tpu.core.enforce import InvalidArgumentError as JaxInvalidArg
from paddle_tpu.nn import ParamAttr as JaxParamAttr
from paddle_tpu.optimizer import Adagrad as JaxAdagrad
from paddle_tpu.static import analysis as janalysis
from paddle_tpu.static import contrib_layers as jcontrib
from paddle_tpu.static import decoder as jdecoder
from paddle_tpu.static import nest_utils as jnest

import paddle_tpu_torch as tpt
from paddle_tpu_torch.core.enforce import InvalidArgumentError, NotFoundError
from paddle_tpu_torch.static import analysis, nest_utils
from paddle_tpu_torch.testing import decoder_cases as dc
from test_torch_static_decoders import build_both, run_both

JAX_API = types.SimpleNamespace(pt=jpt, static=jstatic, decoder=jdecoder,
                                contrib_layers=jcontrib,
                                ParamAttr=JaxParamAttr, Adagrad=JaxAdagrad)
PORT_API = dc.port_api()
TOL = dict(rtol=1e-5, atol=1e-6)

Pair = collections.namedtuple("Pair", ["left", "right"])


@pytest.fixture(autouse=True)
def _cpu():
    tpt.set_device("cpu")


# ------------------------------------------------------------ nest_utils
NESTS = {
    "list_tuple_dict": [1, (2, {"b": 3, "a": None}), [4, [5]]],
    "dict_keys_sorted": {"z": [1, 2], "a": (3,), "m": {"y": 4, "x": 5}},
    "none_is_empty": (None, [None, 7], {"k": None}),
    "ordered_dict": collections.OrderedDict([("z", 1), ("a", [2, 3])]),
    "namedtuple": Pair(left=[1, 2], right=Pair(left=3, right=None)),
    "leaves": ["ab", np.arange(3), 4.5, ()],
    "single_leaf": 3,
}


def _same(got, want):
    """Equal values of equal types, all the way down."""
    assert type(got) is type(want), (got, want)
    if isinstance(got, dict):
        assert list(got) == list(want)
        for k in got:
            _same(got[k], want[k])
    elif isinstance(got, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
    elif isinstance(got, np.ndarray):
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want


@pytest.mark.parametrize("name", list(NESTS))
def test_nest_utils_match_jax_tree_semantics(name):
    """flatten, pack_sequence_as, map_structure (one and two
    structures), assert_same_structure and is_sequence."""
    nest = NESTS[name]
    flat = nest_utils.flatten(nest)
    _same(flat, jnest.flatten(nest))
    vals = [f"v{i}" for i in range(len(flat))]
    _same(nest_utils.pack_sequence_as(nest, vals),
          jnest.pack_sequence_as(nest, vals))

    def f(*a):
        return tuple(str(x) for x in a)

    _same(nest_utils.map_structure(f, nest), jnest.map_structure(f, nest))
    _same(nest_utils.map_structure(f, nest, nest),
          jnest.map_structure(f, nest, nest))
    nest_utils.assert_same_structure(nest, nest)
    assert nest_utils.is_sequence(nest) == jnest.is_sequence(nest)


def test_nest_utils_prefix_and_errors_match_jax():
    """map_structure over a second structure with the first as a prefix;
    a leaf-count mismatch, a structure mismatch and a prefix mismatch
    raise in both packages."""
    def f(a, b):
        return (a, b)

    first, second = [1, {"k": 2}], [[3], {"k": (4, None)}]
    _same(nest_utils.map_structure(f, first, second),
          jnest.map_structure(f, first, second))
    with pytest.raises(InvalidArgumentError):
        nest_utils.pack_sequence_as([1, (2, 3)], [1, 2])
    with pytest.raises(JaxInvalidArg):
        jnest.pack_sequence_as([1, (2, 3)], [1, 2])
    for a, b in (([1, 2], (1, 2)), ({"a": 1}, {"b": 1}), ([None], [1])):
        with pytest.raises(InvalidArgumentError):
            nest_utils.assert_same_structure(a, b)
        with pytest.raises(JaxInvalidArg):
            jnest.assert_same_structure(a, b)
    with pytest.raises(ValueError):
        nest_utils.map_structure(f, [1, [2]], [1, 2])
    with pytest.raises(ValueError):
        jnest.map_structure(f, [1, [2]], [1, 2])
    with pytest.raises(InvalidArgumentError):
        nest_utils.map_structure(f)


# -------------------------------------------------------------- analysis
def _analysis_program(api):
    """conv2d + relu, pool2d, batch_norm, fc (mul), layer_norm, softmax,
    and a matmul of two data inputs, on a -1 batch."""
    st, nn = api.static, api.static.nn
    main, startup = api.pt.Program(), api.pt.Program()
    with st.program_guard(main, startup):
        img = st.data("img", [-1, 1, 16, 16], "float32")
        c = nn.conv2d(img, num_filters=8, filter_size=3, padding=1,
                      act="relu")
        p = nn.pool2d(c, pool_size=2, pool_stride=2)
        b = nn.batch_norm(p)
        h = nn.layer_norm(nn.fc(b, size=32))
        nn.softmax(h)
        q = st.data("q", [-1, 6, 16], "float32")
        k = st.data("k", [-1, 16, 6], "float32")
        nn.matmul(q, k)
    return main


def test_analysis_matches_jax_on_one_program():
    text = _analysis_program(PORT_API).to_json()
    port_prog = tpt.Program.from_json(text)
    jax_prog = jpt.Program.from_json(text)
    for batch in (1, 8):
        assert analysis.memory_usage(port_prog, batch) == \
            janalysis.memory_usage(jax_prog, batch)
        assert analysis.summary(port_prog, batch) == \
            janalysis.summary(jax_prog, batch)
    assert analysis.op_freq_statistic(port_prog) == \
        janalysis.op_freq_statistic(jax_prog)
    with pytest.raises(InvalidArgumentError):
        analysis.memory_usage(port_prog, 0)


def test_memory_usage_sizes_torch_dtypes():
    """A port VarDesc holds a torch dtype: bf16 counts 2 bytes, int64 8."""
    prog = tpt.Program()
    blk = prog.global_block()
    blk.create_var("a", shape=(4, 4), dtype=torch.bfloat16)
    blk.create_var("b", shape=(-1, 4), dtype=torch.int64)
    blk.append_op("assign", {"X": ["a"]}, {"Out": ["a"]}, {})
    blk.append_op("assign", {"X": ["b"]}, {"Out": ["b"]}, {})
    lo, hi, unit = analysis.memory_usage(prog, 2)
    assert unit == "B" and lo == pytest.approx((32 + 64) * 1.05)


# -------------------------------------------------------- contrib_layers
def _check(name, jruns, pruns):
    case = dc.CONTRIB[name]
    feed = case["feed"]
    for jr, pr in zip(jruns, pruns):
        for (j, _), (p, _) in zip(jr, pr):
            assert p.shape == j.shape and p.dtype == j.dtype, (p, j)
            if case["check"] == "value":
                if np.issubdtype(p.dtype, np.floating):
                    np.testing.assert_allclose(p, j, **TOL)
                else:
                    np.testing.assert_array_equal(p, j)
        if case["check"] == "rows":
            for out in (jr[0][0], pr[0][0]):
                assert sorted(map(tuple, out)) == sorted(map(tuple,
                                                             feed["x"]))
        elif case["check"] == "tdm":
            for r in (jr, pr):
                np.testing.assert_array_equal(r[0][0][:, 0], [1, 2, 2])
                np.testing.assert_array_equal(r[1][0][:, 0], [3, 5, 6])
                assert r[2][0][:, 0].tolist() == [1, 1, 1]


def _jax_correlation_program(api, name):
    """The JAX package's correlation builder names the op's output slot
    "Out"; its op (and the reference's, correlation_op.cc) writes
    "Output", so the JAX program cannot run. The port's builder writes
    "Output"; the JAX program is renamed to it here before the two are
    compared."""
    main, startup, fetch = dc.contrib_program(api, name)
    if api.pt is jpt:
        blk = main.global_block()
        for op in blk.ops:
            if op.type == "correlation":
                op.outputs = {"Output": op.outputs.pop("Out")}
                # the shape the op gives: (2 * max_displacement / stride2
                # + 1)^2 = 9 channels over the 5 x 5 map
                out = blk.var(op.outputs["Output"][0])
                out.shape, out.dtype = (1, 9, 5, 5), np.dtype("float32")
        main._invalidate_fingerprint()
    return main, startup, fetch


@pytest.mark.parametrize("name", list(dc.CONTRIB))
def test_contrib_builder_matches_jax(name):
    case = dc.CONTRIB[name]
    builder = (_jax_correlation_program if name == "correlation"
               else dc.contrib_program)
    jprogs, pprogs = build_both(builder, name)
    pprogs = pprogs + (case["feed"],)
    jprogs = jprogs + (case["feed"],)
    values = dc.startup_values(pprogs[1])
    values.update(case["params"])
    jruns = dc.run_program(JAX_API, jpt.Executor(),
                           lambda v, lod: jpt.TpuTensor(v, lod), jprogs[0],
                           values, case["feed"], jprogs[2], case["runs"])
    pruns = dc.run_program(PORT_API, tpt.Executor("cpu"),
                           lambda v, lod: tpt.TpuTensor(v, lod,
                                                        device="cpu"),
                           pprogs[0], values, case["feed"], pprogs[2],
                           case["runs"])
    _check(name, jruns, pruns)
    if name == "ctr_metric_bundle":     # running totals: the second run
        np.testing.assert_allclose([float(v.reshape(-1)[0])
                                    for v, _ in pruns[1]],
                                   [0.16, 0.8, 2.0, 2.0], atol=1e-5)


def _pull_box(api):
    main = api.pt.Program()
    with api.static.program_guard(main, api.pt.Program()):
        ids = api.static.data("ids", [-1, 1], "int64")
        out, ext = api.contrib_layers._pull_box_extended_sparse(
            ids, size=4, extend_size=2)
    return main, out.name


def test_pull_box_extended_sparse_builds_and_names_its_item(monkeypatch):
    """The BoxPS builder writes the JAX builder's op (the JAX package
    builds it only with a table registered under 'boxps'; its shape
    inference then stops at the host-side op, as the port's does at the
    unregistered type); its type comes with ROADMAP item 8, so running
    it raises NotFoundError naming the item."""
    from paddle_tpu.ops import ps_ops as jps
    monkeypatch.setitem(jps.sparse_table_registry(), "boxps", object())
    jmain, _ = _pull_box(JAX_API)
    pmain, out = _pull_box(PORT_API)
    assert pmain.to_json() == jmain.to_json()
    with pytest.raises(NotFoundError, match="item 8"):
        tpt.Executor("cpu").run(pmain, feed={"ids": np.array(
            [[1], [2]], np.int64)}, fetch_list=[out], scope=tpt.Scope())


def test_search_pyramid_hash_raises_in_both():
    with pytest.raises(NotImplementedError):
        PORT_API.contrib_layers.search_pyramid_hash()
    with pytest.raises(NotImplementedError):
        jcontrib.search_pyramid_hash()
