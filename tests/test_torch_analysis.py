"""The port's static analyzer (paddle_tpu_torch.analysis) against the
JAX package's on the same programs.

Each program is built by one builder from either package's ``Program``
(the IR is shared), analyzed by both ``analyze_program``s, and the two
diagnostic lists must agree code for code, with severity, op, op type
and var: PTA001-004 (dataflow), PTA101-104 (shapes and dtypes, where
the port runs each op on ``meta`` tensors and the reference runs
``jax.eval_shape``), PTA201-205 (collective schedules) and PTA301-303
(recompile hazards). The clean programs the serving slice admits (the
book's fit_a_line, a tiny static ResNet, the attn program) give the
same list in both: nothing but the PTA301 note of a -1 feed dim.
"""
import types

import numpy as np
import pytest

import paddle_tpu as jpt
import paddle_tpu.static as jstatic
from paddle_tpu import analysis as janalysis
from paddle_tpu import io as jio
from paddle_tpu.nn import ParamAttr as JaxParamAttr
from paddle_tpu.nn.initializer import Uniform as JaxUniform
from paddle_tpu.optimizer import Momentum as JaxMomentum

import chip_smoke
import paddle_tpu_torch as tpt
from paddle_tpu_torch import analysis as tanalysis
from paddle_tpu_torch.analysis import collective_check as tcollective

JAX_API = types.SimpleNamespace(pt=jpt, static=jstatic, io=jio,
                                ParamAttr=JaxParamAttr, Uniform=JaxUniform,
                                Momentum=JaxMomentum)
PORT_API = chip_smoke.port_static_api()
MISS_STORM = {"executor/compile_cache_miss": 50,
              "executor/compile_cache_hit": 1}


@pytest.fixture(autouse=True)
def _cpu():
    tpt.set_device("cpu")


def _key(d):
    return (d.code, d.severity, d.block_idx, d.op_idx, d.op_type, d.var)


def _var(blk, name, shape, dtype="float32", **kw):
    blk.create_var(name, shape=shape, dtype=dtype, **kw)


def _use_before_def(pt):
    p = pt.Program()
    blk = p.global_block()
    _var(blk, "x", [4], is_data=True)
    _var(blk, "late", [4])
    _var(blk, "never", [4])
    blk.append_op("relu", {"X": ["late"]}, {"Out": ["r1"]}, {})
    blk.append_op("scale", {"X": ["x"]}, {"Out": ["late"]}, {"scale": 2.0})
    blk.append_op("relu", {"X": ["never"]}, {"Out": ["r2"]}, {})
    return p


def _dangling(pt):
    p = pt.Program()
    blk = p.global_block()
    _var(blk, "x", [4], is_data=True)
    blk.append_op("elementwise_add", {"X": ["x"], "Y": ["typo_var"]},
                  {"Out": ["o"]}, {})
    return p


def _dead_code(pt):
    p = pt.Program()
    blk = p.global_block()
    _var(blk, "x", [2, 4], is_data=True)
    blk.append_op("relu", {"X": ["x"]}, {"Out": ["live"]}, {})
    blk.append_op("tanh", {"X": ["x"]}, {"Out": ["dead"]}, {})
    blk.append_op("top_k", {"X": ["live"]},
                  {"Out": ["out"], "Indices": ["idx"]}, {"k": 2})
    return p


def _dtype_mismatch(pt):
    p = pt.Program()
    blk = p.global_block()
    _var(blk, "f", [4], "float32", is_data=True)
    _var(blk, "i", [4], "int64", is_data=True)
    blk.append_op("elementwise_add", {"X": ["f"], "Y": ["i"]},
                  {"Out": ["o"]}, {})
    return p


def _integer_slot(pt):
    p = pt.Program()
    blk = p.global_block()
    _var(blk, "ids", [4, 1], "float32", is_data=True)   # must be int
    _var(blk, "w", [10, 3], "float32", persistable=True)
    blk.append_op("lookup_table_v2", {"Ids": ["ids"], "W": ["w"]},
                  {"Out": ["emb"]}, {})
    return p


def _matmul_contract(pt):
    p = pt.Program()
    blk = p.global_block()
    _var(blk, "x", [4, 3], is_data=True)
    _var(blk, "w", [5, 2], persistable=True)    # 3 vs 5: cannot contract
    blk.append_op("matmul_v2", {"X": ["x"], "Y": ["w"]}, {"Out": ["o"]}, {})
    return p


def _mul_contract(pt):
    p = pt.Program()
    blk = p.global_block()
    _var(blk, "x", [2, 3, 4], is_data=True)
    _var(blk, "w", [11, 5], persistable=True)   # prod(3,4)=12 != 11
    blk.append_op("mul", {"X": ["x"], "Y": ["w"]}, {"Out": ["o"]},
                  {"x_num_col_dims": 1, "y_num_col_dims": 1})
    return p


def _no_broadcast(pt):
    p = pt.Program()
    blk = p.global_block()
    _var(blk, "x", [4, 3], is_data=True)
    _var(blk, "y", [5], persistable=True)
    blk.append_op("elementwise_mul", {"X": ["x"], "Y": ["y"]},
                  {"Out": ["o"]}, {})
    return p


def _unknown_op(pt):
    p = pt.Program()
    blk = p.global_block()
    _var(blk, "x", [4], is_data=True)
    blk.append_op("frobnicate", {"X": ["x"]}, {"Out": ["y"]}, {})
    blk.append_op("relu", {"X": ["y"]}, {"Out": ["z"]}, {})
    blk.append_op("relu_grad", {"X": ["x"]}, {"X@GRAD": ["gx"]}, {})
    return p


def _declared_clash(pt):
    p = pt.Program()
    blk = p.global_block()
    _var(blk, "x", [4], "float32", is_data=True)
    _var(blk, "y", [4], "int32")                # ops produce float32
    blk.append_op("relu", {"X": ["x"]}, {"Out": ["y"]}, {})
    _var(blk, "r", [4, 1], "float32")           # rank clash
    blk.append_op("relu", {"X": ["x"]}, {"Out": ["r"]}, {})
    return p


def _mismatch_in_sub_block(pt):
    p = pt.Program()
    blk = p.global_block()
    _var(blk, "f", [4], "float32", is_data=True)
    _var(blk, "i", [4], "int64", is_data=True)
    sub = p.append_block(blk)
    sub.create_var("o", shape=[4], dtype="float32")
    sub.ops.append(pt.Program().global_block().append_op(
        "elementwise_add", {"X": ["f"], "Y": ["i"]}, {"Out": ["o"]}, {}))
    blk.append_op("while_loop_stub", {"X": ["f", "i"]}, {"Out": ["r"]},
                  {"sub_block": sub.idx})
    return p


def _collective_in_sub_block(pt):
    p = pt.Program()
    blk = p.global_block()
    _var(blk, "x", [8], is_data=True)
    sub = p.append_block(blk)
    sub.create_var("inner", shape=[8], dtype="float32")
    sub.ops.append(pt.Program().global_block().append_op(
        "c_allreduce_sum", {"X": ["x"]}, {"Out": ["inner"]}, {"ring_id": 0}))
    blk.append_op("some_cf_op", {"X": ["x"]}, {"Out": ["y"]},
                  {"sub_block": sub.idx})
    return p


def _dynamic_feed(pt, static):
    p = pt.Program()
    with static.program_guard(p, pt.Program()):
        x = static.data("x", [-1, 8], "float32")
        static.nn.fc(x, size=2)
    return p


def _churn_prone(pt):
    p = pt.Program()
    blk = p.global_block()
    _var(blk, "x", [4], is_data=True)
    blk.append_op("scale", {"X": ["x"]}, {"Out": ["y"]}, {"scale": 0.1})
    blk.append_op("fill_constant", {}, {"Out": ["c"]},
                  {"shape": [1], "value": 0.5, "dtype": "float32"})
    return p


# (builder, analyze_program keywords, the codes it must report)
CASES = {
    "PTA001": (_use_before_def, dict(checks=("dataflow",)), {"PTA001"}),
    "PTA002": (_dangling, dict(checks=("dataflow",)), {"PTA002"}),
    "PTA002_scope_read": (_dangling, dict(checks=("dataflow",),
                                          scope_names=["typo_var"]), set()),
    "PTA003_PTA004": (_dead_code, dict(checks=("dataflow",),
                                       fetch_names=["out"]),
                      {"PTA003", "PTA004"}),
    "PTA101_elementwise": (_dtype_mismatch, dict(checks=("shapes",)),
                           {"PTA101"}),
    "PTA101_integer_slot": (_integer_slot, dict(checks=("shapes",)),
                            {"PTA101"}),
    "PTA101_sub_block": (_mismatch_in_sub_block, dict(checks=("shapes",)),
                         {"PTA101", "PTA103"}),
    "PTA102_matmul": (_matmul_contract, dict(checks=("shapes",)),
                      {"PTA102"}),
    "PTA102_mul": (_mul_contract, dict(checks=("shapes",)), {"PTA102"}),
    "PTA102_broadcast": (_no_broadcast, dict(checks=("shapes",)),
                         {"PTA102"}),
    "PTA103": (_unknown_op, dict(checks=("shapes",)), {"PTA103"}),
    "PTA104": (_declared_clash, dict(checks=("shapes",)), {"PTA104"}),
    "PTA205": (_collective_in_sub_block, dict(checks=("collectives",)),
               {"PTA205"}),
    "PTA302_PTA303": (_churn_prone, dict(checks=("recompile",),
                                         metrics_snapshot=MISS_STORM),
                      {"PTA302", "PTA303"}),
    "PTA302_no_evidence": (_churn_prone, dict(checks=("recompile",)),
                           set()),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_same_diagnostics_as_the_jax_analyzer(case):
    build, kw, expect = CASES[case]
    want = janalysis.analyze_program(build(jpt), **kw)
    got = tanalysis.analyze_program(build(tpt), **kw)
    assert {d.code for d in got} == expect
    assert sorted(map(_key, got)) == sorted(map(_key, want))


@pytest.mark.parametrize("snapshot", [None, MISS_STORM])
def test_dynamic_feed_pta301_in_both(snapshot):
    kw = dict(checks=("recompile",), metrics_snapshot=snapshot)
    want = janalysis.analyze_program(_dynamic_feed(jpt, jstatic), **kw)
    got = tanalysis.analyze_program(_dynamic_feed(tpt, PORT_API.static),
                                    **kw)
    assert [d.code for d in got] == ["PTA301"] + (
        ["PTA303"] if snapshot else [])
    assert got[0].severity == ("warning" if snapshot else "info")
    assert list(map(_key, got)) == list(map(_key, want))


def test_pta301_suggestion_from_observed_signatures():
    """Observed feed signatures make PTA301 carry the same concrete
    pow2-rounded buckets=[...] declaration in both packages."""
    seen = [{"x": ((3, 8), "float32")}, {"x": ((9, 8), "float32")}]
    want = janalysis.analyze_program(_dynamic_feed(jpt, jstatic),
                                     checks=("recompile",),
                                     observed_signatures=seen)
    got = tanalysis.analyze_program(_dynamic_feed(tpt, PORT_API.static),
                                    checks=("recompile",),
                                    observed_signatures=seen)
    assert [d.message for d in got] == [d.message for d in want]
    assert "buckets=[{'x': (4, 8)}, {'x': (16, 8)}]" in got[0].message


@pytest.mark.parametrize("mutation,expect", [
    (dict(order=["c_broadcast", "c_allreduce_sum"]), "PTA201"),
    (dict(order=["c_allreduce_sum", "c_broadcast"], ring=3), "PTA202"),
    (dict(order=["c_allreduce_sum", "c_broadcast"],
          dtype="bfloat16"), "PTA203"),
    (dict(order=["c_allreduce_sum"]), "PTA204"),
])
def test_collective_schedules_across_programs(mutation, expect):
    def prog(pt, order, ring=0, dtype="float32"):
        p = pt.Program()
        blk = p.global_block()
        _var(blk, "g", [8], dtype, is_data=True)
        cur = "g"
        for i, t in enumerate(order):
            _var(blk, f"o{i}", [8], dtype)
            blk.append_op(t, {"X": [cur]}, {"Out": [f"o{i}"]},
                          {"ring_id": ring})
            cur = f"o{i}"
        return p

    ref = dict(order=["c_allreduce_sum", "c_broadcast"])
    want = janalysis.check_collective_consistency(
        [("rank0", prog(jpt, **ref)), ("rank1", prog(jpt, **mutation))])
    got = tcollective.check_collective_consistency(
        [("rank0", prog(tpt, **ref)), ("rank1", prog(tpt, **mutation))])
    assert expect in {d.code for d in got}
    assert [(d.code, d.message) for d in got] == \
        [(d.code, d.message) for d in want]


def _book(api):
    return chip_smoke.book_program(api, "fit_a_line")[0]


def _tiny_resnet(api):
    return chip_smoke.static_resnet(api, -1, 32, 10, depth=(1, 1, 1, 1),
                                    num_filters=(8, 16, 32, 64),
                                    train=False)[0]


def _attn(api):
    return chip_smoke.attn_program(api, 64, 2, 16)[0]


@pytest.mark.parametrize("build", [_book, _tiny_resnet, _attn],
                         ids=["fit_a_line", "tiny_resnet", "attn"])
def test_clean_programs_give_the_same_list(build):
    want = janalysis.analyze_program(build(JAX_API))
    got = tanalysis.analyze_program(build(PORT_API))
    assert {d.code for d in got} <= {"PTA301"}
    assert not tanalysis.errors(got)
    assert sorted(map(_key, got)) == sorted(map(_key, want))


def test_shape_propagation_matches_the_jax_engine():
    """The meta-tensor propagation infers the same shapes and dtypes as
    the reference's jax.eval_shape over the tiny static ResNet."""
    _, want = janalysis.propagate(_tiny_resnet(JAX_API))
    _, got = tanalysis.propagate(_tiny_resnet(PORT_API))
    assert set(got) == set(want)
    for name, meta in got.items():
        ref = want[name]
        assert meta.shape == ref.shape, name
        if ref.dtype is None:
            assert meta.dtype is None, name
        else:
            assert str(meta.dtype).replace("torch.", "") == \
                np.dtype(ref.dtype).name, name


def test_diagnostic_registry_is_the_jax_packages():
    assert tanalysis.CODES == janalysis.CODES
