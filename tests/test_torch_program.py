"""The port's Program IR against the JAX package's.

The JSON IR is a format the two packages share. For each of the six
book programs of tests/test_book.py and the tiny static ResNet, the JAX
package's ``to_json()`` loads in the port and writes back byte for
byte, and the port's builders, run on the same builder code
(``chip_smoke.book_program`` / ``static_resnet`` take either package),
give the same JSON: the same ops, slots, attrs, var names, VarDesc
shapes and dtypes, before and after ``append_backward`` (and, for the
ResNet, ``Momentum.minimize``), and the same startup program. A chain
of other builders whose ops the port has (the "zoo") infers the same
VarDescs on ``meta`` tensors as ``jax.eval_shape`` does and runs the
same forward in both executors; the flash op's shape rule launches no
kernel. Then the Program contracts of tests/test_static.py, re-stated
on the port.
"""
import json
import types

import numpy as np
import pytest

import paddle_tpu as jpt
import paddle_tpu.static as jstatic
from paddle_tpu import io as jio
from paddle_tpu.nn import ParamAttr as JaxParamAttr
from paddle_tpu.nn.initializer import Uniform as JaxUniform
from paddle_tpu.optimizer import Momentum as JaxMomentum

import chip_smoke
import paddle_tpu_torch as tpt
from paddle_tpu_torch.core.program import Program

JAX_API = types.SimpleNamespace(pt=jpt, static=jstatic, io=jio,
                                ParamAttr=JaxParamAttr, Uniform=JaxUniform,
                                Momentum=JaxMomentum)
# the tiny static ResNet: every kind of block at narrow widths
TINY_RESNET = dict(batch=4, px=64, class_dim=10, depth=(1, 1, 1, 1),
                   num_filters=(8, 16, 32, 64), lr=1e-2)


@pytest.fixture(autouse=True)
def _cpu():
    tpt.set_device("cpu")


def _programs(api, which, backward):
    if which == "resnet_tiny":
        return chip_smoke.static_resnet(api, train=backward, **TINY_RESNET)
    return chip_smoke.book_program(api, which, backward=backward)


def _first_difference(a, b):
    """A readable first difference of two program JSONs."""
    da, db = json.loads(a), json.loads(b)
    for ba, bb in zip(da["blocks"], db["blocks"]):
        for i, (oa, ob) in enumerate(zip(ba["ops"], bb["ops"])):
            if oa != ob:
                return f"op {i}: {oa} != {ob}"
        if len(ba["ops"]) != len(bb["ops"]):
            return f"{len(ba['ops'])} ops != {len(bb['ops'])}"
        for n in sorted(set(ba["vars"]) | set(bb["vars"])):
            if ba["vars"].get(n) != bb["vars"].get(n):
                return f"var {n}: {ba['vars'].get(n)} != {bb['vars'].get(n)}"
    return "blocks differ"


PROGRAMS = list(chip_smoke.BOOK) + ["resnet_tiny"]


@pytest.mark.parametrize("backward", [False, True],
                         ids=["forward", "backward"])
@pytest.mark.parametrize("which", PROGRAMS)
def test_builders_write_the_jax_json(which, backward):
    jmain, jstart, jfetch = _programs(JAX_API, which, backward)
    pmain, pstart, pfetch = _programs(chip_smoke.port_static_api(), which,
                                      backward)
    assert pfetch == jfetch
    for jprog, pprog in ((jmain, pmain), (jstart, pstart)):
        want, got = jprog.to_json(), pprog.to_json()
        assert got == want, _first_difference(got, want)
    if backward:
        types_ = pmain.op_types()
        assert "fill_constant" in types_ and any(
            t.endswith("_grad") for t in types_)


@pytest.mark.parametrize("which", PROGRAMS)
def test_jax_json_round_trips_through_the_port(which):
    jmain, jstart, _ = _programs(JAX_API, which, True)
    for prog in (jmain, jstart):
        text = prog.to_json()
        loaded = Program.from_json(text)
        assert loaded.to_json() == text
        assert loaded.fingerprint() == prog.fingerprint()


def _linreg_program():
    """tests/test_static.py's hand-built linear regression."""
    prog = tpt.Program()
    blk = prog.global_block()
    blk.create_var("x", shape=(8, 3), is_data=True)
    blk.create_var("w", shape=(3, 1), persistable=True)
    blk.create_var("b", shape=(1,), persistable=True)
    blk.create_var("label", shape=(8, 1), is_data=True, stop_gradient=True)
    blk.append_op("mul", {"X": ["x"], "Y": ["w"]}, {"Out": ["xw"]},
                  {"x_num_col_dims": 1, "y_num_col_dims": 1})
    blk.create_var("xw")
    blk.append_op("elementwise_add", {"X": ["xw"], "Y": ["b"]},
                  {"Out": ["pred"]}, {})
    blk.create_var("pred")
    blk.append_op("elementwise_sub", {"X": ["pred"], "Y": ["label"]},
                  {"Out": ["diff"]}, {})
    blk.create_var("diff")
    blk.append_op("square", {"X": ["diff"]}, {"Out": ["sq"]}, {})
    blk.create_var("sq")
    blk.append_op("mean", {"X": ["sq"]}, {"Out": ["loss"]}, {})
    blk.create_var("loss", shape=())
    return prog


def test_grad_op_structure():
    """tests/test_static.py:63: grad ops in reverse order, fluid naming,
    and the OpDesc attrs the JAX package writes."""
    prog = _linreg_program()
    pgs = tpt.append_backward("loss", parameter_list=["w", "b"],
                              program=prog)
    assert pgs == [("w", "w@GRAD"), ("b", "b@GRAD")]
    types_ = prog.op_types()
    assert types_.index("fill_constant") > types_.index("mean")
    assert types_.index("mean_grad") > types_.index("fill_constant")
    assert types_.index("mul_grad") > types_.index("elementwise_add_grad")
    mul_grad = prog.global_block().ops[types_.index("mul_grad")]
    assert mul_grad.attrs["__fwd_type__"] == "mul"
    assert mul_grad.attrs["__fwd_input_slots__"] == ["X", "Y"]
    assert mul_grad.attrs["__fwd_output_slots__"] == ["Out"]
    assert mul_grad.outputs["Y@GRAD"] == ["w@GRAD"]


def test_shared_input_gets_a_sum_op():
    """tests/test_static.py:76: a var read twice has its gradients
    summed by a ``sum`` op, then rebased onto ``x@GRAD``."""
    prog = tpt.Program()
    blk = prog.global_block()
    blk.create_var("x", shape=(3,), persistable=True)
    blk.append_op("elementwise_mul", {"X": ["x"], "Y": ["x"]},
                  {"Out": ["sq"]}, {})
    blk.create_var("sq")
    blk.append_op("mean", {"X": ["sq"]}, {"Out": ["loss"]}, {})
    blk.create_var("loss", shape=())
    tpt.append_backward("loss", parameter_list=["x"], program=prog)
    assert "sum" in prog.op_types() and prog.op_types()[-1] == "assign"


def test_append_backward_refuses_a_non_scalar_loss():
    prog = tpt.Program()
    blk = prog.global_block()
    blk.create_var("x", shape=(3,), persistable=True)
    blk.append_op("square", {"X": ["x"]}, {"Out": ["y"]}, {})
    blk.create_var("y", shape=(3,))
    with pytest.raises(tpt.core.enforce.InvalidArgumentError,
                       match="must be a scalar"):
        tpt.append_backward("y", program=prog)


def test_gradients_names_the_input_grads():
    prog = _linreg_program()
    with tpt.program_guard(prog):
        names = tpt.gradients(["loss"], ["w", "x"])
    assert names == ["w@GRAD", "x@GRAD"]
    assert "mul_grad" in prog.op_types()


def test_program_serialization_roundtrip():
    """tests/test_static.py:117."""
    prog = _linreg_program()
    tpt.append_backward("loss", program=prog)
    clone = Program.from_json(prog.to_json())
    assert clone.fingerprint() == prog.fingerprint()
    assert clone.op_types() == prog.op_types()


def test_clone_for_test_sets_is_test():
    """tests/test_static.py:125."""
    prog = tpt.Program()
    blk = prog.global_block()
    blk.create_var("x", is_data=True)
    blk.append_op("dropout", {"X": ["x"]}, {"Out": ["o"], "Mask": ["m"]},
                  {"dropout_prob": 0.5})
    test_prog = prog.clone(for_test=True)
    assert test_prog.global_block().ops[0].attrs["is_test"] is True
    assert "is_test" not in prog.global_block().ops[0].attrs


def test_prune_keeps_what_the_target_needs():
    prog = _linreg_program()
    pruned = prog.prune(["pred"])
    assert pruned.op_types() == ["mul", "elementwise_add"]
    assert prog.op_types()[-1] == "mean"


def test_fingerprint_follows_structural_changes():
    prog = _linreg_program()
    before = prog.fingerprint()
    prog.global_block().append_op("relu", {"X": ["pred"]},
                                  {"Out": ["r"]}, {})
    assert prog.fingerprint() != before


def test_vardesc_dtypes_are_torch_and_write_numpy_names():
    """A VarDesc holds a torch dtype and writes the name the JAX package
    writes for its numpy dtype; a dtype attr writes {"__dtype__": name}
    and reads back a torch dtype."""
    import torch
    prog = tpt.Program()
    v = prog.global_block().create_var("ids", shape=(2,), dtype=np.int64)
    assert v.dtype == torch.int64 and v.to_dict()["dtype"] == "int64"
    op = prog.global_block().append_op("cast", {"X": ["ids"]},
                                       {"Out": ["f"]},
                                       {"out_dtype": torch.bfloat16})
    d = op.to_dict()["attrs"]["out_dtype"]
    assert d == {"__dtype__": "bfloat16"}
    again = Program.from_json(prog.to_json()).global_block().ops[0]
    assert again.attrs["out_dtype"] == torch.bfloat16


def _builder_zoo(api):
    """One program through the builders whose ops the port registers:
    shape inference of each on both sides, then a forward run."""
    static = api.static
    nn = static.nn
    prog, startup = api.pt.Program(), api.pt.Program()
    with static.program_guard(prog, startup):
        x = static.data("x", [4, 6], "float32")
        ids = static.data("ids", [4, 3], "int64")
        h = nn.fc(x, size=8, act="tanh")
        a = nn.leaky_relu(nn.scale(h, scale=2.0, bias=0.5), alpha=0.1)
        b = nn.relu6(nn.elementwise_max(a, nn.gelu(h)))
        c = nn.transpose(nn.elementwise_div(b, nn.elementwise_add(
            nn.square(h), nn.scale(h, scale=0.0, bias=2.0))), axis=[1, 0])
        d = nn.matmul(c, nn.reshape(nn.softmax(h), [8, 4]),
                      transpose_x=True)
        e = nn.embedding(ids, size=[10, 5])
        f = nn.concat([nn.flatten(e), nn.cast(d, out_dtype="float32")],
                      axis=1)
        out = nn.reduce_sum(nn.elementwise_mul(f, f), dim=1, keep_dim=True)
        loss = nn.mean(nn.sum([out, nn.reduce_sum(f, dim=1,
                                                  keep_dim=True)]))
    return prog, startup, [x.name for x in (h, a, b, c, d, e, f, out, loss)]


def test_builder_zoo_infers_the_jax_shapes():
    """Shape inference on ``meta`` tensors gives each output the VarDesc
    (shape, dtype) ``jax.eval_shape`` gives it: the program JSON of a
    chain of table-built and hand-written builders is the same in both
    packages."""
    jmain, jstart, _ = _builder_zoo(JAX_API)
    pmain, pstart, _ = _builder_zoo(chip_smoke.port_static_api())
    for jprog, pprog in ((jmain, pmain), (jstart, pstart)):
        want, got = jprog.to_json(), pprog.to_json()
        assert got == want, _first_difference(got, want)


def test_builder_of_an_op_the_port_lacks_builds_and_raises_at_run():
    """A table builder whose op the port has not registered builds (its
    outputs' VarDescs stay unknown) and raises NotFoundError when run,
    as the JAX package does for an unregistered op."""
    from paddle_tpu_torch.core.registry import OpInfoMap
    api = chip_smoke.port_static_api()
    assert not OpInfoMap.instance().has("top_k_v2")
    prog, startup = tpt.Program(), tpt.Program()
    with api.static.program_guard(prog, startup):
        x = api.static.data("x", [2, 5], "float32")
        top, idx = api.static.nn.topk(x, k=2)
    assert prog.global_block().var(top.name).shape is None
    with pytest.raises(tpt.core.enforce.NotFoundError, match="top_k_v2"):
        tpt.Executor().run(prog, feed={"x": np.ones((2, 5), np.float32)},
                           fetch_list=[top], scope=tpt.Scope())


def test_flash_shape_rule_launches_nothing():
    """The flash op's shape rule: Out has Q's shape and dtype (as the
    JAX package infers it), and inference launches no kernel."""
    import torch
    from paddle_tpu_torch import static
    from paddle_tpu_torch.ops import flash_attention as fa
    before = [w.launches for w in fa.WRAPPERS]
    calls = fa.blockwise_route.calls
    for api in (JAX_API, chip_smoke.port_static_api()):
        prog = api.pt.Program()
        blk = prog.global_block()
        for n in "qkv":
            blk.create_var(n, shape=(2, 16, 2, 32), dtype="bfloat16")
        blk.create_var("o")
        api.static._op(blk, "flash_attention",
                       {"Q": ["q"], "K": ["k"], "V": ["v"]},
                       {"Out": ["o"]}, {"causal": True})
        assert blk.var("o").to_dict()["shape"] == [2, 16, 2, 32]
        assert blk.var("o").to_dict()["dtype"] == "bfloat16"
    assert blk.var("o").dtype == torch.bfloat16
    assert [w.launches for w in fa.WRAPPERS] == before
    assert fa.blockwise_route.calls == calls
    assert static is not None


def test_builder_zoo_runs_like_the_jax_package():
    """The zoo's forward in both executors from the JAX startup values:
    every intermediate within fp32 rounding (rtol 1e-5 / atol 1e-6)."""
    jmain, jstart, names = _builder_zoo(JAX_API)
    pmain, _, _ = _builder_zoo(chip_smoke.port_static_api())
    jscope = jpt.Scope()
    with jpt.scope_guard(jscope):
        jpt.Executor().run(jstart, feed={}, fetch_list=[], scope=jscope)
    rs = np.random.RandomState(3)
    feed = {"x": rs.randn(4, 6).astype(np.float32),
            "ids": rs.randint(0, 10, (4, 3)).astype(np.int64)}
    want = jpt.Executor().run(jmain, feed=feed, fetch_list=names,
                              scope=jscope)
    pscope = tpt.Scope()
    for n, v in jstart.global_block().vars.items():
        pscope.var(n).set(tpt.TpuTensor(
            np.asarray(jscope.find_var(n).get().value)))
    got = tpt.Executor().run(pmain, feed=feed, fetch_list=names,
                             scope=pscope)
    for n, g, w in zip(names, got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-5, atol=1e-6,
                                   err_msg=n)
