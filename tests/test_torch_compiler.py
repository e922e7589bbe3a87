"""``static/compiler.py``: BuildStrategy, ExecutionStrategy,
CompiledProgram and ParallelExecutor against the JAX package's.

The strategies carry the JAX package's fields and defaults. A
``CompiledProgram(...).with_data_parallel(loss_name=...)`` run and a
``ParallelExecutor`` run of a small training program (fc, relu, fc,
softmax_with_cross_entropy, mean, SGD) give the plain Program run's bits
on the port, step for step, and the JAX package's losses and parameters
on one device within fp32 rounding (rtol 1e-5 / atol 1e-6 for the
losses, 1e-5 of the update's norm for the parameters). Two places
raise ``UnimplementedError`` naming ROADMAP item 8. An inference
CompiledProgram fed a positional list (the C-API run, ROADMAP item 7)
needs the feed-target order that ``load_inference_model`` records: on a
program built in place both packages raise ``InvalidArgumentError``
(``tests/test_torch_export.py`` runs it on a loaded model).
"""
import types

import jax
import numpy as np
import pytest

import paddle_tpu as jpt
import paddle_tpu.static as jstatic
from paddle_tpu.optimizer import SGD as JaxSGD

import paddle_tpu_torch as tpt
import paddle_tpu_torch.static as pstatic
from paddle_tpu.core.enforce import \
    InvalidArgumentError as JaxInvalidArgumentError
from paddle_tpu_torch.core.enforce import (InvalidArgumentError,
                                           UnimplementedError)
from paddle_tpu_torch.optimizer import SGD as PortSGD
from test_torch_static_builders import _cpu, startup_scopes  # noqa: F401

JAX = types.SimpleNamespace(pt=jpt, static=jstatic, SGD=JaxSGD)
PORT = types.SimpleNamespace(pt=tpt, static=pstatic, SGD=PortSGD)
STEPS = 3


def test_strategies_have_the_jax_package_fields_and_defaults():
    for cls in ("BuildStrategy", "ExecutionStrategy"):
        want = vars(getattr(jstatic, cls)())
        got = vars(getattr(pstatic, cls)())
        assert got == want, cls
    for inner in ("ReduceStrategy", "GradientScaleStrategy"):
        j = getattr(jstatic.BuildStrategy, inner)
        p = getattr(pstatic.BuildStrategy, inner)
        assert {k: v for k, v in vars(p).items() if not k.startswith("_")} \
            == {k: v for k, v in vars(j).items() if not k.startswith("_")}
    assert tpt.CompiledProgram is pstatic.CompiledProgram
    assert tpt.BuildStrategy is pstatic.BuildStrategy


def _program(api):
    main, startup = api.pt.Program(), api.pt.Program()
    with api.static.program_guard(main, startup):
        x = api.static.data("x", [-1, 6], "float32")
        y = api.static.data("y", [-1, 1], "int64")
        h = api.static.nn.fc(x, size=8, act="relu")
        logits = api.static.nn.fc(h, size=3)
        loss = api.static.nn.mean(
            api.static.nn.softmax_with_cross_entropy(logits, y))
        api.SGD(learning_rate=0.5).minimize(loss)
    return main, startup, loss.name


def _feeds():
    rs = np.random.RandomState(0)
    return [{"x": rs.randn(4, 6).astype(np.float32),
             "y": rs.randint(0, 3, (4, 1)).astype(np.int64)}
            for _ in range(STEPS)]


def _train(pt, exe, scope, program, loss, params):
    losses = [exe.run(program, feed=f, fetch_list=[loss], scope=scope)[0]
              for f in _feeds()]
    return losses, {n: np.asarray(scope.find_var(n).get().value)
                    for n in params}


def test_compiled_program_and_parallel_executor_runs():
    jmain, jstart, jloss = _program(JAX)
    pmain, pstart, ploss = _program(PORT)
    assert pmain.to_json() == jmain.to_json()
    params = sorted(pstart.global_block().vars)
    jscope, _ = startup_scopes(jstart)
    start = {n: np.asarray(jscope.find_var(n).get().value) for n in params}

    def port_scope():
        scope = tpt.Scope()
        for n, v in start.items():
            scope.var(n).set(tpt.TpuTensor(v.copy()))
        return scope

    plain = _train(tpt, tpt.Executor(), port_scope(), pmain, ploss, params)
    compiled = pstatic.CompiledProgram(pmain).with_data_parallel(
        loss_name=ploss)
    assert compiled.data_parallel_world_size == 1
    assert compiled.place == tpt.get_device()
    runs = {"compiled": _train(tpt, tpt.Executor(), port_scope(), compiled,
                               ploss, params)}
    scope = port_scope()
    pe = pstatic.compiler.ParallelExecutor(True, loss_name=ploss,
                                           main_program=pmain, scope=scope)
    losses = [pe.run([ploss], feed=f)[0] for f in _feeds()]
    runs["parallel_executor"] = (losses, {
        n: np.asarray(scope.find_var(n).get().value) for n in params})
    for what, (losses, state) in runs.items():
        for a, b in zip(losses, plain[0]):
            np.testing.assert_array_equal(a, b, err_msg=what)
        for n in params:
            np.testing.assert_array_equal(state[n], plain[1][n],
                                          err_msg=(what, n))

    jcompiled = jstatic.CompiledProgram(jmain).with_data_parallel(
        loss_name=jloss, places=jax.devices()[:1])
    want = _train(jpt, jpt.Executor(), jscope, jcompiled, jloss, params)
    for a, b in zip(runs["compiled"][0], want[0]):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=1e-6)
    for n in params:
        update = np.linalg.norm(want[1][n] - start[n])
        err = np.linalg.norm(runs["compiled"][1][n] - want[1][n])
        assert err <= 1e-5 * max(update, 1e-12), (n, err, update)


def test_two_places_raise_naming_item_8():
    pmain, _, ploss = _program(PORT)
    with pytest.raises(UnimplementedError, match="item 8"):
        pstatic.CompiledProgram(pmain).with_data_parallel(
            loss_name=ploss, places=["cpu", "cpu"])
    with pytest.raises(Exception):
        pstatic.CompiledProgram("not a program")


def test_inference_compiled_program_positional_feed_names_item_7():
    feed = [np.zeros((1, 6), np.float32)]
    for api, exc in ((JAX, JaxInvalidArgumentError),
                     (PORT, InvalidArgumentError)):
        main, _, _ = _program(api)
        compiled = api.static.CompiledProgram(main)._with_inference_optimize(
            None)
        assert compiled._is_inference
        with pytest.raises(exc, match="feed target order unknown"):
            api.pt.Executor().run(compiled, feed=feed)
