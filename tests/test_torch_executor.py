"""The port's static executor against the JAX package's, and its
contracts.

The six programs of tests/test_book.py, built by the same builder code
in both packages (``chip_smoke.book_program``), train in both executors
from the JAX package's startup parameters, carried across by name, on
the same feeds: each meets its book threshold in the port, and the
port's per-step losses and final parameters match the JAX run. Both
sides are fp32 on the CPU and differ by rounding only, which the SGD
loop carries from step to step: the losses are held at rtol 1e-4 /
atol 1e-5 a step (the label_semantic_roles CRF loss, the worst, moves by
6e-5 of itself by its last step) and each parameter at 1e-4 of its
update (``||port - jax|| / ||jax - start||``; 4e-6 measured).

The tiny static ResNet (``chip_smoke.static_resnet`` at narrow widths,
batch 4, 64 px, Momentum 1e-2) runs two steps in both: its parameters
are compared by the norm of the update error as ROADMAP Queue 3
prescribes (a ReLU input within rounding of 0 moves one gradient
position), 2**-8 after the first step and 2**-5 after the second (a
batch-4 BN net, ill-conditioned after one step), and its BN running
statistics at 1e-4. Measured: the worst update error 9.4e-5 and 2.2e-3
(medians 7e-6 and 2e-5), the statistics 1.2e-6 apart.

Then the executor contracts of tests/test_static.py and
tests/test_executor_robustness.py, re-stated on the port, and the two
grad routes (the forward's kept graph, and the forward run again)
against each other.
"""
import types

import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu.static as jstatic
from paddle_tpu import io as jio
from paddle_tpu.nn import ParamAttr as JaxParamAttr
from paddle_tpu.nn.initializer import Uniform as JaxUniform
from paddle_tpu.optimizer import Momentum as JaxMomentum

import chip_smoke
import paddle_tpu_torch as tpt
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch.core import enforce as tenforce
from paddle_tpu_torch.core.tensor import TpuTensor

JAX_API = types.SimpleNamespace(pt=jpt, static=jstatic, io=jio,
                                ParamAttr=JaxParamAttr, Uniform=JaxUniform,
                                Momentum=JaxMomentum)
TINY_RESNET = dict(batch=4, px=64, class_dim=10, depth=(1, 1, 1, 1),
                   num_filters=(8, 16, 32, 64), lr=1e-2)
LOSS_TOL = dict(rtol=1e-4, atol=1e-5)
PARAM_UPDATE_TOL = 1e-4
RESNET_UPDATE_TOL = (2.0 ** -8, 2.0 ** -5)
RESNET_BUFFER_TOL = 1e-4


@pytest.fixture(autouse=True)
def _cpu():
    tpt.set_device("cpu")


def _update_error(got, want, start):
    return float(np.linalg.norm(got - want) /
                 max(np.linalg.norm(want - start), 1e-12))


def _jax_startup(program, names):
    scope = jpt.Scope()
    with jpt.scope_guard(scope):
        jpt.Executor().run(program, feed={}, fetch_list=[], scope=scope)
    return {n: np.asarray(scope.find_var(n).get().value) for n in names}


@pytest.mark.parametrize("name", list(chip_smoke.BOOK))
def test_book_program_trains_like_the_jax_package(name, tmp_path):
    feeds, held_out = chip_smoke.book_feeds(name)
    jprog = chip_smoke.book_program(JAX_API, name)
    pprog = chip_smoke.book_program(chip_smoke.port_static_api(), name)
    start = _jax_startup(jprog[1], chip_smoke.book_params(jprog[0]))
    jexe, pexe = jpt.Executor(), tpt.Executor()
    jl, jlast, jparams = chip_smoke.train_book(
        JAX_API, name, jexe, jpt.Scope(), jprog, feeds, start)
    pscope = tpt.Scope()
    pl, plast, pparams = chip_smoke.train_book(
        chip_smoke.port_static_api(), name, pexe, pscope, pprog, feeds, start)
    assert chip_smoke.book_converged(name, pl, plast), pl[::10]
    np.testing.assert_allclose(pl, jl, **LOSS_TOL)
    for n in jparams:
        assert _update_error(pparams[n], jparams[n], start[n]) <= \
            PARAM_UPDATE_TOL, n
    if held_out is not None:            # fit_a_line's serving round trip
        p1, p2 = chip_smoke.inference_roundtrip(
            chip_smoke.port_static_api(), pexe, pscope, pprog, held_out,
            str(tmp_path / name))
        np.testing.assert_allclose(p1, p2, rtol=1e-5)


def _resnet_feeds(steps=2):
    rs = np.random.RandomState(4)
    b, px, c = (TINY_RESNET[k] for k in ("batch", "px", "class_dim"))
    return [{"image": rs.rand(b, 3, px, px).astype(np.float32),
             "label": rs.randint(0, c, (b, 1)).astype(np.int64)}
            for _ in range(steps)]


def _run_resnet(api, exe, scope, program, start, feeds, grads=()):
    prog, _, fetch = program
    losses, states, grad_vals = [], [], []
    with api.pt.scope_guard(scope):
        for n, v in start.items():
            scope.var(n).set(api.pt.TpuTensor(v))
        for feed in feeds:
            out = exe.run(prog, feed=feed, fetch_list=[fetch["loss"], *grads],
                          scope=scope)
            losses.append(float(np.asarray(out[0]).ravel()[0]))
            grad_vals.append([np.asarray(g) for g in out[1:]])
            states.append({n: np.asarray(scope.find_var(n).get().numpy())
                           for n in start})
    return losses, states, grad_vals


def _resnet_start(program):
    _, startup, _ = program
    names = [n for n, v in startup.global_block().vars.items()
             if v.persistable]
    return _jax_startup(startup, names)


def test_tiny_static_resnet_matches_the_jax_package():
    jprog = chip_smoke.static_resnet(JAX_API, **TINY_RESNET)
    pprog = chip_smoke.static_resnet(chip_smoke.port_static_api(),
                                     **TINY_RESNET)
    start = _resnet_start(jprog)
    feeds = _resnet_feeds()
    jl, jstates, _ = _run_resnet(JAX_API, jpt.Executor(), jpt.Scope(), jprog,
                                 start, feeds)
    pl, pstates, _ = _run_resnet(chip_smoke.port_static_api(),
                                 tpt.Executor(), tpt.Scope(), pprog, start,
                                 feeds)
    assert all(np.isfinite(pl))
    np.testing.assert_allclose(pl[0], jl[0], rtol=1e-5)
    for i, (ps, js) in enumerate(zip(pstates, jstates)):
        for n in js:
            if n.endswith(("_mean", "_variance")):
                np.testing.assert_allclose(ps[n], js[n], rtol=RESNET_BUFFER_TOL,
                                           atol=RESNET_BUFFER_TOL, err_msg=n)
            elif "@" not in n and "learning_rate" not in n:
                assert _update_error(ps[n], js[n], start[n]) <= \
                    RESNET_UPDATE_TOL[i], (i, n)


def _executor(route: str):
    """An executor on the CPU that takes the grad-op record route, or
    sends every grad op down the recompute route."""
    exe = tpt.Executor()
    exe._force_recompute = route == "recompute"
    return exe


def test_grad_routes_give_equal_gradients():
    """The forward's kept graph (``record``) and the forward run again
    (``recompute``): the same gradients, parameters and BN statistics
    after two steps of the tiny static ResNet, bit for bit on the CPU."""
    api = chip_smoke.port_static_api()
    prog = chip_smoke.static_resnet(api, **TINY_RESNET)
    start = _resnet_start(chip_smoke.static_resnet(JAX_API, **TINY_RESNET))
    grads = [g for g in (n + "@GRAD" for n in chip_smoke.book_params(prog[0]))
             if prog[0].global_block().has_var(g)]
    assert len(grads) > 10
    runs = {route: _run_resnet(api, _executor(route),
                               tpt.Scope(), prog, start, _resnet_feeds(),
                               grads)
            for route in ("record", "recompute")}
    (rl, rs, rg), (cl, cs, cg) = runs["record"], runs["recompute"]
    assert rl == cl
    for a, b in zip(rg, cg):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    for a, b in zip(rs, cs):
        for n in a:
            np.testing.assert_array_equal(a[n], b[n], err_msg=n)


def test_recompute_route_runs_the_forward_again(monkeypatch):
    """``record`` runs each forward op once a step; ``recompute`` a second
    time for its grad op."""
    api = chip_smoke.port_static_api()
    prog, startup, fetch = chip_smoke.book_program(api, "fit_a_line")
    feed = chip_smoke.book_feeds("fit_a_line")[0][0]
    from paddle_tpu_torch.core.registry import OpInfoMap
    mul = OpInfoMap.instance().get("mul")
    calls = []
    real = mul.compute
    monkeypatch.setattr(mul, "compute",
                        lambda ins, attrs: calls.append(1) or real(ins, attrs))
    for route, want in (("record", 1), ("recompute", 2)):
        scope, exe = tpt.Scope(), _executor(route)
        exe.run(startup, scope=scope)
        scope.var("lr@book").set(TpuTensor(np.float32(0.01)))
        calls.clear()
        exe.run(prog, feed=feed, fetch_list=[fetch["loss"]], scope=scope)
        assert len(calls) == want, route


@pytest.mark.parametrize("impl", ["upscale_in_train", "downgrade_in_infer"])
@pytest.mark.parametrize("seed", [0, 7])
def test_dropout_grad_uses_the_forward_mask(seed, impl):
    """A static dropout's grad op reads the mask its forward drew, by the
    record route, the recompute route and in the JAX executor: each
    one's W@GRAD and b@GRAD are the gradients of its own fetched mask
    (rtol 1e-5, float32 against float64), and the port's two routes,
    from the same parameters at the same step, draw the same mask and
    give the same gradients bit for bit."""
    x = np.random.RandomState(1).randn(8, 16).astype(np.float32)
    jprog, jstart, names = chip_smoke.static_dropout_program(JAX_API, seed,
                                                             impl)
    start = _jax_startup(jstart, names[:2])
    got = {}
    jscope = jpt.Scope()
    for n, v in start.items():
        jscope.var(n).set(jpt.TpuTensor(v))
    with jpt.scope_guard(jscope):
        got["jax"] = chip_smoke.static_dropout_step(
            lambda *a, **k: jpt.Executor().run(*a, scope=jscope, **k),
            jprog, names, x, impl)
    for route in ("record", "recompute"):
        pprog, _, pnames = chip_smoke.static_dropout_program(
            chip_smoke.port_static_api(), seed, impl)
        assert pnames == names
        scope = tpt.Scope()
        for n, v in start.items():
            scope.var(n).set(TpuTensor(v))
        tpt.seed(3)
        exe = _executor(route)
        got[route] = chip_smoke.static_dropout_step(
            lambda *a, **k: exe.run(*a, scope=scope, **k), pprog, names, x,
            impl)
    for who, (m, grads, want) in got.items():
        assert 0 < m.sum() < m.size, who
        for g, w in zip(grads, want):
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-7,
                                       err_msg=who)
    np.testing.assert_array_equal(got["record"][0], got["recompute"][0])
    for a, b in zip(got["record"][1], got["recompute"][1]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", [0, 7])
def test_dropout_draws_a_fresh_mask_every_step(seed):
    """Each run of a static dropout draws another mask, with the seed
    attr 0 or not (the JAX package folds the step into its key); a
    fresh executor after the same ``seed`` draws the same masks again."""
    prog, startup, (_, _, mask, _) = chip_smoke.static_dropout_program(
        chip_smoke.port_static_api(), seed, "upscale_in_train")
    x = np.random.RandomState(1).randn(8, 16).astype(np.float32)
    runs = []
    for _ in range(2):
        tpt.seed(3)
        scope, exe = tpt.Scope(), tpt.Executor()
        exe.run(startup, scope=scope)
        runs.append([exe.run(prog, feed={"x": x}, fetch_list=[mask],
                             scope=scope)[0] for _ in range(2)])
    assert not np.array_equal(runs[0][0], runs[0][1])
    for a, b in zip(*runs):
        np.testing.assert_array_equal(a, b)


def test_random_op_numbers_do_not_depend_on_the_fetch_list():
    """A random op's numbers are keyed on its place in the block: the
    same whether or not an earlier random op runs (it is skipped when
    nothing reads it)."""
    prog = tpt.Program()
    blk = prog.global_block()
    for n in ("g1", "g2"):
        blk.append_op("gaussian_random", {}, {"Out": [n]},
                      {"shape": [16], "seed": 0})
        blk.create_var(n)
    outs = []
    for fetch in (["g2"], ["g1", "g2"]):
        tpt.seed(3)
        outs.append(tpt.Executor().run(prog, fetch_list=fetch,
                                       scope=tpt.Scope())[-1])
    np.testing.assert_array_equal(outs[0], outs[1])


def _linreg_program():
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


def test_linear_regression_converges():
    """tests/test_static.py:34."""
    prog = _linreg_program()
    pgs = tpt.append_backward("loss", parameter_list=["w", "b"],
                              program=prog)
    blk = prog.global_block()
    blk.create_var("lr", persistable=True)
    for p, g in pgs:
        blk.append_op("sgd", {"Param": [p], "Grad": [g],
                              "LearningRate": ["lr"]}, {"ParamOut": [p]}, {})
    scope = tpt.Scope()
    rs = np.random.RandomState(7)
    with tpt.scope_guard(scope):
        scope.var("w").set(TpuTensor(rs.randn(3, 1).astype(np.float32)))
        scope.var("b").set(TpuTensor(np.zeros(1, np.float32)))
        scope.var("lr").set(TpuTensor(np.float32(0.1)))
        true_w = rs.randn(3, 1).astype(np.float32)
        exe = tpt.Executor()
        for _ in range(150):
            x = rs.randn(8, 3).astype(np.float32)
            loss, = exe.run(prog, feed={"x": x, "label": x @ true_w + 0.5},
                            fetch_list=["loss"], scope=scope)
        assert loss.shape == (1,) and loss < 1e-3
        np.testing.assert_allclose(scope.find_var("w").get().numpy(),
                                   true_w, atol=0.05)
        np.testing.assert_allclose(scope.find_var("b").get().numpy(),
                                   [0.5], atol=0.05)


def test_shared_input_grad_accumulates():
    """tests/test_static.py:76."""
    prog = tpt.Program()
    blk = prog.global_block()
    blk.create_var("x", shape=(3,), persistable=True)
    blk.append_op("elementwise_mul", {"X": ["x"], "Y": ["x"]},
                  {"Out": ["sq"]}, {})
    blk.create_var("sq")
    blk.append_op("mean", {"X": ["sq"]}, {"Out": ["loss"]}, {})
    blk.create_var("loss", shape=())
    tpt.append_backward("loss", parameter_list=["x"], program=prog)
    scope = tpt.Scope()
    scope.var("x").set(TpuTensor(np.asarray([1.0, 2.0, 3.0], np.float32)))
    g, = tpt.Executor().run(prog, fetch_list=["x@GRAD"], scope=scope)
    np.testing.assert_allclose(g, 2 * np.asarray([1, 2, 3]) / 3, rtol=1e-6)


@pytest.mark.parametrize("route", ["record", "recompute"])
def test_inplace_forward_op_backward(route):
    """tests/test_static.py:97: the same name written twice gets one
    gradient a version, and each grad op pairs with its own forward."""
    prog = tpt.Program()
    blk = prog.global_block()
    blk.create_var("x", shape=(3,), persistable=True)
    blk.append_op("scale", {"X": ["x"]}, {"Out": ["h"]}, {"scale": 2.0})
    blk.create_var("h")
    blk.append_op("scale", {"X": ["h"]}, {"Out": ["h"]}, {"scale": 3.0})
    blk.append_op("mean", {"X": ["h"]}, {"Out": ["loss"]}, {})
    blk.create_var("loss", shape=())
    tpt.append_backward("loss", parameter_list=["x"], program=prog)
    scope = tpt.Scope()
    scope.var("x").set(TpuTensor(np.asarray([1.0, 2.0, 3.0], np.float32)))
    g, = _executor(route).run(prog, fetch_list=["x@GRAD"],
                                            scope=scope)
    np.testing.assert_allclose(g, 2.0)  # d(mean(6x))/dx


def test_uninitialized_var_error():
    """tests/test_static.py:136."""
    with pytest.raises(tenforce.PreconditionNotMetError):
        tpt.Executor().run(_linreg_program(),
                           feed={"x": np.zeros((8, 3), np.float32),
                                 "label": np.zeros((8, 1), np.float32)},
                           fetch_list=["loss"], scope=tpt.Scope())


def test_rng_fresh_per_step_and_seeded():
    """tests/test_static.py:145: a random op draws fresh numbers every
    run; the same seed and step give the same numbers."""
    prog = tpt.Program()
    blk = prog.global_block()
    blk.append_op("gaussian_random", {}, {"Out": ["g"]},
                  {"shape": [16], "seed": 0})
    blk.create_var("g")
    tpt.seed(3)
    exe = tpt.Executor()
    a, = exe.run(prog, fetch_list=["g"], scope=tpt.Scope())
    b, = exe.run(prog, fetch_list=["g"], scope=tpt.Scope())
    assert not np.allclose(a, b), "random op repeated values across steps"
    tpt.seed(3)
    again, = tpt.Executor().run(prog, fetch_list=["g"], scope=tpt.Scope())
    np.testing.assert_array_equal(again, a)


def test_executor_changing_batch_size_same_program():
    """tests/test_static.py:157 and test_executor_robustness.py:27: one
    cached analysis serves every batch size."""
    prog = tpt.Program()
    b = prog.global_block()
    b.create_var("x", shape=(-1, 4), is_data=True)
    b.create_var("o")
    b.append_op("softmax", {"X": ["x"]}, {"Out": ["o"]}, {})
    exe = tpt.Executor()
    for bs in (2, 5, 2, 7):
        x = np.random.RandomState(bs).rand(bs, 4).astype(np.float32)
        out, = exe.run(prog, feed={"x": x}, fetch_list=["o"],
                       scope=tpt.Scope())
        assert out.shape == (bs, 4)
        np.testing.assert_allclose(out.sum(1), 1.0, rtol=1e-6)
    assert exe.stats["analysis_cache_hit"] == 3
    assert exe.stats["analysis_cache_miss"] == 1


def test_executor_error_path_leaves_scope_usable():
    """tests/test_static.py:180."""
    prog = tpt.Program()
    b = prog.global_block()
    b.create_var("x", shape=(2, 2), is_data=True)
    b.create_var("o")
    b.append_op("relu", {"X": ["x"]}, {"Out": ["o"]}, {})
    exe = tpt.Executor()
    x = np.ones((2, 2), np.float32)
    with pytest.raises(tenforce.NotFoundError):
        exe.run(prog, feed={"x": x}, fetch_list=["does_not_exist"],
                scope=tpt.Scope())
    out, = exe.run(prog, feed={"x": x}, fetch_list=["o"], scope=tpt.Scope())
    np.testing.assert_allclose(out, 1.0)


def _robust_prog():
    prog = tpt.Program()
    blk = prog.global_block()
    blk.create_var("x", shape=(-1, 3), is_data=True)
    blk.create_var("w", shape=(3, 1), persistable=True)
    blk.append_op("mul", {"X": ["x"], "Y": ["w"]}, {"Out": ["out"]},
                  {"x_num_col_dims": 1, "y_num_col_dims": 1})
    blk.create_var("out")
    blk.append_op("mean", {"X": ["out"]}, {"Out": ["loss"]}, {})
    blk.create_var("loss", shape=())
    return prog


def test_scope_state_intact_after_failed_run():
    """tests/test_executor_robustness.py:45: a run that fails midway
    writes nothing back; the next good run sees the original weights."""
    prog = _robust_prog()
    pgs = tpt.append_backward("loss", parameter_list=["w"], program=prog)
    blk = prog.global_block()
    blk.create_var("lr", persistable=True)
    for p, g in pgs:
        blk.append_op("sgd", {"Param": [p], "Grad": [g],
                              "LearningRate": ["lr"]}, {"ParamOut": [p]}, {})
    # a NaN check after the update makes the run fail once w is written
    blk.append_op("scale", {"X": ["w"]}, {"Out": ["w_probe"]},
                  {"scale": float("nan")})
    scope = tpt.Scope()
    w0 = np.ones((3, 1), np.float32)
    scope.var("w").set(TpuTensor(w0.copy()))
    scope.var("lr").set(TpuTensor(np.float32(0.5)))
    exe = tpt.Executor()
    x = np.ones((4, 3), np.float32)
    with pytest.raises(Exception):
        exe.run(prog, feed={}, fetch_list=["loss"], scope=scope)
    tpt.set_flags({"check_nan_inf": True})
    try:
        with pytest.raises(tenforce.EnforceNotMet, match="Inf/Nan"):
            exe.run(prog, feed={"x": x}, fetch_list=["loss", "w_probe"],
                    scope=scope)
    finally:
        tpt.set_flags({"check_nan_inf": False})
    np.testing.assert_array_equal(scope.find_var("w").get().numpy(), w0)
    loss, = exe.run(prog, feed={"x": x}, fetch_list=["loss"], scope=scope)
    np.testing.assert_allclose(loss, 3.0, rtol=1e-6)
    assert not np.array_equal(scope.find_var("w").get().numpy(), w0)


def test_fetch_unknown_var_raises_cleanly():
    """tests/test_executor_robustness.py:77."""
    scope = tpt.Scope()
    scope.var("w").set(TpuTensor(np.ones((3, 1), np.float32)))
    with pytest.raises(Exception, match="neither produced"):
        tpt.Executor().run(_robust_prog(),
                           feed={"x": np.ones((2, 3), np.float32)},
                           fetch_list=["nope"], scope=scope)


def test_fetch_a_scope_var_the_block_never_touches():
    scope = tpt.Scope()
    scope.var("w").set(TpuTensor(np.full((3, 1), 2.0, np.float32)))
    scope.var("extra").set(TpuTensor(np.arange(3, dtype=np.float32)))
    out, = tpt.Executor().run(_robust_prog(),
                              feed={"x": np.ones((2, 3), np.float32)},
                              fetch_list=["extra"], scope=scope)
    np.testing.assert_array_equal(out, [0.0, 1.0, 2.0])


def test_return_numpy_false_keeps_tensors_on_the_device():
    scope = tpt.Scope()
    scope.var("w").set(TpuTensor(np.ones((3, 1), np.float32)))
    loss, = tpt.Executor().run(_robust_prog(),
                               feed={"x": np.ones((2, 3), np.float32)},
                               fetch_list=["loss"], scope=scope,
                               return_numpy=False)
    assert isinstance(loss, TpuTensor) and loss.shape == ()
    assert loss.device.type == "cpu" and float(loss.value) == 3.0


def test_scope_guard_default_scope_and_place():
    """A run with no scope uses ``global_scope()``, which scope_guard
    swaps; ``Executor("cpu")`` runs on the CPU whatever the default
    device; a scope value on another device moves once."""
    prog = _robust_prog()
    scope = tpt.Scope()
    scope.var("w").set(TpuTensor(torch.ones(3, 1)))
    with tpt.scope_guard(scope):
        assert tpt.global_scope() is scope
        loss, = tpt.Executor("cpu").run(
            prog, feed={"x": np.ones((2, 3), np.float32)},
            fetch_list=["loss"])
    assert tpt.global_scope() is not scope
    np.testing.assert_allclose(loss, 3.0)


def test_executor_raises_without_a_card(monkeypatch):
    """No fallback: with no device asked for and no card, the executor
    (through ``get_device``) raises."""
    monkeypatch.setattr(tdevice, "_device", None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(tenforce.UnavailableError):
        tpt.Executor().run(_robust_prog(), feed={}, fetch_list=[])


def test_check_nan_inf_names_the_op():
    prog = tpt.Program()
    b = prog.global_block()
    b.create_var("x", shape=(2,), is_data=True)
    b.append_op("scale", {"X": ["x"]}, {"Out": ["y"]}, {"scale": 0.0,
                                                        "bias": 1.0})
    b.append_op("elementwise_div", {"X": ["y"], "Y": ["x"]},
                {"Out": ["z"]}, {})
    exe = tpt.Executor()
    x = np.zeros(2, np.float32)
    z, = exe.run(prog, feed={"x": x}, fetch_list=["z"], scope=tpt.Scope())
    assert np.isinf(z).all()
    tpt.set_flags({"check_nan_inf": True})
    try:
        with pytest.raises(tenforce.EnforceNotMet,
                           match="elementwise_div output 'z'"):
            exe.run(prog, feed={"x": x}, fetch_list=["z"],
                    scope=tpt.Scope())
    finally:
        tpt.set_flags({"check_nan_inf": False})


def test_minimize_appends_backward_and_momentum_ops():
    """``opt.minimize(static_loss)``: the lr var and a momentum op with
    its velocity a parameter, initialized in the startup program, and
    the loss falls."""
    api = chip_smoke.port_static_api()
    prog = tpt.Program()
    startup = tpt.Program()
    with api.static.program_guard(prog, startup):
        x = api.static.data("x", [8, 3], "float32")
        y = api.static.data("y", [8, 1], "float32")
        loss = api.static.nn.mean(api.static.nn.square(
            api.static.nn.elementwise_sub(api.static.nn.fc(x, size=1), y)))
        _, pgs = api.Momentum(learning_rate=0.05, momentum=0.9).minimize(loss)
    assert [t for t in prog.op_types() if t == "momentum"] == ["momentum"] * 2
    assert len(pgs) == 2
    scope, exe = tpt.Scope(), tpt.Executor()
    exe.run(startup, scope=scope)
    rs = np.random.RandomState(0)
    w = rs.randn(3, 1).astype(np.float32)
    losses = []
    for _ in range(30):
        xb = rs.randn(8, 3).astype(np.float32)
        losses.append(float(exe.run(prog, feed={"x": xb, "y": xb @ w},
                                    fetch_list=[loss], scope=scope)[0][0]))
    assert losses[-1] < 0.2 * losses[0]
    vel = [n for n in scope.local_var_names() if "@momentum@Velocity" in n]
    assert len(vel) == 2


@pytest.mark.parametrize("route", ["record", "recompute"])
def test_dead_ops_are_skipped(route, monkeypatch):
    """An op whose outputs nothing reads, fetches or writes back is not
    run (the closing ``assign`` of a merged gradient nobody fetches); the
    same op runs when its output is fetched."""
    prog = tpt.Program()
    blk = prog.global_block()
    blk.create_var("x", shape=(3,), persistable=True)
    blk.append_op("elementwise_mul", {"X": ["x"], "Y": ["x"]},
                  {"Out": ["sq"]}, {})
    blk.create_var("sq")
    blk.append_op("mean", {"X": ["sq"]}, {"Out": ["loss"]}, {})
    blk.create_var("loss", shape=())
    tpt.append_backward("loss", parameter_list=["x"], program=prog)
    assert prog.op_types()[-2:] == ["sum", "assign"]
    from paddle_tpu_torch.core.registry import OpInfoMap
    assign = OpInfoMap.instance().get("assign")
    calls = []
    real = assign.compute
    monkeypatch.setattr(assign, "compute",
                        lambda ins, attrs: calls.append(1) or real(ins, attrs))
    scope = tpt.Scope()
    scope.var("x").set(TpuTensor(np.asarray([1.0, 2.0, 3.0], np.float32)))
    exe = _executor(route)
    loss, = exe.run(prog, fetch_list=["loss"], scope=scope)
    assert calls == [] and loss[0] == pytest.approx(14 / 3)
    g, = exe.run(prog, fetch_list=["x@GRAD"], scope=scope)
    assert calls == [1]
    np.testing.assert_allclose(g, [2 / 3, 4 / 3, 2.0], rtol=1e-6)


def test_run_op_desc_runs_a_forward_and_a_grad_op():
    """``run_op_desc`` (the control-flow ops' entry in the reference):
    one OpDesc against an env, a grad op by running its forward again."""
    from paddle_tpu_torch.core.executor import run_op_desc
    prog = tpt.Program()
    blk = prog.global_block()
    blk.create_var("x", shape=(2, 2), persistable=True)
    blk.append_op("square", {"X": ["x"]}, {"Out": ["y"]}, {})
    blk.create_var("y", shape=(2, 2))
    blk.append_op("mean", {"X": ["y"]}, {"Out": ["loss"]}, {})
    blk.create_var("loss", shape=())
    tpt.append_backward("loss", parameter_list=["x"], program=prog)
    env = {"x": torch.tensor([[1.0, 2.0], [3.0, 4.0]])}
    for op in prog.global_block().ops:
        run_op_desc(op, env)
    torch.testing.assert_close(env["loss"], torch.tensor(7.5))
    torch.testing.assert_close(env["x@GRAD"], env["x"] / 2)


def test_unknown_op_raises_even_when_nothing_reads_it():
    prog = tpt.Program()
    blk = prog.global_block()
    blk.create_var("x", shape=(2,), is_data=True)
    blk.append_op("no_such_op", {"X": ["x"]}, {"Out": ["y"]}, {})
    with pytest.raises(tenforce.NotFoundError, match="no_such_op"):
        tpt.Executor().run(prog, feed={"x": np.ones(2, np.float32)},
                           fetch_list=[], scope=tpt.Scope())
