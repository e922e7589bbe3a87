"""Static control flow in the port against the JAX package:
tests/test_control_flow.py's programs (while_loop, nested, bounded with a
gradient, While in block form, cond with a gradient, case, switch_case
with negative and large indices, StaticRNN with a gradient, an NMT-style
greedy decode, branches returning outer vars, DynamicRNN on the dense
path and on ragged LoD feeds) and a few of the port's own, built by the
same code in both packages (``chip_smoke.CF_PROGRAMS``).

For each program: the JSON the two packages' builders write is the same
text (sub-blocks and the grad ops of append_backward included); the
port runs the JAX package's JSON and the JAX package the port's, from
the same parameter values, and the fetches agree (integers equal, fp32
rtol 1e-5 / atol 1e-6). Then what only the port does or must show:
the gradient of an unbounded while_loop (the JAX package cannot reverse
``lax.while_loop``) against the bounded loop's; one dropout mask for
every StaticRNN step, as ``lax.scan`` gives; the two grad routes
agreeing on loops (the recompute route replaying the forward's masks);
the array forms by the JAX executor's rule.

The ragged DynamicRNN cases of tests/test_control_flow.py feed flat
rows with a level-1 LoD, which each executor pads beside the input's
``@seq_len`` companion, and build a ``sequence_mask`` op that freezes
each finished row's state (``dynamic_rnn_ragged``,
``dynamic_rnn_memory_ragged``).
"""
import types

import numpy as np
import pytest

import paddle_tpu as jpt
import paddle_tpu.static as jstatic
from paddle_tpu.core.program import Program as JaxProgram
from paddle_tpu.nn import ParamAttr as JaxParamAttr
from paddle_tpu.nn.initializer import Uniform as JaxUniform
from paddle_tpu.optimizer import SGD as JaxSGD
from paddle_tpu.optimizer import Momentum as JaxMomentum

import chip_smoke
import paddle_tpu_torch as tpt
from paddle_tpu_torch import static as tstatic
from paddle_tpu_torch.core.program import Program

JAX_API = types.SimpleNamespace(pt=jpt, static=jstatic, ParamAttr=JaxParamAttr,
                                Uniform=JaxUniform, SGD=JaxSGD,
                                Momentum=JaxMomentum)
TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def _static_cpu():
    tpt.set_device("cpu")
    jstatic.enable_static()
    tstatic.enable_static()
    yield
    jstatic.disable_static()
    tstatic.disable_static()


def _start(built):
    """The builder's parameter values over the JAX package's startup
    draws (both packages then run from the same values)."""
    scope = jpt.Scope()
    with jpt.scope_guard(scope):
        jpt.Executor().run(built["startup"], feed={}, fetch_list=[],
                           scope=scope)
    names = [n for n, v in built["main"].global_block().vars.items()
             if v.persistable and scope.find_var(n) is not None]
    start = {n: np.asarray(scope.find_var(n).get().value) for n in names}
    start.update(built["params"])
    return start


def _loaded(built, program_cls):
    return dict(built, main=program_cls.from_json(built["main"].to_json()),
                startup=program_cls.from_json(built["startup"].to_json()))


def _assert_same(got, want, what):
    assert len(got) == len(want), what
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, (what, g, w)
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g, w, err_msg=what, **TOL)
        else:
            np.testing.assert_array_equal(g, w, err_msg=what)


@pytest.mark.parametrize("name", list(chip_smoke.CF_PROGRAMS))
def test_program_runs_like_the_jax_package(name):
    builder = chip_smoke.CF_PROGRAMS[name]
    jb = builder(JAX_API)
    pb = builder(chip_smoke.port_static_api())
    assert pb["main"].to_json() == jb["main"].to_json()
    assert pb["startup"].to_json() == jb["startup"].to_json()
    start = _start(jb)
    want = chip_smoke.run_cf(JAX_API, jb, jpt.Executor(), jpt.Scope(), start)
    port_api = chip_smoke.port_static_api()
    got = chip_smoke.run_cf(port_api, _loaded(jb, Program),
                            tpt.Executor("cpu"), tpt.Scope(), start)
    _assert_same(got, want, f"{name}: the port on the JAX package's JSON")
    back = chip_smoke.run_cf(JAX_API, _loaded(pb, JaxProgram),
                             jpt.Executor(), jpt.Scope(), start)
    _assert_same(back, want, f"{name}: the JAX package on the port's JSON")


def test_expected_values():
    """tests/test_control_flow.py's own expectations, on the port."""
    api = chip_smoke.port_static_api()

    def run(name):
        built = chip_smoke.CF_PROGRAMS[name](api)
        return chip_smoke.run_cf(api, built, tpt.Executor("cpu"),
                                 tpt.Scope())
    assert run("while_basic")[0][0] == 10
    np.testing.assert_allclose(run("while_nested")[0], [9.0])
    np.testing.assert_allclose(run("while_grad")[1], [32.0], rtol=1e-6)
    acc, i = run("while_block")
    np.testing.assert_allclose(acc, [81.0], rtol=1e-6)
    assert i[0] == 4
    np.testing.assert_allclose(run("cond_grad")[0], [5.0, 5.0])
    np.testing.assert_allclose(run("case_chain")[0], [100.3], rtol=1e-6)
    for idx, want in ((0, 6.0), (1, 30.0), (7, 0.0), (-1, 0.0), (-7, 0.0),
                      (2, 0.0), (100, 0.0)):
        np.testing.assert_allclose(run(f"switch_case_{idx}")[0], [want] * 2)
    np.testing.assert_allclose(run("case_no_default")[0], [105.0])
    np.testing.assert_allclose(run("while_invariant")[0], [5.0])
    xv = np.arange(8, dtype=np.float32).reshape(4, 2, 1)
    np.testing.assert_allclose(
        run("static_rnn_grad")[1],
        [sum((4 - t) * xv[t].sum() for t in range(4)) * 1.0], rtol=1e-6)
    out = run("dynamic_rnn")[0]
    np.testing.assert_allclose(out[0, :, 0], [1, 3, 6])
    o = run("dynamic_rnn_memory")[0]
    assert o.shape == (1, 2, 7)
    np.testing.assert_allclose(o[0, 0], np.full(7, 1.5))
    o, last = run("dynamic_rnn_ragged")
    np.testing.assert_allclose(o[0, :, 0], [1, 3, 6])
    np.testing.assert_allclose(o[1, :, 0], [10, 10, 10])     # frozen
    np.testing.assert_allclose(last[:, 0], [6, 10])
    o = run("dynamic_rnn_memory_ragged")[0]
    assert o.shape == (1, 2, 7)
    np.testing.assert_allclose(o[0, 0], np.full(7, 1.5))
    stacked, index, length, step = run("array_decode")
    np.testing.assert_allclose(stacked[:6, 0, 0],
                               [1.0, 2.5, 5.5, 11.5, 23.5, 47.5])
    np.testing.assert_array_equal(stacked[6], 0.0)
    assert length[0] == 7 and step[0] == 5 and index.tolist() == [1] * 7
    r, g = run("cond_nan_untaken")
    assert np.isfinite(g).all()


def test_nmt_decode_matches_numpy():
    api = chip_smoke.port_static_api()
    built = chip_smoke.cf_nmt_decode(api)
    n, toks = chip_smoke.run_cf(api, built, tpt.Executor("cpu"), tpt.Scope())
    emb_w, proj_w = built["params"]["emb"], built["params"]["proj"]
    tok, ref = 1, []
    for _ in range(6):
        tok = int(np.argmax(emb_w[tok] @ proj_w))
        ref.append(tok)
        if tok == 0:
            break
    assert 1 <= int(n[0]) <= 6
    np.testing.assert_array_equal(toks[:len(ref)], ref)


def test_unbounded_while_gradient_matches_the_bounded_loop():
    """The port differentiates a while_loop without max_trip_count (the
    JAX package cannot: lax.while_loop has no reverse mode) and gives
    the bounded loop's gradient."""
    api = chip_smoke.port_static_api()
    bounded = chip_smoke.run_cf(api, chip_smoke.cf_while_grad(api),
                                tpt.Executor("cpu"), tpt.Scope())
    unbounded = chip_smoke.run_cf(
        api, chip_smoke.cf_while_grad(api, max_trip_count=None),
        tpt.Executor("cpu"), tpt.Scope())
    _assert_same(unbounded, bounded, "unbounded against bounded")
    with pytest.raises(Exception, match="[Rr]everse-mode"):
        chip_smoke.run_cf(JAX_API, chip_smoke.cf_while_grad(
            JAX_API, max_trip_count=None), jpt.Executor(), jpt.Scope())


def test_static_rnn_dropout_draws_one_mask_for_all_steps():
    """A dropout in a StaticRNN body takes one mask for all the steps of
    a run, in both packages (lax.scan traces the body once), and a new
    one the next run."""
    for api, exe, scope in ((JAX_API, jpt.Executor(), jpt.Scope()),
                            (chip_smoke.port_static_api(),
                             tpt.Executor("cpu"), tpt.Scope())):
        built = chip_smoke.cf_static_rnn_dropout(api)
        first = chip_smoke.run_cf(api, built, exe, scope)[0]
        for t in range(1, first.shape[0]):
            np.testing.assert_array_equal(first[t], first[0])
        assert set(np.unique(first)) == {0.0, 2.0}
        with api.pt.scope_guard(scope):
            second = exe.run(built["main"], feed=built["feed"],
                             fetch_list=built["fetch"], scope=scope)[0]
        assert not np.array_equal(np.asarray(second), first)


def _dropout_rnn_grad(api):
    st = api.static
    main, startup = st.Program(), st.Program()
    with st.program_guard(main, startup):
        x = st.data("x", [5, 3, 8])
        w = st.create_parameter([8, 8], "float32", name="w")
        h0 = st.fill_constant([3, 8], "float32", 0.0)
        rnn = st.StaticRNN()
        with rnn.step():
            xt = rnn.step_input(x)
            h = rnn.memory(init=h0)
            nh = st.nn.tanh(st.nn.elementwise_add(
                st.nn.matmul(st.nn.dropout(
                    h, 0.5, dropout_implementation="upscale_in_train"), w),
                xt))
            rnn.update_memory(h, nh)
            rnn.step_output(nh)
        loss = st.nn.reduce_sum(rnn())
        pg = st.append_backward(loss, parameter_list=["w"], program=main)
    rs = np.random.RandomState(2)
    return dict(main=main, startup=startup,
                feed={"x": rs.randn(5, 3, 8).astype(np.float32)},
                fetch=[loss.name, chip_smoke._name(pg[0][1])],
                params={"w": rs.randn(8, 8).astype(np.float32) * 0.3})


@pytest.mark.parametrize("name", ["while_grad", "static_rnn_grad",
                                  "cond_grad", "dropout_rnn"])
def test_grad_routes_agree(name):
    """The recorded route (the loop's kept graph) and the recompute
    route (the loop run again in its grad op) give the same gradient of
    the captured weights; with a dropout in the body, the recompute
    replays the forward's mask (its grad op draws with the forward's
    RNG salt)."""
    api = chip_smoke.port_static_api()
    make = _dropout_rnn_grad if name == "dropout_rnn" else \
        chip_smoke.CF_PROGRAMS[name]
    runs = []
    for recompute in (False, True):
        exe = tpt.Executor("cpu")
        exe._force_recompute = recompute
        runs.append(chip_smoke.run_cf(api, make(api), exe, tpt.Scope()))
    _assert_same(runs[1], runs[0], name)


def test_dropout_rnn_gradient_uses_the_forward_mask():
    """The loss and gradient through a StaticRNN with a dropout in its
    body, on the port, against the same net written out step by step in
    torch with the one mask the op draws: the generator of the
    executor's step 2 (the startup program was step 1) and the op's
    salt, the first draw of the block."""
    import torch
    api = chip_smoke.port_static_api()
    built = _dropout_rnn_grad(api)
    loss, grad = chip_smoke.run_cf(api, built, tpt.Executor("cpu"),
                                   tpt.Scope())
    x = torch.from_numpy(built["feed"]["x"])
    w = torch.from_numpy(built["params"]["w"]).requires_grad_()
    from paddle_tpu_torch.core import rng
    with rng.step_scope(2):
        rng.set_op_salt(0)
        gen = rng.random_generator(0, "cpu")
        keep = torch.rand((3, 8), generator=gen) < 0.5
    h = torch.zeros(3, 8)
    total = 0.0
    for t in range(5):
        h = torch.tanh(torch.where(keep, h / 0.5, 0.0) @ w + x[t])
        total = total + h.sum()
    total.backward()
    np.testing.assert_allclose(loss, [total.item()], rtol=1e-5)
    np.testing.assert_allclose(grad, w.grad.numpy(), rtol=1e-4, atol=1e-6)


def _array_length_program(api):
    st = api.static
    main, startup = st.Program(), st.Program()
    with st.program_guard(main, startup):
        i = st.fill_constant([1], "int64", 0)
        arr = st.nn.array_write(st.fill_constant([2], "float32", 1.0), i,
                                max_size=6)
        st.nn.array_write(st.fill_constant([2], "float32", 2.0),
                          st.fill_constant([1], "int64", 1), array=arr)
        n = st.nn.array_length(arr)
    return main, n


def test_array_form_follows_the_jax_executors_rule():
    """A program run the JAX executor's jitted way keeps the dense array
    (array_length: the capacity, 6); run its eager way (no program
    cache) the list (array_length: the slots written, 2). The port
    takes the same form in each case."""
    for use_cache, want in ((True, 6), (False, 2)):
        for api, exe in ((JAX_API, jpt.Executor()),
                         (chip_smoke.port_static_api(),
                          tpt.Executor("cpu"))):
            main, n = _array_length_program(api)
            out = exe.run(main, fetch_list=[n],
                          use_program_cache=use_cache)[0]
            assert int(np.asarray(out).ravel()[0]) == want, (api, use_cache)


def test_check_nan_inf_runs_list_form_arrays():
    """FLAGS_check_nan_inf sends the JAX executor down its eager path,
    where a tensor array is a list: the port's finiteness check passes
    over it and gives the slots written; the JAX package's check takes
    ``np.asarray`` of the list's (value, lod) entries and raises (a
    reference fault the port does not reproduce)."""
    runs = ((JAX_API, jpt.Executor(), jpt),
            (chip_smoke.port_static_api(), tpt.Executor("cpu"), tpt))
    for api, exe, pkg in runs:
        main, n = _array_length_program(api)
        pkg.set_flags({"check_nan_inf": True})
        try:
            if pkg is jpt:
                with pytest.raises(ValueError, match="inhomogeneous"):
                    exe.run(main, fetch_list=[n])
            else:
                out = exe.run(main, fetch_list=[n])[0]
                assert int(np.asarray(out).ravel()[0]) == 2
        finally:
            pkg.set_flags({"check_nan_inf": False})
