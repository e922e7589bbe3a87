"""The PTB language model's script (``chip_smoke.ptb_lm_program``, the
card's ``ptb_lm`` phase) at a small size in both packages: 2 layers,
hidden 32, 5 steps, batch 4, vocabulary 50.

- Training: the program the two packages' builders write is the same
  JSON; two SGD steps (lr 1.0, dropout 0: the packages' masks never
  agree) from the JAX package's startup parameters on the same token
  ids: the losses within rtol 1e-5, and each parameter's update within
  1e-4 of its norm (``||port - jax|| / ||jax - start||``; about 5e-6
  measured).
- Routes: the ``static.nn.lstm`` program (``cudnn_lstm``) on the
  StaticRNN program's weights (W split into Wx and Wh) against the
  StaticRNN program, in the port: the loss within rtol 1e-5 and the
  gradients of the LSTM weights within 1e-4 of their norm.
- Generation: the greedy ``While`` decode with tensor arrays gives the
  same tokens in both packages, and logits within rtol 1e-5 / atol 1e-5,
  on weights drawn uniform in +-1 and zero biases (trained ones at this
  size decode one token over and over).
"""
import types

import numpy as np
import pytest

import paddle_tpu as jpt
import paddle_tpu.static as jstatic
from paddle_tpu.nn import ParamAttr as JaxParamAttr
from paddle_tpu.nn.initializer import Uniform as JaxUniform
from paddle_tpu.optimizer import SGD as JaxSGD

import chip_smoke
import paddle_tpu_torch as tpt
from paddle_tpu_torch import static as tstatic

JAX_API = types.SimpleNamespace(pt=jpt, static=jstatic, ParamAttr=JaxParamAttr,
                                Uniform=JaxUniform, SGD=JaxSGD)
SMALL = dict(chip_smoke.PTB_LARGE, vocab=50, hidden=32, layers=2, steps=5,
             batch=4, init_scale=0.1)
LOSS_RTOL = 1e-5
UPDATE_TOL = 1e-4
GRAD_TOL = 1e-4


@pytest.fixture(autouse=True)
def _static_cpu():
    tpt.set_device("cpu")
    jstatic.enable_static()
    tstatic.enable_static()
    yield
    jstatic.disable_static()
    tstatic.disable_static()


def _jax_start(startup, names):
    scope = jpt.Scope()
    with jpt.scope_guard(scope):
        jpt.Executor().run(startup, feed={}, fetch_list=[], scope=scope)
    return {n: np.asarray(scope.find_var(n).get().value) for n in names}


def _norm_err(got, want, ref):
    return float(np.linalg.norm(got - want) /
                 max(np.linalg.norm(ref), 1e-12))


def test_full_width_configuration():
    assert chip_smoke.ptb_param_count(chip_smoke.PTB_LARGE) == 66_022_000


def test_two_sgd_steps_match_the_jax_package():
    jprog = chip_smoke.ptb_lm_program(JAX_API, SMALL)
    port = chip_smoke.port_static_api()
    pprog = chip_smoke.ptb_lm_program(port, SMALL)
    assert pprog[0].to_json() == jprog[0].to_json()
    assert pprog[1].to_json() == jprog[1].to_json()
    names = chip_smoke.ptb_param_names(jprog[0])
    assert len(names) == 7
    start = _jax_start(jprog[1], names)
    feeds = [chip_smoke.ptb_feeds(SMALL, s) for s in range(2)]
    jloss, _, jparams = chip_smoke.ptb_train(
        JAX_API, jpt.Executor(), jpt.Scope(), jprog, start, feeds)
    ploss, _, pparams = chip_smoke.ptb_train(
        port, tpt.Executor("cpu"), tpt.Scope(), pprog, start, feeds)
    np.testing.assert_allclose(ploss, jloss, rtol=LOSS_RTOL)
    assert abs(jloss[0] - np.log(SMALL["vocab"])) < 0.1
    for n in names:
        assert _norm_err(pparams[n], jparams[n], jparams[n] - start[n]) \
            <= UPDATE_TOL, n


def test_cudnn_lstm_route_matches_the_static_rnn_route():
    port = chip_smoke.port_static_api()
    sprog = chip_smoke.ptb_lm_program(port, SMALL)
    cprog = chip_smoke.ptb_lm_program(port, SMALL, route="cudnn_lstm")
    cm = cprog[0]
    start = _jax_start(chip_smoke.ptb_lm_program(JAX_API, SMALL)[1],
                       chip_smoke.ptb_param_names(sprog[0]))
    cstart = {n: v for n, v in start.items() if not n.startswith("lstm_")}
    cstart.update(chip_smoke.ptb_lstm_weights(cm, SMALL, start))
    assert set(cstart) == set(chip_smoke.ptb_param_names(cm))
    weights = next(o for o in cm.global_block().ops
                   if o.type == "cudnn_lstm").inputs["WeightList"]
    feed = [chip_smoke.ptb_feeds(SMALL, 0)]
    sgrads = [f"lstm_w{k}@GRAD" for k in range(2)] + \
        [f"lstm_b{k}@GRAD" for k in range(2)]
    cgrads = [n + "@GRAD" for n in weights]
    sloss, sout, _ = chip_smoke.ptb_train(
        port, tpt.Executor("cpu"), tpt.Scope(), sprog, start, feed, sgrads)
    closs, cout, _ = chip_smoke.ptb_train(
        port, tpt.Executor("cpu"), tpt.Scope(), cprog, cstart, feed, cgrads)
    np.testing.assert_allclose(closs, sloss, rtol=LOSS_RTOL)
    sg, cg = sout[0], cout[0]
    for k in range(2):
        w = np.concatenate([cg[3 * k], cg[3 * k + 1]], 0)
        assert _norm_err(w, sg[k], sg[k]) <= GRAD_TOL, k
        assert _norm_err(cg[3 * k + 2], sg[2 + k], sg[2 + k]) <= GRAD_TOL


def test_greedy_while_decode_matches_the_jax_package():
    port = chip_smoke.port_static_api()
    jm, jt, jlog = chip_smoke.ptb_decode_program(JAX_API, SMALL, 8, 3)
    pm, pt_, plog = chip_smoke.ptb_decode_program(port, SMALL, 8, 3)
    assert pm.to_json() == jm.to_json()
    rs = np.random.RandomState(1)
    names = chip_smoke.ptb_param_names(
        chip_smoke.ptb_lm_program(port, SMALL)[0])
    shapes = {n: v.shape for n, v in pm.global_block().vars.items()
              if n in names}
    values = {n: (rs.uniform(-1.0, 1.0, shapes[n]) * (len(shapes[n]) > 1))
              .astype(np.float32) for n in names}
    jtok, jl = chip_smoke.ptb_decode(JAX_API, jpt.Executor(), jpt.Scope(),
                                     jm, jt, jlog, values)
    ptok, pl = chip_smoke.ptb_decode(port, tpt.Executor("cpu"), tpt.Scope(),
                                     pm, pt_, plog, values)
    np.testing.assert_array_equal(ptok, jtok)
    assert len(set(jtok.tolist())) > 2, jtok
    np.testing.assert_allclose(pl, jl, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(ptok, pl.argmax(-1))
