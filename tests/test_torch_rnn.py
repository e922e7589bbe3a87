"""The recurrent half of the sequence slice against the JAX package, on
the CPU:

- the 8 op types of ``ops/rnn_ops.py`` (``rnn_scan``, ``lstm``,
  ``lstmp``, ``gru``, ``gru_unit``, ``lstm_unit``, ``row_conv``,
  ``conv_shift``): each case of ``paddle_tpu_torch/testing/seq_cases.py``
  through both registries, forward and ``generic_vjp_grad`` gradients;
  the recurrences at rtol 1e-4 / atol 2e-5 (sums over the steps of
  products through the gates), the rest at fp32's 1e-5 / 1e-6;
- ``nn.LSTM``, ``nn.GRU`` and ``nn.SimpleRNN`` at 1-2 layers, both
  directions, ``time_major`` and initial states, ``nn.RowConv`` and
  ``dygraph.GRUUnit``: built by the JAX package from a seed, the weights
  carried by structured name (``convert.load_state_dict``); outputs and
  final states at rtol 1e-4 / atol 2e-5, the gradients of every
  parameter, the input and the initial states of sum(out * G) within
  1e-4 of the gradient's largest element (``test_torch_nn_layers``'s
  bounds);
- ``convert``'s gate-order maps, against the JAX ops: the cuDNN
  WeightList and the PTB cells' [x; h] weights onto ``nn.LSTM``;
- the book's ``stacked_lstm_net`` (``chip_smoke.sentiment_program``) at
  embedding 16, ``hid_dim`` 32, ``stacked_num`` 3, fed a ragged batch as
  flat rows plus a level-1 LoD: the same JSON from both packages'
  builders, then one ``Adagrad`` step in each executor from the same
  start: the loss at rtol 1e-5, every parameter after the step within
  1e-4 of its update's norm;
- the ragged ``DynamicRNN`` cases of tests/test_control_flow.py run in
  ``test_torch_control_flow.py`` over ``chip_smoke.CF_PROGRAMS``.
"""
import types

import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu.static as jstatic
from paddle_tpu import dygraph as jdy
from paddle_tpu import nn as jnn
from paddle_tpu.optimizer import Adagrad as JaxAdagrad
from paddle_tpu.core.registry import OpInfoMap as JaxOpInfoMap

import chip_smoke
import paddle_tpu_torch as tpt
from paddle_tpu_torch import convert
from paddle_tpu_torch import dygraph as tdy
from paddle_tpu_torch import nn
from paddle_tpu_torch import static as tstatic
from paddle_tpu_torch.convert import load_state_dict
from paddle_tpu_torch.core.program import Program
from paddle_tpu_torch.testing.op_cases import f32
from paddle_tpu_torch.testing.seq_cases import SEQ_CASES
from test_torch_parity_ops import (cf_check_error, cf_check_forward,
                                   cf_check_gradient)
from test_torch_tensor_ops import _jax_in, ref_module

OUT_TOL = dict(rtol=1e-4, atol=2e-5)
GRAD_TOL = 1e-4
CASES = [c for c in SEQ_CASES
         if ref_module(c.op) == "paddle_tpu.ops.rnn_ops"]
VALUE = [c for c in CASES if c.kind == "value"]
GRAD = [c for c in VALUE if c.grad]
ERRORS = [c for c in CASES if c.kind == "error"]
# what sentiment_program takes of the JAX package
JAX_API = types.SimpleNamespace(pt=jpt, static=jstatic, Adagrad=JaxAdagrad)


@pytest.fixture(autouse=True)
def _cpu():
    tpt.set_device("cpu")


@pytest.mark.parametrize("case", VALUE, ids=[c.id for c in VALUE])
def test_forward_matches_jax(case, tmp_path):
    cf_check_forward(case, tmp_path)


@pytest.mark.parametrize("case", GRAD, ids=[c.id for c in GRAD])
def test_gradient_matches_jax(case, tmp_path):
    cf_check_gradient(case, tmp_path)


@pytest.mark.parametrize("case", ERRORS, ids=[c.id for c in ERRORS])
def test_raises_as_jax_does(case, tmp_path):
    cf_check_error(case, tmp_path)


# ------------------------------------------------------- the 2.0 layers
def _jax_t(x, grad):
    return jpt.to_tensor(x, stop_gradient=not grad)


def _port_t(x, grad):
    return torch.from_numpy(x.copy()).requires_grad_(grad)


def _run(jax_side, model, x, states, call):
    """``call(model, x, states)``: the outputs flattened, and the
    gradients of sum(out * G) by parameter name and input position."""
    make = _jax_t if jax_side else _port_t
    tx = make(x, True)
    ts = None if states is None else [make(s, True) for s in states]
    outs = call(model, tx, ts)
    flat = []
    for o in outs:
        flat.extend(o if isinstance(o, (list, tuple)) else [o])
    total = None
    for k, o in enumerate(flat):
        g = np.random.RandomState(99 + k).randn(*o.shape).astype(np.float32)
        term = (o * (jpt.to_tensor(g) if jax_side
                     else torch.from_numpy(g))).sum()
        total = term if total is None else total + term
    total.backward()
    grads = {n: (p.gradient() if jax_side else p.grad.numpy())
             for n, p in model.named_parameters()}
    for k, t in enumerate([tx] + (ts or [])):
        grads[f"input {k}"] = t.gradient() if jax_side else t.grad.numpy()
    return [np.asarray(o.numpy() if jax_side else o.detach().numpy())
            for o in flat], grads


def _compare(want, got):
    (wo, wg), (go, gg) = want, got
    assert len(wo) == len(go)
    for a, b in zip(go, wo):
        assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape)
        np.testing.assert_allclose(a, b, **OUT_TOL)
    assert set(gg) == set(wg)
    for name, w in wg.items():
        scale = max(float(np.abs(w).max()), 1e-12)
        err = float(np.abs(gg[name] - w).max()) / scale
        assert err <= GRAD_TOL, (name, err)


def _pair(make, seed=0):
    jpt.seed(seed)
    jm = make(types.SimpleNamespace(nn=jnn, dygraph=jdy))
    tm = make(types.SimpleNamespace(nn=nn, dygraph=tdy))
    load_state_dict(tm, {k: v.numpy() for k, v in jm.state_dict().items()})
    assert [n for n, _ in tm.named_parameters()] == \
        [n for n, _ in jm.named_parameters()]
    return jm, tm


def _rnn_call(model, x, states):
    if states is None:
        return model(x)
    init = tuple(states) if len(states) == 2 else states[0]
    return model(x, init)


# (id, builder, x shape, initial states' shapes)
LAYERS = [
    ("lstm_2_layers_bidirect_init",
     lambda a: a.nn.LSTM(3, 4, num_layers=2, direction="bidirect"),
     (2, 5, 3), [(4, 2, 4), (4, 2, 4)]),
    ("lstm_time_major",
     lambda a: a.nn.LSTM(3, 4, time_major=True), (5, 2, 3), None),
    ("gru_time_major_init",
     lambda a: a.nn.GRU(3, 4, time_major=True), (5, 2, 3), [(1, 2, 4)]),
    ("gru_2_layers_bidirect",
     lambda a: a.nn.GRU(3, 4, num_layers=2, direction="bidirectional"),
     (2, 4, 3), None),
    ("simple_rnn_relu_2_layers_init",
     lambda a: a.nn.SimpleRNN(3, 4, num_layers=2, activation="relu"),
     (2, 4, 3), [(2, 2, 4)]),
    ("simple_rnn_bidirect",
     lambda a: a.nn.SimpleRNN(3, 4, direction="bidirect"), (2, 4, 3),
     None),
]


@pytest.mark.parametrize("case", LAYERS, ids=[c[0] for c in LAYERS])
def test_rnn_layer_matches_jax(case):
    _, make, xshape, sshapes = case
    jm, tm = _pair(make)
    x = f32(1, *xshape)
    states = None if sshapes is None else \
        [f32(2 + k, *s, scale=0.5) for k, s in enumerate(sshapes)]
    _compare(_run(True, jm, x, states, _rnn_call),
             _run(False, tm, x, states, _rnn_call))


def test_row_conv_layer_matches_jax():
    jm, tm = _pair(lambda a: a.nn.RowConv(3, 2))
    x = f32(5, 2, 6, 3)
    call = (lambda m, x, s: [m(x)])
    _compare(_run(True, jm, x, None, call), _run(False, tm, x, None, call))


@pytest.mark.parametrize("origin", [False, True])
def test_gru_unit_layer_matches_jax(origin):
    """dygraph.GRUUnit (no longer deferred): hidden, reset hidden and
    gates, and the gradients of its weight, bias, input and previous
    hidden state."""
    jm, tm = _pair(lambda a: a.dygraph.GRUUnit(
        9, activation="relu", origin_mode=origin))
    x, h = f32(6, 3, 9), f32(7, 3, 3, scale=0.5)
    call = (lambda m, x, s: list(m(x, s[0])))
    _compare(_run(True, jm, x, [h], call), _run(False, tm, x, [h], call))


# ------------------------------------------------------- convert's maps
def _jax_rnn_scan(x, w_ih, w_hh, b_ih, b_hh):
    ins = {"X": [x], "WeightIh": [w_ih], "WeightHh": [w_hh],
           "BiasIh": [b_ih], "BiasHh": [b_hh]}
    return np.asarray(JaxOpInfoMap.instance().get("rnn_scan").compute(
        _jax_in(ins), {"mode": "LSTM"})["Out"][0])


def test_cudnn_weight_list_maps_onto_lstm():
    """cudnn_lstm's [Wx [I, 4H], Wh [H, 4H], B [4H]] a layer, the JAX
    op's output, equals the JAX rnn_scan's on convert's nn.LSTM weights
    (1e-5); the PTB cells' [x; h] weight splits the same way."""
    i, h, b, t = 3, 4, 2, 5
    wx, wh, bias = f32(10, i, 4 * h), f32(11, h, 4 * h), f32(12, 4 * h)
    x = f32(13, t, b, i)
    zeros = np.zeros((1, b, h), np.float32)
    want = JaxOpInfoMap.instance().get("cudnn_lstm").compute(
        _jax_in({"Input": [x], "InitH": [zeros], "InitC": [zeros],
                 "WeightList": [wx, wh, bias]}),
        {"num_layers": 1, "is_bidirec": False})["Out"][0]
    state = convert.lstm_state_from_cudnn([wx, wh, bias], 1)
    got = _jax_rnn_scan(np.swapaxes(x, 0, 1), state["weight_ih_l0"],
                        state["weight_hh_l0"], state["bias_ih_l0"],
                        state["bias_hh_l0"])
    np.testing.assert_allclose(got, np.swapaxes(np.asarray(want), 0, 1),
                               rtol=1e-5, atol=1e-6)
    cells = convert.lstm_state_from_cells(
        [np.concatenate([wx, wh], 0)], [bias])
    assert cells.keys() == state.keys()
    for k in state:
        np.testing.assert_array_equal(cells[k], state[k])


def test_fluid_lstm_gates_map_onto_rnn_scan():
    """The fluid lstm op's (c, i, f, o) weight and bias, without
    peepholes, reordered by convert to rnn_scan's (i, f, g, o): the JAX
    lstm op's Hidden equals the JAX rnn_scan's Out when the fluid input
    is x projected by the same W_x (rtol 1e-5)."""
    i, d, b, t = 3, 4, 2, 5
    wx, wh, bias = f32(20, i, 4 * d), f32(21, d, 4 * d), f32(22, 1, 4 * d)
    x = f32(23, b, t, i)
    want = JaxOpInfoMap.instance().get("lstm").compute(
        _jax_in({"Input": [x @ wx], "Weight": [wh], "Bias": [bias]}),
        {"use_peepholes": False})["Hidden"][0]
    order = convert.fluid_lstm_to_rnn_gates
    got = _jax_rnn_scan(x, order(wx).T, order(wh).T, order(bias)[0],
                        np.zeros(4 * d, np.float32))
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-6)


# --------------------------------------------- the LoD-fed stacked LSTM
SMALL_SENTIMENT = dict(chip_smoke.SENTIMENT, vocab=40, emb=16, hid=32,
                       batch=4, min_len=0, max_len=9)


def test_lod_stacked_lstm_net_matches_jax():
    """The book's stacked_lstm_net fed as flat rows + a level-1 LoD:
    both executors pad it beside its @seq_len companion, the three
    dynamic_lstm (peepholes, alternating direction, the reverse ones
    within each review's length) and sequence_pool MAX; one Adagrad
    step from the same start."""
    cfg = SMALL_SENTIMENT
    jstatic.enable_static()
    tstatic.enable_static()
    try:
        jb = chip_smoke.sentiment_program(JAX_API, cfg)
        pb = chip_smoke.sentiment_program(chip_smoke.port_static_api(), cfg)
        assert pb[0].to_json() == jb[0].to_json()
        assert pb[1].to_json() == jb[1].to_json()
        ops = [o.type for o in pb[0].global_block().ops]
        assert ops.count("lstm") == 3 and ops.count("sequence_pool") == 2
        lstm_ops = [o for o in pb[0].global_block().ops if o.type == "lstm"]
        assert [o.attrs["is_reverse"] for o in lstm_ops] == \
            [False, True, False]
        assert all(o.inputs["Length"] == ["words@seq_len"]
                   for o in lstm_ops)
        # an empty review, a full-window one and two between
        rows, lod, label = chip_smoke.sentiment_batch(cfg, seed=11)
        assert np.diff(lod[0]).tolist() == [9, 0, 1, 7]
        scope = jpt.Scope()
        exe = jpt.Executor()
        with jpt.scope_guard(scope):
            exe.run(jb[1], feed={}, fetch_list=[], scope=scope)
        names = chip_smoke.sentiment_params(jb[0])
        start = {n: np.asarray(scope.find_var(n).get().value) for n in names}
        want = chip_smoke.sentiment_train(JAX_API, jpt.Executor(),
                                          jpt.Scope(), jb, start,
                                          [(rows, lod, label)])
        got = chip_smoke.sentiment_train(
            chip_smoke.port_static_api(), tpt.Executor("cpu"), tpt.Scope(),
            (Program.from_json(jb[0].to_json()),
             Program.from_json(jb[1].to_json()), jb[2]), start,
            [(rows, lod, label)])
    finally:
        jstatic.disable_static()
        tstatic.disable_static()
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    errs = chip_smoke.update_errors(got[1], want[1], start)
    assert max(errs.values()) <= 1e-4, errs


def test_lod_feed_pads_as_the_jax_executor():
    """The port's padding of a LoD feed equals the JAX executor's
    ``_lod_to_padded``: rows [N, 1] int64 with an empty review between
    two others."""
    from paddle_tpu.core import executor as jex
    from paddle_tpu.core.tensor import TpuTensor as JaxTpuTensor
    from paddle_tpu_torch.core.executor import lod_to_padded
    rows = np.arange(7, dtype=np.int64).reshape(7, 1)
    lod = [[0, 3, 3, 7]]
    want, want_len = jex._lod_to_padded(JaxTpuTensor(rows, lod))
    got, got_len = lod_to_padded(tpt.TpuTensor(rows, lod), "cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_len.numpy(), want_len)


def test_gru_unit_takes_the_builders_activation_names():
    """The static ``gru_unit`` builder (both packages') writes its
    activations as names, which the JAX op reads as integer codes and
    fails on: a reference fault the port does not reproduce. The port's
    op takes both, and the names give the JAX op's result for their
    codes (fp32)."""
    from paddle_tpu_torch.core.registry import OpInfoMap
    from paddle_tpu_torch.device import op_device
    from test_torch_tensor_ops import _port_in
    case = next(c for c in SEQ_CASES if c.id == "gru_unit")
    names = {"gate_activation": "sigmoid", "activation": "tanh"}
    jdef = JaxOpInfoMap.instance().get("gru_unit")
    with pytest.raises(ValueError):
        jdef.compute(_jax_in(case.inputs), dict(names))
    want = jdef.compute(_jax_in(case.inputs), dict(case.attrs))
    with op_device("cpu"):
        got = OpInfoMap.instance().get("gru_unit").compute(
            _port_in(case.inputs), dict(names))
    for slot in ("Hidden", "Gate", "ResetHiddenPrev"):
        np.testing.assert_allclose(got[slot][0].numpy(),
                                   np.asarray(want[slot][0]),
                                   rtol=1e-5, atol=1e-6)
