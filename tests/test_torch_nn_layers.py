"""The rest of the port's ``paddle.nn`` against the JAX package's, on the
CPU: every class this slice brought (``nn/__init__.py``,
``layers_ext.py``, ``layers_20a.py``) and every function of
``nn.functional``, and the 1.x ``dygraph`` names ``NCE``,
``BilinearTensorProduct``, ``PRelu`` and ``InstanceNorm``.

A layer is built by the JAX package from a seed and its ``state_dict``
(parameters, and the ``stop_gradient`` U / V vectors of
``SpectralNorm``) carried into the port's by structured name
(``convert.load_state_dict``); inputs come from numpy with a seed. The
outputs are compared, then the gradients of every parameter and float
input of sum(out * G), G a fixed random array a float output.
Tolerances (fp32): outputs at rtol 1e-4 / atol 2e-5, gradients at 1e-4
of the gradient's largest element (the two frameworks sum products in
other orders; measured errors are about 1e-6 of it, and a wrong gate,
tap or pad moves them by O(1)).

Every public name of the reference's ``nn`` and ``nn.functional``
exists in the port; the names of ROADMAP item 4e build here:
``CTCLoss`` and ``F.ctc_loss`` (item 4e-ii, held against the reference
in ``test_torch_decode_ops.py``) and ``nn.GRU``, ``nn.LSTM``,
``nn.SimpleRNN``, ``RowConv`` and ``dygraph.GRUUnit`` (item 4e-i, held
in ``test_torch_rnn.py``). The dropout layers are held in eval mode
against the reference and in train mode by what their masks do.
"""
import inspect
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpt
from paddle_tpu import dygraph as jdy
from paddle_tpu import nn as jnn
from paddle_tpu.nn import functional as jF

import paddle_tpu_torch as tpt
from paddle_tpu_torch import dygraph as tdy
from paddle_tpu_torch import nn
from paddle_tpu_torch.convert import load_state_dict
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.testing.nn_cases import FUNC_CASES, LAYER_CASES
from paddle_tpu_torch.testing.op_cases import f32, ints

OUT_TOL = dict(rtol=1e-4, atol=2e-5)
GRAD_TOL = 1e-4


def _flat(out):
    if isinstance(out, (list, tuple)):
        return [v for o in out for v in _flat(o)]
    return [out]


def _np(v):
    return v.detach().numpy() if isinstance(v, torch.Tensor) else v.numpy()


def _run(pkg, model, inputs, call):
    """``model(*tensors)``, or ``call(pkg's nn.functional, *tensors)``
    without a model: the outputs and the gradients of sum(out * G) by
    parameter name and input position."""
    jax_side = pkg == "jax"
    ts = []
    for x in inputs:
        floating = np.issubdtype(x.dtype, np.floating)
        if jax_side:
            ts.append(jpt.to_tensor(x, stop_gradient=not floating))
        else:
            ts.append(torch.from_numpy(x.copy()).requires_grad_(floating))
    outs = _flat(call(jF if jax_side else F, *ts) if model is None
                 else model(*ts))
    differentiable = model is not None and list(model.parameters()) or any(
        np.issubdtype(x.dtype, np.floating) for x in inputs)
    total = None
    for k, o in enumerate(outs):
        if not np.issubdtype(_np(o).dtype, np.floating):
            continue
        g = np.asarray(np.random.RandomState(99 + k).randn(*_np(o).shape),
                       np.float32)
        term = (o * (jpt.to_tensor(g) if jax_side else
                     torch.from_numpy(g))).sum()
        total = term if total is None else total + term
    grads = {}
    if total is not None and differentiable:
        total.backward()
        params = model.named_parameters() if model is not None else []
        for n, p in params:
            grads[n] = p.gradient() if jax_side else (
                None if p.grad is None else p.grad.numpy())
        for k, t in enumerate(ts):
            g = t.gradient() if jax_side else (
                None if t.grad is None else t.grad.numpy())
            grads[f"input {k}"] = g
    return [_np(o) for o in outs], grads


def _compare(j, t):
    (jo, jg), (to, tg) = j, t
    assert len(jo) == len(to)
    for a, b in zip(to, jo):
        assert a.shape == b.shape and str(a.dtype) == str(b.dtype), \
            (a.shape, b.shape, a.dtype, b.dtype)
        np.testing.assert_allclose(a, b, **OUT_TOL)
    assert set(tg) == set(jg)
    for name, want in jg.items():
        got = tg[name]
        if want is None or got is None:       # no gradient on either side
            assert (want is None or not np.any(want)) and \
                (got is None or not np.any(got)), name
            continue
        scale = max(float(np.abs(want).max()), 1e-12)
        err = float(np.abs(got - want).max()) / scale
        assert err <= GRAD_TOL, (name, err)


JAX_API = types.SimpleNamespace(nn=jnn, dygraph=jdy)
PORT_API = types.SimpleNamespace(nn=nn, dygraph=tdy)


def _pair(make, seed=0):
    """``make(api)`` in both packages, the JAX weights carried into the
    port's."""
    jpt.seed(seed)
    jm = make(JAX_API)
    tpt.set_device("cpu")
    tm = make(PORT_API)
    load_state_dict(tm, {k: v.numpy() for k, v in jm.state_dict().items()})
    return jm, tm


@pytest.fixture(autouse=True)
def _cpu():
    tpt.set_device("cpu")


@pytest.mark.parametrize("case", LAYER_CASES,
                         ids=[c[0] for c in LAYER_CASES])
def test_layer_matches_jax(case):
    _, make, inputs = case
    jm, tm = _pair(make)
    assert [n for n, _ in tm.named_parameters()] == \
        [n for n, _ in jm.named_parameters()]
    _compare(_run("jax", jm, inputs, None), _run("torch", tm, inputs, None))


@pytest.mark.parametrize("case", FUNC_CASES, ids=[c[0] for c in FUNC_CASES])
def test_function_matches_jax(case):
    _, inputs, call = case
    _compare(_run("jax", None, inputs, call),
             _run("torch", None, inputs, call))


def _public(mod):
    return {n for n in dir(mod) if not n.startswith("_")
            and not inspect.ismodule(getattr(mod, n))}


def test_every_reference_name_exists():
    assert _public(jnn) <= _public(nn), sorted(_public(jnn) - _public(nn))
    assert _public(jF) <= _public(F), sorted(_public(jF) - _public(F))


def test_item_4e_names_raise():
    """None of the names of item 4e raises any more: those of 4e-ii
    (the CTC loss) give a finite loss, those of 4e-i build."""
    labels = torch.ones(2, 2, dtype=torch.int64)
    for loss in (nn.CTCLoss()(torch.zeros(2, 3, 4), labels),
                 F.ctc_loss(torch.zeros(2, 3, 4), labels)):
        assert loss.shape == () and torch.isfinite(loss)
    for make in (lambda: nn.GRU(3, 4), lambda: nn.LSTM(3, 4),
                 lambda: nn.SimpleRNN(3, 4), lambda: nn.RowConv(3, 2),
                 lambda: tdy.GRUUnit(6)):
        assert list(make().parameters())


@pytest.mark.parametrize("name", ["Dropout2D", "Dropout3d", "AlphaDropout"])
def test_dropout_layers(name):
    """Eval mode is the identity in both packages; train mode zeroes
    whole channels (Dropout2D / 3d) scaled by 1 / (1 - p), or sets
    AlphaDropout's dropped units to one value, in about p of them."""
    x = f32(150, 8, 64, 3, 3) if name != "AlphaDropout" else f32(151, 64, 64)
    jm, tm = _pair(lambda a: getattr(a.nn, name)(0.25))
    jm.eval()
    tm.eval()
    _compare(_run("jax", jm, [x], None), _run("torch", tm, [x], None))
    tm.train()
    y = tm(torch.from_numpy(x)).numpy()
    if name == "AlphaDropout":
        q, alpha_p = 0.75, -1.6732632423543772 * 1.0507009873554805
        a = (q + alpha_p ** 2 * q * 0.25) ** -0.5
        dropped = np.isclose(y, alpha_p * a - a * alpha_p * 0.25)
        assert abs(dropped.mean() - 0.25) < 0.03
        np.testing.assert_allclose(
            y[~dropped], x[~dropped] * a - a * alpha_p * 0.25, rtol=1e-5,
            atol=1e-6)
        return
    dropped = np.all(y == 0, axis=tuple(range(2, y.ndim)))
    assert abs(dropped.mean() - 0.25) < 0.06
    np.testing.assert_allclose(y[~dropped], x[~dropped] / 0.75, rtol=1e-6)


def test_nce_1x_matches_jax_on_the_ports_draws(monkeypatch):
    """dygraph.NCE: the port's Cost against the reference's layer made to
    draw the port's negatives (SampleLabels of the port's op on the same
    seed), then both gradients."""
    from paddle_tpu_torch.core.registry import OpInfoMap
    jm, tm = _pair(lambda a: a.dygraph.NCE(10, 3, num_neg_samples=4,
                                           seed=5))
    x, label = f32(152, 4, 3), ints(153, 0, 10, 4, 1)
    ins = {"Input": [torch.from_numpy(x)], "Label": [torch.from_numpy(label)],
           "Weight": [tm.weight.detach()], "Bias": [tm.bias.detach()]}
    draws = OpInfoMap.instance().get("nce").compute(
        ins, {"num_total_classes": 10, "num_neg_samples": 4, "seed": 5})
    noise = draws["SampleLabels"][0][:, 1:].numpy()
    monkeypatch.setattr(jax.random, "randint",
                        lambda key, shape, lo, hi: jnp.asarray(noise,
                                                               jnp.int32))
    _compare(_run("jax", jm, [x, label], None),
             _run("torch", tm, [x, label], None))
