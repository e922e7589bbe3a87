"""The port's AMP surface (paddle_tpu_torch/amp) against the JAX package's.

- ``auto_cast`` with custom white and black lists: each op's inputs are
  cast to the same dtypes by both tracers, and the thread's AMP state is
  restored on exit.
- ``decorate`` keeps each Parameter object (the optimizer and TrainStep
  hold them), casts fp32 parameters only, leaves buffers fp32, and turns
  on fp32 masters unless ``master_weight`` is False.
- ``GradScaler`` against the JAX one over the same steps, through a
  skipped overflow step, a decrease after ``decr_every_n_nan_or_inf``
  bad steps and a growth after ``incr_every_n_steps`` good ones.

Tolerances: the scaler's scale and step counters are exact (powers of
two and integers). Parameters after each step at rtol 1e-5 / atol 1e-6:
one fp32 Linear, two frameworks that sum in other orders.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import paddle_tpu as jpt
import paddle_tpu.optimizer as jopt
from paddle_tpu import amp as jamp
from paddle_tpu.dygraph import tracer as jtracer
from paddle_tpu.nn import Linear as JaxLinear

import paddle_tpu_torch as tpt
import paddle_tpu_torch.optimizer as topt
from paddle_tpu_torch import amp
from paddle_tpu_torch.convert import load_state_dict
from paddle_tpu_torch.dygraph import tracer as ttracer
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.nn import BatchNorm2D, Linear
from paddle_tpu_torch.text.models import BertForPretraining

F32_TOL = dict(rtol=1e-5, atol=1e-6)
OPS = ("matmul_v2", "conv2d", "layer_norm", "softmax_with_cross_entropy",
       "elementwise_add", "gelu", "reduce_sum")


def _cast_dtypes(tracer, make, op):
    raw = {"X": [make("float32")], "Y": [make("bfloat16")],
           "Z": [make("float16")]}
    out = tracer._amp_cast_inputs(op, raw)
    return [str(out[s][0].dtype).split(".")[-1] for s in ("X", "Y", "Z")]


@pytest.mark.parametrize("level,dtype,white,black", [
    ("O1", "bfloat16", None, None),
    ("O2", "float16", None, None),
    ("O1", "bfloat16", ["gelu", "layer_norm"], None),
    ("O1", "bfloat16", None, ["matmul_v2", "gelu"]),
    ("O2", "bfloat16", ["reduce_sum"], ["conv2d", "reduce_sum"]),
])
def test_auto_cast_lists_match_jax(level, dtype, white, black):
    jx = lambda d: jnp.zeros((2,), d)  # noqa: E731
    tx = lambda d: torch.zeros(2, dtype=getattr(torch, d))  # noqa: E731
    with jamp.auto_cast(True, white, black, level, dtype):
        want = {op: _cast_dtypes(jtracer, jx, op) for op in OPS}
        j_state = jtracer.amp_state()
    with amp.auto_cast(True, white, black, level, dtype) as ctx:
        got = {op: _cast_dtypes(ttracer, tx, op) for op in OPS}
        assert ttracer.amp_state() == (level, getattr(torch, dtype))
    assert got == want
    assert str(j_state[1]) == dtype
    assert isinstance(ctx, amp.auto_cast)
    assert ttracer.amp_state() == ("O0", torch.bfloat16)
    assert ttracer._state().amp_custom_white == set()


def test_auto_cast_decorator_disable_and_guard_alias():
    @amp.auto_cast(level="O2", dtype="float16")
    def inside():
        return ttracer.amp_state()

    assert inside() == ("O2", torch.float16)
    assert ttracer.amp_level() == "O0"
    with amp.amp_guard(enable=False, level="O2"):
        assert ttracer.amp_level() == "O0"
    with pytest.raises(Exception):
        amp.auto_cast(level="O3")


@pytest.mark.parametrize("master_weight", [None, False])
def test_decorate_casts_in_place_and_keeps_identity(master_weight):
    tpt.set_device("cpu")
    model = BertForPretraining(vocab_size=64, d_model=32, num_layers=1,
                               nhead=2, d_ffn=64, dropout=0.0)
    bn = BatchNorm2D(4)
    params = list(model.parameters())
    ids = [id(p) for p in params]
    opt = topt.AdamW(learning_rate=1e-3, parameters=params)
    step = TrainStep(model, lambda m, x: m(x)[0].sum(), opt, amp_level="O2")
    out_models, out_opt = amp.decorate([model, bn], opt, level="O2",
                                       master_weight=master_weight)
    assert out_models[0] is model and out_opt is opt
    assert [id(p) for p in model.parameters()] == ids
    assert all(a is b for a, b in zip(opt._params, model.parameters()))
    assert all(step._params[n] is p for n, p in model.named_parameters())
    assert all(p.dtype == torch.bfloat16 for p in model.parameters())
    assert all(p.dtype == torch.bfloat16 for p in bn.parameters())
    assert all(b.dtype == torch.float32 for b in bn.buffers())
    assert opt._multi_precision == (master_weight is None)
    assert model.cls.decoder_weight is model.bert.embeddings.word.weight
    # a TrainStep built before decorate picks the dtype up at its first
    # step; its masters come from the cast parameters
    step.ensure_state()
    assert step._amp_dtype == torch.bfloat16
    assert bool(step._masters) == (master_weight is None)
    assert amp.decorate(model, level="O1") is model
    assert model.parameters()[0].dtype == torch.bfloat16


def _pair():
    jpt.seed(3)
    jm = JaxLinear(8, 4)
    tpt.set_device("cpu")
    tm = load_state_dict(Linear(8, 4), {k: v.numpy() for k, v in
                                        jm.state_dict().items()})
    return jm, tm


def test_grad_scaler_matches_jax_through_skip_decrease_and_growth():
    jm, tm = _pair()
    kw = dict(init_loss_scaling=2.0 ** 10, incr_ratio=2.0, decr_ratio=0.5,
              incr_every_n_steps=2, decr_every_n_nan_or_inf=2)
    js, ts = jamp.GradScaler(**kw), amp.GradScaler(**kw)
    jo = jopt.Momentum(learning_rate=0.1, momentum=0.9,
                       parameters=jm.parameters())
    to = topt.Momentum(learning_rate=0.1, momentum=0.9,
                       parameters=tm.parameters())
    rs = np.random.RandomState(0)
    # good, bad, good, good (growth), bad, bad (decrease), good
    plan = [1.0, np.inf, 1.0, 1.0, np.nan, np.inf, 1.0]
    scales, skipped = [], []
    for mul in plan:
        x = rs.randn(4, 8).astype(np.float32) * mul
        j_before = {n: np.asarray(p._value) for n, p in
                    jm.named_parameters()}
        t_before = {n: p.detach().clone() for n, p in tm.named_parameters()}
        jl = (jm(jpt.to_tensor(x)) ** 2).mean()
        js.scale(jl).backward()
        js.step(jo)
        jo.clear_grad()
        tl = (tm(torch.from_numpy(x)) ** 2).mean()
        ts.scale(tl).backward()
        ts.step(to)
        to.clear_grad()
        assert ts.get_loss_scaling() == js.get_loss_scaling()
        assert ts.state_dict()["good_steps"] == js.state_dict()["good_steps"]
        assert ts.state_dict()["bad_steps"] == js.state_dict()["bad_steps"]
        scales.append(ts.get_loss_scaling())
        moved = [not torch.equal(p, t_before[n])
                 for n, p in tm.named_parameters()]
        skipped.append(not any(moved))
        assert skipped[-1] == (not np.isfinite(mul))
        for n, p in jm.named_parameters():
            want = np.asarray(p._value)
            assert skipped[-1] == np.array_equal(want, j_before[n])
            np.testing.assert_allclose(
                dict(tm.named_parameters())[n].detach().numpy(), want,
                err_msg=n, **F32_TOL)
    assert scales == [1024.0, 1024.0, 1024.0, 2048.0, 2048.0, 1024.0,
                      1024.0]
    assert skipped == [False, True, False, False, True, True, False]
    state = ts.state_dict()
    other = amp.AmpScaler()
    other.load_state_dict(state)
    assert other.get_loss_scaling() == 1024.0
    assert other.state_dict()["good_steps"] == state["good_steps"]


def test_grad_scaler_disabled_and_minimize():
    _, tm = _pair()
    opt = topt.SGD(learning_rate=0.1, parameters=tm.parameters())
    scaler = amp.GradScaler(enable=False)
    x = torch.ones(2, 8)
    loss = (tm(x) ** 2).mean()
    assert scaler.scale(loss) is loss
    before = tm.weight.detach().clone()
    loss.backward()
    scaler.minimize(opt, loss)
    assert not torch.equal(before, tm.weight)
    assert tm.weight.grad is None
    assert not scaler.is_enable() and scaler.is_use_dynamic_loss_scaling()
