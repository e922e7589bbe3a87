"""The port's optimizer surface against the JAX package's.

- Every one of the sixteen optimizer ops (``ops/optimizer_ops.py``) on the
  same seeded numpy inputs, in fp32 and, where the op takes them, with
  bf16 parameters, gradients and accumulators (the learning rate and the
  beta powers stay fp32, as the optimizers make them).
- The three clip classes, ``L2Decay`` through ``functional_step``, and
  every scheduler's trajectory.
- The eager ``step()`` with ``multi_precision`` (bf16 parameters, fp32
  masters) against the JAX eager step, and the optimizer's
  ``state_dict`` round trip.

Tolerances. fp32: rtol 1e-5 / atol 1e-6. XLA fuses an op's elementwise
chain and may contract a multiply and an add into one rounding; torch
rounds each operation, so results differ by an ulp or two. These cases
hold the formulas. The bf16 cases hold the dtypes exactly (JAX promotes
a bf16 tensor against a 0-d fp32 array, the learning rate, to fp32, and
the port must too) and the values to two bf16 ulps of each output's
largest element (rtol and atol 2**-6 of it): JAX rounds a Python
constant to bf16 before it multiplies a bf16 tensor (0.9 becomes
0.8984), torch keeps it in fp32, and XLA on the CPU carries a fused bf16
chain in fp32 where torch rounds each operation; a sum whose terms
cancel (adadelta's p + update) keeps the terms' absolute rounding.
The schedulers are the same pure-Python code in both: exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu.optimizer as jopt
from paddle_tpu import amp as jamp
from paddle_tpu.core.registry import OpInfoMap as JaxOpInfoMap
from paddle_tpu.nn import Linear as JaxLinear

import paddle_tpu_torch as tpt
import paddle_tpu_torch.optimizer as topt
from paddle_tpu_torch import amp, clip, regularizer
from paddle_tpu_torch.convert import load_state_dict, to_tensor
from paddle_tpu_torch.core.registry import OpInfoMap
from paddle_tpu_torch.nn import Linear

F32_TOL = dict(rtol=1e-5, atol=1e-6)
LOW_TOL = dict(rtol=2.0 ** -6)
SHAPE = (8, 16)


def _arr(rs, kind="n", shape=SHAPE):
    x = rs.randn(*shape).astype(np.float32)
    return {"n": x, "pos": np.abs(x) + 0.1, "small": 0.1 * x}[kind]


def _f32(v):
    return np.asarray([v], np.float32)


def _adam_like(rs):
    return {"Param": _arr(rs), "Grad": _arr(rs), "Moment1": _arr(rs, "small"),
            "Moment2": _arr(rs, "pos") * 0.01, "LearningRate": _f32(1e-2),
            "Beta1Pow": _f32(0.9 ** 3), "Beta2Pow": _f32(0.999 ** 3)}


# op -> (inputs from a RandomState, attrs, slots that stay fp32 at bf16)
F32_SLOTS = ("LearningRate", "Beta1Pow", "Beta2Pow")
CASES = {
    "sgd": (lambda rs: {"Param": _arr(rs), "Grad": _arr(rs),
                        "LearningRate": _f32(0.1)}, {}),
    "momentum": (lambda rs: {"Param": _arr(rs), "Grad": _arr(rs),
                             "Velocity": _arr(rs),
                             "LearningRate": _f32(0.1)},
                 {"mu": 0.9}),
    "momentum-nesterov-l2": (
        lambda rs: {"Param": _arr(rs), "Grad": _arr(rs),
                    "Velocity": _arr(rs), "LearningRate": _f32(0.1)},
        {"mu": 0.8, "use_nesterov": True,
         "regularization_method": "l2_decay", "regularization_coeff": 0.01}),
    "adam": (_adam_like, {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}),
    "adamw": (_adam_like, {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8,
                           "coeff": 0.02, "with_decay": True}),
    "lamb": (_adam_like, {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-6,
                          "weight_decay": 0.01}),
    "lars_momentum": (lambda rs: {"Param": _arr(rs), "Grad": _arr(rs),
                                  "Velocity": _arr(rs),
                                  "LearningRate": _f32(0.1)},
                      {"mu": 0.9, "lars_coeff": 0.001,
                       "lars_weight_decay": 0.0005}),
    "rmsprop": (lambda rs: {"Param": _arr(rs), "Grad": _arr(rs),
                            "MeanSquare": _arr(rs, "pos"),
                            "Moment": _arr(rs, "small"),
                            "LearningRate": _f32(1e-2)},
                {"decay": 0.9, "epsilon": 1e-6, "momentum": 0.5}),
    "rmsprop-centered": (lambda rs: {"Param": _arr(rs), "Grad": _arr(rs),
                                     "MeanSquare": _arr(rs, "pos") + 1.0,
                                     "MeanGrad": _arr(rs, "small"),
                                     "Moment": _arr(rs, "small"),
                                     "LearningRate": _f32(1e-2)},
                         {"decay": 0.9, "epsilon": 1e-6, "momentum": 0.5,
                          "centered": True}),
    "adagrad": (lambda rs: {"Param": _arr(rs), "Grad": _arr(rs),
                            "Moment": _arr(rs, "pos"),
                            "LearningRate": _f32(0.1)}, {"epsilon": 1e-6}),
    "decayed_adagrad": (lambda rs: {"Param": _arr(rs), "Grad": _arr(rs),
                                    "Moment": _arr(rs, "pos"),
                                    "LearningRate": _f32(0.1)},
                        {"decay": 0.95, "epsilon": 1e-6}),
    "adadelta": (lambda rs: {"Param": _arr(rs), "Grad": _arr(rs),
                             "AvgSquaredGrad": _arr(rs, "pos"),
                             "AvgSquaredUpdate": _arr(rs, "pos")},
                 {"rho": 0.95, "epsilon": 1e-6}),
    "adamax": (lambda rs: {"Param": _arr(rs), "Grad": _arr(rs),
                           "Moment": _arr(rs, "small"),
                           "InfNorm": _arr(rs, "pos"),
                           "LearningRate": _f32(1e-2),
                           "Beta1Pow": _f32(0.9 ** 2)},
               {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}),
    "ftrl": (lambda rs: {"Param": _arr(rs), "Grad": _arr(rs),
                         "SquaredAccumulator": _arr(rs, "pos"),
                         "LinearAccumulator": _arr(rs),
                         "LearningRate": _f32(0.1)},
             {"l1": 0.1, "l2": 0.01, "lr_power": -0.5}),
    "ftrl-power": (lambda rs: {"Param": _arr(rs), "Grad": _arr(rs),
                               "SquaredAccumulator": _arr(rs, "pos"),
                               "LinearAccumulator": _arr(rs),
                               "LearningRate": _f32(0.1)},
                   {"l1": 0.0, "l2": 0.01, "lr_power": -0.7}),
    # sigma 0: the noise (torch's Philox against JAX's threefry) is zero,
    # so the clipped update is compared exactly; the noise itself is
    # tested by distribution below
    "dpsgd": (lambda rs: {"Param": _arr(rs), "Grad": 3.0 * _arr(rs),
                          "LearningRate": _f32(0.1)},
              {"clip": 1.0, "batch_size": 4.0, "sigma": 0.0}),
}


def _op_type(case):
    return case.split("-")[0]


def _run_jax(op, inputs, attrs):
    outs = JaxOpInfoMap.instance().get(op).compute(
        {k: [jnp.asarray(v)] for k, v in inputs.items()}, dict(attrs))
    return {k: [np.asarray(x) for x in v] for k, v in outs.items()}


def _run_torch(op, inputs, attrs):
    outs = OpInfoMap.instance().get(op).compute(
        {k: [to_tensor(v)] for k, v in inputs.items()}, dict(attrs))
    return {k: [x for x in v] for k, v in outs.items()}


def _compare(got, want, low=False):
    """Dtypes exactly; values at F32_TOL, or with bf16 inputs (``low``)
    at LOW_TOL plus an atol of LOW_TOL's rtol times the output's largest
    element."""
    assert set(got) == set(want)
    for slot in want:
        for x, y in zip(got[slot], want[slot]):
            assert str(x.dtype).split(".")[-1] == str(y.dtype), \
                (slot, x.dtype, y.dtype)
            y = np.asarray(y, np.float32)
            t = F32_TOL if not low else dict(
                LOW_TOL, atol=LOW_TOL["rtol"] * float(np.abs(y).max()))
            np.testing.assert_allclose(x.float().numpy(), y, err_msg=slot,
                                       **t)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_optimizer_op_matches_jax(case, dtype):
    build, attrs = CASES[case]
    inputs = build(np.random.RandomState(sorted(CASES).index(case)))
    if dtype == "bfloat16":
        inputs = {k: (v if k in F32_SLOTS else
                      np.asarray(jnp.asarray(v, jnp.bfloat16)))
                  for k, v in inputs.items()}
    _compare(_run_torch(_op_type(case), inputs, attrs),
             _run_jax(_op_type(case), inputs, attrs), dtype == "bfloat16")


def test_dpsgd_noise_is_seeded_by_step_and_param():
    rs = np.random.RandomState(0)
    p = torch.zeros(64, 64)
    g = to_tensor(_arr(rs, shape=(64, 64)))
    op = OpInfoMap.instance().get("dpsgd")
    attrs = {"clip": 1.0, "batch_size": 4.0, "sigma": 2.0, "seed": 5}

    def run(step, pid):
        a = dict(attrs, param_id=pid)
        out = op.compute({"Param": [p], "Grad": [g],
                          "LearningRate": [torch.tensor([1.0])],
                          "Step": [torch.tensor([step])]}, a)
        return out["ParamOut"][0], out["StepOut"][0]

    base, step_out = run(3, 0)
    assert int(step_out) == 4
    assert torch.equal(base, run(3, 0)[0])
    assert not torch.equal(base, run(4, 0)[0])
    assert not torch.equal(base, run(3, 1)[0])
    clipped = g / torch.clamp_min(g.norm() / attrs["clip"], 1.0)
    noise = -(base + clipped) * attrs["batch_size"]
    # noise ~ N(0, (sigma * clip)^2): 4096 draws put the std within 5%
    assert abs(noise.std().item() / 2.0 - 1.0) < 0.05
    assert abs(noise.mean().item()) < 0.1


def _avg_inputs(num_acc, old, num_upd):
    rs = np.random.RandomState(4)
    i64 = lambda v: np.asarray([v], np.int64)  # noqa: E731
    return {"param": _arr(rs), "in_sum_1": _arr(rs), "in_sum_2": _arr(rs),
            "in_sum_3": _arr(rs), "in_num_accumulates": i64(num_acc),
            "in_old_num_accumulates": i64(old),
            "in_num_updates": i64(num_upd)}


@pytest.mark.parametrize("num_acc,num_upd,attrs", [
    (3, 10, {"average_window": 0.5, "max_average_window": 100,
             "min_average_window": 50}),            # accumulate
    (60, 100, {"average_window": 0.5, "max_average_window": 100,
               "min_average_window": 50}),          # window full: roll
    (3, 16383, {"average_window": 0.5, "max_average_window": 10 ** 6,
                "min_average_window": 10 ** 5}),    # spill into sum_2
])
def test_average_accumulates_matches_jax(num_acc, num_upd, attrs):
    inputs = _avg_inputs(num_acc, 7, num_upd)
    _compare(_run_torch("average_accumulates", inputs, attrs),
             _run_jax("average_accumulates", inputs, attrs))


@pytest.mark.parametrize("grads,found,good,bad", [
    ("finite", False, 0, 0), ("finite", False, 2, 1),
    ("inf", True, 2, 0), ("nan", True, 0, 1), ("inf", True, 0, 0)])
def test_loss_scaling_ops_match_jax(grads, found, good, bad):
    rs = np.random.RandomState(9)
    xs = [_arr(rs) * 512, _arr(rs, shape=(5,)) * 512]
    if grads != "finite":
        xs[1][2] = np.inf if grads == "inf" else np.nan
    scale = np.float32(512.0)
    attrs = {"incr_every_n_steps": 3, "decr_every_n_nan_or_inf": 2,
             "incr_ratio": 2.0, "decr_ratio": 0.5}
    j_unscale = JaxOpInfoMap.instance().get("check_finite_and_unscale")
    t_unscale = OpInfoMap.instance().get("check_finite_and_unscale")
    jo = j_unscale.compute({"X": [jnp.asarray(x) for x in xs],
                            "Scale": [jnp.asarray(scale)]}, {})
    to = t_unscale.compute({"X": [torch.from_numpy(x) for x in xs],
                            "Scale": [torch.tensor(scale)]}, {})
    assert bool(to["FoundInfinite"][0]) == bool(jo["FoundInfinite"][0]) \
        == found
    for x, y in zip(to["Out"], jo["Out"]):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), **F32_TOL)
    upd_in = {"FoundInfinite": np.asarray(found),
              "PrevLossScaling": np.asarray(scale),
              "InGoodSteps": np.asarray(good, np.int32),
              "InBadSteps": np.asarray(bad, np.int32)}
    j_upd = JaxOpInfoMap.instance().get("update_loss_scaling").compute(
        dict({k: [jnp.asarray(v)] for k, v in upd_in.items()},
             X=list(jo["Out"])), attrs)
    t_upd = OpInfoMap.instance().get("update_loss_scaling").compute(
        dict({k: [torch.from_numpy(np.asarray(v))]
              for k, v in upd_in.items()}, X=list(to["Out"])), attrs)
    for slot in ("LossScaling", "OutGoodSteps", "OutBadSteps"):
        x, y = t_upd[slot][0], np.asarray(j_upd[slot][0])
        assert str(x.dtype).split(".")[-1] == str(y.dtype), slot
        assert x.item() == y.item(), slot
    for x, y in zip(t_upd["Out"], j_upd["Out"]):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), **F32_TOL)
    assert all(not x.any() for x in t_upd["Out"]) == found


def _grads(seed, n=3):
    rs = np.random.RandomState(seed)
    return [rs.randn(4, 6).astype(np.float32) * s for s in (1.0, 5.0, 0.1)][:n]


@pytest.mark.parametrize("name,arg", [
    ("ClipGradByGlobalNorm", 1.0), ("ClipGradByGlobalNorm", 100.0),
    ("ClipGradByNorm", 2.0), ("ClipGradByValue", 0.5)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_clip_matches_jax(name, arg, dtype):
    gs = [np.asarray(jnp.asarray(g, dtype)) for g in _grads(1)]
    want = getattr(jopt, name)(arg).apply([jnp.asarray(g) for g in gs])
    got = getattr(clip, name)(arg).apply([to_tensor(g) for g in gs])
    _compare({"g": got}, {"g": [np.asarray(w) for w in want]},
             dtype == "bfloat16")
    assert clip.GradientClipByGlobalNorm is topt.ClipGradByGlobalNorm


def test_l2_decay_and_1x_spellings_match_jax():
    rs = np.random.RandomState(2)
    pv, gv = _arr(rs), _arr(rs)
    j = jopt.SGD(learning_rate=0.1, weight_decay=0.05)
    want, _ = j.functional_step({"w": jnp.asarray(pv)}, {"w": jnp.asarray(gv)},
                                {"w": {}}, jnp.float32(0.1))
    for t in (topt.SGD(learning_rate=0.1, weight_decay=0.05),
              topt.SGD(learning_rate=0.1,
                       regularization=regularizer.L2DecayRegularizer(
                           regularization_coeff=0.05)),
              topt.SGDOptimizer(learning_rate=0.1,
                                weight_decay=regularizer.L2Decay(0.05))):
        got, _ = t.functional_step({"w": torch.from_numpy(pv)},
                                   {"w": torch.from_numpy(gv)}, {"w": {}},
                                   torch.tensor(0.1))
        np.testing.assert_allclose(got["w"].numpy(), np.asarray(want["w"]),
                                   **F32_TOL)


SCHEDULERS = [
    ("NoamDecay", dict(d_model=64, warmup_steps=4, learning_rate=1.0)),
    ("PiecewiseDecay", dict(boundaries=[3, 6], values=[1.0, 0.5, 0.1])),
    ("ExponentialDecay", dict(learning_rate=0.5, gamma=0.9)),
    ("NaturalExpDecay", dict(learning_rate=0.5, gamma=0.3)),
    ("InverseTimeDecay", dict(learning_rate=0.5, gamma=0.3)),
    ("PolynomialDecay", dict(learning_rate=0.5, decay_steps=5,
                             end_lr=0.01, power=2.0)),
    ("PolynomialDecay", dict(learning_rate=0.5, decay_steps=3,
                             end_lr=0.01, cycle=True)),
    ("CosineAnnealingDecay", dict(learning_rate=0.5, T_max=5)),
    ("StepDecay", dict(learning_rate=0.5, step_size=3, gamma=0.5)),
    ("MultiStepDecay", dict(learning_rate=0.5, milestones=[2, 5],
                            gamma=0.5)),
    ("LambdaDecay", dict(learning_rate=0.5,
                         lr_lambda=lambda e: 0.9 ** e)),
]


@pytest.mark.parametrize("name,kw", SCHEDULERS,
                         ids=[f"{n}-{i}" for i, (n, _) in
                              enumerate(SCHEDULERS)])
def test_scheduler_trajectory_matches_jax(name, kw):
    j = getattr(jopt.lr_sched, name)(**kw)
    t = getattr(topt.lr_sched, name)(**kw)
    traj = []
    for _ in range(10):
        traj.append((t(), j()))
        t.step()
        j.step()
    assert [a for a, _ in traj] == [b for _, b in traj]
    assert len({a for a, _ in traj}) > 1


def test_warmup_plateau_and_1x_adapters_match_jax():
    pairs = [
        (topt.lr_sched.LinearWarmup(topt.lr_sched.PolynomialDecay(
            1e-4, 1000, 0.0), 10, 0.0, 1e-4),
         jopt.lr_sched.LinearWarmup(jopt.lr_sched.PolynomialDecay(
             1e-4, 1000, 0.0), 10, 0.0, 1e-4)),
        (topt.lr_sched.LinearWarmup(0.5, 4, 0.1, 0.5),
         jopt.lr_sched.LinearWarmup(0.5, 4, 0.1, 0.5)),
        (topt.ExponentialDecay(0.5, 3, 0.5, staircase=True),
         jopt.ExponentialDecay(0.5, 3, 0.5, staircase=True)),
        (topt.NaturalExpDecay(0.5, 3, 0.5), jopt.NaturalExpDecay(0.5, 3, 0.5)),
        (topt.InverseTimeDecay(0.5, 3, 0.5),
         jopt.InverseTimeDecay(0.5, 3, 0.5)),
        (topt.CosineDecay(0.5, 2, 5), jopt.CosineDecay(0.5, 2, 5)),
    ]
    for t, j in pairs:
        for _ in range(14):
            assert t() == j()
            t.step()
            j.step()
    t = topt.ReduceLROnPlateau(1.0, patience=1, decay_rate=0.5)
    j = jopt.ReduceLROnPlateau(1.0, patience=1, decay_rate=0.5)
    for loss in (3.0, 2.0, 2.5, 2.6, 2.7, 1.0, 1.5, 1.6):
        t.step(loss)
        j.step(loss)
        assert t() == j()
    assert t() < 1.0


def _linear_pair(seed=0):
    jpt.seed(seed)
    jm = JaxLinear(16, 8)
    tpt.set_device("cpu")
    tm = load_state_dict(Linear(16, 8), {k: v.numpy() for k, v in
                                         jm.state_dict().items()})
    return jm, tm


# masters after 3 steps of a bf16 forward: both sides take the same bf16
# matmul, but sum its cotangents in other orders, and Adam and Lamb scale
# any gradient element to about lr; 2**-7 of each element or 2e-4 (a
# fiftieth of lr) absolute
EAGER_TOL = dict(rtol=2.0 ** -7, atol=2e-4)


def _loss_jax(m, x):
    y = m(jpt.to_tensor(x))
    return (y * y).mean()


def _loss_torch(m, x):
    y = m(torch.from_numpy(x))
    return (y.float() * y.float()).mean()


@pytest.mark.parametrize("kind", ["AdamW", "Momentum", "Lamb"])
def test_eager_step_with_masters_matches_jax(kind):
    """bf16 parameters (amp.decorate at O2), fp32 masters, the update on
    the master, global-norm clip binding: three eager steps."""
    jm, tm = _linear_pair()
    start = {n: p.detach().clone() for n, p in tm.named_parameters()}
    kw = {"AdamW": dict(weight_decay=0.01),
          "Momentum": dict(momentum=0.9, weight_decay=0.01),
          "Lamb": dict(lamb_weight_decay=0.01)}[kind]
    jo = getattr(jopt, kind)(learning_rate=1e-2, parameters=jm.parameters(),
                             grad_clip=jopt.ClipGradByGlobalNorm(0.5), **kw)
    to = getattr(topt, kind)(learning_rate=1e-2, parameters=tm.parameters(),
                             grad_clip=topt.ClipGradByGlobalNorm(0.5), **kw)
    jm, jo = jamp.decorate(jm, jo, level="O2")
    tm, to = amp.decorate(tm, to, level="O2")
    rs = np.random.RandomState(1)
    for _ in range(3):
        x = rs.randn(4, 16).astype(np.float32)
        with jamp.auto_cast(level="O2"):
            loss = _loss_jax(jm, x)
        loss.backward()
        jo.step()
        jo.clear_grad()
        with amp.auto_cast(level="O2"):
            loss = _loss_torch(tm, x)
        loss.backward()
        to.step()
        to.clear_grad()
    jp = dict(jm.named_parameters())
    for i, (name, p) in enumerate(tm.named_parameters()):
        assert p.dtype == torch.bfloat16
        master = to.state_dict()[f"param_{i}.master_weight"]
        assert master.dtype == torch.float32
        want = np.asarray(jo._masters[jp[name].name])
        np.testing.assert_allclose(master.numpy(), want, err_msg=name,
                                   **EAGER_TOL)
        np.testing.assert_allclose(p.detach().float().numpy(),
                                   np.asarray(jp[name]._value, np.float32),
                                   err_msg=name, rtol=2.0 ** -7, atol=1e-3)
        assert not torch.equal(master, start[name])
    assert to._global_step == jo._global_step == 3


def test_optimizer_state_dict_round_trip():
    _, tm = _linear_pair()
    sched = topt.lr_sched.StepDecay(0.1, step_size=1, gamma=0.5)
    opt = topt.Adam(learning_rate=sched, parameters=tm.parameters(),
                    multi_precision=True)
    amp.decorate(tm, level="O2")
    x = np.random.RandomState(3).randn(4, 16).astype(np.float32)
    with amp.auto_cast(level="O2"):
        _loss_torch(tm, x).backward()
    opt.step()
    sched.step()
    state = opt.state_dict()
    assert set(state) == {"global_step", "LR_Scheduler"} | {
        f"param_{i}.{k}" for i in range(2) for k in
        ("Moment1", "Moment2", "Beta1Pow", "Beta2Pow", "master_weight")}
    saved = {n: p.detach().clone() for n, p in tm.named_parameters()}

    def resume():
        for n, p in tm.named_parameters():
            p.data = saved[n].clone()
            p.grad = None
        s = topt.lr_sched.StepDecay(0.1, step_size=1, gamma=0.5)
        o = topt.Adam(learning_rate=s, parameters=tm.parameters(),
                      multi_precision=True)
        o.set_state_dict(state)
        with amp.auto_cast(level="O2"):
            _loss_torch(tm, x).backward()
        o.step()
        o.clear_grad()
        return o, {n: p.detach().clone() for n, p in tm.named_parameters()}

    o1, after1 = resume()
    o2, after2 = resume()
    assert o1.get_lr() == 0.05 and o1._global_step == 2
    for n in after1:
        assert torch.equal(after1[n], after2[n])
        assert not torch.equal(after1[n], saved[n])
    assert torch.equal(o1.state_dict()["param_0.Moment1"],
                       o2.state_dict()["param_0.Moment1"])


def test_set_lr_and_scheduler_guard():
    _, tm = _linear_pair()
    opt = topt.SGD(learning_rate=0.1, parameters=tm.parameters())
    opt.set_lr(0.2)
    assert opt.get_lr() == 0.2
    lr = opt.lr_tensor("cpu")
    assert lr.dtype == torch.float32 and lr.ndim == 0
    opt.set_lr(0.3)
    assert opt.lr_tensor("cpu") is lr and lr.item() == pytest.approx(0.3)
    sched = topt.Adam(learning_rate=topt.lr_sched.StepDecay(0.1, 1),
                      parameters=tm.parameters())
    with pytest.raises(Exception):
        sched.set_lr(0.2)
