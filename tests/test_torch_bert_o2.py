"""BERT-tiny pretraining at AMP O2 through the port's TrainStep against the
JAX package's: ``amp.decorate(model, opt, level="O2")`` (bf16 parameters,
fp32 masters), AdamW with LinearWarmup(PolynomialDecay), a global-norm
clip that binds and weight decay; and Lamb.

Weights are drawn by the JAX model and carried across with
``convert.load_state_dict``; the batch comes from numpy with a seed. The
JAX step runs with buffer donation off (its model lists the tied decoder
weight under two names, and donating one buffer twice fails on the CPU).
The head dim is 64, so the port's attention takes K1-K3's route (their
plain versions on the CPU).

Tolerances. Losses at rtol 4e-3 (one bf16 ulp), as at O1. The forward
and backward run in bf16 in both, but round at other places (XLA on the
CPU carries fused bf16 chains in fp32; torch rounds each operation, and
sums a tensor's cotangents in fp32), so gradients differ by about a bf16
ulp. Adam and Lamb divide each moment by its own root, so a gradient
element that is rounding noise still moves its parameter by about lr:
parameters are compared by the norm of their update error,
||master - jax master|| / ||jax master - start||, at 2**-2 (measured:
AdamW 6.3% worst, 3.0% median; Lamb 14.3% worst, on a query bias that
starts at 0, where Lamb's trust ratio is 1 and the step is lr times the
noisy direction, 1.7% median; a wrong gradient reads near 1 and more, a
missing master or a skipped update 1). The first moments are held at 2**-3 of
their norm (measured below 6%). One parameter is left out of both:
the key bias, whose exact gradient is 0 (a softmax does not move when
every score of a row shifts by the same q.b), so both steps move it by
rounding noise scaled to lr; it is held to its dtype and to moving no
more than the sum of the learning rates.
"""
import jax
import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu.optimizer as jopt
from paddle_tpu import amp as jamp
from paddle_tpu.core.registry import OpInfoMap as JaxOpInfoMap
from paddle_tpu.jit import TrainStep as JaxTrainStep
from paddle_tpu.text import models as jmodels
from paddle_tpu.text.models import BertForPretraining as JaxBert

import paddle_tpu_torch as tpt
import paddle_tpu_torch.optimizer as topt
from paddle_tpu_torch import amp
from paddle_tpu_torch.convert import load_state_dict, load_train_state
from paddle_tpu_torch.core.registry import OpInfoMap
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.text import models as tmodels
from paddle_tpu_torch.text.models import BertForPretraining

TINY = dict(vocab_size=512, d_model=128, num_layers=2, nhead=2, d_ffn=256,
            dropout=0.0)
LOSS_TOL = dict(rtol=4e-3, atol=1e-5)
UPDATE_TOL = 2.0 ** -2
MOMENT_TOL = 2.0 ** -3
CLIP = 0.5
ZERO_GRAD = ".self_attn.k_bias"
F32_TOL = dict(rtol=1e-4, atol=2e-5)


class _JaxTrainStep(JaxTrainStep):
    def _build_jit(self, pv, bv, raw_args):
        return jax.jit(self._step)


def _step_fn(m, ids, labels, nsp):
    return m(ids, masked_lm_labels=labels, next_sentence_label=nsp)


def _batch(seed=0, seq=32):
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, TINY["vocab_size"], (2, seq)).astype(np.int32)
    labels = np.where(rs.rand(2, seq) < 0.15, ids, -1).astype(np.int32)
    labels[:, 0] = ids[:, 0]
    nsp = rs.randint(0, 2, (2, 1)).astype(np.int32)
    return ids, labels, nsp


def _models():
    jpt.seed(0)
    jm = JaxBert(**TINY)
    state = {k: v.numpy() for k, v in jm.state_dict().items()}
    tpt.set_device("cpu")
    tm = load_state_dict(BertForPretraining(**TINY), state)
    return jm, tm, state


def _sched(pkg):
    lr = pkg.lr_sched
    return lr.LinearWarmup(lr.PolynomialDecay(1e-2, 10, 0.0), 2, 2e-3, 1e-2)


def _opt(pkg, kind, model, clip=CLIP, **kw):
    sched = _sched(pkg)
    grad_clip = pkg.ClipGradByGlobalNorm(clip)
    if kind == "adamw":
        opt = pkg.AdamW(learning_rate=sched, weight_decay=0.01,
                        grad_clip=grad_clip, parameters=model.parameters(),
                        **kw)
    elif kind == "lamb":
        opt = pkg.Lamb(learning_rate=sched, lamb_weight_decay=0.01,
                       grad_clip=grad_clip, parameters=model.parameters(),
                       **kw)
    else:
        opt = pkg.SGD(learning_rate=sched, grad_clip=grad_clip,
                      parameters=model.parameters(), **kw)
    return opt, sched


def _o2_pair(kind, master_weight=None):
    jm, tm, start = _models()
    jo, js = _opt(jopt, kind, jm)
    to, ts = _opt(topt, kind, tm)
    jm, jo = jamp.decorate(jm, jo, level="O2", master_weight=master_weight)
    tm, to = amp.decorate(tm, to, level="O2", master_weight=master_weight)
    return (_JaxTrainStep(jm, _step_fn, jo, amp_level="O2"), js,
            TrainStep(tm, _step_fn, to, amp_level="O2"), ts, start)


def _run(step, sched, batch, n):
    losses = []
    for _ in range(n):
        out = step(*batch)
        losses.append(float(out) if isinstance(out, torch.Tensor)
                      else float(out.numpy()))
        sched.step()
    return losses


def _lrs(n):
    sched = _sched(topt)
    out = []
    for _ in range(n):
        out.append(sched())
        sched.step()
    return out


def _np(x):
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) \
        else x.detach().float().cpu().numpy()


def _update_error(got, want, start):
    return float(np.linalg.norm(_np(got) - _np(want)) /
                 max(np.linalg.norm(_np(want) - start), 1e-12))


def _check_o2_state(j_step, t_step, start, steps):
    jsd = j_step.state_dict()
    assert set(jsd["params"]) == set(t_step._params) | set(t_step.aliases)
    assert t_step.aliases == {"cls.decoder_weight":
                              "bert.embeddings.word.weight"}
    errs, moment_errs = {}, {}
    for name, p in t_step._params.items():
        assert p.dtype == torch.bfloat16, name
        assert str(jsd["params"][name].dtype) == "bfloat16", name
        master = t_step._masters[name]
        assert master.dtype == torch.float32, name
        assert str(jsd["masters"][name].dtype) == "float32", name
        np.testing.assert_array_equal(_np(p), _np(master.to(torch.bfloat16)))
        for k, v in t_step._opt_states[name].items():
            assert str(v.dtype).split(".")[-1] == \
                str(jsd["opt_states"][name][k].dtype), (name, k)
        if name.endswith(ZERO_GRAD):
            assert np.abs(_np(master) - start[name]).max() <= \
                2 * sum(_lrs(steps)), name
            continue
        errs[name] = _update_error(master, jsd["masters"][name], start[name])
        m1, jm1 = (t_step._opt_states[name]["Moment1"],
                   _np(jsd["opt_states"][name]["Moment1"]))
        moment_errs[name] = float(np.linalg.norm(_np(m1) - jm1) /
                                  max(np.linalg.norm(jm1), 1e-12))
    worst = max(errs, key=errs.get)
    worst_m = max(moment_errs, key=moment_errs.get)
    print(f"update error worst {errs[worst]:.4f} ({worst}), median "
          f"{sorted(errs.values())[len(errs) // 2]:.4f}; first moment "
          f"worst {moment_errs[worst_m]:.4f} ({worst_m})")
    assert errs[worst] <= UPDATE_TOL, (worst, errs[worst])
    assert moment_errs[worst_m] <= MOMENT_TOL, (worst_m, moment_errs[worst_m])
    for k in ("Beta1Pow", "Beta2Pow"):
        if k in jsd["opt_states"][worst]:
            np.testing.assert_allclose(
                _np(t_step._opt_states[worst][k]),
                _np(jsd["opt_states"][worst][k]), rtol=1e-6)


def _global_norm(step):
    """The global gradient norm the port's clip sees: the tied weight's
    gradient once a name."""
    grads = [step._params[c].grad for c in step._names.values()]
    return float(torch.sqrt(sum(torch.sum(torch.square(g.float()))
                                for g in grads if g is not None)))


@pytest.mark.parametrize("kind", ["adamw", "lamb"])
def test_o2_train_step_matches_jax(kind):
    j_step, js, t_step, ts, start = _o2_pair(kind)
    batch = _batch()
    j_loss = _run(j_step, js, batch, 3)
    t_loss = _run(t_step, ts, batch, 3)
    np.testing.assert_allclose(t_loss, j_loss, **LOSS_TOL)
    assert len(set(j_loss)) == 3
    assert _global_norm(t_step) > CLIP          # the clip binds
    _check_o2_state(j_step, t_step, start, 3)


def test_o2_attention_inputs_are_bfloat16_in_both(monkeypatch):
    """Under O2 every parameter is bf16, so the bias add after each q, k
    and v matmul stays bf16 and the flash kernels get bf16 inputs (under
    O1 they get fp32)."""
    seen = {"jax": [], "torch": []}
    for key, opmap in (("jax", JaxOpInfoMap), ("torch", OpInfoMap)):
        opdef = opmap.instance().get("flash_attention")
        real = opdef.compute

        def spy(inputs, attrs, _real=real, _key=key):
            seen[_key].append(tuple(str(inputs[s][0].dtype).split(".")[-1]
                                    for s in ("Q", "K", "V")))
            return _real(inputs, attrs)
        monkeypatch.setattr(opdef, "compute", spy)
    j_step, _, t_step, _, _ = _o2_pair("adamw")
    batch = _batch()
    j_step(*batch)
    t_step(*batch)
    assert seen["jax"] == [("bfloat16",) * 3] * TINY["num_layers"]
    assert seen["torch"] == seen["jax"]


@pytest.mark.parametrize("kind", ["sgd", "adamw"])
def test_o2_without_masters_matches_jax_dtypes(kind):
    """decorate(master_weight=False): no masters, and the update runs on
    the bf16 parameter. JAX promotes it against the fp32 learning rate,
    so the parameter comes back fp32 from the op and the step installs
    it; the port does the same. Values by update error, as above."""
    j_step, js, t_step, ts, start = _o2_pair(kind, master_weight=False)
    batch = _batch()
    _run(j_step, js, batch, 2)
    _run(t_step, ts, batch, 2)
    jsd = j_step.state_dict()
    assert not t_step._masters and "masters" not in jsd
    dtypes = {}
    for name, p in t_step._params.items():
        want = jsd["params"][name]
        dtypes[name] = str(want.dtype)
        assert str(p.dtype).split(".")[-1] == str(want.dtype), name
        for k, v in t_step._opt_states[name].items():
            assert str(v.dtype).split(".")[-1] == \
                str(jsd["opt_states"][name][k].dtype), (name, k)
        if not name.endswith(ZERO_GRAD):
            err = _update_error(p, want, start[name])
            assert err <= UPDATE_TOL, (name, err)
    # every parameter a gradient reaches comes back fp32; the token type
    # embedding (no token_type_ids) gets none and stays bf16, in both
    assert {n for n, d in dtypes.items() if d != "float32"} == {
        "bert.embeddings.token_type.weight"}


def test_jax_train_state_carried_into_port_gives_the_same_next_steps():
    j_step, js, t_step, ts, start = _o2_pair("adamw")
    batch, later = _batch(0), _batch(1)
    _run(j_step, js, batch, 1)
    ts.step()                              # the schedule is at step 1 too
    load_train_state(t_step, jax.tree_util.tree_map(np.asarray,
                                                    j_step.state_dict()))
    assert t_step._step_count == 1
    for name, p in t_step._params.items():
        np.testing.assert_array_equal(
            _np(p), _np(j_step.state_dict()["params"][name]))
        np.testing.assert_array_equal(
            _np(t_step._masters[name]),
            _np(j_step.state_dict()["masters"][name]))
    j_loss = _run(j_step, js, later, 2)
    t_loss = _run(t_step, ts, later, 2)
    np.testing.assert_allclose(t_loss, j_loss, **LOSS_TOL)
    _check_o2_state(j_step, t_step, start, 3)


def test_train_state_round_trip_in_the_port():
    _, _, t_step, ts, _ = _o2_pair("lamb")
    batch = _batch()
    _run(t_step, ts, batch, 1)
    saved = t_step.state_dict()
    sched = ts.state_dict()
    after = _run(t_step, ts, batch, 1)
    t_step.set_state_dict(saved)
    ts.set_state_dict(sched)
    assert t_step._step_count == 1
    assert _run(t_step, ts, batch, 1) == after
    assert t_step._step_count == 2


def test_global_norm_clip_counts_the_tied_weight_under_each_name():
    """fp32 (O0) SGD with a binding global-norm clip, where the clip
    scales the update itself: the reference's step counts the tied
    decoder weight's gradient under each of its two names (here a third
    of the squared norm), and the port's updates match it within 1e-3 of
    their norm (fp32; measured about 1e-6); counted once, every update
    would be 21% larger."""
    jm, tm, _ = _models()
    jo, js = _opt(jopt, "sgd", jm, clip=0.05)
    to, ts = _opt(topt, "sgd", tm, clip=0.05)
    j_step = _JaxTrainStep(jm, _step_fn, jo, amp_level="O0")
    t_step = TrainStep(tm, _step_fn, to, amp_level="O0")
    once = TrainStep(load_state_dict(BertForPretraining(**TINY),
                                     {k: v.numpy() for k, v in
                                      jm.state_dict().items()}),
                     _step_fn, _opt(topt, "sgd", tm, clip=0.05)[0])
    once._names = {n: c for n, c in once._names.items() if n == c}
    once._opt._params = list(once._model.parameters())
    start = {k: v.numpy() for k, v in jm.state_dict().items()}
    batch = _batch()
    _run(j_step, js, batch, 1)
    _run(t_step, ts, batch, 1)
    once(*batch)
    assert _global_norm(t_step) > 0.05
    want = {k: v.numpy() for k, v in jm.state_dict().items()}
    errs = {n: _update_error(p, want[n], start[n])
            for n, p in t_step._params.items()
            if not np.array_equal(want[n], start[n])
            and not n.endswith(ZERO_GRAD)}
    assert len(errs) == len(t_step._params) - 1 - TINY["num_layers"]
    assert max(errs.values()) <= 1e-3, max(errs.items(), key=lambda kv:
                                           kv[1])
    w = "bert.encoder.layer_0.linear1.weight"
    assert _update_error(once._params[w], want[w], start[w]) > 0.1


def test_ernie_base_factory_matches_jax():
    kw = dict(d_model=32, num_layers=1, nhead=2, d_ffn=64, dropout=0.0)
    jpt.seed(0)
    j = jmodels.ernie_base(**kw)
    tpt.set_device("cpu")
    t = tmodels.ernie_base(**kw)
    assert t.vocab_size == j.vocab_size == 18000
    assert {k: tuple(v.shape) for k, v in t.state_dict().items()} == \
        {k: tuple(v.shape) for k, v in j.state_dict().items()}
    assert tmodels.ernie_base(vocab_size=100, **kw).vocab_size == 100
