"""gpt_tiny through the port against the JAX package, on the CPU.

Weights are drawn by the JAX model and carried across with
``convert.load_state_dict`` (or ``load_train_state`` for a whole
TrainStep state); token ids come from numpy with a seed; dropout is 0.
The head dim is 32, so the port's attention takes K1-K3's route (their
plain versions on the CPU), and the cached decode steps its q_offset
route, as in the reference.

Tolerances. fp32 (O0): logits and losses at rtol 1e-5 / atol 2e-5,
gradients within 1e-4 of each parameter's largest element (measured
some 1e-6; the two frameworks sum in other orders), the parameters
after two AdamW steps at lr 1e-3 at rtol 1e-4 / atol 1e-4, a twentieth
of the two steps' lr (Adam divides each gradient element by the root of
its second moment, so an element near rounding noise moves by a share
of lr that the noise decides: measured 3.3e-5 on one element of 16,384;
a wrong gradient moves elements by up to 2e-3). The key biases have an exact
gradient of 0 (a softmax does not move when every score of a row shifts
by the same q.b): their gradients are held to 1e-5 of the largest one,
and since Adam scales that rounding noise to about lr, their values
after the steps to moving no more than lr a step.
O2 (bf16 parameters, fp32 masters), as tests/test_torch_bert_o2.py:
losses at rtol 4e-3 (one bf16 ulp), the masters by the norm of their
update error at 2**-2 and the first moments at 2**-3 of their norm (XLA
and torch round bf16 chains at other places, and Adam scales a rounding
noise gradient element to about lr), the key biases left out. The
cached decode at rtol 1e-5 / atol 2e-5 against the JAX package's
cached blocks and against the uncached forward.
"""
import jax
import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu.optimizer as jopt
from paddle_tpu import amp as jamp
from paddle_tpu.dygraph.tracer import trace_op as jax_trace_op
from paddle_tpu.jit import TrainStep as JaxTrainStep
from paddle_tpu.text import gpt_tiny as jax_gpt_tiny
from paddle_tpu.text import models as jmodels

import chip_smoke
import paddle_tpu_torch as tpt
import paddle_tpu_torch.optimizer as topt
from paddle_tpu_torch import amp, text
from paddle_tpu_torch.convert import load_state_dict, load_train_state
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.text import models as tmodels

VOCAB, SEQ, BATCH = 1024, 32, 2
F32_TOL = dict(rtol=1e-5, atol=2e-5)
GRAD_TOL = 1e-4
ZERO_GRAD_TOL = 1e-5
PARAM_TOL = dict(rtol=1e-4, atol=1e-4)
O2_LOSS_TOL = dict(rtol=4e-3, atol=1e-5)
UPDATE_TOL = 2.0 ** -2
MOMENT_TOL = 2.0 ** -3
ZERO_GRAD = ".attn.k_bias"


class _JaxTrainStep(JaxTrainStep):
    """Buffer donation off, as the port's other parity tests run it."""

    def _build_jit(self, pv, bv, raw_args):
        return jax.jit(self._step)


def _step_fn(m, ids):
    return m(ids, labels=ids)[1]


def _ids(seed=0, seq=SEQ):
    rs = np.random.RandomState(seed)
    return rs.randint(0, VOCAB, (BATCH, seq)).astype(np.int32)


def _models(**kw):
    jpt.seed(0)
    jm = jax_gpt_tiny(**kw)
    state = {k: v.numpy() for k, v in jm.state_dict().items()}
    tpt.set_device("cpu")
    tm = load_state_dict(tmodels.gpt_tiny(**kw), state)
    return jm, tm, state


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def _rel(got, want):
    return float(np.abs(_np(got) - _np(want)).max()) / max(
        float(np.abs(_np(want)).max()), 1e-12)


def test_text_exports():
    for name in ("GPTModel", "GPTForCausalLM", "gpt_tiny", "gpt2_small",
                 "gpt3_1p3b"):
        assert getattr(text, name) is getattr(tmodels, name)


@pytest.mark.parametrize("factory", ["gpt_tiny", "gpt2_small",
                                     "gpt3_1p3b"])
def test_factories_build_what_the_reference_builds(factory, monkeypatch):
    """Each factory's arguments, caught before any weight is drawn (the
    1.3B model is too large for a CPU test)."""
    seen = {}
    for key, mod in (("jax", jmodels), ("torch", tmodels)):
        monkeypatch.setattr(mod, "GPTForCausalLM",
                            lambda *a, _k=key, **kw: seen.setdefault(
                                _k, (a, kw)))
        getattr(mod, factory)(moe=True)
    assert seen["torch"] == seen["jax"]


def test_logits_loss_and_gradients_match():
    jm, tm, _ = _models()
    ids = _ids()
    j_logits, j_loss = jm(jpt.to_tensor(ids), labels=jpt.to_tensor(ids))
    t_logits, t_loss = tm(torch.from_numpy(ids),
                          labels=torch.from_numpy(ids))
    np.testing.assert_allclose(_np(t_logits), j_logits.numpy(), **F32_TOL)
    np.testing.assert_allclose(float(t_loss), float(j_loss.numpy()),
                               **F32_TOL)
    assert abs(float(t_loss) - np.log(VOCAB)) < 1.0
    j_loss.backward()
    t_loss.backward()
    j_grads = {n: p.gradient() for n, p in jm.named_parameters()}
    t_grads = {n: p.grad for n, p in tm.named_parameters()}
    assert set(t_grads) == set(j_grads) and len(t_grads) == 2 + 2 * 16 + 2
    top = max(float(np.abs(g).max()) for g in j_grads.values())
    for name, want in j_grads.items():
        if name.endswith(ZERO_GRAD):
            assert np.abs(_np(t_grads[name])).max() <= ZERO_GRAD_TOL * top
        else:
            assert _rel(t_grads[name], want) <= GRAD_TOL, name


def test_positions_are_made_on_the_device():
    _, tm, _ = _models()
    ids = torch.from_numpy(_ids())
    pos = torch.arange(SEQ).expand(BATCH, SEQ)
    with torch.no_grad():
        assert torch.equal(tm.gpt(ids), tm.gpt(ids, position_ids=pos))


def _o0_opt(pkg, model):
    return pkg.AdamW(learning_rate=1e-3, beta1=0.9, beta2=0.95,
                     epsilon=1e-8, weight_decay=0.1,
                     parameters=model.parameters())


def test_two_o0_adamw_steps_match_jax():
    jm, tm, _ = _models()
    j_step = _JaxTrainStep(jm, _step_fn, _o0_opt(jopt, jm), amp_level="O0")
    t_step = TrainStep(tm, _step_fn, _o0_opt(topt, tm), amp_level="O0")
    ids = _ids()
    j_loss = [float(j_step(ids).numpy()) for _ in range(2)]
    t_loss = [float(t_step(ids)) for _ in range(2)]
    np.testing.assert_allclose(t_loss, j_loss, **F32_TOL)
    assert j_loss[1] < j_loss[0]
    want = {k: v.numpy() for k, v in jm.state_dict().items()}
    for name, got in tm.state_dict().items():
        if name.endswith(ZERO_GRAD):
            assert np.abs(_np(got)).max() <= 2 * 1e-3, name
            continue
        np.testing.assert_allclose(_np(got), want[name], err_msg=name,
                                   **PARAM_TOL)


def _sched(pkg):
    """GPT-3's shape of schedule at a test's length: linear warm-up, then
    cosine decay to 10% of the peak."""
    lr = pkg.lr_sched
    return lr.LinearWarmup(lr.CosineAnnealingDecay(2e-3, 10, 2e-4), 2,
                           0.0, 2e-3)


def _o2_opt(pkg, model, sched):
    return pkg.AdamW(learning_rate=sched, beta1=0.9, beta2=0.95,
                     epsilon=1e-8, weight_decay=0.1,
                     grad_clip=pkg.ClipGradByGlobalNorm(1.0),
                     parameters=model.parameters())


def _o2_pair():
    jm, tm, start = _models()
    js, ts = _sched(jopt), _sched(topt)
    jm, jo = jamp.decorate(jm, _o2_opt(jopt, jm, js), level="O2")
    tm, to = amp.decorate(tm, _o2_opt(topt, tm, ts), level="O2")
    return (_JaxTrainStep(jm, _step_fn, jo, amp_level="O2"), js,
            TrainStep(tm, _step_fn, to, amp_level="O2"), ts, start)


def _run(step, sched, ids, n):
    out = []
    for _ in range(n):
        loss = step(ids)
        out.append(float(loss) if isinstance(loss, torch.Tensor)
                   else float(loss.numpy()))
        sched.step()
    return out


def _check_o2_state(j_step, t_step, start):
    jsd = j_step.state_dict()
    assert set(jsd["params"]) == set(t_step._params)
    assert not t_step.aliases
    errs, moment_errs = {}, {}
    for name, p in t_step._params.items():
        master = t_step._masters[name]
        assert p.dtype == torch.bfloat16 and master.dtype == torch.float32
        assert str(jsd["masters"][name].dtype) == "float32", name
        np.testing.assert_array_equal(_np(p), _np(master.to(torch.bfloat16)))
        if name.endswith(ZERO_GRAD):
            continue
        want = _np(jsd["masters"][name])
        errs[name] = float(np.linalg.norm(_np(master) - want) / max(
            np.linalg.norm(want - start[name]), 1e-12))
        m1 = _np(jsd["opt_states"][name]["Moment1"])
        moment_errs[name] = float(np.linalg.norm(
            _np(t_step._opt_states[name]["Moment1"]) - m1) / max(
                np.linalg.norm(m1), 1e-12))
    worst = max(errs, key=errs.get)
    worst_m = max(moment_errs, key=moment_errs.get)
    assert errs[worst] <= UPDATE_TOL, (worst, errs[worst])
    assert moment_errs[worst_m] <= MOMENT_TOL, (worst_m,
                                                moment_errs[worst_m])


def test_two_o2_bf16_steps_match_jax():
    """amp.decorate(level="O2") and TrainStep(amp_level="O2") take the
    GPT, whose LM head reads gpt.wte.weight itself (no tied name); the
    flash op gets bf16 q / k / v in both packages."""
    j_step, js, t_step, ts, start = _o2_pair()
    ids = _ids()
    launches = fa.flash_fwd.launches
    j_loss = _run(j_step, js, ids, 2)
    t_loss = _run(t_step, ts, ids, 2)
    np.testing.assert_allclose(t_loss, j_loss, **O2_LOSS_TOL)
    assert fa.flash_fwd.launches == launches     # plain versions on the CPU
    _check_o2_state(j_step, t_step, start)


def test_jax_train_state_carried_into_port():
    j_step, js, t_step, ts, start = _o2_pair()
    _run(j_step, js, _ids(0), 1)
    ts.step()
    load_train_state(t_step, jax.tree_util.tree_map(np.asarray,
                                                    j_step.state_dict()))
    assert t_step._step_count == 1
    jsd = j_step.state_dict()
    for name, p in t_step._params.items():
        np.testing.assert_array_equal(_np(p), _np(jsd["params"][name]))
        np.testing.assert_array_equal(_np(t_step._masters[name]),
                                      _np(jsd["masters"][name]))
    later = _ids(1)
    np.testing.assert_allclose(_run(t_step, ts, later, 1),
                               _run(j_step, js, later, 1), **O2_LOSS_TOL)
    _check_o2_state(j_step, t_step, start)


def test_moe_train_state_carries_expert_weights():
    """The MoE's 3-d expert weights and their optimizer slots cross by
    name like any other."""
    jpt.seed(0)
    jm = jax_gpt_tiny(moe=True, num_experts=4)
    j_step = _JaxTrainStep(jm, _step_fn, _o0_opt(jopt, jm), amp_level="O0")
    j_step(_ids())
    tpt.set_device("cpu")
    tm = tmodels.gpt_tiny(moe=True, num_experts=4)
    t_step = TrainStep(tm, _step_fn, _o0_opt(topt, tm), amp_level="O0")
    load_train_state(t_step, jax.tree_util.tree_map(np.asarray,
                                                    j_step.state_dict()))
    w1 = "gpt.blocks.1.mlp.w1"
    jsd = j_step.state_dict()
    assert tuple(t_step._params[w1].shape) == (4, 128, 512)
    np.testing.assert_array_equal(_np(t_step._params[w1]),
                                  _np(jsd["params"][w1]))
    np.testing.assert_array_equal(
        _np(t_step._opt_states[w1]["Moment2"]),
        _np(jsd["opt_states"][w1]["Moment2"]))
    later = _ids(1)
    np.testing.assert_allclose(float(t_step(later)),
                               float(j_step(later).numpy()), **F32_TOL)


def _jax_decode(model, ids, prompt):
    """Logits [B, S, V] of a cached decode through the JAX package's
    blocks, as chip_smoke.gpt_cached_logits runs the port's: a prompt of
    ``prompt`` tokens with fresh caches, then one token at a time."""
    gpt = model.gpt
    caches = [blk.attn.Cache(k=None, v=None) for blk in gpt.blocks]
    pos = np.arange(ids.shape[1], dtype=np.int64)[None].repeat(
        ids.shape[0], 0)
    outs = []
    spans = [(0, prompt)] + [(t, t + 1) for t in range(prompt,
                                                       ids.shape[1])]
    for a, b in spans:
        x = gpt.wte(jpt.to_tensor(ids[:, a:b])) + \
            gpt.wpe(jpt.to_tensor(pos[:, a:b]))
        for i, blk in enumerate(gpt.blocks):
            x, caches[i] = blk(x, cache=caches[i])
        outs.append(jax_trace_op("matmul_v2", {"X": [gpt.ln_f(x)],
                                               "Y": [gpt.wte.weight]},
                                 {"trans_y": True},
                                 out_slots=["Out"])[0].numpy())
    return np.concatenate(outs, 1)


def test_cached_decode_matches_jax_and_uncached():
    jm, tm, _ = _models()
    ids = _ids(2, seq=24)
    want = _jax_decode(jm, ids, 16)
    calls = fa.blockwise_route.calls
    with torch.no_grad():
        got = chip_smoke.gpt_cached_logits(tm, torch.from_numpy(ids),
                                           16).numpy()
        full = tm(torch.from_numpy(ids)).numpy()
    # 8 decode steps x 2 blocks on the q_offset route; the prompt not
    assert fa.blockwise_route.calls == calls + 8 * 2
    np.testing.assert_allclose(got, want, **F32_TOL)
    np.testing.assert_allclose(got, full, **F32_TOL)
