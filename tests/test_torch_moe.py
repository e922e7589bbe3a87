"""The port's moe_ffn op, MoELayer and gpt_tiny(moe=True) against the
JAX package's, on the CPU.

The op runs on both sides from the same numpy inputs (made with a seed):
Out, AuxLoss, and the gradients of every input (X, GateW, W1, B1, W2,
B2) of sum(Out * G) + 0.3 * AuxLoss, by jax.value_and_grad on the JAX
op and torch autograd on the port's. Cases: the three activations (gelu
is jax.nn.gelu's tanh form), norm_topk_prob on and off, a capacity
factor small enough that tokens are dropped, ties in the gate (two equal
gate columns, and zero tokens whose gates all tie), and bf16 inputs (as
O2 feeds the op).

Tolerances. fp32: Out and AuxLoss at rtol 1e-5 / atol 1e-6, gradients
within 2e-4 of the gradient's largest element (the einsums sum in other
orders; measured some 1e-7, and up to 9.4e-5 on GateW at top_k 1, where
norm_topk_prob makes each combine weight gate / gate: its gradient is 0
up to rounding, and GateW's is then the aux loss's alone, small beside
that noise). bf16: xin, the activation and Out are
rounded to bf16 on both sides, so an element can land one bf16 ulp
(2**-8 of its size) apart: Out and the gradients within 2**-6 of their
largest element, AuxLoss (fp32 from fp32 gates) at rtol 1e-5. A wrong
expert choice, capacity or combine weight moves whole tokens, O(1).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpt
from paddle_tpu.core.registry import OpInfoMap as JaxOpInfoMap
from paddle_tpu.distributed.moe import MoELayer as JaxMoELayer
from paddle_tpu.text import gpt_tiny as jax_gpt_tiny

import paddle_tpu_torch as tpt
from paddle_tpu_torch.convert import load_state_dict, to_tensor
from paddle_tpu_torch.core.registry import OpInfoMap
from paddle_tpu_torch.distributed import MoELayer
from paddle_tpu_torch.text import gpt_tiny

SLOTS = ("X", "GateW", "W1", "B1", "W2", "B2")
AUX_W = 0.3
F32_TOL = dict(rtol=1e-5, atol=1e-6)
F32_GRAD = 2e-4
BF16_REL = 2.0 ** -6


def _inputs(seed, b=2, s=12, d=16, e=4, f=24, dtype=np.float32,
            tie=False):
    rs = np.random.RandomState(seed)
    x = rs.randn(b, s, d)
    gate = rs.randn(d, e) * 0.5
    if tie:
        gate[:, 2] = gate[:, 1]            # experts 1 and 2 always tie
        x[0, :3] = 0.0                     # every gate of these ties
    arrs = [x, gate, rs.randn(e, d, f) * 0.3, rs.randn(e, f) * 0.1,
            rs.randn(e, f, d) * 0.3, rs.randn(e, d) * 0.1]
    g = rs.randn(b, s, d).astype(np.float32)
    arrs = [a.astype(np.float32) for a in arrs]
    if dtype == "bfloat16":
        arrs = [np.asarray(jnp.asarray(a, jnp.bfloat16)) for a in arrs]
    return arrs, g


def _jax(arrs, attrs, g):
    op = JaxOpInfoMap.instance().get("moe_ffn").compute

    def f(*xs):
        outs = op({s: [x] for s, x in zip(SLOTS, xs)}, attrs)
        out, aux = outs["Out"][0], outs["AuxLoss"][0]
        return jnp.sum(out.astype(jnp.float32) * g) + AUX_W * aux, (out, aux)
    (_, (out, aux)), grads = jax.value_and_grad(
        f, argnums=tuple(range(6)), has_aux=True)(
            *[jnp.asarray(a) for a in arrs])
    return (np.asarray(out.astype(jnp.float32)), float(aux),
            [np.asarray(gr.astype(jnp.float32)) for gr in grads])


def _port(arrs, attrs, g):
    ins = [to_tensor(a).requires_grad_() for a in arrs]
    outs = OpInfoMap.instance().get("moe_ffn").compute(
        {s: [x] for s, x in zip(SLOTS, ins)}, attrs)
    out, aux = outs["Out"][0], outs["AuxLoss"][0]
    assert out.dtype == ins[0].dtype and aux.dtype == torch.float32
    ((out.float() * torch.from_numpy(g)).sum() + AUX_W * aux).backward()
    return (out.detach().float().numpy(), float(aux),
            [x.grad.float().numpy() for x in ins])


def _rel(got, want):
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-12)


def _compare(arrs, attrs, g, bf16=False):
    j_out, j_aux, j_grads = _jax(arrs, attrs, g)
    t_out, t_aux, t_grads = _port(arrs, attrs, g)
    np.testing.assert_allclose(t_aux, j_aux, **F32_TOL)
    if bf16:
        assert _rel(t_out, j_out) <= BF16_REL
    else:
        np.testing.assert_allclose(t_out, j_out, **F32_TOL)
    for slot, got, want in zip(SLOTS, t_grads, j_grads):
        assert _rel(got, want) <= (BF16_REL if bf16 else F32_GRAD), slot
    return t_out


def _kept(arrs, attrs):
    """Tokens the port's op keeps in some expert: a token whose every
    choice finds its expert full gets a zero Out row."""
    out, _, _ = _port(arrs, attrs, np.zeros(arrs[0].shape, np.float32))
    return int((np.abs(out.reshape(-1, out.shape[-1])).sum(-1) > 0).sum())


@pytest.mark.parametrize("activation", ["gelu", "relu", "silu"])
@pytest.mark.parametrize("norm_topk_prob", [True, False])
def test_moe_ffn_matches_jax(activation, norm_topk_prob):
    arrs, g = _inputs(0)
    _compare(arrs, {"top_k": 2, "capacity_factor": 1.25,
                    "activation": activation,
                    "norm_topk_prob": norm_topk_prob}, g)


def test_gelu_is_the_tanh_form():
    """jax.nn.gelu defaults to approximate=True: the op's gelu is the
    tanh form, so it differs from the erf form the dense MLP takes."""
    arrs, g = _inputs(1)
    attrs = {"top_k": 1, "activation": "gelu"}
    out = _compare(arrs, attrs, g)
    import paddle_tpu_torch.ops.moe_ops as moe_ops
    erf = dict(moe_ops._ACT)
    erf["gelu"] = torch.nn.functional.gelu
    saved, moe_ops._ACT = moe_ops._ACT, erf
    try:
        out_erf, _, _ = _port(arrs, attrs, g)
    finally:
        moe_ops._ACT = saved
    assert np.abs(out_erf - out).max() > 1e-5


@pytest.mark.parametrize("top_k", [1, 2])
def test_capacity_overflow_drops_tokens(top_k):
    """capacity = int(max(top_k * N * 0.3 / E, 1)): most tokens find
    their experts full and are dropped (their Out row is zero), as in
    the JAX op."""
    arrs, g = _inputs(2)
    attrs = {"top_k": top_k, "capacity_factor": 0.3}
    n = arrs[0].shape[0] * arrs[0].shape[1]
    assert 0 < _kept(arrs, attrs) < n
    _compare(arrs, attrs, g)


@pytest.mark.parametrize("top_k", [1, 2, 3])
def test_ties_take_the_first_expert(top_k):
    arrs, g = _inputs(3, tie=True)
    _compare(arrs, {"top_k": top_k, "capacity_factor": 2.0}, g)


@pytest.mark.parametrize("activation", ["gelu", "silu"])
def test_bf16_inputs(activation):
    arrs, g = _inputs(4, dtype="bfloat16")
    _compare(arrs, {"top_k": 2, "activation": activation}, g, bf16=True)


def test_moe_ffn_is_on_no_amp_list():
    from paddle_tpu import amp as jamp
    from paddle_tpu_torch import amp
    for pkg in (jamp, amp):
        assert "moe_ffn" not in pkg.white_list | pkg.black_list


def test_moe_layer_matches_jax():
    jpt.seed(0)
    jm = JaxMoELayer(16, 24, 4, top_k=2)
    state = {k: v.numpy() for k, v in jm.state_dict().items()}
    tpt.set_device("cpu")
    tm = load_state_dict(MoELayer(16, 24, 4, top_k=2), state)
    assert tm.w1.partition_spec == ("ep", None, None)
    assert tm.b2.partition_spec == ("ep", None)
    assert tm.gate_weight.ndim == 2 and not hasattr(tm.gate_weight,
                                                    "partition_spec")
    x = np.random.RandomState(5).randn(2, 8, 16).astype(np.float32)
    j_out = jm(jpt.to_tensor(x))
    t_out = tm(torch.from_numpy(x))
    np.testing.assert_allclose(t_out.detach().numpy(), j_out.numpy(),
                               **F32_TOL)
    np.testing.assert_allclose(float(tm.aux_loss),
                               float(jm.aux_loss.numpy()), **F32_TOL)


def test_gpt_tiny_moe_loss_and_gradients():
    """gpt_tiny(moe=True, num_experts=4): the LM loss plus 0.01 of each
    block's aux loss, and every parameter's gradient, against the JAX
    model from the same weights."""
    jpt.seed(0)
    jm = jax_gpt_tiny(moe=True, num_experts=4)
    state = {k: v.numpy() for k, v in jm.state_dict().items()}
    tpt.set_device("cpu")
    tm = load_state_dict(gpt_tiny(moe=True, num_experts=4), state)
    assert tuple(tm.gpt.blocks[0].mlp.w1.shape) == (4, 128, 512)
    ids = np.random.RandomState(6).randint(0, 1024, (2, 24)).astype(
        np.int32)
    _, j_loss = jm(jpt.to_tensor(ids), labels=jpt.to_tensor(ids))
    _, t_loss = tm(torch.from_numpy(ids), labels=torch.from_numpy(ids))
    np.testing.assert_allclose(float(t_loss), float(j_loss.numpy()),
                               **F32_TOL)
    auxes = tm.gpt.aux_losses()
    assert len(auxes) == 2 and all(float(a) > 0 for a in auxes)
    j_loss.backward()
    t_loss.backward()
    j_grads = {n: p.gradient() for n, p in jm.named_parameters()}
    t_grads = {n: p.grad for n, p in tm.named_parameters()}
    assert set(t_grads) == set(j_grads)
    top = max(float(np.abs(g).max()) for g in j_grads.values())
    for name, want in j_grads.items():
        got = t_grads[name].numpy()
        if name.endswith("k_bias"):        # exact gradient 0
            assert np.abs(got).max() <= 1e-5 * top, name
        else:
            assert _rel(got, want) <= 1e-4, name
