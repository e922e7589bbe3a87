"""The port's flash attention (paddle_tpu_torch/ops/flash_attention.py)
against the JAX package's.

On the CPU the port's wrappers run their plain versions; they are held
against the JAX Pallas kernels in interpret mode, against JAX's
``blockwise_attention`` and, through the autograd Function, against
``jax.grad`` of ``flash_attention``, at the cases of test_flash_tpu.py.
Tolerances, float32 on the CPU: o and lse at rtol 1e-4 / atol 1e-5 (two
fp32 computations that sum in other orders); gradients at rtol 2e-3 /
atol 3e-4, the bound test_flash_tpu.py uses on the CPU (the gradient
sums run over up to 512 keys). bfloat16 outputs round to 8 mantissa
bits, so bf16 cases compare at rtol / atol 2e-2.

The kernels themselves are held against these plain versions on the card
by tests/test_torch_kernels_cuda.py and chip_smoke.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from paddle_tpu.core.registry import OpInfoMap as JaxOpInfoMap
from paddle_tpu.ops import flash_attention as jfa
from paddle_tpu_torch.core.enforce import InvalidArgumentError
from paddle_tpu_torch.core.registry import OpInfoMap
from paddle_tpu_torch.ops import flash_attention as tfa

FWD_CASES = [
    # (b, s, h, d, causal) — test_flash_tpu.py:19-25
    (2, 128, 12, 64, False),
    (1, 256, 4, 64, True),
    (2, 100, 3, 64, False),      # ragged tail
    (1, 512, 8, 128, True),
]
BWD_CASES = [
    # test_flash_tpu.py:95-101
    (2, 128, 2, 64, False),
    (1, 256, 4, 64, True),
    (2, 100, 3, 64, True),       # ragged tail: padded q AND k blocks
    (1, 130, 2, 128, False),     # ragged, d=128
]
BF16_CASES = [(2, 100, 3, 64, True), (1, 130, 2, 128, False)]
CROSS_CASES = [
    # (b, sq, sk, h, d, causal): Sq != Sk, as tests/test_torch_kernels_cuda.py
    (1, 64, 192, 4, 64, False),
    (1, 64, 192, 4, 64, True),
    (2, 130, 60, 3, 64, False),
    (2, 130, 60, 3, 64, True),
]

O_TOL = dict(rtol=1e-4, atol=1e-5)
G_TOL = dict(rtol=2e-3, atol=3e-4)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)


def _mk(b, s, h, d, seed):
    rs = np.random.RandomState(seed)
    return tuple(rs.randn(b, s, h, d).astype(np.float32) for _ in range(4))


def _t(*arrays, dtype=torch.float32):
    return tuple(torch.from_numpy(np.array(a)).to(dtype) for a in arrays)


def _np(t):
    return t.detach().float().numpy()


@pytest.mark.parametrize("b,s,h,d,causal", FWD_CASES)
def test_plain_forward_matches_pallas_and_blockwise(b, s, h, d, causal):
    q, k, v, _ = _mk(b, s, h, d, seed=0)
    scale = 1.0 / d ** 0.5
    o, lse = tfa.flash_fwd(*_t(q, k, v), causal, scale, block_size=128)
    assert o.dtype == torch.float32 and lse.shape == (b, h, s)
    o_p, lse_p = jfa._flash_fwd_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, scale,
        block_q=128, block_k=128, interpret=True)
    o_b, lse_b = jfa.blockwise_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        scale=scale, block_size=128)
    for want_o, want_lse in ((o_p, lse_p), (o_b, lse_b)):
        np.testing.assert_allclose(_np(o), np.asarray(want_o), **O_TOL)
        np.testing.assert_allclose(_np(lse), np.asarray(want_lse), **O_TOL)


@pytest.mark.parametrize("b,s,h,d,causal", BWD_CASES)
def test_plain_backward_matches_pallas(b, s, h, d, causal):
    q, k, v, g = _mk(b, s, h, d, seed=3)
    scale = 1.0 / d ** 0.5
    jq, jk, jv, jg = (jnp.asarray(a) for a in (q, k, v, g))
    o, lse = jfa._flash_fwd_pallas(jq, jk, jv, causal, scale, block_q=128,
                                   block_k=128, interpret=True)
    want = jfa._flash_bwd_pallas(jq, jk, jv, o, lse, jg, causal, scale,
                                 block_q=128, block_k=128, interpret=True)
    tq, tk, tv, tg = _t(q, k, v, g)
    to, tlse = _t(np.asarray(o), np.asarray(lse))
    dq, delta = tfa.flash_bwd_dq(tq, tk, tv, to, tg, tlse, causal, scale,
                                 block_size=128)
    dk, dv = tfa.flash_bwd_dkv(tq, tk, tv, tg, tlse, delta, causal, scale,
                               block_size=128)
    np.testing.assert_allclose(_np(delta), np.einsum(
        "bqhd,bqhd->bhq", g, np.asarray(o)), **O_TOL)
    for got, w in zip((dq, dk, dv), want):
        np.testing.assert_allclose(_np(got), np.asarray(w), **G_TOL)


@pytest.mark.parametrize("b,sq,sk,h,d,causal", CROSS_CASES)
def test_plain_cross_lengths_match_pallas(b, sq, sk, h, d, causal):
    """Sq != Sk, causal or not: the plain forward and backward (what the
    card's kernels are held against) against the Pallas kernels."""
    rs = np.random.RandomState(4)
    q, g = (rs.randn(b, sq, h, d).astype(np.float32) for _ in range(2))
    k, v = (rs.randn(b, sk, h, d).astype(np.float32) for _ in range(2))
    scale = 1.0 / d ** 0.5
    jq, jk, jv, jg = (jnp.asarray(a) for a in (q, k, v, g))
    o_p, lse_p = jfa._flash_fwd_pallas(jq, jk, jv, causal, scale,
                                       block_q=128, block_k=128,
                                       interpret=True)
    tq, tk, tv, tg = _t(q, k, v, g)
    o, lse = tfa.flash_fwd(tq, tk, tv, causal, scale, block_size=128)
    np.testing.assert_allclose(_np(o), np.asarray(o_p), **O_TOL)
    np.testing.assert_allclose(_np(lse), np.asarray(lse_p), **O_TOL)
    want = jfa._flash_bwd_pallas(jq, jk, jv, o_p, lse_p, jg, causal, scale,
                                 block_q=128, block_k=128, interpret=True)
    to, tlse = _t(np.asarray(o_p), np.asarray(lse_p))
    dq, delta = tfa.flash_bwd_dq(tq, tk, tv, to, tg, tlse, causal, scale,
                                 block_size=128)
    dk, dv = tfa.flash_bwd_dkv(tq, tk, tv, tg, tlse, delta, causal, scale,
                               block_size=128)
    for got, w in zip((dq, dk, dv), want):
        np.testing.assert_allclose(_np(got), np.asarray(w), **G_TOL)


@pytest.mark.parametrize("b,s,h,d,causal", BWD_CASES)
def test_autograd_function_matches_jax_grad(b, s, h, d, causal):
    q, k, v, g = _mk(b, s, h, d, seed=2)
    tq, tk, tv = (t.requires_grad_() for t in _t(q, k, v))
    out = tfa.flash_attention(tq, tk, tv, causal=causal)
    (out * torch.from_numpy(g)).sum().backward()

    def loss(q_, k_, v_):
        return jnp.sum(jfa.flash_attention(q_, k_, v_, causal=causal)
                       * jnp.asarray(g))

    jo = jfa.flash_attention(*(jnp.asarray(a) for a in (q, k, v)),
                             causal=causal)
    np.testing.assert_allclose(_np(out), np.asarray(jo), **O_TOL)
    grads = jax.grad(loss, argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in (q, k, v)))
    for got, want in zip((tq.grad, tk.grad, tv.grad), grads):
        np.testing.assert_allclose(_np(got), np.asarray(want), **G_TOL)


@pytest.mark.parametrize("b,s,h,d,causal", BF16_CASES)
def test_bf16_matches_jax(b, s, h, d, causal):
    q, k, v, g = _mk(b, s, h, d, seed=6)
    scale = 1.0 / d ** 0.5
    jq, jk, jv, jg = (jnp.asarray(a).astype(jnp.bfloat16)
                      for a in (q, k, v, g))
    tq, tk, tv, tg = _t(q, k, v, g, dtype=torch.bfloat16)
    o, lse = tfa.flash_fwd(tq, tk, tv, causal, scale, block_size=128)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    jo, jlse = jfa.blockwise_attention(jq, jk, jv, causal=causal,
                                       scale=scale, block_size=128)
    np.testing.assert_allclose(_np(o), np.asarray(jo, np.float32),
                               **BF16_TOL)
    np.testing.assert_allclose(_np(lse), np.asarray(jlse), **O_TOL)
    jo16 = jnp.asarray(jo).astype(jnp.bfloat16)
    want = jfa._flash_bwd_pallas(jq, jk, jv, jo16, jlse, jg, causal, scale,
                                 block_q=128, block_k=128, interpret=True)
    to = torch.from_numpy(np.asarray(jo16, np.float32)).to(torch.bfloat16)
    dq, delta = tfa.flash_bwd_dq(tq, tk, tv, to, tg,
                                 torch.from_numpy(np.array(jlse)),
                                 causal, scale, block_size=128)
    dk, dv = tfa.flash_bwd_dkv(tq, tk, tv, tg,
                               torch.from_numpy(np.array(jlse)), delta,
                               causal, scale, block_size=128)
    for got, w in zip((dq, dk, dv), want):
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(_np(got), np.asarray(w, np.float32),
                                   **BF16_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_fp64_reference_matches_jax_and_plain(causal):
    """chip_smoke.attention_fp64, what the card holds K1's o and lse to,
    computes the reference's function: JAX's blockwise_attention on the
    same float64 inputs (x64 is on, but its products accumulate in fp32,
    so fp32 rounding apart: rtol 1e-5 / atol 1e-6) and the port's plain
    version (fp32: O_TOL), ragged Sq != Sk in both orders."""
    for sq, sk in ((37, 21), (21, 37)):
        rs = np.random.RandomState(sq)
        q = rs.randn(2, sq, 3, 64)
        k, v = (rs.randn(2, sk, 3, 64) for _ in range(2))
        o, lse = chip_smoke.attention_fp64(*_t(q, k, v, dtype=torch.float64),
                                           causal, 0.125)
        assert o.dtype == lse.dtype == torch.float64
        o_j, lse_j = jfa.blockwise_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
            scale=0.125, block_size=16)
        np.testing.assert_allclose(o.numpy(), np.asarray(o_j), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j),
                                   rtol=1e-5, atol=1e-6)
        o_p, lse_p = tfa.blockwise_attention(
            *_t(q, k, v), causal=causal, scale=0.125, block_size=16)
        np.testing.assert_allclose(o.numpy(), _np(o_p), **O_TOL)
        np.testing.assert_allclose(lse.numpy(), _np(lse_p), **O_TOL)


@pytest.mark.parametrize("route", ["bias", "q_offset"])
def test_op_bias_and_offset_routes_match_jax(route):
    b, s, h, d = 2, 48, 2, 64
    q, k, v, _ = _mk(b, s, h, d, seed=8)
    inputs_t = {"Q": [torch.from_numpy(q)], "K": [torch.from_numpy(k)],
                "V": [torch.from_numpy(v)]}
    inputs_j = {"Q": [jnp.asarray(q)], "K": [jnp.asarray(k)],
                "V": [jnp.asarray(v)]}
    attrs = {"causal": True, "q_offset": 0}
    if route == "bias":
        keep = np.random.RandomState(9).rand(b, 1, 1, s) > 0.3
        bias = np.where(keep, 0.0, -1e30).astype(np.float32)
        inputs_t["Bias"] = [torch.from_numpy(bias)]
        inputs_j["Bias"] = [jnp.asarray(bias)]
    else:
        attrs["q_offset"] = 5
    got = OpInfoMap.instance().get("flash_attention").compute(
        inputs_t, attrs)["Out"][0]
    want = JaxOpInfoMap.instance().get("flash_attention").compute(
        inputs_j, attrs)["Out"][0]
    np.testing.assert_allclose(_np(got), np.asarray(want), **O_TOL)


@pytest.mark.parametrize("bad,match", [
    ("head_dim", "head dim"), ("dtype", "float32 or bfloat16"),
    ("layout", "contiguous"), ("shape", "bad shapes"),
    ("device", "CUDA device")])
def test_kernel_input_checks_raise(bad, match):
    q = torch.zeros(1, 8, 2, 64)
    k, v = q.clone(), q.clone()
    if bad == "head_dim":
        q = k = v = torch.zeros(1, 8, 2, 32)
    elif bad == "dtype":
        q = q.half()
    elif bad == "layout":
        q = torch.zeros(1, 2, 8, 64).transpose(1, 2)
    elif bad == "shape":
        k = torch.zeros(1, 8, 3, 64)
    # "device": well-formed tensors, but on the CPU
    with pytest.raises(InvalidArgumentError, match=match):
        tfa._check_cuda(q, k, v)
