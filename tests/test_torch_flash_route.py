"""The port's flash_attention op against the JAX package's op on inputs
K1-K3 take only after the op reshapes them, and on its bias route.

K1-K3 take fp32, bf16 or fp16 q/k/v with head dim 64 or 128, contiguous
and 16-byte aligned. The op zero-pads a smaller head dim to the next of
those and copies a view or an unaligned tensor, so all of these reach the
kernels (on the CPU, the wrappers' plain versions); only the bias and
``q_offset`` routes take the blockwise path, counted in
``blockwise_route.calls``. The K1-K3 wrappers still raise on the card on
what they do not take (tests/test_torch_kernels_cuda.py).

Tolerances: fp32 o at rtol 1e-4 / atol 1e-5 and gradients at rtol 2e-3 /
atol 3e-4 (test_torch_flash_attention.py's: two fp32 computations that
sum in other orders); fp16 outputs round to 11 significant bits, so o
and the gradients at rtol / atol 4e-3 (a few fp16 ulps of values near
1); bf16 at 2e-2 (8 bits).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.core.registry import OpInfoMap as JaxOpInfoMap
from paddle_tpu_torch.core.registry import OpInfoMap
from paddle_tpu_torch.ops import flash_attention as tfa

TOL = {"float32": (dict(rtol=1e-4, atol=1e-5), dict(rtol=2e-3, atol=3e-4)),
       "float16": (dict(rtol=4e-3, atol=4e-3), dict(rtol=4e-3, atol=4e-3)),
       "bfloat16": (dict(rtol=2e-2, atol=2e-2), dict(rtol=2e-2, atol=2e-2))}
# (b, s, h, d, causal, dtype, layout, route): layout "bhsd" makes q a
# permuted view of a [B, H, S, D] tensor, not contiguous; "unaligned"
# makes it contiguous but 4 bytes past 16-byte alignment; route
# "blockwise" passes a zero Bias, which takes the blockwise route
CASES = [
    (2, 64, 4, 32, False, "float32", "bshd", "kernels"),
    (2, 64, 4, 32, True, "float32", "bshd", "kernels"),
    (2, 100, 3, 64, False, "float16", "bshd", "kernels"),
    (1, 130, 2, 128, True, "float16", "bshd", "kernels"),
    (2, 100, 3, 64, True, "float32", "bhsd", "kernels"),
    (2, 100, 3, 64, False, "float32", "unaligned", "kernels"),
    (2, 64, 2, 96, False, "bfloat16", "bshd", "kernels"),
    (2, 100, 3, 64, True, "bfloat16", "bshd", "kernels"),
    (2, 100, 3, 64, True, "float32", "bshd", "blockwise"),
]


def _inputs(b, s, h, d, seed=3):
    rs = np.random.RandomState(seed)
    return [rs.randn(b, s, h, d).astype(np.float32) for _ in range(4)]


def _bias(q, route):
    return [np.zeros((1, 1, q.shape[1], q.shape[1]), np.float32)] \
        if route == "blockwise" else []


def _jax_op(q, k, v, g, causal, dtype, route):
    op = JaxOpInfoMap.instance().get("flash_attention")
    bias = [jnp.asarray(b) for b in _bias(q, route)]

    def f(q_, k_, v_):
        out = op.compute({"Q": [q_], "K": [k_], "V": [v_], "Bias": bias},
                         {"causal": causal})["Out"][0]
        return jnp.sum(out.astype(jnp.float32) * g), out

    args = [jnp.asarray(x, dtype) for x in (q, k, v)]
    (_, out), grads = jax.value_and_grad(f, argnums=(0, 1, 2),
                                         has_aux=True)(*args)
    return [np.asarray(x.astype(jnp.float32)) for x in (out, *grads)]


def _unaligned(t):
    """``t``'s values in a contiguous tensor 4 bytes past 16-byte
    alignment."""
    flat = torch.empty(t.numel() + 16 // t.element_size(), dtype=t.dtype)
    off = (-flat.data_ptr() % 16 + 4) // t.element_size()
    out = flat[off:off + t.numel()].view(t.shape)
    out.copy_(t)
    assert out.is_contiguous() and out.data_ptr() % 16 == 4
    return out


def _torch_op(q, k, v, g, causal, dtype, layout, route):
    dt = getattr(torch, dtype)
    ts = [torch.from_numpy(x).to(dt) for x in (q, k, v)]
    if layout == "bhsd":
        ts[0] = ts[0].permute(0, 2, 1, 3).contiguous().permute(0, 2, 1, 3)
    elif layout == "unaligned":
        ts[0] = _unaligned(ts[0])
    leaves = [t.detach().requires_grad_() for t in ts]
    bias = [torch.from_numpy(x) for x in _bias(q, route)]
    before = tfa.blockwise_route.calls
    out = OpInfoMap.instance().get("flash_attention").compute(
        {"Q": leaves[:1], "K": leaves[1:2], "V": leaves[2:], "Bias": bias},
        {"causal": causal})["Out"][0]
    (out.float() * torch.from_numpy(g)).sum().backward()
    got = [out.detach()] + [t.grad for t in leaves]
    assert all(x.dtype == dt for x in got)
    return [x.float().numpy() for x in got], \
        tfa.blockwise_route.calls - before, leaves[0].is_contiguous()


@pytest.mark.parametrize("b,s,h,d,causal,dtype,layout,route", CASES)
def test_op_matches_jax_on_either_route(b, s, h, d, causal, dtype, layout,
                                        route):
    q, k, v, g = _inputs(b, s, h, d)
    want = _jax_op(q, k, v, g, causal, dtype, route)
    got, calls, contiguous = _torch_op(q, k, v, g, causal, dtype, layout,
                                       route)
    assert contiguous == (layout != "bhsd")
    assert calls == (1 if route == "blockwise" else 0)
    o_tol, g_tol = TOL[dtype]
    for name, x, y, tol in zip(("o", "dq", "dk", "dv"), got, want,
                               (o_tol, g_tol, g_tol, g_tol)):
        np.testing.assert_allclose(x, y, err_msg=name, **tol)


@pytest.mark.parametrize("d,dtype", [(32, torch.float32),
                                     (96, torch.bfloat16),
                                     (64, torch.float16),
                                     (128, torch.float32)])
def test_op_hands_the_kernels_what_they_take(monkeypatch, d, dtype):
    """Whatever the op is given (a smaller head dim, a view, an unaligned
    tensor), the K1-K3 wrappers see tensors their check on the card
    accepts, copied only where needed."""
    seen = []
    real = tfa.flash_fwd

    def spy(q, k, v, *args):
        seen.append((tfa._refusal(q, k, v), q.shape[-1]))
        return real(q, k, v, *args)
    monkeypatch.setattr(tfa, "flash_fwd", spy)
    x = torch.zeros(2, 16, 2, d, dtype=dtype)
    views = {"contiguous": x,
             "view": x.transpose(1, 2).contiguous().transpose(1, 2),
             "unaligned": _unaligned(x)}
    for name, q in views.items():
        out = tfa._flash_attention_op({"Q": [q], "K": [x], "V": [x]},
                                      {})["Out"][0]
        assert out.shape == x.shape and out.dtype == dtype, name
        assert seen.pop() == (None, tfa._kernel_head_dim(d)), name
    assert tfa._kernel_head_dim(d) == (64 if d <= 64 else 128)
    if d in tfa.KERNEL_HEAD_DIMS:      # no copy of what they take as it is
        assert tfa._kernel_layout(x, d) is x
