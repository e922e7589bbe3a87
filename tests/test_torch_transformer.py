"""The port's nn/transformer.py against the JAX package's, on the CPU.

Every layer is built by the JAX package from a seed and its weights
carried into the port's by structured name (``convert.load_state_dict``);
inputs come from numpy with a seed; dropout is 0. Outputs are compared,
and the gradients of every parameter and input of the scalar
sum(out * G), G a fixed random array.

Tolerances (fp32 throughout): outputs at rtol 1e-4 / atol 2e-5, and
gradients at rtol 1e-4 / atol 1e-4 of the gradient's largest element
(the two frameworks sum products in other orders; measured errors are
some 1e-6 of the largest element, and a wrong route, mask or cache
offset moves them by O(1)). A key bias has an exact gradient of 0 (a
softmax does not move when every score of a row shifts by the same
q.b), so both sides give rounding noise there: it is held to 1e-5 of
the largest gradient of the layer instead.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jpt
from paddle_tpu import nn as jnn

import paddle_tpu_torch as tpt
from paddle_tpu_torch import nn
from paddle_tpu_torch.convert import load_state_dict
from paddle_tpu_torch.core.enforce import UnimplementedError
from paddle_tpu_torch.ops import flash_attention as fa

OUT_TOL = dict(rtol=1e-4, atol=2e-5)
GRAD_TOL = 1e-4
ZERO_GRAD_TOL = 1e-5


def _pair(make_jax, make_port, seed=0):
    jpt.seed(seed)
    jm = make_jax()
    tpt.set_device("cpu")
    tm = load_state_dict(make_port(), {k: v.numpy() for k, v in
                                       jm.state_dict().items()})
    return jm, tm


def _arrays(seed, *shapes):
    rs = np.random.RandomState(seed)
    return [rs.randn(*s).astype(np.float32) for s in shapes]


def _grad_close(got, want, what):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    scale = max(float(np.abs(want).max()), 1e-12)
    err = float(np.abs(got - want).max()) / scale
    assert err <= GRAD_TOL, (what, err)


def _grads_close(t_grads, j_grads):
    assert set(t_grads) == set(j_grads)
    top = max(float(np.abs(g).max()) for g in j_grads.values())
    for name, want in j_grads.items():
        got = t_grads[name]
        assert want is not None and got is not None, name
        if name.endswith("k_bias"):
            assert max(float(np.abs(want).max()),
                       float(got.abs().max())) <= ZERO_GRAD_TOL * top, name
        else:
            _grad_close(got, want, name)


def _run_both(jm, tm, inputs, call, g=None):
    """call(model, *tensors) on both sides; returns (jax out, port out,
    jax grads, port grads) with grads by parameter name and by input
    position, from sum(out * g)."""
    j_in = [jpt.to_tensor(x, stop_gradient=False) for x in inputs]
    t_in = [torch.from_numpy(x).requires_grad_() for x in inputs]
    j_out, t_out = call(jm, *j_in), call(tm, *t_in)
    if g is None:
        return j_out, t_out, None, None
    (j_out * jpt.to_tensor(g)).sum().backward()
    (t_out * torch.from_numpy(g)).sum().backward()
    j_grads = {n: p.gradient() for n, p in jm.named_parameters()}
    t_grads = {n: p.grad for n, p in tm.named_parameters()}
    for i, (a, b) in enumerate(zip(j_in, t_in)):
        j_grads[f"input {i}"], t_grads[f"input {i}"] = a.gradient(), b.grad
    return j_out, t_out, j_grads, t_grads


def _check(jm, tm, inputs, call, out_shape):
    g, = _arrays(99, out_shape)
    j_out, t_out, j_grads, t_grads = _run_both(jm, tm, inputs, call, g)
    np.testing.assert_allclose(t_out.detach().numpy(), j_out.numpy(),
                               **OUT_TOL)
    _grads_close(t_grads, j_grads)


# ---------------------------------------------------------------------------
# MultiHeadAttention
# ---------------------------------------------------------------------------
def test_mha_cross_attention_with_kdim_vdim():
    """kdim / vdim: keys and values of other widths and another length
    (Sq 6, Sk 9), through the op's kernel route."""
    jm, tm = _pair(lambda: jnn.MultiHeadAttention(32, 4, kdim=24, vdim=40),
                   lambda: nn.MultiHeadAttention(32, 4, kdim=24, vdim=40))
    assert tuple(tm.k_weight.shape) == (24, 32)
    assert tuple(tm.v_weight.shape) == (40, 32)
    x, k, v = _arrays(1, (2, 6, 32), (2, 9, 24), (2, 9, 40))
    calls = fa.blockwise_route.calls
    _check(jm, tm, [x, k, v], lambda m, a, b, c: m(a, b, c), (2, 6, 32))
    assert fa.blockwise_route.calls == calls


def test_mha_without_bias():
    jm, tm = _pair(lambda: jnn.MultiHeadAttention(32, 4, bias_attr=False),
                   lambda: nn.MultiHeadAttention(32, 4, bias_attr=False))
    names = [n for n, _ in tm.named_parameters()]
    assert names == ["q_weight", "k_weight", "v_weight", "out_weight"]
    assert tm.q_bias is None
    x, = _arrays(2, (2, 7, 32))
    _check(jm, tm, [x], lambda m, a: m(a), (2, 7, 32))


@pytest.mark.parametrize("kind", ["bool", "float"])
def test_mha_masks(kind):
    """A bool mask (True keeps) and an additive float mask of shape
    [B, 1, Sq, Sk], on the op's bias route."""
    jm, tm = _pair(lambda: jnn.MultiHeadAttention(16, 2),
                   lambda: nn.MultiHeadAttention(16, 2))
    x, = _arrays(3, (2, 6, 16))
    keep = np.random.RandomState(4).rand(2, 1, 6, 6) > 0.3
    keep[..., 0] = True
    mask = keep if kind == "bool" else np.where(
        keep, 0.0, -1e4).astype(np.float32)
    calls = fa.blockwise_route.calls
    _check(jm, tm, [x], lambda m, a: m(
        a, attn_mask=(jpt.to_tensor(mask) if isinstance(m, jnn.Layer)
                      else torch.from_numpy(mask))), (2, 6, 16))
    assert fa.blockwise_route.calls == calls + 1


def _cached_decode(m, x, prefill, to_tensor, numpy_of):
    """A prefill of ``prefill`` positions with a fresh Cache, then one
    position at a time; the outputs concatenated on the sequence axis."""
    o, cache = m(to_tensor(x[:, :prefill]), cache=m.Cache(k=None, v=None))
    outs = [numpy_of(o)]
    for t in range(prefill, x.shape[1]):
        o, cache = m(to_tensor(x[:, t:t + 1]), cache=cache)
        outs.append(numpy_of(o))
    assert cache.k.shape[1] == x.shape[1]
    return np.concatenate(outs, 1)


@pytest.mark.parametrize("prefill", [1, 4])
def test_mha_cache_against_jax_and_uncached(prefill):
    """The cached route: k / v concatenated onto the cache, q_offset =
    its length, causal across the offset. Equal to the JAX package's
    cached decode and to the port's uncached causal forward."""
    jm, tm = _pair(lambda: jnn.MultiHeadAttention(16, 2, causal=True),
                   lambda: nn.MultiHeadAttention(16, 2, causal=True))
    x, = _arrays(5, (2, 7, 16))
    want = _cached_decode(jm, x, prefill, jpt.to_tensor,
                          lambda t: t.numpy())
    calls = fa.blockwise_route.calls
    with torch.no_grad():
        got = _cached_decode(tm, x, prefill, torch.from_numpy,
                             lambda t: t.numpy())
        full = tm(torch.from_numpy(x)).numpy()
    # the prefill has no past (the kernel route); each later step has
    assert fa.blockwise_route.calls == calls + 7 - prefill
    np.testing.assert_allclose(got, want, **OUT_TOL)
    np.testing.assert_allclose(got, full, **OUT_TOL)


def test_mha_cache_gradient():
    """Gradients flow through the cache's concat into the first step's
    keys and values, as in the JAX package."""
    jm, tm = _pair(lambda: jnn.MultiHeadAttention(16, 2, causal=True),
                   lambda: nn.MultiHeadAttention(16, 2, causal=True))
    x, = _arrays(6, (1, 5, 16))

    def call(m, a):
        first, cache = m(a[:, :3], cache=m.Cache(k=None, v=None))
        second, _ = m(a[:, 3:], cache=cache)
        return first.sum() + second * 2.0
    g, = _arrays(7, (1, 2, 16))
    j_out, t_out, j_grads, t_grads = _run_both(jm, tm, [x], call, g)
    np.testing.assert_allclose(t_out.detach().numpy(), j_out.numpy(),
                               **OUT_TOL)
    _grads_close(t_grads, j_grads)


def test_mha_rejects_need_weights_and_sequence_parallel():
    with pytest.raises(NotImplementedError):
        nn.MultiHeadAttention(16, 2, need_weights=True)
    tpt.set_device("cpu")
    m = nn.MultiHeadAttention(16, 2, sp_axis="sp")
    assert (m.sp_axis, m.sp_mode) == ("sp", "ring")
    with pytest.raises(UnimplementedError):
        m(torch.zeros(1, 4, 16))


# ---------------------------------------------------------------------------
# Encoder, decoder, Transformer
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("normalize_before", [False, True])
def test_encoder_with_norm(normalize_before):
    """Pre-LN and post-LN layers, two deep-copied layers, a final norm,
    relu / gelu, and a float key-padding mask."""
    act = "gelu" if normalize_before else "relu"

    def make(pkg):
        def build():
            layer = pkg.TransformerEncoderLayer(
                32, 4, 64, dropout=0.0, activation=act,
                normalize_before=normalize_before)
            return pkg.TransformerEncoder(layer, 2, norm=pkg.LayerNorm(32))
        return build
    jm, tm = _pair(make(jnn), make(nn))
    assert "norm.weight" in tm.state_dict()
    x, = _arrays(8, (2, 5, 32))
    mask = np.zeros((2, 1, 1, 5), np.float32)
    mask[1, ..., 3:] = -1e4
    _check(jm, tm, [x], lambda m, a: m(a, src_mask=(
        jpt.to_tensor(mask) if isinstance(m, jnn.Layer)
        else torch.from_numpy(mask))), (2, 5, 32))


def test_encoder_layer_dropout_attrs():
    tpt.set_device("cpu")
    a = nn.TransformerEncoderLayer(16, 2, 32, dropout=0.1)
    assert (a.dropout, a.act_dropout, a.self_attn.dropout) == (0.1, 0.1, 0.1)
    b = nn.TransformerEncoderLayer(16, 2, 32, dropout=0.1, attn_dropout=0.2,
                                   act_dropout=0.3, bias_attr=False)
    assert (b.dropout, b.act_dropout, b.self_attn.dropout) == (0.1, 0.3, 0.2)
    assert b.linear1.bias is None and b.self_attn.out_bias is None
    # eval() turns every dropout off: two calls agree
    x = torch.randn(1, 4, 16)
    b.eval()
    assert torch.equal(b(x), b(x))


@pytest.mark.parametrize("normalize_before", [False, True])
def test_decoder_layer(normalize_before):
    """Causal self-attention (the kernel route), cross-attention over a
    longer memory with a bool memory mask (the bias route)."""
    jm, tm = _pair(
        lambda: jnn.TransformerDecoderLayer(
            32, 4, 48, dropout=0.0, normalize_before=normalize_before),
        lambda: nn.TransformerDecoderLayer(
            32, 4, 48, dropout=0.0, normalize_before=normalize_before))
    assert tm.self_attn.causal and not tm.cross_attn.causal
    tgt, mem = _arrays(9, (2, 6, 32), (2, 8, 32))
    keep = np.ones((2, 1, 6, 8), bool)
    keep[0, ..., 6:] = False
    _check(jm, tm, [tgt, mem], lambda m, a, b: m(a, b, memory_mask=(
        jpt.to_tensor(keep) if isinstance(m, jnn.Layer)
        else torch.from_numpy(keep))), (2, 6, 32))


def test_decoder_stack():
    def make(pkg):
        def build():
            layer = pkg.TransformerDecoderLayer(32, 4, 48, dropout=0.0,
                                                activation="gelu")
            return pkg.TransformerDecoder(layer, 2, norm=pkg.LayerNorm(32))
        return build
    jm, tm = _pair(make(jnn), make(nn))
    tgt, mem = _arrays(10, (2, 5, 32), (2, 7, 32))
    _check(jm, tm, [tgt, mem], lambda m, a, b: m(a, b), (2, 5, 32))


@pytest.mark.parametrize("normalize_before", [False, True])
def test_transformer(normalize_before):
    """The encoder-decoder, with the final norms when pre-LN."""
    kw = dict(d_model=32, nhead=4, num_encoder_layers=2,
              num_decoder_layers=2, dim_feedforward=64, dropout=0.0,
              normalize_before=normalize_before)
    jm, tm = _pair(lambda: jnn.Transformer(**kw),
                   lambda: nn.Transformer(**kw))
    assert ("encoder.norm.weight" in tm.state_dict()) == normalize_before
    src, tgt = _arrays(11, (2, 8, 32), (2, 6, 32))
    _check(jm, tm, [src, tgt], lambda m, a, b: m(a, b), (2, 6, 32))
