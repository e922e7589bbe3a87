"""Recurrent and context-window ops.

Port of ``paddle_tpu/ops/rnn_ops.py`` (ref: paddle/fluid/operators/
lstm_op.cc, gru_op.cc, gru_unit_op.h, lstm_unit_op.h, row_conv_op.cc,
conv_shift_op.cc, sequence_conv_op.cc). The JAX package runs each
recurrence as one ``lax.scan`` under XLA; none reaches a Pallas kernel.
Here:

- ``rnn_scan`` (one layer, one direction of ``nn.LSTM`` / ``GRU`` /
  ``SimpleRNN``) runs on the card as one call of torch's cuDNN RNN
  (``torch._VF.lstm`` / ``gru`` / ``rnn_tanh`` / ``rnn_relu``), whose
  gate orders and GRU convention are the reference's: LSTM (i, f, g,
  o); GRU (r, u, c) with the reset gate on ``W_hh h + b_hh`` and
  ``h' = u h + (1 - u) c``. On the CPU it is the plain loop over time.
- The fluid ops (``lstm``, ``lstmp``, ``gru``) are loops over time on
  any device, in the reference's gate orders: ``lstm`` (c, i, f, o)
  with peepholes in a [1, 7D] bias, ``gru`` (u, r, c) with
  ``origin_mode``. cuDNN has no peepholes and no such orders.
- Padded steps still run: as in the reference, the forward does not
  freeze a row's state past its length; ``is_reverse`` with ``Length``
  reverses each row within its own length.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.enforce import InvalidArgumentError, enforce
from ..core.registry import OpInfoMap, register_infer_meta, register_op
from .sequence_ops import ragged_reverse

_VF_MODE = {"LSTM": "lstm", "GRU": "gru", "RNN_TANH": "rnn_tanh",
            "RNN_RELU": "rnn_relu"}


def _stack(steps, like, width):
    """Per-step [B, width] tensors as [B, T, width] (T may be 0)."""
    if steps:
        return torch.stack(steps, dim=1)
    return like.new_zeros((like.shape[0], 0, width))


def _loop_scan(x_tm, h0, c0, w_ih, w_hh, b_ih, b_hh, mode):
    """The plain recurrence. x_tm: time-major [T, B, I]. Returns
    (out [T, B, H], h_T, c_T)."""
    # the input projection over all steps in one product
    xp = torch.einsum("tbi,gi->tbg", x_tm, w_ih)
    if b_ih is not None:
        xp = xp + b_ih
    h, c = h0, c0
    outs = []
    for t in range(x_tm.shape[0]):
        hp = h @ w_hh.T
        if b_hh is not None:
            hp = hp + b_hh
        if mode == "LSTM":
            i, f, g, o = (xp[t] + hp).chunk(4, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
        elif mode == "GRU":
            xr, xu, xc = xp[t].chunk(3, dim=-1)
            hr, hu, hc = hp.chunk(3, dim=-1)
            r = torch.sigmoid(xr + hr)
            u = torch.sigmoid(xu + hu)
            cand = torch.tanh(xc + r * hc)
            h = u * h + (1.0 - u) * cand
            c = h
        else:
            pre = xp[t] + hp
            h = torch.tanh(pre) if mode == "RNN_TANH" else torch.relu(pre)
            c = h
        outs.append(h)
    out = torch.stack(outs) if outs else xp.new_zeros(
        (0,) + tuple(h0.shape))
    return out, h, c


def _cudnn_scan(x, h0, c0, w_ih, w_hh, b_ih, b_hh, mode):
    """One layer, one direction through torch's cuDNN RNN. x:
    batch-major [B, T, I]. Returns (out [B, T, H], h_T, c_T)."""
    has_bias = b_ih is not None or b_hh is not None
    params = [w_ih.contiguous(), w_hh.contiguous()]
    if has_bias:
        zeros = w_ih.new_zeros(w_ih.shape[0])
        params += [zeros if b_ih is None else b_ih,
                   zeros if b_hh is None else b_hh]
    fn = getattr(torch._VF, _VF_MODE[mode])
    x = x.contiguous()
    if mode == "LSTM":
        out, h, c = fn(x, (h0[None].contiguous(), c0[None].contiguous()),
                       params, has_bias, 1, 0.0, torch.is_grad_enabled(),
                       False, True)
        return out, h[0], c[0]
    out, h = fn(x, h0[None].contiguous(), params, has_bias, 1, 0.0,
                torch.is_grad_enabled(), False, True)
    return out, h[0], h[0]


@register_op("rnn_scan", non_differentiable_inputs=())
def rnn_scan(inputs, attrs):
    """One RNN layer, one direction. X: [B, T, I] (batch-major).

    Outputs: Out [B, T, H], LastH [B, H], LastC [B, H] (for the modes
    other than LSTM the last h again, as the reference's scan carries
    it)."""
    x = inputs["X"][0]
    w_ih = inputs["WeightIh"][0]
    w_hh = inputs["WeightHh"][0]
    b_ih = inputs["BiasIh"][0] if inputs.get("BiasIh") else None
    b_hh = inputs["BiasHh"][0] if inputs.get("BiasHh") else None
    mode = attrs.get("mode", "LSTM")
    enforce(mode in _VF_MODE, f"rnn_scan: unknown mode {mode!r}",
            InvalidArgumentError)
    reverse = attrs.get("is_reverse", False)
    hidden = w_hh.shape[-1]
    b = x.shape[0]
    h0 = (inputs["InitH"][0] if inputs.get("InitH")
          else x.new_zeros((b, hidden)))
    c0 = (inputs["InitC"][0] if inputs.get("InitC")
          else x.new_zeros((b, hidden)))
    if reverse:
        x = torch.flip(x, dims=[1])
    if x.is_cuda:
        out, h_t, c_t = _cudnn_scan(x, h0, c0, w_ih, w_hh, b_ih, b_hh, mode)
    else:
        out, h_t, c_t = _loop_scan(x.transpose(0, 1), h0, c0, w_ih, w_hh,
                                   b_ih, b_hh, mode)
        out = out.transpose(0, 1)
    if reverse:
        out = torch.flip(out, dims=[1])
    return {"Out": [out], "LastH": [h_t], "LastC": [c_t]}


# --------------------------------------------------------- fluid parity
def _act(name):
    return {"sigmoid": torch.sigmoid, "tanh": torch.tanh,
            "relu": torch.relu, "identity": lambda v: v}[name]


@register_op("lstm", non_differentiable_inputs=("Length",),
             intermediate_outputs=("BatchGate", "BatchCellPreAct"))
def lstm(inputs, attrs):
    """Sequence LSTM (ref: lstm_op.cc). Input is dense-padded [B, T, 4D]
    of pre-projected gates (the fc + lstm pairing), Weight [D, 4D] =
    {W_ch, W_ih, W_fh, W_oh}, Bias [1, 4D] = {b_c, b_i, b_f, b_o} (with
    ``use_peepholes`` [1, 7D]: then W_ic, W_fc, W_oc), optional Length
    [B] for ragged batches. Outputs Hidden / Cell [B, T, D].

    ``is_reverse`` with Length reverses each sequence within its own
    length, not the padded window. Gate order is the reference's
    (c, i, f, o), not rnn_scan's (i, f, g, o)."""
    x = inputs["Input"][0]
    seq_len = (inputs["Length"][0].reshape(-1).to(torch.int32)
               if inputs.get("Length") else None)
    w = inputs["Weight"][0]
    bias = (inputs.get("Bias") or [None])[0]
    h = (inputs.get("H0") or [None])[0]
    c = (inputs.get("C0") or [None])[0]
    use_peep = bool(attrs.get("use_peepholes", False))
    gate_act = _act(attrs.get("gate_activation", "sigmoid"))
    cell_act = _act(attrs.get("cell_activation", "tanh"))
    cand_act = _act(attrs.get("candidate_activation", "tanh"))
    reverse = bool(attrs.get("is_reverse", False))
    b, t, d4 = x.shape
    d = d4 // 4
    if h is None:
        h = x.new_zeros((b, d))
    if c is None:
        c = x.new_zeros((b, d))
    w_ic = w_fc = w_oc = None
    if bias is not None:
        flat = bias.reshape(-1)
        enforce(flat.shape[0] == (7 * d if use_peep else 4 * d),
                f"lstm Bias must be [{'7D' if use_peep else '4D'}], got "
                f"{flat.shape[0]} with D={d}", InvalidArgumentError)
        if use_peep:
            w_ic, w_fc, w_oc = (flat[4 * d:5 * d], flat[5 * d:6 * d],
                                flat[6 * d:7 * d])
            flat = flat[:4 * d]
        x = x + flat.reshape(1, 1, -1)
    else:
        enforce(not use_peep, "use_peepholes needs the [1,7D] Bias "
                "carrying the peephole weights", InvalidArgumentError)
    if reverse and seq_len is not None:
        x = ragged_reverse(x, seq_len)
    steps = range(t - 1, -1, -1) if reverse and seq_len is None \
        else range(t)
    hs, cs, gs = [None] * t, [None] * t, [None] * t
    for s in steps:
        gates = torch.addmm(x[:, s], h, w)
        gc, gi, gf, go = gates.chunk(4, dim=-1)
        if use_peep:
            # peephole connections (lstm_kernel.h): i and f see c_prev,
            # o sees c_new
            gi = gi + w_ic * c
            gf = gf + w_fc * c
        c = gate_act(gf) * c + gate_act(gi) * cand_act(gc)
        if use_peep:
            go = go + w_oc * c
        h = gate_act(go) * cell_act(c)
        hs[s], cs[s], gs[s] = h, c, gates
    hs, cs, gs = _stack(hs, x, d), _stack(cs, x, d), _stack(gs, x, d4)
    if reverse and seq_len is not None:
        hs, cs, gs = (ragged_reverse(v, seq_len) for v in (hs, cs, gs))
    return {"Hidden": [hs], "Cell": [cs], "BatchGate": [gs],
            "BatchCellPreAct": [cs]}


@register_op("lstmp", intermediate_outputs=("BatchGate",
                                            "BatchHidden"))
def lstmp(inputs, attrs):
    """LSTM with recurrent projection (ref: lstmp_op.cc): the recurrent
    state is r = proj_act(h @ ProjWeight) [B, P]; Weight is [P, 4D]."""
    x = inputs["Input"][0]
    w = inputs["Weight"][0]
    w_proj = inputs["ProjWeight"][0]
    bias = (inputs.get("Bias") or [None])[0]
    gate_act = _act(attrs.get("gate_activation", "sigmoid"))
    cell_act = _act(attrs.get("cell_activation", "tanh"))
    cand_act = _act(attrs.get("candidate_activation", "tanh"))
    proj_act = _act(attrs.get("proj_activation", "tanh"))
    reverse = bool(attrs.get("is_reverse", False))
    b, t, d4 = x.shape
    d = d4 // 4
    p = w_proj.shape[1]
    r = (inputs.get("H0") or [None])[0]
    c = (inputs.get("C0") or [None])[0]
    if r is None:
        r = x.new_zeros((b, p))
    if c is None:
        c = x.new_zeros((b, d))
    if bias is not None:
        x = x + bias.reshape(1, 1, -1)
    rs, cs, hs = [None] * t, [None] * t, [None] * t
    for s in (range(t - 1, -1, -1) if reverse else range(t)):
        gates = torch.addmm(x[:, s], r, w)
        gc, gi, gf, go = gates.chunk(4, dim=-1)
        c = gate_act(gf) * c + gate_act(gi) * cand_act(gc)
        h = gate_act(go) * cell_act(c)
        r = proj_act(h @ w_proj)
        rs[s], cs[s], hs[s] = r, c, h
    rs, cs, hs = _stack(rs, x, p), _stack(cs, x, d), _stack(hs, x, d)
    return {"Projection": [rs], "Cell": [cs], "BatchGate": [hs],
            "BatchHidden": [hs]}


def _gru_step(x_t, h, w, origin_mode, gate_act, cand_act):
    """One fluid GRU step: gates [u, r, c]; W [D, 3D] with the candidate
    block last (gru_unit_op.h slice layout)."""
    d = h.shape[-1]
    g_ur = x_t[:, :2 * d] + h @ w[:, :2 * d]
    u = gate_act(g_ur[:, :d])
    r = gate_act(g_ur[:, d:])
    g_c = x_t[:, 2 * d:] + (r * h) @ w[:, 2 * d:]
    c = cand_act(g_c)
    if origin_mode:
        h_new = c + u * (h - c)       # (1-u)*c + u*h_prev
    else:
        h_new = u * (c - h) + h       # u*c + (1-u)*h_prev
    return h_new, r, torch.cat([g_ur, g_c], dim=-1)


@register_op("gru", intermediate_outputs=("BatchGate",
                                          "BatchResetHiddenPrev",
                                          "BatchHidden"))
def gru(inputs, attrs):
    """Sequence GRU (ref: gru_op.cc): Input dense-padded [B, T, 3D]
    pre-projected, Weight [D, 3D] (update and reset blocks, then the
    candidate), Bias [1, 3D]."""
    x = inputs["Input"][0]
    w = inputs["Weight"][0]
    bias = (inputs.get("Bias") or [None])[0]
    h = (inputs.get("H0") or [None])[0]
    gate_act = _act(attrs.get("gate_activation", "sigmoid"))
    cand_act = _act(attrs.get("activation", "tanh"))
    origin = bool(attrs.get("origin_mode", False))
    reverse = bool(attrs.get("is_reverse", False))
    b, t, d3 = x.shape
    if h is None:
        h = x.new_zeros((b, d3 // 3))
    if bias is not None:
        x = x + bias.reshape(1, 1, -1)
    hs, rh, gs = [None] * t, [None] * t, [None] * t
    for s in (range(t - 1, -1, -1) if reverse else range(t)):
        h_new, r, gates = _gru_step(x[:, s], h, w, origin, gate_act,
                                    cand_act)
        rh[s], gs[s] = r * h, gates
        hs[s] = h = h_new
    d = d3 // 3
    hs, rh, gs = _stack(hs, x, d), _stack(rh, x, d), _stack(gs, x, d3)
    return {"Hidden": [hs], "BatchGate": [gs],
            "BatchResetHiddenPrev": [rh], "BatchHidden": [hs]}


def _one_step_meta(op_type, slot):
    """Shape inference of a loop over time: the compute on the first
    step of ``slot``'s [B, T, ...] on ``meta`` tensors, its [B, 1, ...]
    outputs widened to T (the loop would run T steps of nothing)."""
    @register_infer_meta(op_type)
    def rule(inputs, attrs):
        x = inputs[slot][0]
        t = x.shape[1]
        outs = OpInfoMap.instance().get(op_type).compute(
            dict(inputs, **{slot: [x[:, :min(t, 1)]]}), attrs)
        return {s: [v.expand((v.shape[0], t) + tuple(v.shape[2:]))
                    if v.ndim >= 3 else v for v in vs]
                for s, vs in outs.items()}


for _op_type, _slot in (("rnn_scan", "X"), ("lstm", "Input"),
                        ("lstmp", "Input"), ("gru", "Input")):
    _one_step_meta(_op_type, _slot)


# gru_unit's activation codes (gru_unit_op.h); the fluid builder passes
# the names, which the port takes too
_GRU_UNIT_ACTS = {0: "identity", 1: "sigmoid", 2: "tanh", 3: "relu"}


def _gru_unit_act(value):
    return _act(value if isinstance(value, str)
                else _GRU_UNIT_ACTS[int(value)])


@register_op("gru_unit", intermediate_outputs=("Gate",
                                               "ResetHiddenPrev"))
def gru_unit(inputs, attrs):
    """Single GRU step (ref: gru_unit_op.h). The activations are codes
    (0 identity, 1 sigmoid, 2 tanh, 3 relu) or their names."""
    x = inputs["Input"][0]
    h_prev = inputs["HiddenPrev"][0]
    w = inputs["Weight"][0]
    bias = (inputs.get("Bias") or [None])[0]
    gate_act = _gru_unit_act(attrs.get("gate_activation", 1))
    cand_act = _gru_unit_act(attrs.get("activation", 2))
    origin = bool(attrs.get("origin_mode", False))
    if bias is not None:
        x = x + bias.reshape(1, -1)
    h_new, r, gates = _gru_step(x, h_prev, w, origin, gate_act, cand_act)
    return {"Hidden": [h_new], "Gate": [gates],
            "ResetHiddenPrev": [r * h_prev]}


@register_op("lstm_unit")
def lstm_unit(inputs, attrs):
    """Single LSTM step (ref: lstm_unit_op.h): X [B, 4D] gate order
    (i, f, o, g) with forget_bias added to f."""
    x = inputs["X"][0]
    c_prev = inputs["C_prev"][0]
    fb = float(attrs.get("forget_bias", 0.0))
    i, f, o, g = x.chunk(4, dim=-1)
    c = torch.sigmoid(f + fb) * c_prev + torch.sigmoid(i) * torch.tanh(g)
    h = torch.sigmoid(o) * torch.tanh(c)
    return {"C": [c], "H": [h]}


@register_op("row_conv")
def row_conv(inputs, attrs):
    """Lookahead row convolution (ref: row_conv_op.cc): X [B, T, D],
    Filter [future_context, D]; out[t] = sum_j x[t+j] * filter[j]."""
    x = inputs["X"][0]
    filt = inputs["Filter"][0]
    k, t = filt.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, 0, k - 1))
    out = 0.0
    for j in range(k):
        out = out + xp[:, j:j + t] * filt[j][None, None, :]
    return {"Out": [out]}


@register_op("conv_shift")
def conv_shift(inputs, attrs):
    """Circular convolution (ref: conv_shift_op.cc): X [B, M],
    Y [B, N] (N odd) -> out[i] = sum_j x[(i + j - N/2) mod M] * y[j]."""
    x, y = inputs["X"][0], inputs["Y"][0]
    m, n = x.shape[1], y.shape[1]
    idx = (torch.arange(m, device=x.device)[:, None] +
           torch.arange(n, device=x.device)[None, :] - n // 2) % m
    gathered = x[:, idx]                           # [B, M, N]
    return {"Out": [torch.einsum("bmn,bn->bm", gathered, y)]}


@register_op("sequence_conv")
def sequence_conv(inputs, attrs):
    """Context-window sequence conv (ref: sequence_conv_op.cc): X dense
    [B, T, D], Filter [context_length*D, F]; zero-padded context
    starting at context_start."""
    x = inputs["X"][0]
    filt = inputs["Filter"][0]
    ctx_len = int(attrs.get("contextLength",
                            attrs.get("context_length", 3)))
    ctx_start = int(attrs.get("contextStart",
                              attrs.get("context_start", -1)))
    t = x.shape[1]
    cols = []
    for j in range(ctx_len):
        shift = ctx_start + j
        if shift < 0:
            cols.append(F.pad(x, (0, 0, -shift, 0))[:, :t])
        else:
            cols.append(F.pad(x, (0, 0, 0, shift))[:, shift:])
    col = torch.cat(cols, dim=-1)                  # [B, T, ctx_len*D]
    return {"Out": [col @ filt]}
