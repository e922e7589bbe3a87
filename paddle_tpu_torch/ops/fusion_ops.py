"""The fused-operator family (ref: operators/fused/, attention_lstm_op.cc,
fusion_*_op.cc).

Port of ``paddle_tpu/ops/fusion_ops.py``. The reference hand-fuses these
for the CPU (xbyak) or cuDNN; the JAX package writes each as its plain
composition and leaves the fusing to XLA, and the port does the same
over torch's kernels. The op exists so that fluid programs that hold the
fused form load and run. The RNN fusions compose the port's registered
``gru`` / ``lstm`` / ``sequence_conv`` / ``sequence_pool`` ops through
``OpInfoMap``, as the JAX package composes its own: the fluid gate order
(c, i, f, o) is theirs. ``attention_lstm`` has its own order, (f, i, o,
c). Sequences are dense [B, T, ...] with an optional Length.
"""
from __future__ import annotations

import torch

from ..core.enforce import InvalidArgumentError, enforce
from ..core.registry import OpInfoMap, register_op


def _act(name):
    return {"sigmoid": torch.sigmoid, "tanh": torch.tanh,
            "relu": torch.relu, "identity": lambda v: v,
            "": lambda v: v}[name or "identity"]


def _rnn(op_type, xg, wh, inputs, attrs, slots):
    inner = {"Input": [xg], "Weight": [wh]}
    for slot in slots:
        if inputs.get(slot):
            inner[slot] = inputs[slot]
    return OpInfoMap.instance().get(op_type).compute(inner, attrs)


# ------------------------------------------------------------ rnn fusions
@register_op("fusion_gru", intermediate_outputs=("XX", "ReorderedH0",
                                                 "BatchedInput",
                                                 "BatchedOut"))
def fusion_gru(inputs, attrs):
    """ref: operators/fused/fusion_gru_op.cc — fc + gru in one op:
    X [B, T, M] @ WeightX [M, 3D] (+ Bias), then the gru recurrence with
    WeightH [D, 3D]."""
    xg = torch.einsum("btm,md->btd", inputs["X"][0], inputs["WeightX"][0])
    out = _rnn("gru", xg, inputs["WeightH"][0], inputs, attrs,
               ("Bias", "H0"))
    return {"Hidden": out["Hidden"], "XX": [xg], "BatchedInput": [xg],
            "BatchedOut": out["Hidden"]}


@register_op("fusion_lstm", intermediate_outputs=("XX", "BatchedInput",
                                                  "BatchedHidden",
                                                  "BatchedCell",
                                                  "ReorderedH0",
                                                  "ReorderedC0"))
def fusion_lstm(inputs, attrs):
    """ref: operators/fused/fusion_lstm_op.cc — fc + lstm: X [B, T, M] @
    WeightX [M, 4D], then the lstm recurrence with WeightH [D, 4D]."""
    xg = torch.einsum("btm,md->btd", inputs["X"][0], inputs["WeightX"][0])
    out = _rnn("lstm", xg, inputs["WeightH"][0], inputs, attrs,
               ("Bias", "H0", "C0"))
    return {"Hidden": out["Hidden"], "Cell": out["Cell"], "XX": [xg],
            "BatchedInput": [xg], "BatchedHidden": out["Hidden"],
            "BatchedCell": out["Cell"]}


@register_op("fused_embedding_fc_lstm",
             intermediate_outputs=("XX", "BatchedInput", "BatchedHidden",
                                   "BatchedCell", "ReorderedH0",
                                   "ReorderedC0"),
             non_differentiable_inputs=("Ids",))
def fused_embedding_fc_lstm(inputs, attrs):
    """ref: operators/fused/fused_embedding_fc_lstm_op.cc — the
    embedding table is pre-multiplied by the FC weight (Embeddings
    [V, 4D]), so the lookup is the projection; then the lstm
    recurrence."""
    ids = inputs["Ids"][0].long()
    if ids.ndim == 3 and ids.shape[-1] == 1:
        ids = ids[..., 0]
    xg = inputs["Embeddings"][0][ids]                 # [B, T, 4D]
    out = _rnn("lstm", xg, inputs["WeightH"][0], inputs, attrs,
               ("Bias", "H0", "C0"))
    return {"Hidden": out["Hidden"], "Cell": out["Cell"], "XX": [xg],
            "BatchedInput": [xg], "BatchedHidden": out["Hidden"],
            "BatchedCell": out["Cell"]}


@register_op("attention_lstm",
             intermediate_outputs=("AttentionedX", "AttentionFCOut",
                                   "LSTMX", "LSTMOUT"),
             non_differentiable_inputs=("Length",))
def attention_lstm(inputs, attrs):
    """ref: operators/attention_lstm_op.cc — at each step: score every
    source position with relu(fc([x_t; h])), softmax over the valid
    positions, pool a context vector, then one LSTM step on [context; h]
    @ LSTMWeight [M + D, 4D], gate order (f, i, o, c). X [B, T, M] and an
    optional Length [B]. A Python loop over T; the score of x, which no
    step changes, is computed once."""
    x = inputs["X"][0]
    c = inputs["C0"][0]
    h = (inputs.get("H0") or [None])[0]
    attw = inputs["AttentionWeight"][0]
    attb = (inputs.get("AttentionBias") or [None])[0]
    scal = (inputs.get("AttentionScalar") or [None])[0]
    scalb = (inputs.get("AttentionScalarBias") or [None])[0]
    lstm_w = inputs["LSTMWeight"][0]
    lstm_b = inputs["LSTMBias"][0]
    length = (inputs.get("Length") or [None])[0]
    b, t, m = x.shape
    d = c.shape[-1]
    enforce(attw.shape[0] == m + d and lstm_w.shape[0] == m + d,
            "attention_lstm: AttentionWeight/LSTMWeight must have "
            f"{m + d} rows", InvalidArgumentError)
    if h is None:
        h = torch.zeros_like(c)
    if length is None:
        valid = torch.ones((b, t), dtype=torch.bool, device=x.device)
    else:
        valid = torch.arange(t, device=x.device)[None, :] < \
            length.reshape(-1, 1).long()
    xw = (x @ attw[:m])[..., 0]                       # [B, T]
    hs, cs = [], []
    for _ in range(t):
        score = xw + h @ attw[m:]
        if attb is not None:
            score = score + attb.reshape(())
        score = torch.relu(score)
        if scal is not None:
            score = torch.relu(scal.reshape(()) * score)
        if scalb is not None:
            score = score + scalb.reshape(())
        alpha = torch.softmax(torch.where(valid, score, -1e30), dim=1)
        context = torch.einsum("bt,btm->bm", alpha, x)
        gates = torch.cat([context, h], 1) @ lstm_w + lstm_b
        f, i, o, cand = torch.chunk(gates, 4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(cand)
        h = torch.sigmoid(o) * torch.tanh(c)
        hs.append(h)
        cs.append(c)
    return {"Hidden": [torch.stack(hs, 1)], "Cell": [torch.stack(cs, 1)],
            "AttentionedX": [xw], "LSTMX": [hs[-1]]}


# ------------------------------------------------------------ mlp fusions
@register_op("fusion_repeated_fc_relu", intermediate_outputs=("ReluOut",))
def fusion_repeated_fc_relu(inputs, attrs):
    """ref: operators/fused/fusion_repeated_fc_relu_op.cc — a chain of
    relu(x @ W + b)."""
    x = inputs["X"][0]
    ws = inputs["W"]
    bs = inputs.get("Bias", [None] * len(ws))
    enforce(len(ws) == len(bs), "fusion_repeated_fc_relu: W and Bias "
            "counts differ", InvalidArgumentError)
    for w, bias in zip(ws, bs):
        x = x @ w
        if bias is not None:
            x = x + bias.reshape(1, -1)
        x = torch.relu(x)
    return {"Out": [x]}


@register_op("fusion_squared_mat_sub")
def fusion_squared_mat_sub(inputs, attrs):
    """ref: operators/fused/fusion_squared_mat_sub_op.cc —
    ((X @ Y)^2 - X^2 @ Y^2) * scalar (the FM second-order term)."""
    x, y = inputs["X"][0], inputs["Y"][0]
    xy2 = torch.square(x @ y)
    scalar = float(attrs.get("scalar", 1.0))
    return {"Out": [(xy2 - torch.square(x) @ torch.square(y)) * scalar],
            "SquaredXY": [xy2]}


# ------------------------------------------------------- sequence fusions
@register_op("fusion_seqconv_eltadd_relu",
             intermediate_outputs=("ColMat",))
def fusion_seqconv_eltadd_relu(inputs, attrs):
    """ref: operators/fused/fusion_seqconv_eltadd_relu_op.cc —
    relu(sequence_conv(X) + FilterBias)."""
    out = OpInfoMap.instance().get("sequence_conv").compute(
        {"X": inputs["X"], "Filter": inputs["Filter"]}, attrs)["Out"][0]
    bias = inputs["FilterBias"][0]
    return {"Out": [torch.relu(out + bias.reshape(1, 1, -1))]}


@register_op("fusion_seqexpand_concat_fc",
             intermediate_outputs=("FCOut",))
def fusion_seqexpand_concat_fc(inputs, attrs):
    """ref: operators/fused/fusion_seqexpand_concat_fc_op.cc — X[0] is a
    sequence [B, T, D0], the rest are per-instance [B, Di] broadcast over
    time; concatenated on the features, then fc and the activation."""
    seq = inputs["X"][0]
    b, t = seq.shape[0], seq.shape[1]
    feats = [seq] + [e[:, None, :].expand(b, t, e.shape[-1])
                     for e in inputs["X"][1:]]
    out = torch.einsum("btm,mf->btf", torch.cat(feats, dim=-1),
                       inputs["FCWeight"][0])
    if inputs.get("FCBias"):
        out = out + inputs["FCBias"][0].reshape(1, 1, -1)
    return {"Out": [_act(attrs.get("fc_activation", "identity"))(out)]}


@register_op("fusion_seqpool_concat",
             non_differentiable_inputs=("Length",))
def fusion_seqpool_concat(inputs, attrs):
    """ref: operators/fused/fusion_seqpool_concat_op.cc — sequence_pool
    each input (one pooltype) and concatenate the pooled vectors.
    Lengths: one shared vector or one an input."""
    lengths = inputs.get("Length") or []
    pool = OpInfoMap.instance().get("sequence_pool")
    pooled = []
    for i, x in enumerate(inputs["X"]):
        if lengths:
            ln = lengths[min(i, len(lengths) - 1)]
        else:
            ln = torch.full((x.shape[0],), x.shape[1], dtype=torch.int32,
                            device=x.device)
        pooled.append(pool.compute(
            {"X": [x], "Length": [ln]},
            {"pooltype": attrs.get("pooltype", "SUM")})["Out"][0])
    return {"Out": [torch.cat(pooled, dim=-1)]}
