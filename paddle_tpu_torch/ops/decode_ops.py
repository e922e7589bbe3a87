"""Structured prediction ops.

Port of the op types of ``paddle_tpu/ops/decode_ops.py`` that the static
graph's book programs run: ``linear_chain_crf``. As in the JAX package,
sequences are dense-padded with an explicit length vector; the rest of
the module (CTC, Viterbi decode, beam search, edit distance) waits for
the op-set item of ROADMAP Queue 1.
"""
from __future__ import annotations

import torch

from ..core.registry import register_op


@register_op("linear_chain_crf",
             non_differentiable_inputs=("Label", "Length"),
             intermediate_outputs=("Alpha", "EmissionExps",
                                   "TransitionExps"))
def linear_chain_crf(inputs, attrs):
    """Linear-chain CRF log-likelihood (ref: linear_chain_crf_op.cc).
    Emission [B, T, C] dense-padded, Transition [C+2, C] (row 0 start,
    row 1 end, rows 2.. the [C, C] matrix), Label [B, T], Length [B].
    LogLikelihood [B, 1] is the NEGATIVE log-likelihood
    logZ - score(y) >= 0 (ref linear_chain_crf_op.h:216 returns -ll).
    The forward recursion runs over the batch at once, one step of T at
    a time; a row past its length keeps its alpha."""
    em = inputs["Emission"][0]
    trans = inputs["Transition"][0]
    label = inputs["Label"][0].long()
    b, t_max, _ = em.shape
    length = (inputs["Length"][0].reshape(-1).long()
              if inputs.get("Length")
              else torch.full((b,), t_max, dtype=torch.long,
                              device=em.device))
    if label.ndim == 3:
        label = label[..., 0]
    start, end, mat = trans[0], trans[1], trans[2:]
    # partition function by the forward recursion in log space
    a = start + em[:, 0]                                   # [B, C]
    for t in range(1, t_max):
        nxt = torch.logsumexp(a[:, :, None] + mat, dim=1) + em[:, t]
        a = torch.where((t < length)[:, None], nxt, a)
    logz = torch.logsumexp(a + end, dim=1)
    # the gold path's score
    ts = torch.arange(t_max, device=em.device)
    valid = ts[None, :] < length[:, None]                  # [B, T]
    picked = em.gather(2, label[..., None]).squeeze(2)     # [B, T]
    emit = torch.where(valid, picked, 0.0).sum(dim=1)
    tr = torch.where(valid[:, 1:], mat[label[:, :-1], label[:, 1:]],
                     0.0).sum(dim=1)
    last = label.gather(1, torch.clamp_min(length - 1, 0)[:, None])[:, 0]
    score = emit + tr + start[label[:, 0]] + end[last]
    return {"LogLikelihood": [(logz - score)[:, None]], "Alpha": [em],
            "EmissionExps": [torch.exp(em)],
            "TransitionExps": [torch.exp(trans)]}
