"""Structured prediction and decoding ops: CTC, CRF, beam search, edit
distance.

Port of ``paddle_tpu/ops/decode_ops.py``. As in the JAX package,
sequences are dense-padded with explicit length vectors; the true-LoD
beam search and its backtrace run on the host, as the reference's did.
Notes:

- ``warpctc`` is torch's CTC loss fed straight from ``log_softmax`` (its
  backward is the gradient with respect to the logits through that
  log-softmax, not with respect to arbitrary log-probs). A label that
  cannot fit its input length (with its repeats) has no path: torch
  gives ``inf`` there and the reference's log-space scan its floor,
  ``-_NEG``, so the port returns that value, with a zero gradient (the
  reference's AD runs along the floor's paths and gives a gradient of no
  likelihood). With lengths given as tensors torch reads them on the
  host: one host sync a call on the card, and the CUDA backward adds
  with atomics, so the card's gradient is not bit-reproducible.
- ``edit_distance`` computes one row of the Levenshtein table at once:
  with ``cand[j] = min(up[j + 1] + 1, diag[j])`` the row is
  ``new[j] = j + cummin_k<=j(cand'[k] - k)`` (``cand'[0] = i + 1``),
  a few kernels a hypothesis position instead of one a table cell.
- ``ctc_align`` compacts the kept ids with a cumsum and a scatter,
  without reading anything on the host.
- ``crf_decoding`` keeps the first of tied maxima, as ``jnp.argmax``.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..core import lodctx
from ..core.enforce import host_only
from ..core.registry import register_infer_meta, register_op

_NEG = -1e30


def _lengths(inputs, slot, b, full, device):
    if inputs.get(slot):
        return inputs[slot][0].reshape(-1).long()
    return torch.full((b,), full, dtype=torch.long, device=device)


@register_op("warpctc", non_differentiable_inputs=("Label", "LogitsLength",
                                                   "LabelLength"))
def warpctc(inputs, attrs):
    """CTC loss (ref: warpctc_op.cc). Logits [B, T, C] raw (softmax
    applied inside, as warpctc), Label [B, L] padded, LogitsLength [B],
    LabelLength [B]. Loss [B, 1]; ``norm_by_times`` divides the loss by
    the input length, as the JAX package does."""
    logits = inputs["Logits"][0]
    label = inputs["Label"][0]
    blank = int(attrs.get("blank", 0))
    norm_by_times = bool(attrs.get("norm_by_times", False))
    b, t_max, _ = logits.shape
    t_len = _lengths(inputs, "LogitsLength", b, t_max, logits.device)
    l_len = _lengths(inputs, "LabelLength", b, label.shape[1],
                     logits.device)
    lab = label.reshape(b, -1).long()
    logp = F.log_softmax(logits, dim=-1)
    loss = F.ctc_loss(logp.transpose(0, 1), lab, t_len, l_len, blank=blank,
                      reduction="none", zero_infinity=True)
    # a row with no path (its label and repeats need more steps than it
    # has) takes the reference's log-space floor, not torch's inf
    pos = torch.arange(1, lab.shape[1], device=lab.device)
    repeats = ((lab[:, 1:] == lab[:, :-1]) &
               (pos[None, :] < l_len[:, None])).sum(1)
    loss = torch.where(l_len + repeats > t_len, loss.new_full((), -_NEG),
                       loss)
    if norm_by_times:
        loss = loss / t_len.to(loss.dtype)
    return {"Loss": [loss[:, None]]}


@register_infer_meta("warpctc")
def _warpctc_meta(inputs, attrs):
    """torch's CTC has no ``meta`` kernel: Loss is [B, 1] in the logits'
    dtype."""
    logits = inputs["Logits"][0]
    return {"Loss": [logits.new_empty((logits.shape[0], 1))]}


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
    length = _lengths(inputs, "Length", b, t_max, em.device)
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


@register_op("crf_decoding", non_differentiable_inputs=("Emission",
                                                        "Transition",
                                                        "Label",
                                                        "Length"))
def crf_decoding(inputs, attrs):
    """Viterbi decode (ref: crf_decoding_op.cc). ViterbiPath [B, T]
    (padded steps hold 0); with Label given, the per-position
    correctness mask (1 where decoded == label, ref crf_decoding_op.h:70)
    instead. The recursion runs over the batch at once; a row past its
    length keeps its scores and records no back-pointer (-1), and the
    backtrace passes such a step's tag through."""
    em = inputs["Emission"][0]
    trans = inputs["Transition"][0]
    b, t_max, _ = em.shape
    length = _lengths(inputs, "Length", b, t_max, em.device)
    start, end, mat = trans[0], trans[1], trans[2:]
    a = start + em[:, 0]
    back = []
    for t in range(1, t_max):
        best, arg = (a[:, :, None] + mat).max(dim=1)   # first of ties
        keep = (t < length)[:, None]
        a = torch.where(keep, best + em[:, t], a)
        back.append(torch.where(keep, arg, -1))
    tok = (a + end).argmax(dim=1)
    path = [tok]
    for bp in reversed(back):
        prev = bp.gather(1, tok[:, None])[:, 0]
        tok = torch.where(prev >= 0, prev, tok)
        path.append(tok)
    path = torch.stack(path[::-1], dim=1)
    ts = torch.arange(t_max, device=em.device)[None, :]
    valid = ts < length[:, None]
    path = torch.where(valid, path, 0)
    if inputs.get("Label"):
        lab = inputs["Label"][0].long()
        if lab.ndim == 3:
            lab = lab[..., 0]
        path = ((path == lab) & valid).long()
    return {"ViterbiPath": [path]}


@register_op("beam_search", non_differentiable_inputs=("pre_ids",
                                                       "pre_scores",
                                                       "ids", "scores"))
def beam_search(inputs, attrs):
    """One beam-search step (ref: beam_search_op.cc, densified): scores
    [batch*beam, K] of log-probs for the next token; the top beam_size
    continuations of each source sentence. selected_ids /
    selected_scores [batch*beam, 1], parent_idx [batch*beam] (the row in
    the previous beam, for gather_tree). A finished beam (pre_id ==
    end_id) is frozen: it continues with end_id at its score. Ties keep
    the lower index first, as ``lax.top_k`` (a stable sort).

    A step whose pre_ids / pre_scores carry a LoD (an eager LoD program,
    the book's machine-translation decode) takes the true-LoD route on
    the host, as the reference did (:func:`_beam_search_lod`)."""
    if lodctx.in_infer_shape():
        # build-time proxy: the selection count depends on the data
        p = inputs["pre_ids"][0]
        return {"selected_ids": [p.long()],
                "selected_scores": [inputs["pre_scores"][0].float()],
                "parent_idx": [p.reshape(-1).long()]}
    if lodctx.input_lod("pre_scores") or lodctx.input_lod("pre_ids"):
        return _beam_search_lod(inputs, attrs)
    pre_ids = inputs["pre_ids"][0].reshape(-1)
    pre_scores = inputs["pre_scores"][0].reshape(-1)
    scores = inputs["scores"][0]
    ids = (inputs.get("ids") or [None])[0]
    beam = int(attrs["beam_size"])
    end_id = int(attrs["end_id"])
    total, nk = scores.shape
    batch = total // beam
    finished = (pre_ids == end_id)[:, None]
    # is_accumulated: the caller already folded pre_scores in (the fluid
    # builder's contract); a bare op call adds them here
    base = scores if attrs.get("is_accumulated", False) \
        else scores + pre_scores[:, None]
    cont = torch.where(finished, _NEG, base)
    keep_col = (torch.arange(nk, device=scores.device) == end_id)[None, :]
    cont = torch.where(finished & keep_col, pre_scores[:, None], cont)
    flat = cont.reshape(batch, beam * nk)
    top_s, top_i = torch.sort(flat, dim=1, descending=True, stable=True)
    top_s, top_i = top_s[:, :beam], top_i[:, :beam]
    token = top_i % nk
    if ids is not None:
        token = ids.reshape(batch, beam * nk).gather(1, top_i)
    parent = top_i // nk + torch.arange(
        batch, device=scores.device)[:, None] * beam
    return {"selected_ids": [token.reshape(-1, 1).long()],
            "selected_scores": [top_s.reshape(-1, 1)],
            "parent_idx": [parent.reshape(-1).long()]}


def _beam_search_lod(inputs, attrs):
    """True-LoD beam step on the host (ref: beam_search_op.cc).

    pre_ids / pre_scores: [N, 1] with a 2-level LoD (level 0: each
    source's offsets over level 1; level 1: one sequence a parent row).
    ids / scores: [N, K] candidate continuations (top-k tokens and their
    accumulated log-probs). A finished parent (pre_id == end_id) gives
    its one frozen item; a live one its K continuations. The top
    beam_size of each source win; a source whose winners all end is
    pruned (it emits nothing, which is what ends the loop's is_empty).
    Four reads from the device (the inputs; one host sync each on the
    card) and one copy of the selection back."""
    pre_ids = host_only(inputs["pre_ids"][0], "beam_search").reshape(-1)
    pre_scores = host_only(inputs["pre_scores"][0],
                           "beam_search").reshape(-1)
    cand_ids = (host_only(inputs["ids"][0], "beam_search")
                if inputs.get("ids") else None)
    cand_scores = host_only(inputs["scores"][0], "beam_search")
    device = inputs["scores"][0].device
    beam = int(attrs["beam_size"])
    end_id = int(attrs["end_id"])
    accumulated = bool(attrs.get("is_accumulated", True))
    lod = lodctx.input_lod("pre_scores") or lodctx.input_lod("pre_ids")
    level0, level1 = lod[0], lod[-1]
    sel_ids, sel_scores = [], []
    per_parent = [0] * len(pre_ids)
    src_entry_offsets = [0]
    for s in range(len(level0) - 1):
        row_lo, row_hi = level1[level0[s]], level1[level0[s + 1]]
        items = []                       # (score, token, parent row)
        for r in range(row_lo, row_hi):
            if int(pre_ids[r]) == end_id:
                items.append((float(pre_scores[r]), end_id, r))
                continue
            for k in range(cand_scores.shape[1]):
                tok = int(cand_ids[r, k]) if cand_ids is not None else k
                sc = float(cand_scores[r, k])
                if not accumulated:      # raw step log-probs
                    sc += float(pre_scores[r])
                items.append((sc, tok, r))
        items.sort(key=lambda it: -it[0])
        winners = items[:beam]
        if winners and all(t == end_id for _, t, _ in winners):
            winners = []                 # the source is complete
        winners.sort(key=lambda it: it[2])   # grouped by parent row
        for sc, tok, r in winners:
            sel_ids.append(tok)
            sel_scores.append(sc)
            per_parent[r] += 1
        src_entry_offsets.append(src_entry_offsets[-1] + (row_hi - row_lo))
    out_lod = [src_entry_offsets, lodctx.lengths_to_offsets(per_parent)]
    lodctx.set_output_lod("selected_ids", out_lod)
    lodctx.set_output_lod("selected_scores", out_lod)
    m = len(sel_ids)
    return {"selected_ids": [torch.from_numpy(np.asarray(
                sel_ids, np.int64).reshape(m, 1)).to(device)],
            "selected_scores": [torch.from_numpy(np.asarray(
                sel_scores, np.float32).reshape(m, 1)).to(device)],
            "parent_idx": [torch.zeros((m,), dtype=torch.int64,
                                       device=device)]}


def _beam_search_decode_lod(inputs, attrs):
    """True-LoD backtrace over the grown step arrays, on the host (ref:
    beam_search_decode_op.cc). Entry t of each array holds (ids [M_t, 1],
    lod_t) of step t; a row's parent is found through lod_t's level 1
    (one sequence a parent row of step t-1). Emits the flat sentences
    with the reference's 2-level LoD (source -> sentences -> tokens),
    the start token left out. One read from the device an entry."""
    entries = [e for e in inputs["Ids"][0] if e is not None]
    s_entries = [e for e in inputs["Scores"][0] if e is not None]
    device = entries[0][0].device
    last = len(entries) - 1                   # entry 0 is the start
    vals = [host_only(v, "beam_search_decode").reshape(-1)
            for v, _ in entries]
    lods = [lod for _, lod in entries]
    svals = [host_only(v, "beam_search_decode").reshape(-1)
             for v, _ in s_entries]

    def rows_of(t, s):
        l0, l1 = lods[t][0], lods[t][-1]
        return l1[l0[s]], l1[l0[s + 1]]

    sent_tokens, sent_scores = [], []
    level0, level1 = [0], [0]
    for s in range(len(lods[0][0]) - 1):
        t_last = next((t for t in range(last, 0, -1)
                       if rows_of(t, s)[1] > rows_of(t, s)[0]), 0)
        n_sent = 0
        if t_last > 0:
            lo, hi = rows_of(t_last, s)
            for j in range(lo, hi):
                toks, scs = [], []
                jt = j
                for t in range(t_last, 0, -1):
                    toks.append(int(vals[t][jt]))
                    scs.append(float(svals[t][jt]))
                    jt = int(np.searchsorted(np.asarray(lods[t][-1]), jt,
                                             side="right") - 1)
                sent_tokens.extend(toks[::-1])
                sent_scores.extend(scs[::-1])
                level1.append(level1[-1] + len(toks))
                n_sent += 1
        level0.append(level0[-1] + n_sent)
    out_lod = [level0, level1]
    lodctx.set_output_lod("SentenceIds", out_lod)
    lodctx.set_output_lod("SentenceScores", out_lod)
    n = len(sent_tokens)
    return {"SentenceIds": [torch.from_numpy(np.asarray(
                sent_tokens, np.int64).reshape(n, 1)).to(device)],
            "SentenceScores": [torch.from_numpy(np.asarray(
                sent_scores, np.float32).reshape(n, 1)).to(device)]}


@register_op("beam_search_decode",
             non_differentiable_inputs=("Ids", "Scores", "ParentIdx"))
def beam_search_decode(inputs, attrs):
    """Backtrace full beams (ref: beam_search_decode_op.cc, densified):
    Ids / ParentIdx / Scores stacked a step [T, batch, beam] -> each
    beam's token path and scores [T, batch, beam] (gather_tree). Tensor
    arrays of (value, LoD) entries (an eager LoD program) take the
    true-LoD route on the host."""
    from .array_ops import LoDTensorArrayValue
    if lodctx.in_infer_shape():
        flat = inputs["Ids"][0].reshape(-1, 1)
        return {"SentenceIds": [flat.long()],
                "SentenceScores": [flat.float()]}
    if isinstance(inputs["Ids"][0], LoDTensorArrayValue):
        return _beam_search_decode_lod(inputs, attrs)
    ids = inputs["Ids"][0]
    parents = inputs["ParentIdx"][0]
    scores = (inputs.get("Scores") or [ids.float()])[0]
    t, batch, beam = ids.shape
    parent = torch.arange(beam, device=ids.device).expand(batch, beam)
    rid, rsc = [], []
    for tt in range(t - 1, -1, -1):
        rid.append(ids[tt].gather(1, parent))
        rsc.append(scores[tt].gather(1, parent))
        parent = parents[tt].gather(1, parent) % beam
    return {"SentenceIds": [torch.stack(rid[::-1])],
            "SentenceScores": [torch.stack(rsc[::-1])]}


@register_op("edit_distance", non_differentiable_inputs=("Hyps", "Refs",
                                                         "HypsLength",
                                                         "RefsLength"))
def edit_distance(inputs, attrs):
    """Levenshtein distance (ref: edit_distance_op.cc). Hyps [B, L1],
    Refs [B, L2] dense-padded with length vectors; Out [B, 1] float32
    (divided by the reference's length, at least 1, when
    ``normalized``), SequenceNum the batch size. One DP row a hypothesis
    position, over the batch at once (the module's note); a row past its
    hypothesis length keeps its values, and the distance is read at the
    reference's length."""
    hyps = inputs["Hyps"][0].long()
    refs = inputs["Refs"][0].long()
    b, l1 = hyps.shape
    l2 = refs.shape[1]
    dev = hyps.device
    h_len = _lengths(inputs, "HypsLength", b, l1, dev)
    r_len = _lengths(inputs, "RefsLength", b, l2, dev)
    normalized = bool(attrs.get("normalized", False))
    js = torch.arange(l2 + 1, dtype=torch.float32, device=dev)
    row = torch.where(js[None, :] <= r_len[:, None].float(), js[None, :],
                      torch.full((), 1e9, device=dev))
    for i in range(l1):
        diag = row[:, :-1] + (refs != hyps[:, i:i + 1]).float()
        cand = torch.minimum(row[:, 1:] + 1, diag)
        first = torch.full((b, 1), float(i + 1), device=dev)
        new = js + torch.cummin(torch.cat([first, cand], 1) - js,
                                dim=1).values
        row = torch.where((i < h_len)[:, None], new, row)
    d = row.gather(1, r_len[:, None])
    if normalized:
        d = d / torch.clamp_min(r_len[:, None].float(), 1.0)
    return {"Out": [d],
            "SequenceNum": [torch.full((), b, dtype=torch.int64,
                                       device=dev)]}


@register_op("ctc_align", non_differentiable_inputs=("Input",
                                                     "InputLength"))
def ctc_align(inputs, attrs):
    """CTC greedy decode's post-process (ref: ctc_align_op.cc): merge
    repeats, then drop blanks. Output [B, T] int64 dense-padded with
    attr ``padding_value``, OutputLength [B, 1]. The kept ids move to
    their places (a cumsum over the keep mask) by one scatter; the
    dropped ones land in a spare column that is cut off."""
    x = inputs["Input"][0].long()
    blank = int(attrs.get("blank", 0))
    pad_val = int(attrs.get("padding_value", 0))
    b, t = x.shape
    lens = _lengths(inputs, "InputLength", b, t, x.device)
    prev = torch.cat([torch.full((b, 1), -1, dtype=torch.long,
                                 device=x.device), x[:, :-1]], 1)
    ts = torch.arange(t, device=x.device)[None, :]
    keep = (x != blank) & (x != prev) & (ts < lens[:, None])
    target = torch.where(keep, torch.cumsum(keep, 1) - 1, t)
    out = torch.full((b, t + 1), pad_val, dtype=torch.long, device=x.device)
    out.scatter_(1, target, torch.where(keep, x, pad_val))
    return {"Output": [out[:, :t]],
            "OutputLength": [keep.sum(1, keepdim=True)]}
