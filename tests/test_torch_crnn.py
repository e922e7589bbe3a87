"""The CRNN text recognizer (``chip_smoke.crnn_model``: the user script of
the decoding slice, written once against either package's ``nn``) in the
port against the JAX package, on the CPU, at narrow widths: convolutions
of 4, 8, 8, 8, 16, 16 and 16 channels, LSTMs of hidden 8, 37 classes,
1x32x40 images (T = 11), batch 4, labels of 2-5 characters. The network
is built by the JAX package from seed 0 and carried into the port's
(``convert.load_state_dict``); both take the same seeded batch through
``nn.CTCLoss`` (``warpctc``) and one ``Adadelta`` step (rho 0.9, lr 1.0).

Bounds (fp32; the JAX side's CTC scan runs in float64 under the tests'
x64 mode): the loss at rtol 1e-5; each parameter's gradient within 1e-4
of its norm and its update within 1e-4 of the update's norm (the two
frameworks sum the convolutions, norms and recurrences in other orders,
about 1e-6; a wrong pad, pool, gate or CTC term moves them by O(1)); the
BatchNorm running statistics at rtol 1e-5 / atol 1e-6. The greedy decode
(argmax, ``ctc_align``, ``edit_distance`` through each package's eager op
entry) of the JAX network's logits after the step, and of the same with a
seeded bias toward the labels: ids, lengths and distances equal.
"""
import types

import numpy as np
import pytest
import torch

import paddle_tpu as jpt
from paddle_tpu import nn as jnn
from paddle_tpu.dygraph.tracer import trace_op as jax_trace_op
from paddle_tpu.optimizer import Adadelta as JaxAdadelta

import chip_smoke as cs
import paddle_tpu_torch as tpt
from paddle_tpu_torch import nn
from paddle_tpu_torch.convert import load_state_dict

CFG = dict(cs.CRNN, channels=(4, 8, 8, 8, 16, 16, 16), hidden=8, width=40,
           batch=4, min_len=2, max_len=5)
LOSS_RTOL, GRAD_TOL, UPDATE_TOL = 1e-5, 1e-4, 1e-4


def _jax_api():
    return types.SimpleNamespace(
        nn=jnn, Adadelta=JaxAdadelta, squeeze=jpt.squeeze, full=jpt.full,
        argmax=jpt.argmax, to_tensor=jpt.to_tensor, trace_op=jax_trace_op,
        transpose=lambda x, perm: x.transpose(perm))


def _model(nn, api):
    return cs.crnn_model(nn, api, CFG["channels"], CFG["hidden"],
                         CFG["classes"])


@pytest.fixture(scope="module")
def runs():
    japi, tapi = _jax_api(), cs.port_crnn_api()
    jpt.seed(0)
    jmodel = _model(jnn, japi)
    start = {k: np.asarray(v.numpy()).copy()
             for k, v in jmodel.state_dict().items()}
    tpt.set_device("cpu")
    tmodel = _model(nn, tapi)
    load_state_dict(tmodel, start)
    imgs, labels, lens = cs.crnn_batch(np.random.RandomState(0),
                                       CFG["batch"], CFG)
    jg, tg = {}, {}
    jl = cs.crnn_step(japi, jmodel, jnn.CTCLoss(blank=0),
                      cs.crnn_opt(japi, jmodel, CFG), jpt.to_tensor(imgs),
                      jpt.to_tensor(labels), jpt.to_tensor(lens),
                      grads_of=jg)
    tl = cs.crnn_step(tapi, tmodel, nn.CTCLoss(blank=0),
                      cs.crnn_opt(tapi, tmodel, CFG), torch.from_numpy(imgs),
                      torch.from_numpy(labels), torch.from_numpy(lens),
                      grads_of=tg)
    jend = {k: np.asarray(v.numpy()) for k, v in
            jmodel.state_dict().items()}
    tend = {k: v.detach().numpy() for k, v in tmodel.state_dict().items()}
    return dict(start=start, jl=float(np.asarray(jl.numpy())),
                tl=tl.item(), jg=jg, tg=tg, jend=jend, tend=tend,
                jmodel=jmodel, japi=japi, tapi=tapi, labels=labels,
                lens=lens, imgs=imgs)


def _rel(got, want):
    return float(np.linalg.norm(got - want) /
                 max(np.linalg.norm(want), 1e-30))


def test_network_has_the_papers_layout():
    """Seven convolutions (the last 2x2, unpadded), BatchNorm after the
    fifth and sixth, four max pools, two bidirectional LSTMs, 37 classes;
    at the paper's widths 8,722,725 parameters and 26 columns of a
    1x32x100 image."""
    tpt.set_device("cpu")
    full = cs.crnn_model(nn, cs.port_crnn_api())
    kinds = [type(m).__name__ for m in full.cnn]
    assert kinds.count("Conv2D") == 7 and kinds.count("BatchNorm2D") == 2
    assert kinds.count("MaxPool2D") == 4
    assert sum(p.numel() for p in full.parameters()) == 8722725
    with torch.no_grad():
        out = full(torch.zeros(1, 1, 32, 100))
    assert tuple(out.shape) == (1, 26, 37)


def test_loss_matches_jax(runs):
    assert np.isfinite(runs["tl"])
    np.testing.assert_allclose(runs["tl"], runs["jl"], rtol=LOSS_RTOL)


def test_gradients_match_jax(runs):
    assert set(runs["tg"]) == set(runs["jg"]) and len(runs["tg"]) == 34
    errs = {n: _rel(runs["tg"][n], runs["jg"][n]) for n in runs["jg"]}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= GRAD_TOL, (worst, errs[worst])


def test_update_matches_jax(runs):
    """Each parameter after one Adadelta step, by its update's norm; the
    BatchNorm running statistics directly."""
    start, jend, tend = runs["start"], runs["jend"], runs["tend"]
    assert set(tend) == set(jend)
    for n in runs["jg"]:
        err = _rel(tend[n] - start[n], jend[n] - start[n])
        assert err <= UPDATE_TOL, (n, err)
        assert np.abs(jend[n] - start[n]).max() > 0, n
    stats = [n for n in jend if n not in runs["jg"]]
    assert len(stats) == 4
    for n in stats:
        np.testing.assert_allclose(tend[n], jend[n], rtol=1e-5, atol=1e-6,
                                   err_msg=n)


def _decode_both(runs, logits):
    """Both packages' decode of the same logits [B, T, C] (numpy):
    (JAX's, the port's) lists of ids, lengths and distances."""
    japi, tapi = runs["japi"], runs["tapi"]
    want = [np.asarray(v.numpy()) for v in cs.crnn_decode(
        japi, jpt.to_tensor(logits), jpt.to_tensor(runs["labels"]),
        jpt.to_tensor(runs["lens"]))]
    got = [v.numpy() for v in cs.crnn_decode(
        tapi, torch.from_numpy(logits), torch.from_numpy(runs["labels"]),
        torch.from_numpy(runs["lens"]))]
    return want, got


def test_greedy_decode_matches_jax(runs):
    """The JAX network's logits after the step through both packages'
    decode: argmax, ctc_align and the normalized edit distance."""
    logits = np.array(runs["jmodel"](jpt.to_tensor(runs["imgs"])).numpy())
    want, got = _decode_both(runs, logits)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[0].shape == (CFG["batch"], 11)


def test_label_biased_decode_matches_jax(runs):
    """The same logits with ``chip_smoke.crnn_label_bias`` (as the card's
    decode check takes them), so that the decode keeps characters, merges
    repeats and misses some: ids, lengths and distances equal, and the
    decode is neither empty nor all right."""
    logits = np.array(runs["jmodel"](jpt.to_tensor(runs["imgs"])).numpy())
    bias = cs.crnn_label_bias(np.random.RandomState(1), runs["labels"],
                              runs["lens"], logits.shape[1], CFG["classes"])
    biased = logits + (logits.max() - logits.min()) * bias
    want, got = _decode_both(runs, biased)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    ids = biased.argmax(-1)
    assert ((ids[:, 1:] == ids[:, :-1]) & (ids[:, 1:] != 0)).any()
    assert (got[1] > 0).all() and 0 < got[2].mean() < 1
