"""The contrib decoder and the cell drivers in the port against the JAX
package, on the CPU: ``static/decoder.py``'s ``TrainingDecoder`` and
``BeamSearchDecoder`` programs of ``tests/test_contrib_decoder.py``, and
``static.nn.rnn`` / ``birnn`` / ``dynamic_decode`` (with and without
``sequence_length``) of ``tests/test_module_builders.py:134-290``, as
``paddle_tpu_torch/testing/decoder_cases.py`` builds them.

Each program is built by both packages, and their JSON (main and
startup) must be equal; then both executors run it on the same feeds
from the same startup values (the port's startup run, carried into the
JAX scope by name, so that no JAX startup program compiles).

Tolerances (fp32): the training losses at rtol 1e-5 (four Adagrad steps;
the two frameworks sum the LSTM and the fc's in other orders, about
1e-7), the decoded ids and every LoD equal and their scores at rtol
1e-5 / atol 1e-6, the RNN outputs at rtol 1e-5 / atol 1e-6 and against
their manual recurrence.
"""
import types

import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu.static as jstatic
from paddle_tpu.nn import ParamAttr as JaxParamAttr
from paddle_tpu.optimizer import Adagrad as JaxAdagrad
from paddle_tpu.static import contrib_layers as jcontrib
from paddle_tpu.static import decoder as jdecoder

import paddle_tpu_torch as tpt
from paddle_tpu_torch.testing import decoder_cases as dc
from test_torch_program import _first_difference

JAX_API = types.SimpleNamespace(pt=jpt, static=jstatic, decoder=jdecoder,
                                contrib_layers=jcontrib,
                                ParamAttr=JaxParamAttr, Adagrad=JaxAdagrad)
PORT_API = dc.port_api()
TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def _cpu():
    tpt.set_device("cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jax_tensor(v, lod):
    return jpt.TpuTensor(v, lod)


def port_tensor(v, lod):
    return tpt.TpuTensor(v, lod, device="cpu")


def build_both(builder, *args):
    """The program built by each package (JSON held equal): (the JAX
    package's, the port's) outputs of ``builder``."""
    jout, pout = builder(JAX_API, *args), builder(PORT_API, *args)
    for jprog, pprog in zip(jout[:2], pout[:2]):
        assert pprog.to_json() == jprog.to_json(), _first_difference(
            pprog.to_json(), jprog.to_json())
    assert jout[2] == pout[2]
    return jout, pout


def run_both(jprogs, pprogs, feed, runs=1):
    """Both executors from the port's startup values: (JAX, port) runs."""
    values = dc.startup_values(pprogs[1])
    jruns = dc.run_program(JAX_API, jpt.Executor(), jax_tensor, jprogs[0],
                           values, feed, jprogs[2], runs)
    pruns = dc.run_program(PORT_API, tpt.Executor("cpu"), port_tensor,
                           pprogs[0], values, feed, pprogs[2], runs)
    return jruns, pruns


def test_training_decoder_trains_like_jax():
    """TrainingDecoder over DynamicRNN on ragged feeds, cross-entropy and
    Adagrad: four steps' losses equal the JAX package's and fall."""
    jprogs, pprogs = build_both(dc.training_decoder_program)
    types_ = set(pprogs[0].op_types())
    assert {"lstm", "adagrad"} <= types_
    jruns, pruns = run_both(jprogs, pprogs, dc.training_feeds(),
                            dc.TRAIN_STEPS)
    jl = [float(r[0][0]) for r in jruns]
    pl = [float(r[0][0]) for r in pruns]
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    assert np.isfinite(pl).all() and pl[-1] < pl[0]


def test_beam_search_decoder_decodes_like_jax():
    """BeamSearchDecoder: While over tensor arrays, sequence_expand,
    lod_reset, topk and beam_search on level-2 LoD feeds, then
    beam_search_decode: the sentences, their LoD and scores equal."""
    jprogs, pprogs = build_both(dc.beam_decoder_program)
    types_ = {o.type for b in pprogs[0].blocks for o in b.ops}
    assert {"while_loop", "beam_search", "beam_search_decode",
            "sequence_expand", "lod_reset", "top_k_v2"} <= types_
    (jr,), (pr,) = run_both(jprogs, pprogs, dc.beam_feeds())
    (jid, jlod), (jsc, _) = jr
    (pid, plod), (psc, _) = pr
    np.testing.assert_array_equal(pid, jid)
    assert [list(v) for v in plod] == [list(v) for v in jlod]
    np.testing.assert_allclose(psc, jsc, **TOL)
    assert len(plod) == 2 and pid.size > 0
    assert ((pid >= 0) & (pid < dc.DICT)).all()


def _manual_rnn(x, lens=None, act=np.tanh, reverse=False):
    b, t, d = x.shape
    h = np.zeros((b, d), np.float32)
    seq = np.zeros_like(x)
    for s in (range(t - 1, -1, -1) if reverse else range(t)):
        new = act(x[:, s] + h)
        valid = np.ones(b, bool) if lens is None else s < lens
        seq[:, s] = np.where(valid[:, None], new, 0.0)
        h = np.where(valid[:, None], new, h)
    return seq, h


@pytest.mark.parametrize("kind", dc.RNN_KINDS)
def test_cell_drivers_match_jax(kind):
    """rnn / birnn (its forward cell tanh(x + h), its backward cell
    x + h, which the reference's birnn runs over every step whatever
    sequence_length says) and dynamic_decode: outputs equal the JAX
    package's and the manual recurrence."""
    jout, pout = build_both(dc.rnn_program, kind)
    feed = pout[3]
    (jr,), (pr,) = run_both(jout, pout, feed)
    for (j, _), (p, _) in zip(jr, pr):
        np.testing.assert_allclose(p, j, **TOL)
    if kind == "dynamic_decode":
        np.testing.assert_array_equal(pr[0][0].reshape(2, 3)[0], [3, 0, 2])
        return
    x = feed["rc_x"]
    lens = feed.get("rc_len")
    if kind.startswith("birnn"):
        fseq, fh = _manual_rnn(x)
        bseq, bh = _manual_rnn(x, act=lambda v: v, reverse=True)
        want = [np.concatenate([fseq, bseq], -1), fh, bh]
    else:
        want = list(_manual_rnn(x, lens))
    for (p, _), w in zip(pr, want):
        np.testing.assert_allclose(p, w, **TOL)
