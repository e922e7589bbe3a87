"""The eager slice as a whole: the user script of ``chip_smoke.py`` phase
``eager_bert`` (``to_tensor``, ``loss.backward(); opt.step();
opt.clear_grad()``, then ``opt.minimize(loss); model.clear_gradients()``
under ``dygraph.guard()``, and ``paddle.grad``) at BERT-tiny width
(2 layers, d 64, 2 heads, vocab 128, batch 2, seq 16), run by the JAX
dygraph and by the port from the same weights (``convert.py``) on the
same numpy batches.

The reference's eager optimizer keys its state and updates by
parameter name, and its ``TransformerEncoder`` deep-copies layer 0 into
the later layers under the same names, so its eager ``step()`` writes
one layer's update into another; the test gives the JAX parameters
unique names first (the port keys by position and needs none).

fp32 at O0 on the CPU. Losses are held at rtol 1e-4 / atol 1e-5 and the
``paddle.grad`` result at rtol 1e-4 / atol 1e-6, as the other BERT-tiny
O0 parity tests hold theirs (the two libraries sum in other orders, and
three Momentum steps at lr 1e-2 carry that into the later losses).
Within the port, ``paddle.grad`` must equal ``.gradient()`` from
``backward()`` on the same graph bit for bit, and a model reloaded by
``save_dygraph`` / ``load_dygraph`` must give the same next loss bit for
bit.
"""
import types

import numpy as np

import paddle_tpu as jpt
from paddle_tpu import dygraph as jdy
from paddle_tpu.optimizer import Momentum as JaxMomentum
from paddle_tpu.text.models import BertForPretraining as JaxBert

import chip_smoke
import paddle_tpu_torch as tpt
from paddle_tpu_torch.convert import load_state_dict

TINY = dict(vocab_size=128, d_model=64, num_layers=2, nhead=2, d_ffn=128,
            dropout=0.0)
STYLES = ("2.0", "2.0", "1.x")
LR = 1e-2


def _run(api, model, batches):
    opt = api.Momentum(learning_rate=LR, momentum=0.9,
                       parameters=model.parameters())
    word = model.bert.embeddings.word.weight
    losses, pair = [], None
    for i, (batch, style) in enumerate(zip(batches, STYLES)):
        loss, got = chip_smoke.eager_step(api, model, opt, batch, style,
                                          grad_of=word if i == 0 else None)
        losses.append(float(np.asarray(loss.numpy()).reshape(())))
        pair = got or pair
    return losses, pair


def test_eager_bert_script_matches_the_jax_dygraph(tmp_path):
    jpt.seed(0)
    jmodel = JaxBert(**TINY)
    for i, p in enumerate(jmodel.parameters()):
        p.name = f"bert_param_{i}"
    state = {k: v.numpy() for k, v in jmodel.state_dict().items()}
    batches = chip_smoke.eager_batches(4, 2, 16, TINY["vocab_size"])
    japi = types.SimpleNamespace(to_tensor=jpt.to_tensor, grad=jdy.grad,
                                 dygraph=jdy, Momentum=JaxMomentum)
    with jdy.guard():
        want, (jg, jwgrad) = _run(japi, jmodel, batches[:3])
    tpt.set_device("cpu")
    api = chip_smoke.port_eager_api()
    model = load_state_dict(api.Bert(**TINY), state)
    got, (g, wgrad) = _run(api, model, batches[:3])
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(g, jg, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(jg, jwgrad, rtol=1e-6, atol=0)
    np.testing.assert_array_equal(g, wgrad)

    path = str(tmp_path / "bert")
    api.dygraph.save_dygraph(model.state_dict(), path)
    fresh = api.Bert(**TINY)
    assert fresh.set_state_dict(api.dygraph.load_dygraph(path)[0]) == []
    nxt = [api.to_tensor(a) for a in batches[3]]
    with api.dygraph.no_grad():
        a = model(nxt[0], masked_lm_labels=nxt[1], next_sentence_label=nxt[2])
        b = fresh(nxt[0], masked_lm_labels=nxt[1], next_sentence_label=nxt[2])
    assert a.numpy().tobytes() == b.numpy().tobytes()
