"""``paddle_tpu_torch.Model`` (hapi) against the JAX package's ``Model`` on
the CPU, from the same weights (``convert.py``) on the same numpy data,
in the same batch order (``shuffle=False``):

- a 2-layer MLP classifier (Adam 1e-2), ``fit`` for 3 steps, then
  ``evaluate`` and ``predict``;
- a 2-layer BERT-tiny classifier (``chip_smoke.seq_classifier``: the
  encoder with ``flash_attention``, d 64, 2 heads, vocab 64, seq 16,
  dropout 0; AdamW 1e-3), ``fit`` for 2 steps, then ``evaluate`` and
  ``predict``: the model ``chip_smoke`` phase ``hapi_ernie`` fine-tunes
  at ERNIE 1.0 base's widths.

Each step's loss and accuracy (a recording callback reads ``fit``'s
logs), the evaluation and the predictions are held within rtol 1e-5, and
each parameter by the norm of its update's error over the norm of the
JAX update, within 1e-4 (Adam moves an element whose gradient is
rounding noise by up to lr in either package; the key bias, whose exact
gradient is 0, is left out). The reference's eager optimizer keys its
state by parameter name and its ``TransformerEncoder`` copies layer 0's
names, so the JAX BERT's parameters are renamed unique first.

Also, in both packages: a checkpoint the JAX ``Model.save`` wrote loads
into the port's ``Model``; ``save`` / ``load`` round trip;
``EarlyStopping``; ``LRSchedulerCallback`` by step and by epoch;
``ModelCheckpoint``'s files; ``summary``'s counts.
"""
import os
import types

import numpy as np
import pytest

import paddle_tpu as jpt
from paddle_tpu import hapi as jhapi
from paddle_tpu import io as jio
from paddle_tpu import metric as jmetric
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as joptimizer
from paddle_tpu import text as jtext

import chip_smoke
import paddle_tpu_torch as tpt
from paddle_tpu_torch.convert import load_state_dict
from test_torch_static_builders import _cpu  # noqa: F401

JAX_API = types.SimpleNamespace(io=jio, metric=jmetric, nn=jnn, text=jtext,
                                optimizer=joptimizer, hapi=jhapi)
RTOL = 1e-5
UPDATE_TOL = 1e-4
KEY_BIAS = ".self_attn.k_bias"
BERT_TINY = dict(vocab_size=64, d_model=64, num_layers=2, nhead=2,
                 d_ffn=128, max_position=32)


def _port_api():
    tpt.set_device("cpu")
    return chip_smoke.port_hapi_api()


def mlp(api):
    class TinyClassifier(api.nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc1 = api.nn.Linear(8, 32)
            self.fc2 = api.nn.Linear(32, 4)

        def forward(self, x):
            return self.fc2(api.nn.functional.relu(self.fc1(x)))

    return TinyClassifier()


CENTERS = np.random.RandomState(42).randn(4, 8).astype(np.float32) * 4


def blobs(api, n, seed):
    """Linearly separable blobs (tests/test_hapi_metrics_datasets.py's
    BlobDataset)."""
    rs = np.random.RandomState(seed)
    y = rs.randint(0, 4, (n,)).astype(np.int64)
    x = CENTERS[y] + rs.randn(n, 8).astype(np.float32) * 0.3

    class Blobs(api.io.Dataset):
        def __len__(self):
            return n

        def __getitem__(self, i):
            return x[i], y[i:i + 1]

    return Blobs()


def recorder(api):
    class Recorder(api.hapi.Callback):
        def __init__(self):
            super().__init__()
            self.steps, self.evals = [], []

        def on_train_batch_end(self, step, logs=None):
            self.steps.append(dict(logs))

        def on_eval_end(self, logs=None):
            self.evals.append(dict(logs))

    return Recorder()


def _run(api, net, opt, data, batch, **fit_kw):
    """fit (recorded), evaluate and predict; returns (per-step logs,
    evaluation, predictions, parameters after)."""
    model = api.hapi.Model(net)
    model.prepare(opt, api.nn.CrossEntropyLoss(), api.metric.Accuracy())
    rec = recorder(api)
    model.fit(data["train"], batch_size=batch, epochs=1, shuffle=False,
              verbose=0, callbacks=[rec], **fit_kw)
    res = model.evaluate(data["eval"], batch_size=batch, verbose=0)
    preds = model.predict(data["test"], batch_size=batch,
                          stack_outputs=True)[0]
    params = {k: np.asarray(v.numpy(), np.float32)
              for k, v in net.state_dict().items()}
    return rec.steps, res, preds, params


def _compare(got, want, start, skip=()):
    (steps, res, preds, params), (jsteps, jres, jpreds, jparams) = got, want
    assert len(steps) == len(jsteps)
    for s, js in zip(steps, jsteps):
        np.testing.assert_allclose(s["loss"], js["loss"], rtol=RTOL)
        np.testing.assert_allclose(s["acc"], js["acc"], rtol=RTOL)
    np.testing.assert_allclose(res["loss"], jres["loss"], rtol=RTOL)
    np.testing.assert_allclose(res["acc"], jres["acc"], rtol=RTOL)
    np.testing.assert_allclose(preds, jpreds, rtol=RTOL, atol=1e-6)
    assert set(params) == set(jparams)
    for n in params:
        if n.endswith(skip):
            continue
        update = np.linalg.norm(jparams[n] - start[n])
        err = np.linalg.norm(params[n] - jparams[n]) / update
        assert err < UPDATE_TOL, (n, err)


def test_mlp_fit_evaluate_predict_matches_jax():
    jpt.seed(0)
    jnet = mlp(JAX_API)
    start = {k: np.asarray(v.numpy()) for k, v in jnet.state_dict().items()}
    data = {"train": (48, 0), "eval": (32, 1), "test": (16, 2)}
    want = _run(JAX_API, jnet, joptimizer.Adam(
        learning_rate=1e-2, parameters=jnet.parameters()),
        {k: blobs(JAX_API, *v) for k, v in data.items()}, 16)
    api = _port_api()
    net = load_state_dict(mlp(api), start)
    got = _run(api, net, api.optimizer.Adam(
        learning_rate=1e-2, parameters=net.parameters()),
        {k: blobs(api, *v) for k, v in data.items()}, 16)
    assert len(got[0]) == 3
    _compare(got, want, start)


def test_bert_tiny_classifier_fit_matches_jax():
    jpt.seed(0)
    jnet = chip_smoke.seq_classifier(JAX_API, 0.0, 2, **BERT_TINY)
    for i, p in enumerate(jnet.parameters()):
        p.name = f"classifier_param_{i}"
    start = {k: np.asarray(v.numpy()) for k, v in jnet.state_dict().items()}
    sets = {"train": (8, 0), "eval": (8, 1), "test": (4, 2)}

    def data(api):
        return {k: chip_smoke.sst2_dataset(api.io, n, 16, 64, seed)
                for k, (n, seed) in sets.items()}

    want = _run(JAX_API, jnet, joptimizer.AdamW(
        learning_rate=1e-3, parameters=jnet.parameters()), data(JAX_API), 4)
    api = _port_api()
    net = load_state_dict(chip_smoke.seq_classifier(api, 0.0, 2, **BERT_TINY),
                          start)
    got = _run(api, net, api.optimizer.AdamW(
        learning_rate=1e-3, parameters=net.parameters()), data(api), 4)
    assert len(got[0]) == 2
    _compare(got, want, start, skip=(KEY_BIAS,))


def _prepared(api, net, lr=1e-2):
    model = api.hapi.Model(net)
    model.prepare(api.optimizer.Adam(learning_rate=lr,
                                     parameters=net.parameters()),
                  api.nn.CrossEntropyLoss(), api.metric.Accuracy())
    return model


def test_save_load_roundtrip_and_a_jax_checkpoint(tmp_path):
    """The port's save / load round trip gives the same predictions bit
    for bit (parameters and optimizer state restored); a checkpoint the
    JAX ``Model.save`` wrote loads into the port's Model and predicts
    what the JAX model predicts."""
    jpt.seed(0)
    jmodel = _prepared(JAX_API, mlp(JAX_API))
    jmodel.fit(blobs(JAX_API, 32, 0), batch_size=16, verbose=0)
    jmodel.save(str(tmp_path / "jax" / "m"))
    x = blobs(JAX_API, 8, 3)
    xs = np.stack([x[i][0] for i in range(8)])
    want = jmodel.predict_batch([xs])[0]

    api = _port_api()
    model = _prepared(api, mlp(api))
    model.load(str(tmp_path / "jax" / "m"), reset_optimizer=True)
    np.testing.assert_allclose(model.predict_batch([xs])[0], want,
                               rtol=RTOL, atol=1e-6)
    model.fit(blobs(api, 32, 0), batch_size=16, verbose=0)
    ref = model.predict_batch([xs])[0]
    path = str(tmp_path / "port" / "ckpt" / "m")
    model.save(path)
    assert sorted(os.listdir(tmp_path / "port" / "ckpt")) == [
        "m.pdopt.npz", "m.pdparams.npz"]
    fresh = _prepared(api, mlp(api))
    fresh.load(path)
    np.testing.assert_array_equal(fresh.predict_batch([xs])[0], ref)
    opt, fopt = model._optimizer.state_dict(), fresh._optimizer.state_dict()
    assert opt.keys() == fopt.keys()
    for k in opt:
        if hasattr(opt[k], "numpy"):
            np.testing.assert_array_equal(fopt[k].numpy(), opt[k].numpy())


def _stopped_after(api):
    stopper = api.hapi.EarlyStopping(monitor="acc", mode="max", patience=1,
                                     save_best_model=False)
    rec = recorder(api)
    model = _prepared(api, mlp(api))
    model.fit(blobs(api, 64, 0), eval_data=blobs(api, 32, 1), epochs=10,
              batch_size=16, verbose=0, shuffle=False,
              callbacks=[stopper, rec])
    return stopper.stop_training, [e["acc"] for e in rec.evals]


def test_early_stopping_stops_where_the_jax_model_stops():
    jpt.seed(0)
    want = _stopped_after(JAX_API)
    api = _port_api()
    tpt.seed(0)
    got = _stopped_after(api)
    assert got[0] and want[0]
    assert len(got[1]) == len(want[1]) < 10
    assert got[1][-1] == want[1][-1] == 1.0


@pytest.mark.parametrize("by_step", [False, True], ids=["epoch", "step"])
def test_lr_scheduler_callback(by_step):
    """StepDecay(0.1, step_size=1, gamma=0.5) over 3 epochs of 2 steps,
    stepped each epoch or each step, in both packages."""
    def lr_after(api):
        net = mlp(api)
        sched = api.optimizer.lr.StepDecay(learning_rate=0.1, step_size=1,
                                           gamma=0.5)
        opt = api.optimizer.SGD(learning_rate=sched,
                                parameters=net.parameters())
        model = api.hapi.Model(net)
        model.prepare(opt, api.nn.CrossEntropyLoss(), api.metric.Accuracy())
        model.fit(blobs(api, 32, 0), epochs=3, batch_size=16, verbose=0,
                  callbacks=[api.hapi.LRSchedulerCallback(
                      by_step=by_step, by_epoch=not by_step)])
        return opt.get_lr()

    jpt.seed(0)
    want = lr_after(JAX_API)
    got = lr_after(_port_api())
    assert got == want == pytest.approx(0.1 * 0.5 ** (6 if by_step else 3))


def test_model_checkpoint_files(tmp_path):
    def files(api, d):
        model = _prepared(api, mlp(api))
        model.fit(blobs(api, 32, 0), epochs=2, batch_size=16, verbose=0,
                  callbacks=[api.hapi.ModelCheckpoint(save_freq=1,
                                                      save_dir=str(d))])
        return sorted(os.listdir(d))

    jpt.seed(0)
    want = files(JAX_API, tmp_path / "jax")
    got = files(_port_api(), tmp_path / "port")
    assert got == want == sorted(f"{e}.{k}.npz" for e in ("0", "1", "final")
                                 for k in ("pdparams", "pdopt"))


def test_summary_counts(capsys):
    jpt.seed(0)
    want = _prepared(JAX_API, mlp(JAX_API)).summary()
    api = _port_api()
    got = _prepared(api, mlp(api)).summary()
    assert got == want == {"total_params": 8 * 32 + 32 + 32 * 4 + 4,
                           "trainable_params": 8 * 32 + 32 + 32 * 4 + 4}
    assert "Total params: 420" in capsys.readouterr().out


def _traced_fit(api, tracer, metrics):
    """fit for 3 steps with tracing on: (train batches counted, step_ms
    samples, first-step gauge set, train-batch spans)."""
    model = _prepared(api, mlp(api))
    metrics.reset()
    tracer.reset()
    tracer.enable()
    try:
        model.fit(blobs(api, 48, 0), batch_size=16, verbose=0)
    finally:
        tracer.disable()
    samples = [c for c in tracer.counter_samples() if c[0] == "hapi/step_ms"]
    spans = [s for s in tracer.get_spans() if s.name == "hapi/train_batch"]
    return (metrics.metric_get("hapi/train_batches"), len(samples),
            metrics.metric_get("hapi/first_step_ms") is not None, len(spans),
            model._step_timer.report()["steps"])


def test_step_timer_spans_and_counters_match_jax():
    """Model's StepTimer (warm-up 1) and its ``hapi/train_batch`` span and
    ``hapi/train_batches`` counter, in both packages: 3 batches counted,
    2 steady step samples, the first step's gauge, 3 spans."""
    from paddle_tpu.observability import metrics as jmetrics
    from paddle_tpu.observability import tracer as jtracer
    from paddle_tpu_torch.observability import metrics as tmetrics
    from paddle_tpu_torch.observability import tracer as ttracer
    jpt.seed(0)
    want = _traced_fit(JAX_API, jtracer, jmetrics)
    got = _traced_fit(_port_api(), ttracer, tmetrics)
    assert got == want == (3, 2, True, 3, 3)
