"""paddle.Model high-level API (ref: python/paddle/hapi/model.py —
prepare :1186, fit :1242, evaluate :1442, predict :1538, save/load).

Design departure from the reference: the reference adapts between
static-graph and dygraph executors; here there is one dygraph path (the
port's eager tensors on torch's autograd tape, its optimizers, K1-K3
under every attention) and `Model` is the train-loop orchestration:
callbacks, metrics, checkpointing. For maximum-throughput inner loops
use jit.TrainStep directly — fit() stays eager so metrics/callbacks can
inspect arbitrary outputs every step.

Port of ``paddle_tpu/hapi/model.py``. A batch goes to
:func:`paddle_tpu_torch.device.get_device` (``dygraph.to_variable``);
each train or eval batch reads its loss on the host (``float``) and each
metric its inputs (``Metric.compute``): the host waits for the device
there, as in the reference. The data-parallel half (``_dp_mesh`` /
``_shard_batch``) waits for the port's collectives, ROADMAP Queue 1
item 8a; multi-process training reads ``torch.distributed``'s world size
for its sampler.
"""
from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from .. import io as pio
from ..core.enforce import UnimplementedError
from ..dygraph.layers import Layer
from ..dygraph.varbase import to_variable
from ..io.dataloader import _world
from ..metric import Metric
from ..observability import metrics as _obs_metrics
from ..observability.step_timer import StepTimer
from ..observability.tracer import span as _span
from .callbacks import config_callbacks


class InputSpec:
    """paddle.static.InputSpec parity (shape/dtype/name declaration)."""

    def __init__(self, shape, dtype="float32", name=None):
        self.shape = shape
        self.dtype = dtype
        self.name = name


def _to_var(x):
    return to_variable(x)


def _to_list(x):
    if x is None:
        return []
    if isinstance(x, (list, tuple)):
        return list(x)
    return [x]


class Model:
    """ref: hapi/model.py Model. network: a Layer; inputs/labels:
    optional InputSpec lists declaring the batch structure (how many
    leading batch elements are inputs vs labels)."""

    def __init__(self, network: Layer, inputs=None, labels=None):
        self.network = network
        self._inputs = _to_list(inputs)
        self._labels = _to_list(labels)
        self._optimizer = None
        self._loss = None
        self._metrics: List[Metric] = []
        self.stop_training = False
        # observability: did the last train/eval batch run dp-sharded
        self._dp_active = False
        # per-train-batch latency (includes the blocking loss fetch, so
        # this is true step wall time; first batch carries compiles)
        self._step_timer = StepTimer("hapi", warmup=1)

    # -- configuration --
    def prepare(self, optimizer=None, loss=None, metrics=None,
                amp_configs=None):
        self._optimizer = optimizer
        self._loss = loss
        ms = _to_list(metrics)
        for m in ms:
            if not isinstance(m, Metric):
                raise TypeError(f"metric {m!r} is not a paddle Metric")
        self._metrics = ms

    def parameters(self):
        return self.network.parameters()

    # -- batch-level API --
    def _compute_loss(self, outputs, labels):
        outs = _to_list(outputs)
        labs = _to_list(labels)
        if callable(self._loss):
            loss = self._loss(*(outs + labs))
        else:
            raise ValueError("prepare() a loss before train/eval")
        return loss

    # -- distributed (SPMD) plumbing -------------------------------------
    def _dp_mesh(self):
        """The default mesh's data-parallel axis, over which the
        reference's fit/evaluate shard batches (ref hapi fit's
        DataParallel adapter, model.py:788). The port has no mesh until
        its ``CommContext`` (ROADMAP Queue 1 item 8a): None, one
        device."""
        return None

    def _shard_batch(self, vals, mesh):
        raise UnimplementedError(
            "Model: sharding a batch over a data-parallel mesh needs the "
            "port's collectives (ROADMAP Queue 1 item 8a)")

    def train_batch(self, inputs, labels=None):
        with _span("hapi/train_batch"), self._step_timer.step():
            _obs_metrics.counter_add("hapi/train_batches")
            # one copy of the labels to the device, for the loss and the
            # metrics both
            labels = [_to_var(l) for l in _to_list(labels)]
            self.network.train()
            mesh = self._dp_mesh()
            if mesh is not None:
                inputs = self._shard_batch(inputs, mesh)
                labels = self._shard_batch(labels, mesh)
            outs, loss = self._forward(inputs, labels)
            loss.backward()
            self._optimizer.step()
            self._optimizer.clear_grad()
            metrics = self._update_metrics(outs, labels)
            return [float(loss.numpy())] + metrics

    def eval_batch(self, inputs, labels=None):
        with _span("hapi/eval_batch"):
            _obs_metrics.counter_add("hapi/eval_batches")
            labels = [_to_var(l) for l in _to_list(labels)]
            self.network.eval()
            mesh = self._dp_mesh()
            if mesh is not None:
                inputs = self._shard_batch(inputs, mesh)
                labels = self._shard_batch(labels, mesh)
            from ..dygraph.tracer import no_grad
            with no_grad():
                outs, loss = self._forward(inputs, labels)
            metrics = self._update_metrics(outs, labels)
            return [float(loss.numpy())] + metrics

    def predict_batch(self, inputs):
        self.network.eval()
        from ..dygraph.tracer import no_grad
        with no_grad():
            outs = self.network(*[_to_var(i) for i in _to_list(inputs)])
        return [o.numpy() for o in _to_list(outs)]

    def _forward(self, inputs, labels):
        outs = self.network(*[_to_var(i) for i in _to_list(inputs)])
        loss = self._compute_loss(outs, [_to_var(l) for l in
                                         _to_list(labels)])
        return outs, loss

    def _update_metrics(self, outputs, labels):
        vals = []
        outs = _to_list(outputs)
        labs = [_to_var(l) for l in _to_list(labels)]
        for m in self._metrics:
            state = m.compute(*(outs + labs))
            r = m.update(*_to_list(state))
            vals.append(r)
        return vals

    # -- dataset-level API --
    def _loader(self, data, batch_size, shuffle, num_workers, drop_last,
                train=False):
        from ..io.dataloader import DataLoader, Dataset
        if data is None or isinstance(data, DataLoader):
            return data
        if isinstance(data, Dataset) or hasattr(data, "__getitem__"):
            if train and _world()[0] > 1:
                # multi-host TRAINING: each host reads only its shard of
                # the dataset (ref hapi fit wraps DistributedBatchSampler,
                # model.py:1242). Evaluate/predict stay full-dataset on
                # every host — the sampler's padding duplicates samples,
                # which is fine for throughput but wrong for metrics.
                from ..io.dataloader import DistributedBatchSampler
                sampler = DistributedBatchSampler(
                    data, batch_size=batch_size, shuffle=shuffle,
                    drop_last=drop_last)
                return DataLoader(data, batch_sampler=sampler,
                                  num_workers=num_workers)
            return DataLoader(data, batch_size=batch_size, shuffle=shuffle,
                              num_workers=num_workers, drop_last=drop_last)
        return data  # already an iterable of batches

    def _split_batch(self, batch):
        batch = _to_list(batch)
        if self._inputs:
            # declared InputSpecs pin the arity exactly
            n_in = len(self._inputs)
            return batch[:n_in], batch[n_in:n_in + len(self._labels)] \
                if self._labels else batch[n_in:]
        n_label = len(self._labels) if self._labels else 1
        if len(batch) <= n_label:          # unsupervised / predict data
            return batch, []
        return batch[:-n_label], batch[-n_label:]

    def _log_items(self, loss_and_metrics):
        logs = {"loss": loss_and_metrics[0]}
        for m, v in zip(self._metrics, loss_and_metrics[1:]):
            names = m.name()
            logs[names if isinstance(names, str) else names[0]] = \
                v if not isinstance(v, np.ndarray) else float(np.ravel(v)[0])
        return logs

    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1,
            verbose=2, drop_last=False, shuffle=True, num_workers=0,
            callbacks=None):
        assert train_data is not None, "fit needs train_data"
        loader = self._loader(train_data, batch_size, shuffle, num_workers,
                              drop_last, train=True)
        steps = len(loader) if hasattr(loader, "__len__") else None
        cbks = config_callbacks(
            callbacks, model=self, epochs=epochs, steps=steps,
            log_freq=log_freq, verbose=verbose, save_freq=save_freq,
            save_dir=save_dir, metrics=[m.name() for m in self._metrics])
        self.stop_training = False
        cbks.on_train_begin()
        logs = {}
        for epoch in range(epochs):
            if self.stop_training:
                break
            cbks.on_epoch_begin(epoch)
            sampler = getattr(loader, "batch_sampler", None)
            if sampler is not None and hasattr(sampler, "set_epoch"):
                # fresh shuffle order per epoch (ref hapi fit calls
                # set_epoch on its DistributedBatchSampler)
                sampler.set_epoch(epoch)
            for m in self._metrics:
                m.reset()
            logs = {}
            for step, batch in enumerate(loader):
                cbks.on_train_batch_begin(step)
                ins, labs = self._split_batch(batch)
                res = self.train_batch(ins, labs)
                logs = self._log_items(res)
                cbks.on_train_batch_end(step, logs)
            # epoch-end metrics are the accumulated ones
            for m in self._metrics:
                names = m.name()
                logs[names if isinstance(names, str) else names[0]] = \
                    m.accumulate()
            cbks.on_epoch_end(epoch, logs)
            if eval_data is not None and (epoch + 1) % eval_freq == 0:
                self.evaluate(eval_data, batch_size=batch_size,
                              verbose=verbose, callbacks=callbacks,
                              _cbks=cbks)
        cbks.on_train_end(logs)

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=2,
                 num_workers=0, callbacks=None, _cbks=None):
        loader = self._loader(eval_data, batch_size, False, num_workers,
                              False)
        cbks = _cbks or config_callbacks(
            callbacks, model=self, log_freq=log_freq, verbose=verbose,
            metrics=[m.name() for m in self._metrics], mode="eval")
        for m in self._metrics:
            m.reset()
        cbks.on_eval_begin()
        losses = []
        for step, batch in enumerate(loader):
            cbks.on_eval_batch_begin(step)
            ins, labs = self._split_batch(batch)
            res = self.eval_batch(ins, labs)
            losses.append(res[0])
            cbks.on_eval_batch_end(step, self._log_items(res))
        result = {"loss": [float(np.mean(losses))] if losses else []}
        for m in self._metrics:
            names = m.name()
            result[names if isinstance(names, str) else names[0]] = \
                m.accumulate()
        cbks.on_eval_end(result)
        return result

    def predict(self, test_data, batch_size=1, num_workers=0,
                stack_outputs=False, verbose=1, callbacks=None):
        loader = self._loader(test_data, batch_size, False, num_workers,
                              False)
        cbks = config_callbacks(callbacks, model=self, verbose=0,
                                mode="predict")
        cbks.on_predict_begin()
        outputs = []
        for step, batch in enumerate(loader):
            cbks.on_predict_batch_begin(step)
            ins, _ = self._split_batch(batch)
            outs = self.predict_batch(ins)
            outputs.append(outs)
            cbks.on_predict_batch_end(step)
        cbks.on_predict_end()
        # regroup: list over output-slots, each a list over batches
        n_out = len(outputs[0]) if outputs else 0
        grouped = [[b[i] for b in outputs] for i in range(n_out)]
        if stack_outputs:
            grouped = [np.concatenate(g, axis=0) for g in grouped]
        return grouped

    # -- persistence --
    def save(self, path, training=True):
        dirn = os.path.dirname(path)
        if dirn:
            os.makedirs(dirn, exist_ok=True)
        pio.save_dygraph(self.network.state_dict(), path)
        if training and self._optimizer is not None:
            pio.save(self._optimizer.state_dict(), path + ".pdopt")

    def load(self, path, skip_mismatch=False, reset_optimizer=False):
        state, _ = pio.load_dygraph(path)
        self.network.set_state_dict(state)
        if not reset_optimizer and self._optimizer is not None:
            try:
                self._optimizer.set_state_dict(pio.load(path + ".pdopt"))
            except FileNotFoundError:
                pass  # saved with training=False — params only

    def summary(self, input_size=None, dtype=None):
        total = 0
        trainable = 0
        rows = []
        for name, p in self.network.named_parameters():
            n = int(np.prod(p.shape)) if p.shape else 1
            total += n
            if not p.stop_gradient:
                trainable += n
            rows.append((name, list(p.shape), n))
        width = max((len(r[0]) for r in rows), default=20) + 2
        lines = [f"{'Param':<{width}}{'Shape':<20}{'Count':>12}"]
        lines += [f"{r[0]:<{width}}{str(r[1]):<20}{r[2]:>12,}"
                  for r in rows]
        lines.append(f"Total params: {total:,}")
        lines.append(f"Trainable params: {trainable:,}")
        print("\n".join(lines))
        return {"total_params": total, "trainable_params": trainable}
