"""hapi callbacks (ref: python/paddle/hapi/callbacks.py surface).

A copy of ``paddle_tpu/hapi/callbacks.py`` (pure Python)."""
from __future__ import annotations

import numbers
import os
import time
from typing import List, Optional


class Callback:
    """ref: hapi/callbacks.py Callback — all hooks optional."""

    def __init__(self):
        self.model = None
        self.params = {}

    def set_params(self, params):
        self.params = params or {}

    def set_model(self, model):
        self.model = model

    def on_train_begin(self, logs=None): ...
    def on_train_end(self, logs=None): ...
    def on_eval_begin(self, logs=None): ...
    def on_eval_end(self, logs=None): ...
    def on_predict_begin(self, logs=None): ...
    def on_predict_end(self, logs=None): ...
    def on_epoch_begin(self, epoch, logs=None): ...
    def on_epoch_end(self, epoch, logs=None): ...
    def on_train_batch_begin(self, step, logs=None): ...
    def on_train_batch_end(self, step, logs=None): ...
    def on_eval_batch_begin(self, step, logs=None): ...
    def on_eval_batch_end(self, step, logs=None): ...
    def on_predict_batch_begin(self, step, logs=None): ...
    def on_predict_batch_end(self, step, logs=None): ...


class CallbackList:
    def __init__(self, callbacks: Optional[List[Callback]] = None):
        self.callbacks = list(callbacks or [])

    def set_params(self, params):
        for c in self.callbacks:
            c.set_params(params)

    def set_model(self, model):
        for c in self.callbacks:
            c.set_model(model)

    def __getattr__(self, name):
        if name.startswith("on_"):
            def call(*args, **kw):
                for c in self.callbacks:
                    getattr(c, name)(*args, **kw)
            return call
        raise AttributeError(name)


def _fmt(v):
    if isinstance(v, numbers.Number):
        return f"{v:.4f}"
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_fmt(x) for x in v) + "]"
    return str(v)


class ProgBarLogger(Callback):
    """Step/epoch logging (ref: hapi/callbacks.py ProgBarLogger; prints
    flat lines rather than a terminal progress bar — logs survive in
    non-tty CI the reference bar garbles)."""

    def __init__(self, log_freq=1, verbose=2):
        super().__init__()
        self.log_freq = log_freq
        self.verbose = verbose

    def on_epoch_begin(self, epoch, logs=None):
        self.epoch = epoch
        self.steps = self.params.get("steps")
        self._start = time.time()
        if self.verbose and self.params.get("epochs"):
            print(f"Epoch {epoch + 1}/{self.params['epochs']}")

    def _line(self, step, logs, prefix=""):
        items = [f"{k}: {_fmt(v)}" for k, v in (logs or {}).items()]
        total = f"/{self.steps}" if self.steps else ""
        print(f"{prefix}step {step + 1}{total} - " + " - ".join(items))

    def on_train_batch_end(self, step, logs=None):
        if self.verbose > 1 and (step + 1) % self.log_freq == 0:
            self._line(step, logs)

    def on_epoch_end(self, epoch, logs=None):
        if self.verbose:
            dt = time.time() - self._start
            items = [f"{k}: {_fmt(v)}" for k, v in (logs or {}).items()]
            print(f"Epoch {epoch + 1} done ({dt:.1f}s) - "
                  + " - ".join(items))

    def on_eval_end(self, logs=None):
        if self.verbose:
            items = [f"{k}: {_fmt(v)}" for k, v in (logs or {}).items()]
            print("Eval - " + " - ".join(items))


class ModelCheckpoint(Callback):
    """Save every N epochs (ref: hapi/callbacks.py ModelCheckpoint)."""

    def __init__(self, save_freq=1, save_dir=None):
        super().__init__()
        self.save_freq = save_freq
        self.save_dir = save_dir

    def on_epoch_end(self, epoch, logs=None):
        if self.save_dir and (epoch + 1) % self.save_freq == 0:
            path = os.path.join(self.save_dir, str(epoch))
            self.model.save(path)

    def on_train_end(self, logs=None):
        if self.save_dir:
            self.model.save(os.path.join(self.save_dir, "final"))


class EarlyStopping(Callback):
    """ref: hapi/callbacks.py EarlyStopping."""

    def __init__(self, monitor="loss", mode="auto", patience=0,
                 min_delta=0, baseline=None, save_best_model=True,
                 save_dir=None):
        super().__init__()
        self.monitor = monitor
        self.patience = patience
        self.min_delta = abs(min_delta)
        self.baseline = baseline
        self.save_best_model = save_best_model
        self.save_dir = save_dir
        if mode == "auto":
            mode = "min" if ("loss" in monitor or "err" in monitor) \
                else "max"
        self.mode = mode
        self.stopped_epoch = 0
        self.stop_training = False

    def on_train_begin(self, logs=None):
        self.wait = 0
        self.best = (self.baseline if self.baseline is not None else
                     (float("inf") if self.mode == "min"
                      else -float("inf")))

    def on_eval_end(self, logs=None):
        value = (logs or {}).get(self.monitor)
        if isinstance(value, (list, tuple)):
            value = value[0] if value else None
        if value is None:
            return
        better = (value < self.best - self.min_delta
                  if self.mode == "min"
                  else value > self.best + self.min_delta)
        if better:
            self.best = value
            self.wait = 0
            if self.save_best_model and self.save_dir:
                self.model.save(os.path.join(self.save_dir, "best_model"))
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.stop_training = True
                self.model.stop_training = True


class LRSchedulerCallback(Callback):
    """Step the optimizer's LRScheduler each epoch (by_step=False) or
    each batch (by_step=True). ref: hapi/callbacks.py LRScheduler."""

    def __init__(self, by_step=False, by_epoch=True):
        super().__init__()
        self.by_step = by_step
        self.by_epoch = by_epoch

    def _sched(self):
        opt = getattr(self.model, "_optimizer", None)
        lr = getattr(opt, "_lr", None)
        return lr if hasattr(lr, "step") else None

    def on_train_batch_end(self, step, logs=None):
        if self.by_step:
            s = self._sched()
            if s:
                s.step()

    def on_epoch_end(self, epoch, logs=None):
        if self.by_epoch:
            s = self._sched()
            if s:
                s.step()


def config_callbacks(callbacks=None, model=None, epochs=None, steps=None,
                     log_freq=2, verbose=2, save_freq=1, save_dir=None,
                     metrics=None, mode="train"):
    cbks = list(callbacks or [])
    if not any(isinstance(c, ProgBarLogger) for c in cbks) and verbose:
        cbks.append(ProgBarLogger(log_freq, verbose=verbose))
    if not any(isinstance(c, LRSchedulerCallback) for c in cbks) and \
            mode == "train":
        cbks.append(LRSchedulerCallback())
    if not any(isinstance(c, ModelCheckpoint) for c in cbks) and save_dir:
        cbks.append(ModelCheckpoint(save_freq, save_dir))
    lst = CallbackList(cbks)
    lst.set_model(model)
    lst.set_params({"epochs": epochs, "steps": steps, "verbose": verbose,
                    "metrics": metrics or []})
    return lst
