"""paddle.amp parity: autocast contexts, GradScaler, O2 decorate.

Port of ``paddle_tpu/amp/__init__.py``. AMP is the tracer's input cast
(``dygraph/tracer.py``) under the reference's white and black lists, not
``torch.autocast``.

- ``auto_cast`` / ``amp_guard`` set the thread's AMP level, dtype and
  custom lists for a block (ref ``:41``).
- ``decorate`` (O2) casts a model's fp32 parameters to the low precision
  dtype **in place**: each ``Parameter`` object stays the one the
  optimizer and ``jit.TrainStep`` hold; and it turns on the optimizers'
  fp32 master weights (ref ``:207-244``).
- ``GradScaler`` unscales and checks the gradients through the
  ``check_finite_and_unscale`` and ``update_loss_scaling`` ops (ref
  ``:82-104``) and skips the step on overflow, with the reference's one
  host sync in ``step()``.
"""
from __future__ import annotations

import functools

import torch

from ..core import dtype as dtypes
from ..core.enforce import InvalidArgumentError, enforce
from ..core.registry import OpInfoMap
from ..device import get_device
from ..dygraph import tracer as _tracer
from .fp16_lists import (AutoMixedPrecisionLists, black_list,  # noqa: F401
                         gray_list, white_list)

__all__ = [
    "auto_cast", "amp_guard", "GradScaler", "AmpScaler", "decorate",
    "AutoMixedPrecisionLists", "white_list", "black_list", "gray_list",
]


class auto_cast:
    """Context manager enabling O1/O2 autocast on the tracer (ref:
    dygraph/amp/auto_cast.py amp_guard); ``dtype=None`` keeps the
    thread's dtype."""

    def __init__(self, enable=True, custom_white_list=None,
                 custom_black_list=None, level="O1", dtype="bfloat16"):
        enforce(level in ("O0", "O1", "O2"),
                f"amp level must be O0/O1/O2, got {level!r}",
                InvalidArgumentError)
        self._level = level if enable else "O0"
        self._dtype = dtype
        self._white = custom_white_list
        self._black = custom_black_list

    def __enter__(self):
        st = _tracer._state()
        self._saved = (st.amp_level, st.amp_dtype, st.amp_custom_white,
                       st.amp_custom_black)
        _tracer.set_amp_level(self._level, self._dtype, self._white,
                              self._black)
        return self

    def __exit__(self, *exc):
        st = _tracer._state()
        (st.amp_level, st.amp_dtype, st.amp_custom_white,
         st.amp_custom_black) = self._saved

    def __call__(self, fn):
        @functools.wraps(fn)
        def wrapper(*a, **kw):
            with auto_cast(True, self._white, self._black, self._level,
                           self._dtype):
                return fn(*a, **kw)
        return wrapper


amp_guard = auto_cast  # fluid-era alias (dygraph/amp/auto_cast.py)


def _unscale_and_update(grads, scale, good, bad, incr_every, decr_every,
                        incr_ratio, decr_ratio):
    """Unscale + finite check + loss-scale update over a list of grads,
    through the registered ops (ref ``:82-104``). Returns (grads, found,
    scale, good, bad), all on the device."""
    info = OpInfoMap.instance()
    outs = info.get("check_finite_and_unscale").compute(
        {"X": list(grads), "Scale": [scale]}, {})
    found = outs["FoundInfinite"][0]
    upd = info.get("update_loss_scaling").compute(
        {"X": outs["Out"], "FoundInfinite": [found],
         "PrevLossScaling": [scale], "InGoodSteps": [good],
         "InBadSteps": [bad]},
        {"incr_every_n_steps": incr_every,
         "decr_every_n_nan_or_inf": decr_every,
         "incr_ratio": incr_ratio, "decr_ratio": decr_ratio})
    return (upd["Out"], found, upd["LossScaling"][0],
            upd["OutGoodSteps"][0], upd["OutBadSteps"][0])


class GradScaler:
    """Dynamic loss scaler (ref: dygraph/amp/loss_scaler.py AmpScaler;
    2.0 surface paddle/amp/grad_scaler.py). Its scale and step counters
    live on the current device."""

    def __init__(self, enable=True, init_loss_scaling=2.0 ** 15,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=1000,
                 decr_every_n_nan_or_inf=2, use_dynamic_loss_scaling=True):
        dev = get_device()
        self._enable = bool(enable)
        self._scale = torch.full((), init_loss_scaling if enable else 1.0,
                                 dtype=torch.float32, device=dev)
        self._incr_ratio = float(incr_ratio)
        self._decr_ratio = float(decr_ratio)
        self._incr_every = int(incr_every_n_steps)
        self._decr_every = int(decr_every_n_nan_or_inf)
        self._dynamic = bool(use_dynamic_loss_scaling)
        self._good = torch.zeros((), dtype=torch.int32, device=dev)
        self._bad = torch.zeros((), dtype=torch.int32, device=dev)
        self._found_inf = torch.zeros((), dtype=torch.bool, device=dev)
        self._unscaled = False

    def is_enable(self):
        return self._enable

    def is_use_dynamic_loss_scaling(self):
        return self._dynamic

    def get_loss_scaling(self):
        return float(self._scale)

    def scale(self, loss):
        """The loss times the current scale."""
        return loss * self._scale if self._enable else loss

    def _unscale(self, optimizer):
        if not self._enable or self._unscaled:
            return
        params = [p for p in optimizer._params
                  if p.grad is not None and p.requires_grad]
        if not params:
            return
        grads, found, scale, good, bad = _unscale_and_update(
            [p.grad for p in params], self._scale, self._good, self._bad,
            self._incr_every, self._decr_every, self._incr_ratio,
            self._decr_ratio)
        for p, g in zip(params, grads):
            p.grad = g
        self._found_inf = found
        if self._dynamic:
            self._scale, self._good, self._bad = scale, good, bad
        self._unscaled = True

    def unscale_(self, optimizer):
        self._unscale(optimizer)

    def step(self, optimizer):
        """Unscale, then step unless a gradient overflowed: a skipped step
        leaves the parameters and the optimizer's state as they were.
        Reading the overflow flag is the one host sync."""
        if not self._enable:
            optimizer.step()
            return
        self._unscale(optimizer)
        if not bool(self._found_inf):
            optimizer.step()
        self._unscaled = False

    def update(self):
        return  # the scale state already moved inside _unscale

    def minimize(self, optimizer, scaled_loss, **kwargs):
        """fluid surface: scaler.minimize(opt, scaled) after
        scaled.backward()."""
        self.step(optimizer)
        optimizer.clear_grad()

    def state_dict(self):
        return {"scale": self._scale.detach().cpu().numpy(),
                "incr_ratio": self._incr_ratio,
                "decr_ratio": self._decr_ratio,
                "incr_every_n_steps": self._incr_every,
                "decr_every_n_nan_or_inf": self._decr_every,
                "good_steps": int(self._good),
                "bad_steps": int(self._bad)}

    def load_state_dict(self, state):
        dev = self._scale.device
        self._scale = torch.as_tensor(state["scale"], dtype=torch.float32,
                                      device=dev).reshape(())
        self._good = torch.full((), int(state.get("good_steps", 0)),
                                dtype=torch.int32, device=dev)
        self._bad = torch.full((), int(state.get("bad_steps", 0)),
                               dtype=torch.int32, device=dev)


AmpScaler = GradScaler  # fluid-era alias


def decorate(models=None, optimizers=None, level="O2", dtype="bfloat16",
             master_weight=None, save_dtype=None):
    """O2 decorate: cast the models' fp32 parameters to ``dtype`` in place
    (``p.data``; the Parameter objects stay) and turn on fp32 master
    weights in the optimizers unless ``master_weight`` is False. Buffers
    (BN statistics) stay fp32. ``save_dtype`` is accepted for parity and
    unused, as in the reference."""
    enforce(level in ("O1", "O2"), "decorate expects O1/O2",
            InvalidArgumentError)
    target = dtypes.convert_dtype(dtype)
    model_list = models if isinstance(models, (list, tuple)) else [models]
    if level == "O2":
        for m in model_list:
            if m is None:
                continue
            for p in m.parameters():
                if p.dtype == torch.float32:
                    p.data = p.data.to(target)
    if optimizers is None:
        return models
    opt_list = (optimizers if isinstance(optimizers, (list, tuple))
                else [optimizers])
    if level == "O2" and master_weight is not False:
        for opt in opt_list:
            opt._multi_precision = True
    return models, optimizers
