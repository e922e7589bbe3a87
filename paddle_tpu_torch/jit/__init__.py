"""TrainStep: forward, backward and optimizer update in one call.

Port of the single-device ``TrainStep`` of ``paddle_tpu/jit/__init__.py``
(``:134-262``). The reference traces the step into one XLA program; the
port runs it eagerly (no ``torch.compile``): the forward under the step's
AMP level, ``loss.backward()``, then the optimizer's ``functional_step``
under ``no_grad`` with the velocity held by the step, written back into
the parameters in place. The step holds the parameters only: buffers
(BN running statistics) stay on the model, and the ``batch_norm`` op
updates them in place during the forward, which runs in train mode (the
reference reinstalls them after its traced step; the values agree).
``ParallelTrainStep``, ``DataParallelTrainStep`` and fp32 masters (O2)
are not ported yet.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from ..core.enforce import UnimplementedError
from ..dygraph.layers import Layer
from ..dygraph.tracer import amp_level, set_amp_level
from ..dygraph.varbase import to_variable
from ..optimizer import Optimizer


class TrainStep:
    """step_fn(model, *args) -> scalar loss tensor."""

    def __init__(self, model: Layer, step_fn: Callable,
                 optimizer: Optimizer, amp_level: str = "O0"):
        if amp_level not in ("O0", "O1"):
            raise UnimplementedError(
                f"amp_level {amp_level!r} is not ported yet (O0, O1)")
        self._model = model
        self._step_fn = step_fn
        self._opt = optimizer
        self._amp_level = amp_level
        # structured name -> parameter; a tied weight appears once
        self._params = dict(model.named_parameters())
        self._opt_states: Optional[Dict[str, Dict[str, torch.Tensor]]] = None
        self._step_count = 0

    def ensure_state(self) -> "TrainStep":
        """Create the optimizer state (velocity) now, on the parameters'
        device."""
        if self._opt_states is None:
            self._opt_states = {
                name: self._opt._state_spec(p)
                for name, p in self._params.items() if p.requires_grad}
        return self

    def __call__(self, *args) -> torch.Tensor:
        self.ensure_state()
        self._model.train()
        for p in self._params.values():
            p.grad = None
        prev_amp = amp_level()
        set_amp_level(self._amp_level)
        try:
            loss = self._step_fn(self._model,
                                 *[to_variable(a) for a in args])
        finally:
            set_amp_level(prev_amp)
        loss.backward()
        grads = {name: p.grad for name, p in self._params.items()
                 if p.grad is not None}
        with torch.no_grad():
            some = next(iter(self._params.values()))
            lr = torch.tensor(self._opt.get_lr(), dtype=torch.float32,
                              device=some.device)
            new_vals, new_states = self._opt.functional_step(
                {n: self._params[n].detach() for n in grads}, grads,
                {n: self._opt_states[n] for n in grads}, lr)
            for name, val in new_vals.items():
                self._params[name].copy_(val)
            self._opt_states.update(new_states)
        self._step_count += 1
        return loss.detach()
