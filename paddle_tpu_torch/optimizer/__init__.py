"""Optimizers: the base class, SGD and Momentum.

Port of ``paddle_tpu/optimizer/__init__.py:77-333`` as ``jit.TrainStep``
uses it: ``functional_step`` runs the port's registered optimizer op
(``momentum``, ``sgd``) per parameter, not ``torch.optim``, so the update
matches the reference op for op. The eager ``step()``, LR schedulers,
weight decay, gradient clipping and fp32 master weights
(``multi_precision``) are not ported yet.
"""
from __future__ import annotations

from typing import Dict

import torch

from ..core.registry import OpInfoMap


class Optimizer:
    """Base (ref: fluid/optimizer.py:56 Optimizer). Subclasses define
    ``_op_type``, ``_state_spec``, ``_op_state_outputs`` and ``_attrs``."""

    _op_type: str = ""

    def __init__(self, learning_rate=0.001, parameters=None):
        self._lr = float(learning_rate)
        self._params = list(parameters or [])

    def get_lr(self) -> float:
        return self._lr

    def _state_spec(self, param) -> Dict[str, torch.Tensor]:
        return {}

    def _attrs(self) -> dict:
        return {}

    def _op_state_outputs(self) -> Dict[str, str]:
        """state name -> op output slot."""
        return {}

    def functional_step(self, params, grads, states, lr):
        """Update over name-keyed dicts: (params, grads, states, lr) ->
        (new_params, new_states); nothing is written in place."""
        opdef = OpInfoMap.instance().get(self._op_type)
        attrs = self._attrs()
        state_out = self._op_state_outputs()
        new_params, new_states = {}, {}
        for name, pv in params.items():
            inputs = {"Param": [pv], "Grad": [grads[name].to(pv.dtype)],
                      "LearningRate": [lr]}
            inputs.update({k: [v] for k, v in states[name].items()})
            outs = opdef.compute(inputs, attrs)
            new_params[name] = outs["ParamOut"][0]
            new_states[name] = dict(states[name], **{
                k: outs[slot][0] for k, slot in state_out.items()})
        return new_params, new_states


class SGD(Optimizer):
    _op_type = "sgd"


class Momentum(Optimizer):
    _op_type = "momentum"

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False):
        super().__init__(learning_rate, parameters)
        self._momentum = momentum
        self._use_nesterov = use_nesterov

    def _attrs(self):
        return {"mu": self._momentum, "use_nesterov": self._use_nesterov}

    def _state_spec(self, p):
        return {"Velocity": torch.zeros_like(p).detach()}

    def _op_state_outputs(self):
        return {"Velocity": "VelocityOut"}
