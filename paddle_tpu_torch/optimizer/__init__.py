"""Optimizers (paddle.optimizer / fluid.optimizer parity).

Port of ``paddle_tpu/optimizer/__init__.py`` (``:28-311``, ``:336-524``,
``:576-644``): the base class with weight decay, gradient clipping, fp32
master weights (``multi_precision``), LR schedulers and the 1.x keyword
spellings; SGD, Momentum, Adam, AdamW, Lamb, LarsMomentum, RMSProp,
Adagrad, Adadelta and Adamax with their ``*Optimizer`` aliases; the 1.x
scheduler adapters. ``functional_step`` runs the port's registered
optimizer op per parameter (not ``torch.optim``), so an update matches
the reference op for op, in the reference's order: clip, then decay,
then the op.

The eager ``step()`` keys its state by the parameter's position in the
optimizer's list (torch parameters carry no Paddle unique name):
``state_dict()`` holds ``param_<i>.<slot>`` (``param_0.Moment1``),
``param_<i>.master_weight``, ``global_step`` and ``LR_Scheduler``.
``jit.TrainStep`` keeps its own state by structured name. ``minimize``
on a static-graph loss appends backward and one update op a parameter
to its program instead (``static.StaticOptimizerMixin``).

Not ported yet: ``exotic.py`` (ModelAverage, EMA, Lookahead, Recompute,
GradientMerge, Pipeline; Dpsgd, DecayedAdagrad and Ftrl, whose ops are
ported) and ``DGCMomentumOptimizer``.
"""
from __future__ import annotations

import math
from typing import Dict, List

import torch

from ..core.enforce import InvalidArgumentError, enforce
from ..core.registry import OpInfoMap
from ..ops.optimizer_ops import jax_promote
from . import lr as lr_sched  # noqa: F401
from .lr import LRScheduler

_LOW = (torch.bfloat16, torch.float16)


class _L2Decay:
    def __init__(self, coeff):
        self.coeff = coeff


def L2Decay(coeff=0.0, regularization_coeff=None):
    # 1.x fluid spells it L2DecayRegularizer(regularization_coeff=...)
    return _L2Decay(regularization_coeff if regularization_coeff
                    is not None else coeff)


L1Decay = L2Decay  # the reference handles L1 as L2 (rarely used)


class ClipGradByGlobalNorm:
    """ref: fluid/clip.py GradientClipByGlobalNorm: every gradient scaled
    by min(1, clip_norm / ||all gradients||), the norm taken in fp32."""

    def __init__(self, clip_norm):
        self.clip_norm = clip_norm

    def apply(self, grads: List):
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                               for g in grads))
        scale = torch.clamp_max(
            self.clip_norm / torch.clamp_min(gnorm, 1e-12), 1.0)
        return [(jax_promote(g, scale) * scale).to(g.dtype) for g in grads]


class ClipGradByNorm:
    def __init__(self, clip_norm):
        self.clip_norm = clip_norm

    def apply(self, grads):
        out = []
        for g in grads:
            n = torch.sqrt(torch.sum(torch.square(g.float())))
            scale = torch.clamp_max(
                self.clip_norm / torch.clamp_min(n, 1e-12), 1.0)
            out.append((jax_promote(g, scale) * scale).to(g.dtype))
        return out


class ClipGradByValue:
    def __init__(self, max, min=None):
        self.max = max
        self.min = -max if min is None else min

    def apply(self, grads):
        return [torch.clamp(g, self.min, self.max) for g in grads]


def install(param, value):
    """Write an update into ``param`` keeping the Parameter object (the
    optimizer and ``TrainStep`` hold it). A value of another dtype
    replaces the data, as the reference installs whatever dtype the op
    returns (a bf16 parameter updated with no master comes back fp32)."""
    if value.dtype == param.dtype:
        param.copy_(value)
    else:
        param.data = value


class Optimizer:
    """Base (ref: fluid/optimizer.py:56 Optimizer). Subclasses define
    ``_op_type``, ``_state_spec``, ``_op_state_outputs`` and ``_attrs``."""

    _op_type: str = ""

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 multi_precision=False, parameter_list=None,
                 regularization=None):
        if parameters is None and parameter_list is not None:
            parameters = parameter_list          # 1.x fluid spelling
        if weight_decay is None and regularization is not None:
            weight_decay = regularization        # 1.x fluid spelling
        self._lr = learning_rate
        self._params: List[torch.nn.Parameter] = list(parameters or [])
        self._grad_clip = grad_clip
        self._weight_decay = (weight_decay if isinstance(
            weight_decay, _L2Decay) else
            _L2Decay(weight_decay) if weight_decay else None)
        self._state: Dict[int, Dict[str, torch.Tensor]] = {}
        self._global_step = 0
        # O2 AMP master weights: fp32 copies of low-precision parameters
        self._multi_precision = bool(multi_precision)
        self._masters: Dict[int, torch.Tensor] = {}
        self._lr_buf = None

    # -- lr --
    def get_lr(self) -> float:
        if isinstance(self._lr, LRScheduler):
            return self._lr()
        return float(self._lr)

    def set_lr(self, value: float):
        enforce(not isinstance(self._lr, LRScheduler),
                "cannot set_lr when using an LRScheduler",
                InvalidArgumentError)
        self._lr = value

    def lr_tensor(self, device) -> torch.Tensor:
        """``get_lr()`` as one persistent fp32 0-d tensor on ``device``,
        refilled on every call: a tensor built from host data on the card
        would wait for the stream."""
        buf = self._lr_buf
        if buf is None or buf.device != torch.device(device):
            buf = self._lr_buf = torch.zeros((), dtype=torch.float32,
                                             device=device)
        return buf.fill_(self.get_lr())

    def _absorb_common_kwargs(self, kw: dict):
        """Base-class options that subclasses take through ``**kw``, with
        the 1.x fluid spellings (parameter_list, regularization)."""
        if "multi_precision" in kw:
            self._multi_precision = bool(kw["multi_precision"])
        if kw.get("parameter_list") is not None and not self._params:
            self._params = list(kw["parameter_list"])
        if kw.get("regularization") is not None and \
                self._weight_decay is None:
            reg = kw["regularization"]
            self._weight_decay = (reg if isinstance(reg, _L2Decay)
                                  else _L2Decay(reg))

    # -- state --
    def _state_spec(self, value) -> Dict[str, torch.Tensor]:
        """Initial state for a parameter whose update runs on ``value``
        (its fp32 master under multi_precision)."""
        return {}

    def _ensure_state(self, i: int, value) -> Dict[str, torch.Tensor]:
        st = self._state.get(i)
        if st is None:
            st = self._state[i] = self._state_spec(value.detach())
        return st

    def _attrs(self) -> dict:
        return {}

    def _op_inputs(self, pv, gv, state, lr):
        """Map (param, grad, state, lr) onto the registered op's slots."""
        inputs = {"Param": [pv], "Grad": [gv], "LearningRate": [lr]}
        for k, v in state.items():
            inputs[k] = [v]
        return inputs

    def _op_state_outputs(self) -> Dict[str, str]:
        """state name -> op output slot."""
        return {}

    def functional_step(self, params, grads, states, lr):
        """Update over name-keyed dicts: (params, grads, states, lr) ->
        (new_params, new_states); nothing is written in place. The clip
        sees every entry of ``grads``, which may hold more names than
        ``params`` (``TrainStep`` passes a tied weight's gradient under
        each of its names, as the reference's step does)."""
        opdef = OpInfoMap.instance().get(self._op_type)
        attrs = self._attrs()
        wd = self._weight_decay.coeff if self._weight_decay else 0.0
        if self._grad_clip is not None:
            keys = list(grads)
            grads = dict(zip(keys, self._grad_clip.apply(
                [grads[k] for k in keys])))
        state_out = self._op_state_outputs()
        new_params, new_states = {}, {}
        for name, pv in params.items():
            gv = grads[name].to(pv.dtype)
            if wd:
                gv = gv + wd * pv
            outs = opdef.compute(
                self._op_inputs(pv, gv, states[name], lr), attrs)
            new_params[name] = outs["ParamOut"][0]
            # a state entry the op does not output is carried forward
            new_states[name] = dict(states[name], **{
                k: outs[slot][0] for k, slot in state_out.items()})
        return new_params, new_states

    # -- eager use --
    def _update_value(self, i, p):
        """What the update runs on: the fp32 master of a low-precision
        parameter under multi_precision, else the parameter."""
        if self._multi_precision and p.dtype in _LOW:
            m = self._masters.get(i)
            return p.detach().float() if m is None else m
        return p.detach()

    @torch.no_grad()
    def step(self):
        """One eager update from the parameters' ``.grad``."""
        sel = [(i, p) for i, p in enumerate(self._params)
               if p.grad is not None and p.requires_grad]
        if not sel:
            return
        params = {i: self._update_value(i, p) for i, p in sel}
        grads = {i: p.grad for i, p in sel}
        states = {i: self._ensure_state(i, params[i]) for i, _ in sel}
        new_params, new_states = self.functional_step(
            params, grads, states, self.lr_tensor(sel[0][1].device))
        for i, p in sel:
            nv = new_params[i]
            if self._multi_precision and p.dtype in _LOW:
                self._masters[i] = nv
                p.copy_(nv)
            else:
                install(p, nv)
            self._state[i] = new_states[i]
        self._global_step += 1

    def clear_grad(self):
        for p in self._params:
            p.grad = None

    clear_gradients = clear_grad

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        """Dygraph: backward + step; a static Variable (or its name) as
        the loss: append backward + update ops to its program (ref:
        optimizer.minimize contract)."""
        from ..static import StaticOptimizerMixin, Variable as StaticVar
        if isinstance(loss, (StaticVar, str)):
            return StaticOptimizerMixin.minimize_static(
                self, loss, startup_program, parameters, no_grad_set)
        loss.backward()
        self.step()
        return [], [(p, p.grad) for p in self._params]

    # static-mode plumbing lives in static.StaticOptimizerMixin; bind the
    # methods here so fluid-style `opt.minimize(static_loss)` works
    def minimize_static(self, *a, **kw):
        from ..static import StaticOptimizerMixin
        return StaticOptimizerMixin.minimize_static(self, *a, **kw)

    def _append_update_ops(self, *a, **kw):
        from ..static import StaticOptimizerMixin
        return StaticOptimizerMixin._append_update_ops(self, *a, **kw)

    def _append_lr_and_update_ops(self, *a, **kw):
        from ..static import StaticOptimizerMixin
        return StaticOptimizerMixin._append_lr_and_update_ops(self, *a, **kw)

    def _state_spec_names(self):
        from ..static import StaticOptimizerMixin
        return StaticOptimizerMixin._state_spec_names(self)

    def _state_init(self, *a, **kw):
        from ..static import StaticOptimizerMixin
        return StaticOptimizerMixin._state_init(self, *a, **kw)

    # -- checkpointing --
    def state_dict(self):
        out = {}
        for i, st in self._state.items():
            for k, v in st.items():
                out[f"param_{i}.{k}"] = v.detach().clone()
        for i, m in self._masters.items():
            out[f"param_{i}.master_weight"] = m.detach().clone()
        out["global_step"] = self._global_step
        if isinstance(self._lr, LRScheduler):
            out["LR_Scheduler"] = self._lr.state_dict()
        return out

    def set_state_dict(self, state):
        self._global_step = int(state.get("global_step", 0))
        for i, p in enumerate(self._params):
            key = f"param_{i}.master_weight"
            if key in state:
                self._masters[i] = torch.as_tensor(
                    state[key], device=p.device).clone()
        if isinstance(self._lr, LRScheduler) and "LR_Scheduler" in state:
            self._lr.set_state_dict(state["LR_Scheduler"])
        for i, p in enumerate(self._params):
            value = self._update_value(i, p)
            st = {k: torch.as_tensor(state[f"param_{i}.{k}"],
                                     device=p.device).clone()
                  for k in self._state_spec(value)
                  if f"param_{i}.{k}" in state}
            if st:
                self._ensure_state(i, value).update(st)


class SGD(Optimizer):
    _op_type = "sgd"


class Momentum(Optimizer):
    _op_type = "momentum"

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 **kw):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._absorb_common_kwargs(kw)
        self._momentum = momentum
        self._use_nesterov = use_nesterov

    def _attrs(self):
        return {"mu": self._momentum, "use_nesterov": self._use_nesterov}

    def _state_spec(self, p):
        return {"Velocity": torch.zeros_like(p)}

    def _op_state_outputs(self):
        return {"Velocity": "VelocityOut"}


def _pow(p, beta):
    """A beta power slot: [1] fp32 holding beta, filled on the device."""
    return torch.full((1,), beta, dtype=torch.float32, device=p.device)


class Adam(Optimizer):
    _op_type = "adam"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, **kw):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._absorb_common_kwargs(kw)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _attrs(self):
        return {"beta1": self._beta1, "beta2": self._beta2,
                "epsilon": self._epsilon}

    def _state_spec(self, p):
        return {"Moment1": torch.zeros_like(p),
                "Moment2": torch.zeros_like(p),
                "Beta1Pow": _pow(p, self._beta1),
                "Beta2Pow": _pow(p, self._beta2)}

    def _op_state_outputs(self):
        return {"Moment1": "Moment1Out", "Moment2": "Moment2Out",
                "Beta1Pow": "Beta1PowOut", "Beta2Pow": "Beta2PowOut"}


class AdamW(Adam):
    _op_type = "adamw"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 grad_clip=None, **kw):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip)
        self._absorb_common_kwargs(kw)
        self._coeff = (weight_decay.coeff if isinstance(weight_decay, _L2Decay)
                       else float(weight_decay or 0.0))

    def _attrs(self):
        a = super()._attrs()
        a.update({"coeff": self._coeff, "with_decay": True})
        return a


class Lamb(Adam):
    _op_type = "lamb"

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, **kw):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip)
        self._absorb_common_kwargs(kw)
        self._lamb_wd = lamb_weight_decay

    def _attrs(self):
        a = super()._attrs()
        a["weight_decay"] = self._lamb_wd
        return a


class LarsMomentum(Optimizer):
    _op_type = "lars_momentum"

    def __init__(self, learning_rate=0.001, momentum=0.9, lars_coeff=0.001,
                 lars_weight_decay=0.0005, parameters=None, grad_clip=None,
                 **kw):
        super().__init__(learning_rate, parameters, None, grad_clip)
        self._absorb_common_kwargs(kw)
        self._momentum = momentum
        self._lars_coeff = lars_coeff
        self._lars_wd = lars_weight_decay

    def _attrs(self):
        return {"mu": self._momentum, "lars_coeff": self._lars_coeff,
                "lars_weight_decay": self._lars_wd}

    def _state_spec(self, p):
        return {"Velocity": torch.zeros_like(p)}

    def _op_state_outputs(self):
        return {"Velocity": "VelocityOut"}


class RMSProp(Optimizer):
    _op_type = "rmsprop"

    def __init__(self, learning_rate=0.001, rho=0.95, epsilon=1e-6,
                 momentum=0.0, centered=False, parameters=None,
                 weight_decay=None, grad_clip=None, **kw):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._absorb_common_kwargs(kw)
        self._rho, self._epsilon = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def _attrs(self):
        return {"decay": self._rho, "epsilon": self._epsilon,
                "momentum": self._momentum, "centered": self._centered}

    def _state_spec(self, p):
        st = {"MeanSquare": torch.zeros_like(p),
              "Moment": torch.zeros_like(p)}
        if self._centered:
            st["MeanGrad"] = torch.zeros_like(p)
        return st

    def _op_state_outputs(self):
        out = {"MeanSquare": "MeanSquareOut", "Moment": "MomentOut"}
        if self._centered:
            out["MeanGrad"] = "MeanGradOut"
        return out


class Adagrad(Optimizer):
    _op_type = "adagrad"

    def __init__(self, learning_rate=0.001, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None,
                 initial_accumulator_value=0.0, **kw):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._absorb_common_kwargs(kw)
        self._epsilon = epsilon
        self._init_acc = initial_accumulator_value

    def _attrs(self):
        return {"epsilon": self._epsilon}

    def _state_spec(self, p):
        return {"Moment": torch.full_like(p, self._init_acc)}

    def _op_state_outputs(self):
        return {"Moment": "MomentOut"}


class Adadelta(Optimizer):
    _op_type = "adadelta"

    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None, **kw):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._absorb_common_kwargs(kw)
        self._epsilon, self._rho = epsilon, rho

    def _attrs(self):
        return {"epsilon": self._epsilon, "rho": self._rho}

    def _state_spec(self, p):
        return {"AvgSquaredGrad": torch.zeros_like(p),
                "AvgSquaredUpdate": torch.zeros_like(p)}

    def _op_state_outputs(self):
        return {"AvgSquaredGrad": "AvgSquaredGradOut",
                "AvgSquaredUpdate": "AvgSquaredUpdateOut"}


class Adamax(Optimizer):
    _op_type = "adamax"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, **kw):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._absorb_common_kwargs(kw)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _attrs(self):
        return {"beta1": self._beta1, "beta2": self._beta2,
                "epsilon": self._epsilon}

    def _state_spec(self, p):
        return {"Moment": torch.zeros_like(p),
                "InfNorm": torch.zeros_like(p),
                "Beta1Pow": _pow(p, self._beta1)}

    def _op_state_outputs(self):
        return {"Moment": "MomentOut", "InfNorm": "InfNormOut",
                "Beta1Pow": "Beta1PowOut"}


# fluid aliases (fluid.optimizer.* names)
SGDOptimizer = SGD
MomentumOptimizer = Momentum
AdamOptimizer = Adam
AdamaxOptimizer = Adamax
AdagradOptimizer = Adagrad
AdadeltaOptimizer = Adadelta
RMSPropOptimizer = RMSProp
LambOptimizer = Lamb
LarsMomentumOptimizer = LarsMomentum


# 1.x fluid.dygraph.learning_rate_scheduler spellings (ref:
# fluid/dygraph/learning_rate_scheduler.py). Where the 1.x signature
# differs from the 2.0 class an adapter translates it.
LearningRateDecay = lr_sched.LRScheduler
LinearLrWarmup = lr_sched.LinearWarmup
LambdaDecay = lr_sched.LambdaDecay
MultiStepDecay = lr_sched.MultiStepDecay
NoamDecay = lr_sched.NoamDecay
PolynomialDecay = lr_sched.PolynomialDecay
StepDecay = lr_sched.StepDecay
PiecewiseDecay = lr_sched.PiecewiseDecay


class ExponentialDecay(lr_sched.LRScheduler):
    """1.x signature (learning_rate, decay_steps, decay_rate,
    staircase=False): lr · rate^(step/steps)."""

    def __init__(self, learning_rate, decay_steps, decay_rate,
                 staircase=False, begin=0, step=1, dtype="float32"):
        self._steps = float(decay_steps)
        self._rate = float(decay_rate)
        self._staircase = staircase
        super().__init__(learning_rate, last_epoch=begin - 1)

    def _epochs(self):
        e = self.last_epoch / self._steps
        return math.floor(e) if self._staircase else e

    def get_lr(self):
        return self.base_lr * (self._rate ** self._epochs())


class NaturalExpDecay(ExponentialDecay):
    """1.x: lr · exp(-rate · step/steps)."""

    def get_lr(self):
        return self.base_lr * math.exp(-self._rate * self._epochs())


class InverseTimeDecay(ExponentialDecay):
    """1.x: lr / (1 + rate · step/steps)."""

    def get_lr(self):
        return self.base_lr / (1.0 + self._rate * self._epochs())


class CosineDecay(lr_sched.LRScheduler):
    """1.x signature (learning_rate, step_each_epoch, epochs)."""

    def __init__(self, learning_rate, step_each_epoch, epochs,
                 begin=0, step=1, dtype="float32"):
        self._step_each_epoch = int(step_each_epoch)
        self._epochs = int(epochs)
        super().__init__(learning_rate, last_epoch=begin - 1)

    def get_lr(self):
        cur_epoch = self.last_epoch // self._step_each_epoch
        return self.base_lr * 0.5 * (
            math.cos(cur_epoch * math.pi / self._epochs) + 1)


class ReduceLROnPlateau(lr_sched.ReduceOnPlateau):
    """1.x positional order (learning_rate, mode, decay_rate, patience,
    verbose, threshold, ...) → the 2.0 ReduceOnPlateau."""

    def __init__(self, learning_rate, mode="min", decay_rate=0.1,
                 patience=10, verbose=False, threshold=1e-4,
                 threshold_mode="rel", cooldown=0, min_lr=0, eps=1e-8,
                 dtype="float32"):
        super().__init__(learning_rate, mode=mode, factor=decay_rate,
                         patience=patience, threshold=threshold,
                         cooldown=cooldown, min_lr=min_lr,
                         verbose=verbose)
