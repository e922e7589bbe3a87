"""TrainStep: forward, backward and optimizer update in one call.

Port of the single-device ``TrainStep`` of ``paddle_tpu/jit/__init__.py``
(``:134-262``, ``:350-396``). The reference traces the step into one XLA
program; the port runs it eagerly (no ``torch.compile``): the forward
under the step's AMP level and dtype, ``loss.backward()``, then the
optimizer's ``functional_step`` under ``no_grad`` with the optimizer
state held by the step, written back into the parameters in place.

- O2: with ``amp.decorate`` the parameters are bf16 (or fp16); when the
  optimizer is ``_multi_precision`` the step keeps an fp32 master of
  each, the update runs on the master and is cast back into the
  parameter (ref ``_apply_update``, ``:210-240``).
- The learning rate is read from ``get_lr()`` every call and written
  into one persistent tensor on the device (no tensor from host data).
- A tied weight is one Parameter here, updated once. The reference lists
  it under each of its names, so its gradient enters the global-norm
  clip once a name; the step passes it to ``functional_step`` under each
  name as well, so the clip matches the reference.
- Buffers (BN running statistics) stay on the model, and the
  ``batch_norm`` op updates them in place during the forward.

``ParallelTrainStep`` and ``DataParallelTrainStep`` are not ported yet.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from ..amp import auto_cast
from ..core.enforce import UnimplementedError
from ..dygraph.layers import Layer
from ..dygraph.varbase import to_variable
from ..optimizer import Optimizer, install

_LOW = (torch.bfloat16, torch.float16)


def _copies(tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().clone() for k, v in tensors.items()}


class TrainStep:
    """step_fn(model, *args) -> scalar loss tensor.

    The AMP dtype of the step is, at O2, the one ``amp.decorate`` gave the
    parameters (read when the state is made, at the first step), and
    otherwise the thread's (bf16 unless set), as in the reference."""

    def __init__(self, model: Layer, step_fn: Callable,
                 optimizer: Optimizer, amp_level: str = "O0"):
        if amp_level not in ("O0", "O1", "O2"):
            raise UnimplementedError(
                f"amp_level {amp_level!r}: expected O0, O1 or O2")
        self._model = model
        self._step_fn = step_fn
        self._opt = optimizer
        self._amp_level = amp_level
        # structured name -> parameter; a tied weight appears once
        self._params = dict(model.named_parameters())
        # every name of every parameter -> the name it is kept under
        first = {id(p): n for n, p in self._params.items()}
        self._names = {n: first[id(p)] for n, p in
                       model.named_parameters(remove_duplicate=False)}
        self._amp_dtype = None
        self._opt_states: Optional[Dict[str, Dict[str, torch.Tensor]]] = None
        self._masters: Dict[str, torch.Tensor] = {}
        self._step_count = 0

    @property
    def aliases(self) -> Dict[str, str]:
        """The other names of tied parameters -> the name kept here."""
        return {n: c for n, c in self._names.items() if n != c}

    def ensure_state(self) -> "TrainStep":
        """Create the optimizer state (and the fp32 masters of
        low-precision parameters when the optimizer is multi_precision)
        now, on the parameters' device."""
        if self._opt_states is None:
            if self._amp_level == "O2":
                self._amp_dtype = next((p.dtype for p in
                                        self._params.values()
                                        if p.dtype in _LOW), None)
            multi = self._opt._multi_precision
            self._opt_states = {}
            for name, p in self._params.items():
                if not p.requires_grad:
                    continue
                if multi and p.dtype in _LOW:
                    self._masters[name] = p.detach().float()
                self._opt_states[name] = self._opt._state_spec(
                    self._masters.get(name, p.detach()))
        return self

    def __call__(self, *args) -> torch.Tensor:
        self.ensure_state()
        self._model.train()
        for p in self._params.values():
            p.grad = None
        with auto_cast(level=self._amp_level, dtype=self._amp_dtype):
            loss = self._step_fn(self._model,
                                 *[to_variable(a) for a in args])
        loss.backward()
        grads = {n: self._params[c].grad for n, c in self._names.items()
                 if self._params[c].grad is not None}
        with torch.no_grad():
            trainable = {n: self._masters.get(n, p.detach())
                         for n, p in self._params.items() if n in grads}
            new_vals, new_states = self._opt.functional_step(
                trainable, grads,
                {n: self._opt_states[n] for n in trainable},
                self._opt.lr_tensor(loss.device))
            for name, val in new_vals.items():
                if name in self._masters:
                    self._masters[name] = val
                    self._params[name].copy_(val)
                else:
                    install(self._params[name], val)
            self._opt_states.update(new_states)
        self._step_count += 1
        return loss.detach()

    def state_dict(self) -> Dict:
        """A snapshot of the whole training state by structured name:
        ``params``, ``buffers``, ``opt_states``, ``masters`` and
        ``meta.step`` (ref ``:279-309``), every tensor a copy that later
        steps leave as it is; empty groups are left out."""
        self.ensure_state()
        state: Dict = {"params": _copies(self._params),
                       "meta": {"step": self._step_count}}
        buffers = dict(self._model.named_buffers())
        if buffers:
            state["buffers"] = _copies(buffers)
        if self._opt_states:
            state["opt_states"] = {n: _copies(st) for n, st in
                                   self._opt_states.items()}
        if self._masters:
            state["masters"] = _copies(self._masters)
        return state

    def set_state_dict(self, state: Dict):
        """Install a :meth:`state_dict` payload (tensors) over the state
        made from its parameters. Unknown names are ignored."""
        with torch.no_grad():
            for k, v in (state.get("params") or {}).items():
                if k in self._params:
                    p = self._params[k]
                    install(p, v.to(p.device))
            buffers = dict(self._model.named_buffers())
            for k, v in (state.get("buffers") or {}).items():
                if k in buffers:
                    buffers[k].copy_(v)
        self.ensure_state()
        devs = {n: p.device for n, p in self._params.items()}
        if state.get("opt_states"):
            self._opt_states = {
                n: {k: v.to(devs[n]).clone() for k, v in st.items()}
                for n, st in state["opt_states"].items() if n in devs}
        if state.get("masters"):
            self._masters = {n: v.to(devs[n], torch.float32).clone()
                             for n, v in state["masters"].items()
                             if n in devs}
        step = (state.get("meta") or {}).get("step")
        if step is not None:
            self._step_count = int(step)
