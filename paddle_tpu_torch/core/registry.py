"""Operator registry: op_type -> compute over torch tensors.

Port of ``paddle_tpu/core/registry.py``. A registered op is one function

    compute(inputs: Dict[slot, List[Tensor]], attrs: Dict) -> Dict[slot, List[Tensor]]

written in torch ops, so torch autograd differentiates it. An op that
needs a hand-written gradient builds a ``torch.autograd.Function`` inside
its compute (``ops/flash_attention.py``).

The static graph's grad ops (``<type>_grad``, ``core/backward.py``) run
:func:`generic_vjp_grad`, the counterpart of the JAX package's
(``paddle_tpu/core/registry.py:121-170``): ``torch.autograd.grad`` of the
compute on its differentiable input slots. It is split in two, so the
executor can keep a forward op's autograd graph (:func:`vjp_forward`)
until its grad op consumes it (:func:`vjp_backward`) instead of running
the forward again. An op whose forward cannot be run again for its
gradient (``dropout`` would draw a new mask) registers a gradient of
its own with :func:`register_grad`, read from the forward's saved
outputs; the static executor runs it in place of the generic one.

``infer_meta`` is an op's shape rule for static builders, which infer
output shapes by running the compute on ``meta`` tensors; an op whose
compute cannot run there (the flash kernels' wrapper checks the device)
registers one with :func:`register_infer_meta`.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional

import torch
from torch.autograd.graph import get_gradient_edge

from .enforce import AlreadyExistsError, NotFoundError


class OpDef:
    __slots__ = ("type", "compute", "grad", "infer_meta",
                 "intermediate_outputs", "non_differentiable_inputs")

    def __init__(self, type_: str, compute: Callable,
                 intermediate_outputs: tuple = (),
                 non_differentiable_inputs: tuple = ()):
        self.type = type_
        self.compute = compute
        # static grad op: grad(inputs, outputs, out_grads, attrs) ->
        # {forward input slot: [grad or None]}; None is generic_vjp_grad
        self.grad: Optional[Callable] = None
        self.infer_meta: Optional[Callable] = None
        # output slots that exist only to feed the grad (e.g. LN saved stats)
        self.intermediate_outputs = intermediate_outputs
        # input slots that never receive gradient (integer labels, ids)
        self.non_differentiable_inputs = non_differentiable_inputs


class OpInfoMap:
    """Global op table (ref: framework/op_info.h OpInfoMap)."""

    _instance: Optional["OpInfoMap"] = None

    def __init__(self):
        self._ops: Dict[str, OpDef] = {}

    @classmethod
    def instance(cls) -> "OpInfoMap":
        if cls._instance is None:
            cls._instance = cls()
        return cls._instance

    def register(self, op: OpDef):
        if op.type in self._ops:
            raise AlreadyExistsError(f"op {op.type!r} registered twice")
        self._ops[op.type] = op

    def get(self, op_type: str) -> OpDef:
        op = self._ops.get(op_type)
        if op is None:
            raise NotFoundError(
                f"op {op_type!r} has no registered kernel "
                f"({len(self._ops)} ops registered)")
        return op

    def has(self, op_type: str) -> bool:
        return op_type in self._ops


def register_op(op_type: str, *, intermediate_outputs=(),
                non_differentiable_inputs=()):
    """Decorator: register ``compute`` for op_type (ref: REGISTER_OPERATOR)."""

    def deco(compute):
        opdef = OpDef(op_type, compute,
                      intermediate_outputs=tuple(intermediate_outputs),
                      non_differentiable_inputs=tuple(
                          non_differentiable_inputs))
        OpInfoMap.instance().register(opdef)
        compute._opdef = opdef
        return compute

    return deco


def register_grad(op_type: str):
    """Decorator: attach a custom gradient to a registered op (the
    signature of :attr:`OpDef.grad`)."""

    def deco(grad_fn):
        OpInfoMap.instance().get(op_type).grad = grad_fn
        return grad_fn

    return deco


def register_infer_meta(op_type: str):
    """Decorator: attach a shape rule ``(meta inputs, attrs) -> meta
    outputs`` to a registered op, used by static shape inference in place
    of its compute."""

    def deco(fn):
        OpInfoMap.instance().get(op_type).infer_meta = fn
        return fn

    return deco


def _floating(t) -> bool:
    return t.is_floating_point() or t.is_complex()


def _differentiable(opdef: OpDef, slot: str, tensors) -> bool:
    # a slot is differentiable if ANY element is float/complex; integer
    # elements of such a slot get no gradient (None)
    if slot in opdef.non_differentiable_inputs:
        return False
    return any(_floating(t) for t in tensors)


def vjp_forward(opdef: OpDef, inputs: Dict[str, List], attrs: Dict):
    """Run the compute with autograd on. Every floating element of a
    differentiable slot enters as a tensor of its own: a view of an input
    that already carries a graph (the output of an earlier recorded op,
    so the graph runs on through this op as in dygraph), else a fresh
    leaf. Returns (outputs, record); ``record`` holds the graph's edges
    and the shapes :func:`vjp_backward` needs, and no tensor, so an
    output or input it does not save is freed like any other."""
    full, ins = {}, {}
    with torch.enable_grad():
        for slot, vals in inputs.items():
            if not _differentiable(opdef, slot, vals):
                full[slot] = [v.detach() if v.requires_grad else v
                              for v in vals]
                continue
            row, meta = [], []
            for v in vals:
                if _floating(v):
                    v = (v.view_as(v) if v.requires_grad
                         else v.detach().requires_grad_())
                    meta.append((get_gradient_edge(v), v.shape, v.dtype,
                                 v.device))
                else:
                    meta.append(None)
                row.append(v)
            full[slot], ins[slot] = row, meta
        outs = opdef.compute(full, attrs)
    roots = {slot: [(get_gradient_edge(v), v.shape, v.dtype)
                    if v is not None and v.requires_grad else None
                    for v in vals] for slot, vals in outs.items()}
    return outs, (ins, roots)


def _fit_ct(g, shape, dtype):
    # loss vars are shape [1] in fluid but often 0-d here; a size-1
    # cotangent against a bigger output broadcasts (the fluid fill-1
    # loss seed == gradient of sum semantics)
    if tuple(g.shape) != tuple(shape):
        if g.numel() == math.prod(shape):
            g = g.reshape(shape)
        else:
            g = g.reshape((1,) * len(shape)).expand(shape)
    return g.to(dtype)


def vjp_backward(record, out_grads: Dict[str, List]) -> Dict[str, List]:
    """Input gradients from a :func:`vjp_forward` record: the given
    out-grads as cotangents (a missing one is a zero cotangent), zeros
    for an input that does not reach the outputs, None for an integer
    element. The graph's buffers are freed as it runs."""
    ins, roots = record
    edges, cts = [], []
    for slot, metas in roots.items():
        gs = out_grads.get(slot) or []
        for meta, g in zip(metas, gs):
            if g is not None and meta is not None:
                edges.append(meta[0])
                cts.append(_fit_ct(g, meta[1], meta[2]))
    wanted = [m[0] for metas in ins.values() for m in metas if m is not None]
    grads = (torch.autograd.grad(edges, wanted, cts, allow_unused=True)
             if edges and wanted else [None] * len(wanted))
    it = iter(grads)
    in_grads = {}
    for slot, metas in ins.items():
        row = []
        for m in metas:
            if m is None:
                row.append(None)
                continue
            g = next(it)
            row.append(torch.zeros(m[1], dtype=m[2], device=m[3])
                       if g is None else g)
        in_grads[slot] = row
    return in_grads


def generic_vjp_grad(opdef: OpDef, inputs: Dict[str, List],
                     outputs: Dict[str, List], out_grads: Dict[str, List],
                     attrs: Dict) -> Dict[str, List]:
    """Default gradient: the forward run again with autograd on, then
    ``torch.autograd.grad`` (the signature of the JAX package's)."""
    _, record = vjp_forward(opdef, inputs, attrs)
    return vjp_backward(record, out_grads)
