"""Operator registry: op_type -> compute over torch tensors.

Port of ``paddle_tpu/core/registry.py``. A registered op is one function

    compute(inputs: Dict[slot, List[Tensor]], attrs: Dict) -> Dict[slot, List[Tensor]]

written in torch ops, so torch autograd differentiates it: the JAX
package's ``generic_vjp_grad`` has no counterpart here. An op that needs
a hand-written gradient builds a ``torch.autograd.Function`` inside its
compute (``ops/flash_attention.py``).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

from .enforce import AlreadyExistsError, NotFoundError


class OpDef:
    __slots__ = ("type", "compute", "intermediate_outputs",
                 "non_differentiable_inputs")

    def __init__(self, type_: str, compute: Callable,
                 intermediate_outputs: tuple = (),
                 non_differentiable_inputs: tuple = ()):
        self.type = type_
        self.compute = compute
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
