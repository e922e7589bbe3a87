"""Dygraph backward: ``run_backward`` and ``paddle.grad``.

Port of ``paddle_tpu/dygraph/engine.py``. Torch autograd is the tape:
``run_backward`` accumulates d(loss)/d(leaf) into every reachable leaf
that does not stop gradients, adding to what earlier calls left until
``clear_gradient()`` (the reference's GradientAccumulator contract,
``:24-36``), and :func:`grad` returns gradients without touching any
``.grad``, first order only, as the reference does (``:116-139``).
"""
from __future__ import annotations

from typing import List, Optional

import torch

from ..core.enforce import InvalidArgumentError, enforce


def _seed(out: torch.Tensor, grad_tensor):
    """The cotangent of ``out``: ones of its shape (any shape, as the
    reference seeds), or the given tensor or array."""
    enforce(out.requires_grad, "the var does not require grad; call "
            "backward on a loss produced by ops on tensors that take "
            "gradients", InvalidArgumentError)
    if grad_tensor is None:
        return torch.ones_like(out)
    if not isinstance(grad_tensor, torch.Tensor):
        grad_tensor = torch.as_tensor(grad_tensor)
    return grad_tensor.to(device=out.device, dtype=out.dtype).reshape(
        out.shape)


def run_backward(loss: torch.Tensor, grad_tensor=None,
                 retain_graph: bool = False):
    """Accumulate d(loss)/d(leaf) into every reachable leaf's ``.grad``."""
    torch.autograd.backward(loss, _seed(loss, grad_tensor),
                            retain_graph=retain_graph)


def grad(outputs, inputs, grad_outputs=None, retain_graph=False,
         create_graph=False, only_inputs=True, allow_unused=False,
         no_grad_vars=None) -> List[Optional[torch.Tensor]]:
    """paddle.grad parity (ref: imperative/partial_grad_engine.cc):
    first order only, a single output; the gradients are returned,
    detached, and no tensor's ``.grad`` is touched. An input the output
    does not reach raises unless ``allow_unused`` (then its gradient is
    None). ``create_graph`` keeps the graph, as ``retain_graph`` does,
    and builds no graph of the gradients (the reference's contract)."""
    outputs = outputs if isinstance(outputs, (list, tuple)) else [outputs]
    inputs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
    enforce(len(outputs) == 1, "paddle.grad: single output supported",
            InvalidArgumentError)
    out = outputs[0]
    seed = _seed(out, grad_outputs[0] if grad_outputs else None)
    wanted = [i for i, v in enumerate(inputs) if v.requires_grad]
    got = torch.autograd.grad(
        [out], [inputs[i] for i in wanted], [seed],
        retain_graph=bool(retain_graph or create_graph),
        allow_unused=True) if wanted else ()
    grads: List[Optional[torch.Tensor]] = [None] * len(inputs)
    for i, g in zip(wanted, got):
        grads[i] = None if g is None else g.detach()
    for v, g in zip(inputs, grads):
        if g is None and not allow_unused:
            raise InvalidArgumentError(
                f"paddle.grad: an input of shape {list(v.shape)} is unused "
                f"in the graph (pass allow_unused=True)")
    return grads
