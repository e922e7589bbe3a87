"""IR-level autodiff: append_backward over a Program.

Port of ``paddle_tpu/core/backward.py`` (ref:
python/paddle/fluid/backward.py:1275 append_backward, :1861 gradients;
framework/grad_op_desc_maker.h). Every forward op gets ONE canonical
grad OpDesc (type ``<fwd>_grad``, carrying ``__fwd_type__``,
``__fwd_input_slots__`` and ``__fwd_output_slots__``) whose runtime
kernel is the registry's generic gradient (``executor.py``); repeat
producers of one gradient are summed by a ``sum`` op. The grad ops the
port appends are the JAX package's, OpDesc for OpDesc, so one program
JSON runs in both.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from . import dtype as dtypes
from .enforce import InvalidArgumentError, enforce
from .program import GRAD_SUFFIX, Block, OpDesc, Program
from .registry import OpInfoMap


def _is_differentiable_var(block: Block, name: str) -> bool:
    v = block.find_var_recursive(name)
    if v is None:
        return True  # unknown metadata: let the runtime decide by dtype
    if v.stop_gradient:
        return False
    if v.dtype is not None and not dtypes.is_floating(v.dtype):
        return False
    return True


def _relevant_ops(block: Block, target: str,
                  no_grad_set: Set[str]) -> Tuple[List[int], Set[str]]:
    """Backward slice: ops contributing to target (ref: backward.py
    _find_op_path_)."""
    needed = {target}
    op_idxs: List[int] = []
    for idx in range(len(block.ops) - 1, -1, -1):
        op = block.ops[idx]
        outs = set(op.output_names())
        if outs & needed:
            op_idxs.append(idx)
            for n in op.input_names():
                if n and n not in no_grad_set:
                    needed.add(n)
    op_idxs.reverse()
    return op_idxs, needed


def make_grad_op(fwd: OpDesc, out_grad_names: Dict[str, List[Optional[str]]],
                 in_grad_names: Dict[str, List[Optional[str]]]) -> OpDesc:
    """Build the canonical grad OpDesc for a forward op.

    inputs: every fwd input slot, every fwd output slot, plus
    ``<slot>@GRAD`` carrying incoming output grads; outputs:
    ``<slot>@GRAD`` per differentiable fwd input slot — fluid's exact
    grad-op naming convention (ref: grad_op_desc_maker.h InputGrad/
    OutputGrad).
    """
    inputs: Dict[str, List[str]] = {}
    for slot, names in fwd.inputs.items():
        inputs[slot] = list(names)
    for slot, names in fwd.outputs.items():
        inputs[slot] = list(names)
    for slot, gnames in out_grad_names.items():
        inputs[slot + GRAD_SUFFIX] = [g or "" for g in gnames]
    outputs = {
        slot + GRAD_SUFFIX: [g or "" for g in gnames]
        for slot, gnames in in_grad_names.items()
    }
    attrs = dict(fwd.attrs)
    attrs["__fwd_type__"] = fwd.type
    attrs["__fwd_input_slots__"] = sorted(fwd.inputs)
    attrs["__fwd_output_slots__"] = sorted(fwd.outputs)
    return OpDesc(fwd.type + "_grad", inputs, outputs, attrs)


def append_backward(loss, parameter_list: Optional[Sequence] = None,
                    no_grad_set: Optional[Set[str]] = None,
                    program: Optional[Program] = None,
                    checkpoints: Optional[Sequence[str]] = None
                    ) -> List[Tuple[str, str]]:
    """Append grad ops for ``loss`` to its program's global block.

    Returns [(param_name, grad_name)] like the reference
    (ref: python/paddle/fluid/backward.py:1275). ``checkpoints`` is
    accepted for recompute parity and ignored (no op is re-emitted).

    Variable writes are SSA-versioned internally (the analogue of the
    reference's _rename_arg_ plumbing) so in-place forward ops — the same
    name written twice — get distinct gradients per version instead of a
    bogus accumulation.
    """
    from .program import default_main_program

    loss_name = loss if isinstance(loss, str) else loss.name
    program = program or getattr(loss, "program", None) or default_main_program()
    block = program.global_block()
    no_grad = set(no_grad_set or ())

    op_idxs, _needed = _relevant_ops(block, loss_name, no_grad)
    enforce(op_idxs or block.has_var(loss_name),
            f"loss var {loss_name!r} is not produced by this program",
            InvalidArgumentError)

    # SSA versioning pass over the forward slice: version 0 = value
    # entering the block (params/feeds); each write bumps the version.
    version: Dict[str, int] = {}
    read_ver: Dict[int, Dict[str, int]] = {}   # op idx -> {name: version}
    write_ver: Dict[int, Dict[str, int]] = {}
    for idx in op_idxs:
        op = block.ops[idx]
        read_ver[idx] = {n: version.get(n, 0) for n in op.input_names() if n}
        wv = {}
        for n in op.output_names():
            if n:
                version[n] = version.get(n, 0) + 1
                wv[n] = version[n]
        write_ver[idx] = wv
    last_ver = dict(version)  # name -> final version in the slice

    # lazy grad naming: the first version of n to need a grad gets the
    # fluid-visible ``n@GRAD``; later versions (in-place rewrites) get a
    # @v suffix. Backward order means the as-consumed version wins base.
    assigned: Dict[Tuple[str, int], str] = {}
    used_names: set = set()

    def grad_name(n: str, v: int) -> str:
        key = (n, v)
        name = assigned.get(key)
        if name is None:
            base = n + GRAD_SUFFIX
            name = base if base not in used_names else f"{base}@v{v}"
            assigned[key] = name
            used_names.add(name)
        return name

    # d(loss)/d(loss) = 1  (ref: backward.py _append_loss_grad_op)
    loss_grad = grad_name(loss_name, last_ver.get(loss_name, 0))
    loss_var = block.find_var_recursive(loss_name)
    loss_shape = list(loss_var.shape) if loss_var and loss_var.shape else [1]
    # the reference enforces a size-1 loss (backward.py:1283
    # "The loss.shape should be (1L,)"); failing here beats a baffling
    # reshape error from a non-scalar cotangent mid-executor
    enforce(int(np.prod(loss_shape)) == 1,
            f"append_backward loss {loss_name!r} must be a scalar "
            f"(size-1) var, got declared shape {tuple(loss_shape)}; "
            "reduce it (e.g. reduce_mean) before calling append_backward",
            InvalidArgumentError)
    block.append_op(
        "fill_constant", inputs={},
        outputs={"Out": [loss_grad]},
        attrs={"shape": loss_shape, "value": 1.0,
               "dtype": (dtypes.dtype_name(loss_var.dtype)
                         if loss_var and loss_var.dtype else "float32"),
               "force_cpu": False})
    block.create_var(loss_grad, shape=tuple(loss_shape))

    # (name, version) -> accumulated grad var name
    grad_of: Dict[Tuple[str, int], str] = {
        (loss_name, last_ver.get(loss_name, 0)): loss_grad}

    info = OpInfoMap.instance()
    for idx in reversed(op_idxs):
        fwd = block.ops[idx]
        out_grads: Dict[str, List[Optional[str]]] = {}
        any_grad = False
        for slot, names in fwd.outputs.items():
            gs = [grad_of.get((n, write_ver[idx].get(n, 0))) for n in names]
            out_grads[slot] = gs
            any_grad = any_grad or any(g is not None for g in gs)
        if not any_grad:
            continue

        intermediate = (info.get(fwd.type).intermediate_outputs
                        if info.has(fwd.type) else ())
        out_grads = {s: g for s, g in out_grads.items() if s not in intermediate}

        in_grads: Dict[str, List[Optional[str]]] = {}
        produced: List[Tuple[str, int, str]] = []  # (var, version, grad name)
        nondiff = (info.get(fwd.type).non_differentiable_inputs
                   if info.has(fwd.type) else ())
        for slot, names in fwd.inputs.items():
            if slot in nondiff:
                continue
            gnames: List[Optional[str]] = []
            for n in names:
                if not n or n in no_grad or not _is_differentiable_var(block, n):
                    gnames.append(None)
                    continue
                v = read_ver[idx].get(n, 0)
                key = (n, v)
                if key in grad_of:
                    # repeat producer for this version: write fresh, then
                    # sum (ref: backward.py _addup_repetitive_outputs_)
                    fresh = program.unique_name(grad_name(n, v) + "@RENAME")
                    gnames.append(fresh)
                    produced.append((n, v, fresh))
                else:
                    gname = grad_name(n, v)
                    gnames.append(gname)
                    grad_of[key] = gname
                    produced.append((n, v, gname))
                    block.create_var(
                        gname,
                        shape=(block.find_var_recursive(n).shape
                               if block.find_var_recursive(n) else None))
            if any(g is not None for g in gnames):
                in_grads[slot] = gnames
        if not in_grads:
            continue

        block.append_op_desc(make_grad_op(fwd, out_grads, in_grads))

        # accumulate repeat producers into a fresh merged name; consumers
        # of this (name, version) are emitted later and read via grad_of
        for n, v, gname in produced:
            if grad_of[(n, v)] != gname:
                prev = grad_of[(n, v)]
                merged = program.unique_name(grad_name(n, v) + "@MERGE")
                block.append_op("sum", inputs={"X": [prev, gname]},
                                outputs={"Out": [merged]}, attrs={})
                block.create_var(merged)
                grad_of[(n, v)] = merged

    # rebase merged grads onto the fluid-visible name so users (and
    # optimizer wiring) can fetch n@GRAD directly
    for (n, v), gname in list(grad_of.items()):
        canonical = grad_name(n, v)
        if gname != canonical:
            block.append_op("assign", inputs={"X": [gname]},
                            outputs={"Out": [canonical]}, attrs={})
            block.create_var(canonical)
            grad_of[(n, v)] = canonical

    # parameter -> grad pairs (ref: backward.py returns params_and_grads)
    if parameter_list is not None:
        params = [p if isinstance(p, str) else p.name for p in parameter_list]
    else:
        params = [v.name for v in block.vars.values()
                  if v.persistable and not v.is_data and not v.stop_gradient]
    param_grads = [(p, grad_of[(p, 0)]) for p in params if (p, 0) in grad_of]
    return param_grads


def gradients(targets, inputs, target_gradients=None, no_grad_set=None):
    """fluid.gradients parity (ref: backward.py:1861): returns grad var
    names for ``inputs`` w.r.t. the sum of ``targets``."""
    targets = targets if isinstance(targets, (list, tuple)) else [targets]
    enforce(len(targets) == 1 and target_gradients is None,
            "only single-target gradients are supported so far")
    append_backward(targets[0], no_grad_set=no_grad_set)
    names = [i if isinstance(i, str) else i.name for i in inputs]
    return [n + GRAD_SUFFIX for n in names]
