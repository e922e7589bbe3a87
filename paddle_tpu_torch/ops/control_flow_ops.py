"""Static-graph control flow: while_loop, conditional_block, switch and
static_rnn.

Port of ``paddle_tpu/ops/control_flow_ops.py`` (ref:
operators/controlflow/while_op.cc, conditional_block_op.cc; builders
python/paddle/fluid/layers/control_flow.py:971 While, :1110 while_loop,
:2298 cond, :2603 switch_case, rnn.py StaticRNN). The JAX package lowers
each sub-block into ``lax.while_loop``, ``lax.scan``, ``lax.cond`` or
``lax.switch``; here a sub-block is interpreted op by op in eager torch
through the executor's ``run_op_desc``, as the reference's nested
executor does, and autograd differentiates the ops each iteration ran:

- ``static_rnn``: a Python loop over the T steps of ``lax.scan``;
- ``while_loop`` with ``max_trip_count``: exactly that many steps, each
  merged into the carry by ``torch.where`` on the condition, as the
  JAX package's masked scan merges them (``:127-136``): no host sync;
- ``while_loop`` without it: the condition read on the host, one sync
  an iteration (``lax.while_loop``'s). The JAX package cannot reverse
  that loop; the port differentiates it (ROADMAP, "reference faults the
  port does not reproduce");
- ``conditional_block`` and ``switch``: the predicate or index read on
  the host, one sync, and only that branch runs. The other branch's ops
  never run, so neither its gradients (a NaN there stays there) nor its
  array writes land.

Sub-blocks are found through the program the executor publishes for a
run (``core.executor.current_program``). A body that the JAX package
traces once draws the same random numbers in every iteration (one key
for all steps of ``lax.scan``): each iteration here starts from the RNG
salt the first started from, and runs "traced" for the array ops
(``array_ops.traced_body``), which then keep the dense form.
"""
from __future__ import annotations

from typing import Dict, List

import torch

from ..core import lodctx, rng
from ..core.enforce import InvalidArgumentError, PreconditionNotMetError
from ..core.executor import current_program, random_draws, run_op_desc
from ..core.registry import register_op
from .array_ops import LoDTensorArrayValue, traced, traced_body

_CF_NONDIFF = ("Cond", "BranchIndex")
_MAX_EAGER_ITERATIONS = 100000


def _program():
    p = current_program()
    if p is None:
        raise PreconditionNotMetError(
            "control-flow op executed outside an Executor.run (no program "
            "context); run it through paddle_tpu_torch.static.Executor")
    return p


def _run_block(block, env: Dict[str, object]):
    for op in block.ops:
        run_op_desc(op, env)
    return env


def _host_pred(x) -> bool:
    """A predicate read on the host (one device-to-host sync)."""
    return bool(x.reshape(()).item())


def _as_pred(x):
    return x.reshape(()).to(torch.bool)


def _lod_state(init, captured) -> bool:
    if lodctx.active():
        return True
    return any(isinstance(v, LoDTensorArrayValue)
               for v in list(init) + list(captured.values()))


@register_op("while_loop", non_differentiable_inputs=_CF_NONDIFF)
def while_loop_op(inputs, attrs):
    """Carry = the loop vars X; the cond and body sub-blocks read the
    carry and the Captured vars (weights and other outer state) by
    name."""
    program = _program()
    cond_blk = program.blocks[attrs["cond_block"]]
    body_blk = program.blocks[attrs["body_block"]]
    carry_names: List[str] = attrs["carry_names"]
    body_out_names: List[str] = attrs["body_out_names"]
    cond_out = attrs["cond_out_name"]
    captured = dict(zip(attrs.get("captured_names", ()),
                        inputs.get("Captured", ())))
    init = tuple(inputs["X"])
    if len(init) != len(carry_names) or len(init) != len(body_out_names):
        raise InvalidArgumentError(
            f"while_loop: {len(init)} loop vars but {len(carry_names)} "
            f"carry names / {len(body_out_names)} body outputs")

    def cond_fn(carry):
        env = dict(captured)
        env.update(zip(carry_names, carry))
        return _run_block(cond_blk, env)[cond_out]

    def body_fn(carry):
        env = dict(captured)
        env.update(zip(carry_names, carry))
        _run_block(body_blk, env)
        return tuple(env[n] for n in body_out_names)

    mtc = attrs.get("max_trip_count")
    if mtc is None and not traced() and _lod_state(init, captured):
        # the reference's host-side eager loop (its WhileOp on the CPU):
        # carry shapes may change across iterations and tensor arrays
        # grow as lists; each iteration draws afresh
        carry, guard = init, 0
        while _host_pred(cond_fn(carry)):
            carry = body_fn(carry)
            guard += 1
            if guard > _MAX_EAGER_ITERATIONS:
                raise InvalidArgumentError(
                    "while_loop: >1e5 eager iterations — divergent loop?")
        return {"Out": list(carry)}

    salt = rng.op_salt()
    carry = init
    with traced_body():
        if mtc:
            # bounded: exactly mtc steps, the carry frozen once the
            # condition goes false
            for _ in range(int(mtc)):
                rng.set_op_salt(salt)
                active = _as_pred(cond_fn(carry))
                new = body_fn(carry)
                carry = tuple(torch.where(active, n, c)
                              for n, c in zip(new, carry))
        else:
            while True:
                rng.set_op_salt(salt)
                if not _host_pred(cond_fn(carry)):
                    break
                carry = body_fn(carry)
    return {"Out": list(carry)}


def _branch(program, blk_idx, out_names, cap_names, captured, salt):
    """Run one branch sub-block on the captured vars; its random ops
    draw from ``salt`` on."""
    env = dict(zip(cap_names, captured))
    rng.set_op_salt(salt)
    with traced_body():
        _run_block(program.blocks[blk_idx], env)
    return [env[n] for n in out_names]


@register_op("conditional_block", non_differentiable_inputs=_CF_NONDIFF)
def conditional_block_op(inputs, attrs):
    """Two-armed cond: the predicate is read on the host and only its
    branch runs (the reference's conditional_block)."""
    program = _program()
    cap_names = tuple(attrs.get("captured_names", ()))
    captured = tuple(inputs.get("Captured", ()))
    salt = rng.op_salt()
    if _host_pred(inputs["Cond"][0]):
        outs = _branch(program, attrs["true_block"],
                       attrs["true_out_names"], cap_names, captured, salt)
    else:
        # the true branch's draws come first in the JAX package's trace
        salt += random_draws(program, program.blocks[attrs["true_block"]])
        outs = _branch(program, attrs["false_block"],
                       attrs["false_out_names"], cap_names, captured, salt)
    return {"Out": outs}


@register_op("switch", non_differentiable_inputs=_CF_NONDIFF)
def switch_op(inputs, attrs):
    """N-armed switch over sub-blocks (ref: control_flow.py:2603
    switch_case); the last block is the default arm, which any index
    outside [0, n_listed) selects, negative ones too. The index is read
    on the host and only its arm runs."""
    program = _program()
    blocks = list(attrs["blocks"])
    n_listed = len(blocks) - 1
    raw = int(inputs["BranchIndex"][0].reshape(()).to(torch.int32).item())
    idx = raw if 0 <= raw < n_listed else n_listed
    salt = rng.op_salt() + sum(random_draws(program, program.blocks[b])
                               for b in blocks[:idx])
    outs = _branch(program, blocks[idx], attrs["out_names"][idx],
                   tuple(attrs.get("captured_names", ())),
                   tuple(inputs.get("Captured", ())), salt)
    return {"Out": outs}


@register_op("static_rnn")
def static_rnn_op(inputs, attrs):
    """Time-major loop over a step sub-block (ref: fluid StaticRNN,
    layers/rnn.py). Sequences: [T, ...] sliced a step at a time; Inits
    seed the memories; the step outputs come back stacked on a leading
    T dim, and the memories' last values as FinalStates."""
    program = _program()
    blk = program.blocks[attrs["sub_block"]]
    seq_step_names = attrs.get("seq_step_names", [])
    mem_names = attrs.get("mem_names", [])
    mem_update_names = attrs.get("mem_update_names", [])
    step_out_names = attrs.get("step_out_names", [])
    captured = dict(zip(attrs.get("captured_names", ()),
                        inputs.get("Captured", ())))
    seqs = tuple(inputs.get("Sequences", ()))
    carry = tuple(inputs.get("Inits", ()))
    if not seqs and not attrs.get("length"):
        raise InvalidArgumentError(
            "static_rnn needs at least one step_input (or a 'length' attr)")
    lengths = {int(s.shape[0]) for s in seqs}
    if len(lengths) > 1:
        raise InvalidArgumentError(
            f"static_rnn: step inputs of different lengths {lengths}")
    steps = lengths.pop() if seqs else int(attrs["length"])
    ys: List[list] = [[] for _ in step_out_names]
    salt = rng.op_salt()
    with traced_body():
        for t in range(steps):
            rng.set_op_salt(salt)
            env = dict(captured)
            env.update(zip(mem_names, carry))
            env.update(zip(seq_step_names, (s[t] for s in seqs)))
            _run_block(blk, env)
            carry = tuple(env[n] for n in mem_update_names)
            for acc, n in zip(ys, step_out_names):
                acc.append(env[n])
    return {"Out": [torch.stack(acc) for acc in ys],
            "FinalStates": list(carry)}
