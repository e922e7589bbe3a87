"""Dataflow verification over the Program IR.

A copy of ``paddle_tpu/analysis/dataflow.py`` (pure Python).

The static analogue of what the executor discovers dynamically:
``core/executor.py::_analyze_block`` classifies every name it meets as
feed / written / external-scope-read at run time, and a name in none of
those classes explodes as an opaque tracer error inside the jitted
build. Here the same walk happens symbolically, *before* tracing:

- use-before-def (PTA001): a var is read at op *i* but produced only at
  op *j > i* (or never), and is not a feed / persistable / scope seed;
- dangling input (PTA002): a name with no VarDesc anywhere on the block
  chain and no producer — a typo'd or half-deleted edge;
- dead ops (PTA003) / unused outputs (PTA004): relative to an explicit
  target set (fetch names), since fetch targets are a run-time argument
  and any leaf var is fetchable in principle.

Control-flow sub-blocks (``sub_block``/``blocks`` attrs, see
ops/control_flow_ops.py) are walked at their parent op's position with
the parent's defined-set plus the op's attr-named carries — deliberately
conservative: no false positives from un-modeled carry conventions.
"""
from __future__ import annotations

from typing import Iterable, List, Set

import numpy as np

from ..core.program import Block, Program
from .diagnostics import Diagnostic

# ops whose execution is an effect in itself — never dead, never DCE'd.
# Collectives are the critical class: removing one on a single rank turns
# a consistent schedule into the deadlock the PTA2xx checks exist for.
SIDE_EFFECT_PREFIXES = ("c_", "send", "recv", "rpc_", "barrier", "alltoall",
                        "gen_nccl", "mp_allreduce", "partial_send",
                        "partial_recv", "distributed_push", "distributed_pull")
# host-effect ops (ops/misc_ops.py, parity_ops.py): their point is the
# I/O or the message, not a dataflow output
SIDE_EFFECT_OPS = frozenset({"save", "save_combine", "load", "load_combine",
                             "print", "assert", "py_func"})
_STRUCTURAL_OPS = frozenset({"feed", "fetch"})


def has_side_effect(op_type: str) -> bool:
    return (op_type in SIDE_EFFECT_OPS
            or op_type.startswith(SIDE_EFFECT_PREFIXES))


def _sub_block_idxs(op) -> List[int]:
    """Sub-block references across every control-flow convention:
    ``sub_block`` (static_rnn), ``cond_block``/``body_block``
    (while_loop), ``true_block``/``false_block`` (cond), ``blocks``
    (switch/case) — see ops/control_flow_ops.py."""
    idxs = []
    for key, v in op.attrs.items():
        if key == "blocks" and isinstance(v, (list, tuple)):
            idxs.extend(b for b in v if isinstance(b, (int, np.integer)))
        elif key.endswith("block") and isinstance(v, (int, np.integer)):
            idxs.append(int(v))
    return idxs


def _attr_names(op) -> Set[str]:
    """Every string (or element of a string list) attr value: the carry /
    capture names control-flow ops thread into their sub-blocks."""
    names: Set[str] = set()
    for v in op.attrs.values():
        if isinstance(v, str):
            names.add(v)
        elif isinstance(v, (list, tuple)):
            names.update(x for x in v if isinstance(x, str))
    return names


def _seed_defined(program: Program, feed_names: Iterable[str],
                  scope_names: Iterable[str]) -> Set[str]:
    defined = set(feed_names) | set(scope_names)
    for blk in program.blocks:
        for name, v in blk.vars.items():
            if v.persistable or v.is_data:
                defined.add(name)
    return defined


def check_dataflow(program: Program, feed_names: Iterable[str] = (),
                   scope_names: Iterable[str] = (),
                   label: str = "") -> List[Diagnostic]:
    """Use-before-def + dangling-input walk over the whole block tree.

    ``scope_names`` are vars known to be initialized in the executor's
    scope (the pre-flight passes them so legitimate scope reads — the
    executor's ``const_state`` path — never false-positive)."""
    diags: List[Diagnostic] = []
    defined = _seed_defined(program, feed_names, scope_names)
    _walk_block(program, program.global_block(), defined, diags, label,
                visited=set())
    return diags


def _walk_block(program: Program, block: Block, defined: Set[str],
                diags: List[Diagnostic], label: str, visited: Set[int]):
    # `visited` guards against sub-block reference cycles in malformed
    # (hand-edited) programs: diagnose, don't RecursionError
    if block.idx in visited:
        return
    visited = visited | {block.idx}
    # producer index per name, for "produced later by op j" messages
    producers = {}
    for j, op in enumerate(block.ops):
        for n in op.output_names():
            if n and n not in producers:
                producers[n] = j

    for i, op in enumerate(block.ops):
        if op.type == "feed":
            defined.update(n for n in op.output_names() if n)
            continue
        for name in op.input_names():
            if not name or name in defined:
                continue
            later = producers.get(name)
            desc = block.find_var_recursive(name)
            if later is not None and later > i:
                diags.append(Diagnostic(
                    "PTA001", f"read at op {i} but first produced by op "
                              f"{later} ({block.ops[later].type})",
                    program=label, block_idx=block.idx, op_idx=i,
                    op_type=op.type, var=name))
            elif desc is not None:
                diags.append(Diagnostic(
                    "PTA001", "read but never produced by any op and not "
                              "a feed/persistable/scope var",
                    program=label, block_idx=block.idx, op_idx=i,
                    op_type=op.type, var=name))
            else:
                diags.append(Diagnostic(
                    "PTA002", "no VarDesc on the block chain and no "
                              "producing op (typo'd edge?)",
                    program=label, block_idx=block.idx, op_idx=i,
                    op_type=op.type, var=name))
            defined.add(name)   # report each missing name once
        for idx in _sub_block_idxs(op):
            if 0 <= idx < len(program.blocks) and idx not in visited:
                sub_defined = defined | _attr_names(op)
                sub_defined.update(n for n in op.input_names() if n)
                _walk_block(program, program.blocks[idx], sub_defined,
                            diags, label, visited=visited)
        defined.update(n for n in op.output_names() if n)


# ---- liveness / dead-code (target-relative) ----

def live_op_mask(program: Program, targets: Iterable[str],
                 block_idx: int = 0) -> List[bool]:
    """Backward liveness over one block: an op is live if it (transitively)
    feeds a target, writes a persistable var, carries a sub-block, or has
    side effects. Mirrors ``Program.prune``'s slice but keeps effectful
    ops — the difference between an optimizer slice and a SAFE rewrite."""
    block = program.blocks[block_idx]
    needed = {t for t in targets if t}
    live = [False] * len(block.ops)
    for i in range(len(block.ops) - 1, -1, -1):
        op = block.ops[i]
        outs = [n for n in op.output_names() if n]
        keep = (op.type in _STRUCTURAL_OPS
                or has_side_effect(op.type)
                or bool(_sub_block_idxs(op))
                or any(n in needed for n in outs))
        if not keep:
            for n in outs:
                v = block.find_var_recursive(n)
                if v is not None and v.persistable:
                    keep = True
                    break
        if keep:
            live[i] = True
            needed.update(n for n in op.input_names() if n)
            # attr-named vars are uses too (control-flow carry/capture
            # conventions) — mirror read_anywhere/_walk_block, or DCE
            # could delete a producer only referenced through an attr
            needed.update(_attr_names(op))
    return live


def check_dead_code(program: Program, targets: Iterable[str],
                    block_idx: int = 0,
                    label: str = "") -> List[Diagnostic]:
    """PTA003 dead ops + PTA004 unused outputs, relative to ``targets``."""
    from ..core.registry import OpInfoMap
    block = program.blocks[block_idx]
    live = live_op_mask(program, targets, block_idx)
    target_set = {t for t in targets if t}
    # reads by DEAD ops of this block don't count: an output consumed
    # only by a PTA003 op is itself unused once DCE runs
    read_anywhere: Set[str] = set()
    for blk in program.blocks:
        for j, op in enumerate(blk.ops):
            if blk.idx == block_idx and not live[j]:
                continue
            read_anywhere.update(n for n in op.input_names() if n)
            read_anywhere.update(_attr_names(op))

    diags: List[Diagnostic] = []
    info = OpInfoMap.instance()
    for i, op in enumerate(block.ops):
        if not live[i]:
            diags.append(Diagnostic(
                "PTA003", "unreachable from any target/persistable/"
                          "side-effect sink; DCE candidate",
                program=label, block_idx=block_idx, op_idx=i,
                op_type=op.type))
            continue
        intermediates = (info.get(op.type).intermediate_outputs
                         if info.has(op.type) else ())
        for slot, names in op.outputs.items():
            if slot in intermediates:
                continue
            for n in names:
                if not n or n in read_anywhere or n in target_set:
                    continue
                v = block.find_var_recursive(n)
                if v is not None and v.persistable:
                    continue
                diags.append(Diagnostic(
                    "PTA004", f"output slot {slot!r} is never read",
                    program=label, block_idx=block_idx, op_idx=i,
                    op_type=op.type, var=n))
    return diags


def eliminate_dead_ops(program: Program, targets: Iterable[str],
                       block_idx: int = 0) -> List[str]:
    """The optional DCE rewrite: drop every PTA003 op in place.

    Removal goes through ``Block.remove_op`` so the program fingerprint
    is invalidated and the executor cannot serve a stale jitted entry
    for the rewritten graph. Returns the removed op types in original
    program order."""
    block = program.blocks[block_idx]
    live = live_op_mask(program, targets, block_idx)
    removed = [op.type for op, l in zip(block.ops, live) if not l]
    for i in range(len(block.ops) - 1, -1, -1):
        if not live[i]:
            block.remove_op(i)
    return removed
