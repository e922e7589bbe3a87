"""Eager-run LoD side channel.

The TPU-native split of the reference's LoD system: jitted programs use
the dense padded + length convention (static shapes for XLA), while
HOST-side programs — beam-search decode, anything the reference itself
ran CPU-only — carry REAL ragged metadata. This module is that
carrier: during ``Executor._run_eager`` a thread-local map
{var_name: lod} travels alongside the value env, ``run_op_desc``
exposes the current op so lod-aware kernels (sequence_expand,
lod_reset, beam_search, array ops) can read their inputs' lod and
declare their outputs' — everything else ignores it. Under jit the
scope is inactive and every kernel takes its dense path.

lod format: offset-based levels, e.g. [[0, 2, 5], [0, 1, 2, 4, 6, 7]]
(the reference's LoD).
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, List, Optional

_state = threading.local()


def active() -> Optional[Dict[str, list]]:
    return getattr(_state, "lods", None)


@contextlib.contextmanager
def lod_scope(initial: Optional[Dict[str, list]] = None):
    prev = getattr(_state, "lods", None)
    _state.lods = dict(initial or {})
    try:
        yield _state.lods
    finally:
        _state.lods = prev


@contextlib.contextmanager
def infer_shape_scope():
    """Marks build-time shape inference: lod-dependent kernels return a
    shape PROXY instead of raising eager-only (rows stay dynamic)."""
    prev = getattr(_state, "infer", False)
    _state.infer = True
    try:
        yield
    finally:
        _state.infer = prev


def in_infer_shape() -> bool:
    return getattr(_state, "infer", False)


@contextlib.contextmanager
def op_scope(op):
    prev = getattr(_state, "op", None)
    _state.op = op
    try:
        yield
    finally:
        _state.op = prev


def get_lod(name: str) -> Optional[list]:
    m = active()
    return m.get(name) if m else None


def set_lod(name: str, lod) -> None:
    m = active()
    if m is not None:
        if lod:
            m[name] = [list(level) for level in lod]
        else:
            m.pop(name, None)


def input_lod(slot: str, idx: int = 0) -> Optional[list]:
    """The lod of the current op's ``slot`` input (eager runs only)."""
    op = getattr(_state, "op", None)
    m = active()
    if op is None or m is None:
        return None
    names = op.inputs.get(slot) or []
    if idx >= len(names):
        return None
    return m.get(names[idx])


def set_output_lod(slot: str, lod, idx: int = 0) -> None:
    """Declare the lod of the current op's ``slot`` output."""
    op = getattr(_state, "op", None)
    if op is None or active() is None:
        return
    names = op.outputs.get(slot) or []
    if idx < len(names):
        set_lod(names[idx], lod)


def propagate(in_slot: str, out_slot: str) -> None:
    lod = input_lod(in_slot)
    if lod:
        set_output_lod(out_slot, lod)


def lengths_to_offsets(lens: List[int]) -> List[int]:
    offs = [0]
    for l in lens:
        offs.append(offs[-1] + int(l))
    return offs


def widths(level: List[int]) -> List[int]:
    return [level[i + 1] - level[i] for i in range(len(level) - 1)]
