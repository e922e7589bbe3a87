"""Collective-consistency checking: the static deadlock class.

A copy of ``paddle_tpu/analysis/collective_check.py`` (pure Python);
dtype names come from ``core.dtype.dtype_name`` (a torch dtype has no
``.name``).

On real hardware a collective schedule that diverges across ranks —
different order, different ring, different payload — does not error, it
HANGS (every rank blocks in a different all-reduce). Papers like
"Memory-efficient array redistribution" (arxiv 2112.01075) and GC3
(arxiv 2201.11840) get their safety from statically-checkable collective
schedules; this module gives the Program IR the same guarantee:

- extract the ordered collective schedule of a program (ring ids, dtypes
  and payload shapes from ops/collective_ops.py's op set);
- compare schedules across subprograms (e.g. per-stage pipeline
  programs, or per-rank transpiled programs) and diagnose order (PTA201),
  ring (PTA202), payload (PTA203) and count (PTA204) divergence;
- flag collectives nested in control-flow sub-blocks (PTA205): a
  rank-dependent branch around a collective is the canonical deadlock.

Everything here is order-based, mirroring how XLA/NCCL match
collectives: by issue order on the ring, not by name.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

from ..core.dtype import dtype_name
from ..core.program import Program
from .dataflow import _sub_block_idxs
from .diagnostics import Diagnostic

# communicating ops from ops/collective_ops.py. Excluded because they
# move no data on the wire and cannot deadlock: identity/bootstrap ops
# (c_identity, c_sync_*, c_comm_init*, *gen_nccl_id) AND c_split, whose
# kernel is a purely rank-local slice (jnp.split + axis_index).
COLLECTIVE_OPS = frozenset({
    "c_allreduce_sum", "c_allreduce_max", "c_allreduce_min",
    "c_allreduce_prod", "c_reduce_sum", "c_reduce_max", "c_reduce_min",
    "c_reduce_prod", "mp_allreduce_sum", "c_broadcast", "c_allgather",
    "c_reducescatter", "c_scatter", "c_concat", "alltoall",
    "barrier",
})


@dataclass(frozen=True)
class CollectiveEvent:
    """One issued collective: position in the schedule + identity."""

    op_type: str
    ring_id: int
    block_idx: int
    op_idx: int
    dtype: Optional[str] = None
    shape: Optional[Tuple] = None
    in_control_flow: bool = False

    def describe(self) -> str:
        payload = ""
        if self.dtype or self.shape is not None:
            payload = (f" of {self.dtype or '?'}"
                       + (f"{list(self.shape)}" if self.shape is not None
                          else ""))
        return (f"{self.op_type}(ring {self.ring_id}){payload} "
                f"at block {self.block_idx} op {self.op_idx}")


def extract_schedule(program: Program,
                     var_meta=None) -> List[CollectiveEvent]:
    """Ordered collective events, walking sub-blocks at their parent op's
    position (an event inside control flow is marked, since its issue
    count is data-dependent)."""
    events: List[CollectiveEvent] = []
    _walk(program, 0, events, in_cf=False, var_meta=var_meta or {},
          visited=set())
    return events


def _walk(program: Program, block_idx: int, events, in_cf: bool, var_meta,
          visited):
    if block_idx in visited:        # malformed sub-block cycle: stop
        return
    visited = visited | {block_idx}
    block = program.blocks[block_idx]
    for i, op in enumerate(block.ops):
        if op.type in COLLECTIVE_OPS:
            dtype = shape = None
            xs = op.inputs.get("X") or []
            if xs and xs[0]:
                meta = var_meta.get(xs[0])
                if meta is not None:
                    dtype = (dtype_name(meta.dtype)
                             if meta.dtype is not None else None)
                    shape = meta.shape
                else:
                    desc = block.find_var_recursive(xs[0])
                    if desc is not None:
                        dtype = (dtype_name(desc.dtype)
                                 if desc.dtype is not None else None)
                        shape = desc.shape
            events.append(CollectiveEvent(
                op.type, int(op.attrs.get("ring_id", 0)), block_idx, i,
                dtype, tuple(shape) if shape is not None else None, in_cf))
        for sub in _sub_block_idxs(op):
            if 0 <= sub < len(program.blocks) and sub not in visited:
                _walk(program, sub, events, in_cf=True, var_meta=var_meta,
                      visited=visited)


def check_control_flow_collectives(program: Program,
                                   label: str = "") -> List[Diagnostic]:
    """PTA205 for every collective issued from inside a sub-block."""
    diags = []
    for ev in extract_schedule(program):
        if ev.in_control_flow:
            diags.append(Diagnostic(
                "PTA205", f"{ev.op_type}(ring {ev.ring_id}) executes under "
                          f"a control-flow op; if the predicate diverges "
                          f"across ranks the ring deadlocks",
                program=label, block_idx=ev.block_idx, op_idx=ev.op_idx,
                op_type=ev.op_type))
    return diags


def check_collective_consistency(
        programs: Sequence[Tuple[str, Program]]) -> List[Diagnostic]:
    """Pairwise schedule comparison of ≥2 subprograms against the first
    (the reference rank). Any divergence is an error: on hardware these
    manifest as hangs, not messages."""
    if len(programs) < 2:
        return []
    return compare_schedules([(label, extract_schedule(prog))
                              for label, prog in programs])


def compare_schedules(
        schedules: Sequence[Tuple[str, Sequence[CollectiveEvent]]],
) -> List[Diagnostic]:
    """Pairwise comparison of ≥2 ordered collective schedules against
    the first. The schedules need not come from Program IR: this is the
    shared core between the STATIC cross-subprogram check above and
    ``tools/obs_report``'s cross-rank RUNTIME sequence alignment (the
    watchdog's begun-order event log per rank) — both report the same
    PTA201-204 codes."""
    if len(schedules) < 2:
        return []
    diags: List[Diagnostic] = []
    ref_label, ref = schedules[0]
    for label, sched in schedules[1:]:
        if len(sched) != len(ref):
            diags.append(Diagnostic(
                "PTA204", f"issues {len(sched)} collectives but "
                          f"{ref_label!r} issues {len(ref)}; the shorter "
                          f"rank leaves the others blocked",
                program=label))
        for pos, (a, b) in enumerate(zip(ref, sched)):
            if a.op_type != b.op_type:
                diags.append(Diagnostic(
                    "PTA201", f"schedule position {pos}: {b.describe()} "
                              f"vs {ref_label!r}'s {a.describe()} — "
                              f"mismatched collectives block forever "
                              f"waiting for each other",
                    program=label, block_idx=b.block_idx, op_idx=b.op_idx,
                    op_type=b.op_type))
                continue
            if a.ring_id != b.ring_id:
                diags.append(Diagnostic(
                    "PTA202", f"schedule position {pos}: {b.op_type} on "
                              f"ring {b.ring_id} vs {ref_label!r}'s ring "
                              f"{a.ring_id}",
                    program=label, block_idx=b.block_idx, op_idx=b.op_idx,
                    op_type=b.op_type))
            if (a.dtype is not None and b.dtype is not None
                    and a.dtype != b.dtype):
                diags.append(Diagnostic(
                    "PTA203", f"schedule position {pos}: {b.op_type} "
                              f"payload dtype {b.dtype} vs {ref_label!r}'s "
                              f"{a.dtype} — ranks would exchange "
                              f"differently-sized buffers",
                    program=label, block_idx=b.block_idx, op_idx=b.op_idx,
                    op_type=b.op_type))
            elif (a.shape is not None and b.shape is not None
                    and None not in a.shape and None not in b.shape
                    and -1 not in a.shape and -1 not in b.shape
                    and tuple(a.shape) != tuple(b.shape)
                    # every wire collective posts equal-shaped buffers
                    # per rank except the legitimately rank-asymmetric
                    # scatter/concat pair
                    and a.op_type not in ("c_scatter", "c_concat")):
                diags.append(Diagnostic(
                    "PTA203", f"schedule position {pos}: {b.op_type} "
                              f"payload shape {list(b.shape)} vs "
                              f"{ref_label!r}'s {list(a.shape)}",
                    program=label, block_idx=b.block_idx, op_idx=b.op_idx,
                    op_type=b.op_type))
    return diags
