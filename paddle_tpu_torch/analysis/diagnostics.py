"""Diagnostic taxonomy for the Program IR static analyzer.

A copy of ``paddle_tpu/analysis/diagnostics.py`` (pure Python).

Every check in ``paddle_tpu.analysis`` reports through one currency: a
:class:`Diagnostic` carrying a STABLE ``PTAxxx`` code (the analyzer's
analogue of the reference's typed ``platform::errors::*`` taxonomy —
see core/enforce.py — but for *static* program defects, found before
any kernel runs). Codes are grouped by family:

- ``PTA0xx`` dataflow (use-before-def, dangling inputs, dead code)
- ``PTA1xx`` shape/dtype verification
- ``PTA2xx`` collective consistency (the static deadlock class)
- ``PTA3xx`` recompile hazards (jit cache-churn lint)
- ``PTA4xx`` sharding/memory feasibility (SPMD spec validity, shard
  ownership, reshard compatibility, per-device HBM byte plans)
- ``PTA5xx`` host-concurrency discipline (lock ordering, guarded
  fields, blocking under locks, thread lifecycle, condition-variable
  misuse — the analyzer runs over ``paddle_tpu/`` source itself)

The registry below is the single source of truth for code → meaning;
docs/static_analysis.md renders it for humans and
``check_program --list-codes`` for the CLI. Codes are append-only:
never renumber or reuse a retired code — CI greps and user tooling key
on them.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..core.enforce import EnforceNotMet

ERROR = "error"
WARNING = "warning"
INFO = "info"

_SEV_RANK = {INFO: 0, WARNING: 1, ERROR: 2}

# code -> (default severity, one-line meaning)
CODES: Dict[str, tuple] = {
    # -- dataflow --
    "PTA001": (ERROR, "use-before-def: var is read before any op produces it"),
    "PTA002": (ERROR, "dangling input: var has no VarDesc and no producer "
                      "anywhere in the program"),
    "PTA003": (WARNING, "dead op: no path from its outputs to any target, "
                        "persistable write, or side effect"),
    "PTA004": (WARNING, "unused output: a non-intermediate op output is "
                        "never read and is not a target"),
    # -- shape/dtype --
    "PTA101": (ERROR, "dtype mismatch between op operands (or an operand "
                      "with a disallowed dtype)"),
    "PTA102": (ERROR, "shape/rank error: operands cannot compose under the "
                      "op's contract"),
    "PTA103": (WARNING, "unknown op: no TPU kernel registered and not a "
                        "generic *_grad op"),
    "PTA104": (WARNING, "declared VarDesc metadata disagrees with the "
                        "inferred shape/dtype"),
    # -- collective consistency --
    "PTA201": (ERROR, "collective order mismatch across subprograms"),
    "PTA202": (ERROR, "collective ring/axis mismatch at the same schedule "
                      "position"),
    "PTA203": (ERROR, "collective payload (dtype/shape) mismatch at the "
                      "same schedule position"),
    "PTA204": (ERROR, "collective count mismatch: subprograms issue "
                      "different numbers of collectives"),
    "PTA205": (WARNING, "collective inside a control-flow sub-block: "
                        "rank-divergent execution can deadlock"),
    # -- recompile hazards --
    "PTA301": (INFO, "dynamic feed shape: every distinct runtime shape "
                     "re-specializes the jitted program (warning when a "
                     "metrics snapshot shows a miss storm)"),
    "PTA302": (WARNING, "python-scalar attr on a churn-prone op: per-step "
                        "attr updates re-fingerprint the program"),
    "PTA303": (INFO, "observed compile-cache miss storm in the attached "
                     "metrics snapshot"),
    # -- sharding / memory feasibility --
    "PTA401": (ERROR, "infeasible PartitionSpec: a sharded dim does not "
                      "divide over its mesh axis (or the spec exceeds "
                      "the tensor rank)"),
    "PTA402": (ERROR, "unknown or overbooked mesh axis: the spec names "
                      "an axis the mesh does not have, or binds one "
                      "axis to two dims of the same tensor"),
    "PTA403": (ERROR, "sharding binding inconsistency: a spec bound to "
                      "no declared buffer, a donated buffer that is not "
                      "a feed, or a malformed spec entry"),
    "PTA404": (ERROR, "shard-ownership violation: a flat layout whose "
                      "bytes are not owned exactly once (overlapping "
                      "members, uneven shard split, out-of-bounds "
                      "offsets, double-bucketed params)"),
    "PTA405": (ERROR, "incompatible reshard layouts: src and dst do not "
                      "describe the same state (disjoint params, "
                      "element-count drift; warning: quantized residual "
                      "geometry that cannot re-home)"),
    "PTA406": (ERROR, "per-device byte plan exceeds the chip's HBM "
                      "capacity (payload carries the per-device "
                      "ranking)"),
    # -- host-concurrency discipline --
    "PTA500": (ERROR, "malformed pta5xx annotation: bad waiver grammar, "
                      "unknown code, missing justification, or an "
                      "unresolvable guarded_by/holds/edge target"),
    "PTA501": (ERROR, "lock-order inversion: the static lock-acquisition "
                      "graph (with-nesting plus call edges) contains a "
                      "cycle — a potential deadlock"),
    "PTA502": (ERROR, "guarded-field violation: a field declared "
                      "guarded_by a lock is read or written without "
                      "that lock held"),
    "PTA503": (WARNING, "blocking call under a lock: socket/file I/O, "
                        "join, sleep, device readback or a blocking "
                        "wait while holding a lock"),
    "PTA504": (ERROR, "thread-lifecycle violation: a thread spawned "
                      "outside the observability.threads named-thread "
                      "registry"),
    "PTA505": (ERROR, "condition-variable misuse: wait() outside a "
                      "predicate loop or outside its lock, or notify "
                      "without the lock held"),
    "PTA506": (ERROR, "unmodeled witnessed lock-order edge: a runtime "
                      "lock-witness acquisition is not a subgraph of "
                      "the static lock graph"),
}


@dataclass
class Diagnostic:
    """One finding. ``loc()`` renders a stable, greppable location."""

    code: str
    message: str
    severity: str = ""           # defaulted from CODES in __post_init__
    program: str = ""            # label, e.g. a CLI file path
    block_idx: Optional[int] = None
    op_idx: Optional[int] = None
    op_type: Optional[str] = None
    var: Optional[str] = None
    extra: dict = field(default_factory=dict)

    def __post_init__(self):
        if self.code not in CODES:
            raise KeyError(f"unregistered diagnostic code {self.code!r}")
        if not self.severity:
            self.severity = CODES[self.code][0]

    def loc(self) -> str:
        parts = []
        if self.program:
            parts.append(self.program)
        if self.block_idx is not None:
            parts.append(f"block {self.block_idx}")
        if self.op_idx is not None:
            op = f"op {self.op_idx}"
            if self.op_type:
                op += f" ({self.op_type})"
            parts.append(op)
        elif self.op_type:
            parts.append(f"({self.op_type})")
        return ": ".join(parts) if parts else "<program>"

    def format(self) -> str:
        var = f" var {self.var!r}:" if self.var else ""
        return (f"{self.loc()}: {self.code} [{self.severity}]{var} "
                f"{self.message}")

    def to_dict(self) -> dict:
        d = {"code": self.code, "severity": self.severity,
             "message": self.message}
        for k in ("program", "block_idx", "op_idx", "op_type", "var"):
            v = getattr(self, k)
            if v not in (None, ""):
                d[k] = v
        if self.extra:
            d["extra"] = dict(self.extra)
        return d


def errors(diags: List[Diagnostic]) -> List[Diagnostic]:
    return [d for d in diags if d.severity == ERROR]


def warnings_(diags: List[Diagnostic]) -> List[Diagnostic]:
    return [d for d in diags if d.severity == WARNING]


def max_severity(diags: List[Diagnostic]) -> Optional[str]:
    if not diags:
        return None
    return max(diags, key=lambda d: _SEV_RANK[d.severity]).severity


def record(diags: List[Diagnostic]):
    """Funnel diagnostic counts into the observability store
    (``analysis/*`` namespace, docs/observability.md) so CI and bench
    runs can track them without parsing analyzer output."""
    from ..observability import metrics as _metrics
    _metrics.counter_add("analysis/run")
    if not diags:
        return
    _metrics.counter_add("analysis/diagnostics", len(diags))
    for d in diags:
        _metrics.counter_add(f"analysis/code/{d.code}")
        _metrics.counter_add(f"analysis/{d.severity}s")


class StaticAnalysisError(EnforceNotMet):
    """Raised by the executor pre-flight when the analyzer finds
    error-severity diagnostics (ref: the reference's InferShape errors
    aborting program build — here the whole-program pass aborts before
    jit tracing)."""

    code = "StaticAnalysis"

    def __init__(self, diags: List[Diagnostic]):
        self.diagnostics = list(diags)
        lines = "\n  ".join(d.format() for d in diags)
        super().__init__(
            f"static pre-flight found {len(diags)} error(s):\n  {lines}\n"
            f"(disable with FLAGS_static_analysis_preflight=0 or "
            f"Executor(preflight=False))")
