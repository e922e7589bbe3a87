"""Recompile-hazard linting: what will churn the executor's jit cache.

A copy of ``paddle_tpu/analysis/recompile_lint.py`` (pure Python).

The executor keys its jitted-program cache on
``(program.fingerprint(), feed shapes/dtypes, …)`` (core/executor.py)
and counts churn in the ``executor/compile_cache_miss`` /
``executor/compile_cache_hit`` observability counters. Two statically
visible sources make that key unstable:

- **dynamic feed shapes** (PTA301): a ``-1`` dim on an ``is_data`` var
  means every distinct runtime extent is a fresh trace + XLA compile.
  One or two specializations are normal (bucketed batch sizes); a
  ragged dimension fed raw is a compile storm.
- **python-scalar attrs on churn-prone ops** (PTA302): a float baked
  into ``fill_constant``/``scale``/``dropout``/``clip`` attrs
  re-fingerprints the whole program when user code rebuilds it per step
  (the classic "learning rate as attr instead of var" bug). Reported
  only when a metrics snapshot shows the cache actually missing — a
  constant attr in a program compiled once is fine, so without runtime
  evidence this stays silent.

``lint_recompile_hazards`` accepts the snapshot dict produced by
``observability.metrics.snapshot()`` (live, or loaded from the JSON a
bench run attached) and correlates: miss-heavy counters escalate the
static findings and add a program-level PTA303 note.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, List, Optional, Tuple

from ..core.program import Program
from .diagnostics import Diagnostic

# an observed feed signature: feed name -> (shape tuple, dtype str) —
# the serving plane's buckets.Signature shape, accepted here without
# importing the serving package (analysis sits below it)
Signature = Dict[str, Tuple[Tuple[int, ...], str]]

# op families whose scalar attrs user code plausibly updates per step
# (each rebuild re-fingerprints the program → full retrace + XLA compile)
CHURN_PRONE_ATTRS = {
    "fill_constant": ("value",),
    "scale": ("scale", "bias"),
    "dropout": ("dropout_prob",),
    "clip": ("min", "max"),
    "clip_by_norm": ("max_norm",),
    "pad": ("pad_value",),
}

# misses at-or-above this count (with more misses than hits) read as a
# storm rather than warm-up
MISS_STORM_THRESHOLD = 3


def pow2_up(d: int) -> int:
    """Round a dim up to the next power of two — THE rounding rule of
    the serving plane's learned buckets (``serving.buckets`` imports
    it from here), so the PTA301 suggestion below can never diverge
    from what the scheduler actually learns."""
    d = max(int(d), 1)
    p = 1
    while p < d:
        p <<= 1
    return p


_pow2_up = pow2_up      # internal alias


def suggest_buckets(signatures: Iterable[Signature]) -> List[dict]:
    """Observed feed signatures → the concrete bucket declaration that
    absorbs them: every dim pow2-rounded, duplicates collapsed, sorted
    by padded volume (the serving plane's smallest-fitting-first
    order). Each entry is ``{feed: (shape, dtype)}`` — exactly what
    ``PredictorServer.add_tenant(buckets=...)`` accepts."""
    seen = {}
    for sig in signatures:
        rounded = {n: (tuple(_pow2_up(d) for d in shape), str(dt))
                   for n, (shape, dt) in sorted(sig.items())}
        key = tuple(sorted((n, v) for n, v in rounded.items()))
        seen[key] = rounded
    def _volume(b):
        return sum(math.prod(shape or (1,)) for shape, _ in b.values())

    return sorted(seen.values(), key=lambda b: (_volume(b), repr(b)))


def format_bucket_suggestion(signatures: Iterable[Signature]) -> str:
    """The copy-pasteable ``buckets=[...]`` literal for the suggestion
    text (PTA301 diagnostics, ``serving.admission`` load-time
    surfacing)."""
    rows = []
    for b in suggest_buckets(signatures):
        inner = ", ".join(f"{n!r}: {tuple(shape)!r}"
                          if dt == "float32" else
                          f"{n!r}: ({tuple(shape)!r}, {dt!r})"
                          for n, (shape, dt) in b.items())
        rows.append("{" + inner + "}")
    return "buckets=[" + ", ".join(rows) + "]"


def _miss_storm(snapshot: Optional[Dict]) -> int:
    if not snapshot:
        return 0
    miss = int(snapshot.get("executor/compile_cache_miss", 0) or 0)
    hit = int(snapshot.get("executor/compile_cache_hit", 0) or 0)
    return miss if (miss >= MISS_STORM_THRESHOLD and miss > hit) else 0


def lint_recompile_hazards(program: Program,
                           metrics_snapshot: Optional[Dict] = None,
                           label: str = "",
                           observed_signatures: Optional[
                               List[Signature]] = None
                           ) -> List[Diagnostic]:
    """``observed_signatures`` — feed signatures actually seen by a
    runtime (the serving plane's executable-cache provenance, a bench
    run's traffic log): when given, the PTA301 finding stops being
    warn-only and carries the concrete ``buckets=[...]`` declaration
    (pow2-rounded from the observations) that fixes it."""
    diags: List[Diagnostic] = []
    misses = _miss_storm(metrics_snapshot)
    fix = (f"— declare {format_bucket_suggestion(observed_signatures)} "
           f"(pow2-rounded from {len(observed_signatures)} observed "
           f"signature(s))" if observed_signatures else
           "(pad/bucket feeds to a fixed set of shapes)")

    # -1 feed dims are the framework's standard dynamic-batch idiom, so
    # without runtime evidence this is informational only; an observed
    # miss storm escalates it to a warning (so --strict gates it)
    dyn_severity = "warning" if misses else "info"
    for blk in program.blocks:
        for name, desc in blk.vars.items():
            if not desc.is_data or desc.shape is None:
                continue
            dyn = [i for i, d in enumerate(desc.shape) if d in (-1, None)]
            if dyn:
                diags.append(Diagnostic(
                    "PTA301", f"feed var declares dynamic dim(s) "
                              f"{dyn} in shape "
                              f"{[-1 if d in (-1, None) else d for d in desc.shape]}; "
                              f"each distinct extent re-specializes the "
                              f"jitted program {fix}",
                    severity=dyn_severity,
                    program=label, block_idx=blk.idx, var=name))

    if misses:
        suspects = 0
        for blk in program.blocks:
            for i, op in enumerate(blk.ops):
                attr_names = CHURN_PRONE_ATTRS.get(op.type)
                if not attr_names:
                    continue
                scalars = [a for a in attr_names
                           if isinstance(op.attrs.get(a), (int, float))]
                if scalars:
                    suspects += 1
                    diags.append(Diagnostic(
                        "PTA302", f"python-scalar attr(s) "
                                  f"{sorted(scalars)} baked into the "
                                  f"program while the executor reports "
                                  f"{misses} compile-cache misses; if "
                                  f"these change per step, move them to "
                                  f"a fed/persistable var",
                        program=label, block_idx=blk.idx, op_idx=i,
                        op_type=op.type))
        diags.append(Diagnostic(
            "PTA303", f"metrics snapshot shows {misses} compile-cache "
                      f"misses vs "
                      f"{int(metrics_snapshot.get('executor/compile_cache_hit', 0) or 0)} "
                      f"hits ({suspects} churn-prone op(s) flagged above)",
            program=label))
    return diags
