"""Admission control: the static analyzer as the serving front door.

A copy of ``paddle_tpu/serving/admission.py`` (pure Python), less
``PlacementError`` / ``reject_placement`` (the PTA4xx placement pass is
not ported) and ``admit_opaque`` (load path B raises in the port).

The reference's AnalysisPredictor runs its IR pass pipeline at
``Init`` time — a model that cannot be optimized/validated never
serves. Our analogue is ``paddle_tpu.analysis`` run at model-LOAD time:
a program with error-severity PTAxxx diagnostics (use-before-def,
shape/dtype contract violations, collective misuse in an inference
graph) is **refused admission** before any traffic reaches it, and the
PTA3xx recompile-hazard lint is surfaced to the operator right where
the fix lives (declare buckets) instead of paging them at p99 time.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional

from ..analysis import analyze_program
from ..analysis.diagnostics import ERROR, Diagnostic
from ..core.program import Program
from ..observability import metrics as _metrics


class AdmissionError(RuntimeError):
    """Model refused at load: error-severity static diagnostics."""

    def __init__(self, label: str, diagnostics: List[Diagnostic]):
        self.label = label
        self.diagnostics = diagnostics
        lines = [f"model {label!r} refused admission "
                 f"({len(diagnostics)} error(s)):"]
        lines += ["  " + d.format() for d in diagnostics]
        super().__init__("\n".join(lines))


class AdmissionReport:
    """Outcome of one admission check: ``ok`` plus every diagnostic,
    with the recompile hazards (PTA3xx) split out for the server's
    bucket-advice log line."""

    def __init__(self, label: str, diagnostics: List[Diagnostic],
                 checked: bool = True):
        self.label = label
        self.checked = checked
        self.diagnostics = diagnostics
        self.errors = [d for d in diagnostics if d.severity == ERROR]
        self.recompile_hazards = [d for d in diagnostics
                                  if d.code.startswith("PTA3")]

    @property
    def ok(self) -> bool:
        return not self.errors

    def to_dict(self) -> dict:
        return {"label": self.label, "ok": self.ok,
                "checked": self.checked,
                "diagnostics": [d.to_dict() for d in self.diagnostics],
                "recompile_hazards": len(self.recompile_hazards)}


def admit_program(program: Program, feed_names: Iterable[str],
                  fetch_names: Iterable[str],
                  scope_names: Iterable[str] = (),
                  metrics_snapshot: Optional[Dict] = None,
                  label: str = "<model>",
                  observed_signatures=None) -> AdmissionReport:
    """Analyze a loaded inference program; raise :class:`AdmissionError`
    on error-severity findings, return the report otherwise.

    ``scope_names`` are the parameter vars materialized by
    ``load_inference_model`` — legitimate scope reads, not
    use-before-def. ``observed_signatures`` (feed signatures from the
    executable cache's provenance of a PRIOR boot) upgrade the PTA3xx
    recompile lint from warn-only to actionable: the diagnostic carries
    the concrete pow2-rounded ``buckets=[...]`` declaration."""
    diags = analyze_program(program, feed_names=list(feed_names),
                            fetch_names=list(fetch_names),
                            scope_names=list(scope_names),
                            metrics_snapshot=metrics_snapshot,
                            label=label,
                            observed_signatures=observed_signatures)
    report = AdmissionReport(label, diags)
    if not report.ok:
        _metrics.counter_add("serving/admission_rejected")
        raise AdmissionError(label, report.errors)
    _metrics.counter_add("serving/admission_ok")
    return report

