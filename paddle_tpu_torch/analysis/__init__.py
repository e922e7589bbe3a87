"""Static analysis over the Program IR: the checks serving admission runs.

Port of ``paddle_tpu/analysis/__init__.py`` (``analyze_program`` with
``DEFAULT_CHECKS``) and of the passes it runs:

- :mod:`.dataflow` (copied): use-before-def, dangling edges, dead code;
- :mod:`.shape_infer`: registry-driven shape & dtype propagation, on
  ``meta`` tensors where the reference runs ``jax.eval_shape``;
- :mod:`.collective_check` (copied): collectives in control flow;
- :mod:`.recompile_lint` (copied): feed shapes that re-specialize;
- :mod:`.diagnostics` (copied): the ``PTAxxx`` code registry.

``sharding_check``, ``memory_plan``, ``concurrency_check`` and the
executor pre-flight are ROADMAP Queue 1 item 11.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence

from ..core.program import Program
from .collective_check import (COLLECTIVE_OPS, CollectiveEvent,  # noqa: F401
                               check_collective_consistency,
                               check_control_flow_collectives,
                               extract_schedule)
from .dataflow import (check_dataflow, check_dead_code,  # noqa: F401
                       eliminate_dead_ops, live_op_mask)
from .diagnostics import (CODES, ERROR, INFO, WARNING,  # noqa: F401
                          Diagnostic, StaticAnalysisError, errors,
                          max_severity, record)
from .recompile_lint import lint_recompile_hazards  # noqa: F401
from .shape_infer import (VarMeta, propagate,  # noqa: F401
                          register_shape_check, registered_checks)

DEFAULT_CHECKS = ("dataflow", "shapes", "collectives", "recompile")


def analyze_program(program: Program, feed_names: Iterable[str] = (),
                    fetch_names: Optional[Iterable[str]] = None,
                    scope_names: Iterable[str] = (),
                    metrics_snapshot: Optional[Dict] = None,
                    label: str = "",
                    checks: Sequence[str] = DEFAULT_CHECKS,
                    observed_signatures=None
                    ) -> List[Diagnostic]:
    """Run the selected check families over one program.

    ``fetch_names=None`` disables dead-code analysis (any leaf var is a
    potential run-time fetch target); pass the actual fetch list to get
    PTA003/PTA004. ``scope_names`` are vars known live in the executor
    scope, so legitimate scope reads don't flag as use-before-def."""
    diags: List[Diagnostic] = []
    if "dataflow" in checks:
        diags.extend(check_dataflow(program, feed_names, scope_names,
                                    label=label))
        if fetch_names is not None:
            diags.extend(check_dead_code(program, fetch_names, label=label))
    if "shapes" in checks:
        # propagation seeds from VarDesc metadata alone: a bare feed
        # NAME carries no shape/dtype to seed
        sdiags, _env = propagate(program, label=label)
        diags.extend(sdiags)
    if "collectives" in checks:
        diags.extend(check_control_flow_collectives(program, label=label))
    if "recompile" in checks:
        diags.extend(lint_recompile_hazards(
            program, metrics_snapshot, label=label,
            observed_signatures=observed_signatures))
    return diags
