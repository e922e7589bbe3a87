"""StepTimer: per-step latency + steps/sec accounting for train loops.

The per-step report half of the observability subsystem: hapi.Model.fit
feeds one of these; ``summary()`` prints next to throughput numbers so a
regression shows WHERE the time went (first step vs steady step).

A copy of ``paddle_tpu/observability/step_timer.py``. A step's wall time
ends where the host waits for the device (``Model.train_batch`` reads its
loss), so it is the step's time on the card; the first step carries the
kernels' build and cuDNN's and the allocator's first calls, where the
reference's carries trace and compile.
"""
from __future__ import annotations

import time
from typing import Dict, Optional

from . import metrics as _metrics
from . import tracer as _tracer


class StepTimer:
    """Records step wall-times under ``<name>/step_ms`` and keeps
    first-step (compile) time separate from steady-state steps.

        timer = StepTimer("trainstep")
        with timer.step():
            train_step(...)
        timer.steps_per_sec()
    """

    def __init__(self, name: str = "step", warmup: int = 1):
        self.name = name
        self.warmup = max(int(warmup), 0)
        self.count = 0
        self.first_ms: Optional[float] = None
        self._steady_total_ms = 0.0
        self._steady_count = 0
        self._last_ms = 0.0

    class _Ctx:
        __slots__ = ("timer", "_t0")

        def __init__(self, timer):
            self.timer = timer

        def __enter__(self):
            self._t0 = time.perf_counter()
            return self

        def __exit__(self, *exc):
            self.timer.record((time.perf_counter() - self._t0) * 1e3)
            return False

    def step(self) -> "_Ctx":
        return StepTimer._Ctx(self)

    def record(self, dur_ms: float):
        self.count += 1
        self._last_ms = dur_ms
        if self.first_ms is None:
            self.first_ms = dur_ms
        if self.count > self.warmup:
            self._steady_total_ms += dur_ms
            self._steady_count += 1
            # only steady steps feed the histogram: warmup steps carry
            # trace+compile (seconds vs ms), and a short run's p95/max
            # would otherwise report compile time as step latency
            _metrics.hist_observe(f"{self.name}/step_ms", dur_ms)
            # per-step latency as a chrome counter track while tracing
            _tracer.sample_counter(f"{self.name}/step_ms", dur_ms)
        elif self.count == 1:
            # only the FIRST step (trace+compile) — later warmup steps
            # must not overwrite the compile-cost gauge
            _metrics.gauge_set(f"{self.name}/first_step_ms",
                               round(dur_ms, 3))
        sps = self.steps_per_sec()
        if sps:
            _metrics.gauge_set(f"{self.name}/steps_per_s", round(sps, 3))

    def last_ms(self) -> float:
        return self._last_ms

    def steady_step_ms(self) -> float:
        """Mean post-warmup step latency (the steady-state number; the
        first step carries trace+compile and is reported separately)."""
        if not self._steady_count:
            return 0.0
        return self._steady_total_ms / self._steady_count

    def steps_per_sec(self) -> float:
        ms = self.steady_step_ms()
        return 1e3 / ms if ms > 0 else 0.0

    def report(self) -> Dict[str, float]:
        return {
            "steps": self.count,
            "first_step_ms": round(self.first_ms or 0.0, 3),
            "steady_step_ms": round(self.steady_step_ms(), 3),
            "steps_per_s": round(self.steps_per_sec(), 3),
        }

    def summary(self) -> str:
        r = self.report()
        return (f"{self.name}: {r['steps']} steps, first "
                f"{r['first_step_ms']:.1f} ms (first calls), steady "
                f"{r['steady_step_ms']:.3f} ms/step "
                f"({r['steps_per_s']:.1f} steps/s)")
