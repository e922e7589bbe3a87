"""Observability: the metrics store, the tracer's spans, the flight
recorder's ring and the named-thread registry that the serving plane
reports through.

Port of the part of ``paddle_tpu/observability/`` that serving needs:
``metrics`` (counters, gauges, histograms, snapshot and reset),
``tracer`` (``span`` / ``maybe_span`` over
``torch.profiler.record_function``), ``flight_recorder`` (the ring and
``record``) and ``threads`` (copied). The rest (live telemetry, SLOs,
the watchdog, run logs, the perf ledger, the device-trace capture) is
ROADMAP Queue 1 item 11.
"""
from . import flight_recorder, metrics, threads, tracer  # noqa: F401
from .metrics import (Histogram, MetricRegistry, counter_add,  # noqa: F401
                      gauge_set, hist_observe, metric_get, snapshot)
from .metrics import reset as reset_metrics  # noqa: F401
