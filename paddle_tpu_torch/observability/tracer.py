"""Scoped tracer spans, forwarded to ``torch.profiler``.

Port of ``span`` and ``maybe_span`` from
``paddle_tpu/observability/tracer.py``. A span is a nestable scope
recorded on a thread-local stack while tracing is on; each finished
span lands in a bounded process buffer and, while it is open, sits in a
``torch.profiler.record_function`` range, so an active profiler trace
shows it around the kernels it launched (where the reference forwards
to ``jax.profiler.TraceAnnotation``). With tracing off, a span costs
one module-global bool check. Counter samples (``sample_counter``,
which ``step_timer`` feeds) are kept the same way. The chrome-trace
export and cross-thread stacks are ROADMAP Queue 1 item 11.
"""
from __future__ import annotations

import contextlib
import threading
import time
from collections import namedtuple
from typing import List

import torch

from .. import concurrency as _concurrency

Span = namedtuple("Span", "name ts_us dur_us tid depth args")

MAX_SPANS = 1 << 20             # the trace head is kept; overflow counted
MAX_COUNTER_SAMPLES = 1 << 16

_lock = _concurrency.make_lock("_lock")
_enabled = False
_spans: List[Span] = []
_dropped = 0
_counters: List[tuple] = []     # (name, ts_us, value) counter samples
_counters_dropped = 0
_t_origin = time.perf_counter()
_flight_hook = None             # flight_recorder's span tap (or None)

NULL_CTX = contextlib.nullcontext()


class _Tls(threading.local):
    def __init__(self):
        self.stack: List[str] = []


_tls = _Tls()


def enabled() -> bool:
    return _enabled


def enable():
    global _enabled
    _enabled = True


def disable():
    global _enabled
    _enabled = False


def maybe_span(name: str, **args):
    """``span(name)`` when tracing is on, else the shared no-op context."""
    return span(name, **args) if _enabled else NULL_CTX


def reset():
    """Drop every recorded span and counter sample."""
    global _t_origin, _dropped, _counters_dropped
    with _lock:
        _spans.clear()
        _dropped = 0
        _counters.clear()
        _counters_dropped = 0
        _t_origin = time.perf_counter()


def set_flight_hook(fn):
    global _flight_hook
    _flight_hook = fn


def sample_counter(name: str, value):
    """Record a timestamped counter sample (a counter track in a chrome
    trace, e.g. ``hapi/step_ms`` over time). One bool check when tracing
    is off; past MAX_COUNTER_SAMPLES samples are counted, not kept."""
    global _counters_dropped
    if not _enabled:
        return
    ts_us = (time.perf_counter() - _t_origin) * 1e6
    with _lock:
        if len(_counters) < MAX_COUNTER_SAMPLES:
            _counters.append((name, ts_us, float(value)))
        else:
            _counters_dropped += 1


def counter_samples() -> List[tuple]:
    """Recorded (name, ts_us, value) counter samples, oldest first."""
    with _lock:
        return list(_counters)


def dropped_spans() -> int:
    with _lock:
        return _dropped


class span:
    """Nestable trace scope, context manager and decorator::

        with span("serving/batch", rows=8):
            ...

    ``args`` are kept with the finished span."""

    __slots__ = ("name", "args", "_t0", "_ts_us", "_rf", "_depth",
                 "_live")

    def __init__(self, name: str, **args):
        self.name = name
        self.args = args or None
        self._rf = None
        self._live = False

    def __enter__(self):
        if not _enabled:
            return self
        # entered before any tracer state changes: if it raises,
        # __exit__ never runs and no stack entry leaks
        rf = torch.profiler.record_function(self.name)
        rf.__enter__()
        self._rf = rf
        self._live = True
        stack = _tls.stack
        self._depth = len(stack)
        stack.append(self.name)
        self._t0 = time.perf_counter()
        self._ts_us = (self._t0 - _t_origin) * 1e6
        return self

    def __exit__(self, *exc):
        if not self._live:
            return False
        t1 = time.perf_counter()
        self._live = False
        stack = _tls.stack
        if stack and stack[-1] == self.name:
            stack.pop()
        rec = Span(self.name, self._ts_us, (t1 - self._t0) * 1e6,
                   threading.get_ident(), self._depth, self.args)
        global _dropped
        with _lock:
            if len(_spans) < MAX_SPANS:
                _spans.append(rec)
            else:
                _dropped += 1
        if _flight_hook is not None:
            _flight_hook(rec)
        rf, self._rf = self._rf, None
        rf.__exit__(*exc)
        return False

    def __call__(self, fn):
        def wrapped(*a, **kw):
            with span(self.name, **(self.args or {})):
                return fn(*a, **kw)
        wrapped.__name__ = getattr(fn, "__name__", "wrapped")
        return wrapped


def current_stack() -> List[str]:
    """The calling thread's open-span names, outermost first."""
    return list(_tls.stack)


def get_spans() -> List[Span]:
    with _lock:
        return list(_spans)
