"""Flight recorder: a bounded ring of recent runtime events.

Port of the ring and ``record()`` of
``paddle_tpu/observability/flight_recorder.py``: while enabled, each
event (and each finished tracer span) lands in a ring of
``FLAGS_flight_recorder_capacity`` entries that keeps the most recent
ones. The JSON dump and the crash and signal handlers that write it are
ROADMAP Queue 1 item 11.
"""
from __future__ import annotations

import time
from collections import deque
from typing import List, Optional

from ..core.flags import get_flag
from .. import concurrency as _concurrency

_lock = _concurrency.make_lock("_lock")
_enabled = False
_events: deque = deque(maxlen=4096)
_recorded = 0                     # total seen (dropped = seen - kept)


def is_enabled() -> bool:
    return _enabled


def enable(capacity: Optional[int] = None):
    """Turn event recording on (idempotent). ``capacity`` overrides
    ``FLAGS_flight_recorder_capacity``; resizing keeps the most recent
    events."""
    global _enabled, _events
    if capacity is None:
        capacity = int(get_flag("flight_recorder_capacity"))
    capacity = max(int(capacity), 1)
    with _lock:
        if _events.maxlen != capacity:
            _events = deque(_events, maxlen=capacity)
    _enabled = True
    from . import tracer as _tracer
    _tracer.set_flight_hook(_span_hook)


def disable():
    global _enabled
    _enabled = False
    from . import tracer as _tracer
    _tracer.set_flight_hook(None)


def reset():
    """Clear the ring (tests)."""
    global _recorded
    with _lock:
        _events.clear()
        _recorded = 0


def record(kind: str, **fields):
    """Append one event to the ring: ``{"t": <unix>, "kind": kind,
    **fields}``. A single bool check when disabled."""
    if not _enabled:
        return
    _append(kind, fields)


def _append(kind: str, fields: dict):
    global _recorded
    ev = {"t": time.time(), "kind": kind}
    ev.update(fields)
    with _lock:
        _events.append(ev)
        _recorded += 1


def _span_hook(span):
    _append("span", {"name": span.name,
                     "dur_ms": round(span.dur_us / 1e3, 3),
                     "depth": span.depth})


def events() -> List[dict]:
    with _lock:
        return list(_events)


def events_seen() -> int:
    with _lock:
        return _recorded
