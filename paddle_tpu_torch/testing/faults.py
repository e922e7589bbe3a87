"""Deterministic fault injection at the serving plane's request site.

Port of the part of ``paddle_tpu/testing/faults.py`` that serving runs:
one kind, ``slow@ms=M,request=N[,times=T]``, fired by the one hook the
port calls, :func:`on_request`, which sleeps M ms when the scheduler is
about to execute the batch that holds the Nth admitted request (the
straggler-under-load trigger of the deadline tests). A spec is armed
explicitly with :func:`arm`; a malformed one, or one of the reference's
other kinds (crash, sigterm, hang, rpc, ...), raises
:class:`FaultSpecError` there, because the port has no site that fires
them yet (ROADMAP Queue 1 item 9). Every fired injection is counted
(``faults/fired/<kind>``) and recorded in the flight recorder's ring.
"""
from __future__ import annotations

import sys
import threading
import time
from typing import Dict, List, Optional

from ..observability import flight_recorder as _flight
from ..observability import metrics as _metrics

_KEYS = {"ms": float, "request": int, "times": int}

_lock = threading.Lock()
_spec: Optional["FaultSpec"] = None


class FaultSpecError(ValueError):
    """Malformed or unported fault spec, raised at arm time with the
    offending fragment named."""


class Injection:
    """One parsed ``slow`` injection and its remaining fire budget."""

    def __init__(self, params: Dict[str, float], text: str):
        self.kind = "slow"
        self.params = params
        self.text = text
        self.times = int(params.get("times", 1))      # 0 = unlimited
        self.fired = 0

    def exhausted(self) -> bool:
        return self.times > 0 and self.fired >= self.times

    def to_dict(self) -> dict:
        return {"kind": self.kind, "spec": self.text,
                "fired": self.fired, "times": self.times}

    def __repr__(self):
        return f"Injection({self.text!r}, fired={self.fired})"


def _parse_one(frag: str) -> Injection:
    frag = frag.strip()
    kind, at, body = frag.partition("@")
    if not at:
        raise FaultSpecError(
            f"fault spec {frag!r}: expected 'slow@ms=M,request=N'")
    if kind.strip() != "slow":
        raise FaultSpecError(
            f"fault spec {frag!r}: kind {kind.strip()!r} is not ported "
            f"(only 'slow' at the serving request site is; the rest "
            f"waits for ROADMAP Queue 1 item 9)")
    params: Dict[str, float] = {}
    for item in filter(None, (i.strip() for i in body.split(","))):
        key, eq, val = (s.strip() for s in item.partition("="))
        if not eq or key not in _KEYS:
            raise FaultSpecError(
                f"fault spec {frag!r}: {item!r} is not one of "
                f"{', '.join(k + '=' for k in _KEYS)}")
        if key in params:
            raise FaultSpecError(
                f"fault spec {frag!r}: duplicate key {key!r}")
        try:
            params[key] = _KEYS[key](val)
        except ValueError:
            raise FaultSpecError(
                f"fault spec {frag!r}: {key}={val!r} is not a number")
    if "ms" not in params or "request" not in params:
        raise FaultSpecError(
            f"fault spec {frag!r}: slow needs ms= and request=")
    return Injection(params, frag)


class FaultSpec:
    """A parsed fault spec; :meth:`parse` is the only constructor most
    callers need."""

    def __init__(self, injections: List[Injection], text: str):
        self.injections = injections
        self.text = text

    @classmethod
    def parse(cls, text: str) -> "FaultSpec":
        injections = [_parse_one(frag) for frag in text.split(";")
                      if frag.strip()]
        if not injections:
            raise FaultSpecError(f"fault spec {text!r} is empty")
        return cls(injections, text)

    def fire_request(self, request: int):
        # decide + count under the module lock, sleep outside it
        with _lock:
            hits = [inj for inj in self.injections if not inj.exhausted()
                    and int(inj.params["request"]) == request]
            for inj in hits:
                inj.fired += 1
        for inj in hits:
            _execute(inj, "request", {"request": request})


def _execute(inj: Injection, site: str, ctx: dict):
    """Record, then sleep."""
    _metrics.counter_add("faults/fired")
    _metrics.counter_add(f"faults/fired/{inj.kind}")
    _flight.record("fault", fault=inj.kind, site=site, spec=inj.text,
                   **ctx)
    sys.stderr.write(
        f"[paddle_tpu_torch.faults] injecting {inj.kind} at {site} {ctx} "
        f"(spec: {inj.text})\n")
    sys.stderr.flush()
    time.sleep(float(inj.params["ms"]) / 1e3)


def arm(spec) -> FaultSpec:
    """Install a fault spec (a :class:`FaultSpec` or its text form)."""
    global _spec
    if isinstance(spec, str):
        spec = FaultSpec.parse(spec)
    with _lock:
        _spec = spec
    return spec


def disarm():
    """Remove the active spec."""
    global _spec
    with _lock:
        _spec = None


reset = disarm          # the reference's name for back-to-pristine


def active() -> Optional[FaultSpec]:
    """The armed spec, or None."""
    return _spec


def fired() -> List[dict]:
    """Fire counts per injection of the active spec (empty when
    disarmed)."""
    s = _spec
    return [inj.to_dict() for inj in s.injections] if s else []


def on_request(n: int):
    """Serving-plane request about to execute (``serving.scheduler``),
    identified by its per-process admission ordinal: the
    ``slow@ms=M,request=N`` trigger. Disarmed, it costs one module
    global read."""
    s = _spec
    if s is not None:
        s.fire_request(int(n))
