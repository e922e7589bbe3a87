"""Host-concurrency primitives: named locks, guarded fields, and the
runtime lock-witness.

A copy of ``paddle_tpu/concurrency.py`` (pure Python); canonical lock
names are relative to ``paddle_tpu_torch`` here.

The static analyzer (:mod:`paddle_tpu.analysis.concurrency_check`,
PTA5xx — docs/static_analysis.md "Concurrency discipline") proves
lock-order and guarded-field properties over the SOURCE; this module is
the runtime side of the same contract:

- :func:`make_lock` / :func:`make_condition` create ordinary
  ``threading`` primitives carrying a CANONICAL name — the dotted
  module path under ``paddle_tpu`` plus the attribute, e.g.
  ``observability.live.TelemetryPublisher._pub_lock``. Names are what
  join the runtime witness to the static graph, so the analyzer checks
  the literal passed here against the declaration site and flags drift
  (PTA500). With the witness disarmed (the default) these return plain
  ``threading.Lock``/``Condition`` objects — zero overhead.

- With ``PADDLE_LOCK_WITNESS=1`` in the environment, every named lock
  is wrapped: each acquisition records the ordered pairs
  ``(held, acquiring)`` against a per-thread held stack into ONE
  process-wide witness graph. :func:`save_witness` (or
  ``PADDLE_LOCK_WITNESS_DIR``, written at interpreter exit) persists
  it; ``check_concurrency --witness`` then verifies the witnessed
  graph is a SUBGRAPH of the static one — an acquisition order the
  analyzer never modeled fails the gate (PTA506) instead of hiding
  until it deadlocks on a pod.

- :func:`guarded_by` declares a field's guarding lock as a descriptor
  the analyzer reads statically; under the witness it ALSO asserts at
  runtime that the named lock is held on every access.

Comment annotations (``# guarded_by: <lock>``, ``# pta5xx:
waive(<code>) <why>``, ``# pta5xx: holds(<lock>)``, ``# pta5xx:
edge(<a> -> <b>) <why>``) are parsed by the analyzer, not here — see
docs/static_analysis.md for the grammar.
"""
from __future__ import annotations

import atexit
import json
import os
import sys
import threading
from typing import Dict, List, Optional, Tuple

__all__ = ["make_lock", "make_condition", "guarded_by",
           "witness_enabled", "witness_edges", "witness_nodes",
           "save_witness", "load_witness", "reset_witness",
           "held_locks"]

_PKG_PREFIX = "paddle_tpu_torch."


def _caller_module(depth: int = 2) -> str:
    """Dotted module path of the caller, relative to ``paddle_tpu_torch``
    (the analyzer's canonical vocabulary)."""
    try:
        mod = sys._getframe(depth).f_globals.get("__name__", "")
    except ValueError:          # pragma: no cover - shallow stack
        mod = ""
    if mod.startswith(_PKG_PREFIX):
        mod = mod[len(_PKG_PREFIX):]
    return mod


def witness_enabled() -> bool:
    return os.environ.get("PADDLE_LOCK_WITNESS", "") not in ("", "0")


# ------------------------------------------------------------- witness
_state_lock = threading.Lock()
_edges: Dict[Tuple[str, str], int] = {}   # (held, acquired) -> count
_nodes: Dict[str, int] = {}               # name -> acquisition count
_tls = threading.local()                  # .held: per-thread name stack
_atexit_armed = False


def _held_stack() -> List[str]:
    stack = getattr(_tls, "held", None)
    if stack is None:
        stack = _tls.held = []
    return stack


def held_locks() -> Tuple[str, ...]:
    """The current thread's witnessed held-lock names, outermost
    first (empty when the witness is off)."""
    return tuple(_held_stack())


def _note_acquired(name: str):
    stack = _held_stack()
    with _state_lock:
        _nodes[name] = _nodes.get(name, 0) + 1
        for held in stack:
            if held != name:    # re-entrant RLock self-nesting
                key = (held, name)
                _edges[key] = _edges.get(key, 0) + 1
    stack.append(name)


def _note_released(name: str):
    stack = _held_stack()
    # release order may not be LIFO (rare but legal): drop the
    # innermost matching entry
    for i in range(len(stack) - 1, -1, -1):
        if stack[i] == name:
            del stack[i]
            break


class _WitnessLock:
    """A named wrapper over a ``threading`` lock recording acquisition
    order into the process-wide witness graph. Context-manager and
    acquire/release compatible; conditions wrap their wait so the
    held stack reflects the release-inside-wait semantics."""

    __slots__ = ("name", "_inner")

    def __init__(self, name: str, inner):
        self.name = name
        self._inner = inner

    def acquire(self, *a, **kw):
        got = self._inner.acquire(*a, **kw)
        if got:
            _note_acquired(self.name)
        return got

    def release(self):
        self._inner.release()
        _note_released(self.name)

    def locked(self):
        return self._inner.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def __repr__(self):
        return f"<witness {self.name} over {self._inner!r}>"


class _WitnessCondition(_WitnessLock):
    """Witnessed ``threading.Condition``: ``wait``/``wait_for`` release
    the lock, so the held stack pops around the inner wait and
    re-pushes on wake (the re-acquire is NOT a new ordering edge — the
    thread held the lock when it called wait)."""

    def _paused(self):
        class _P:
            def __enter__(_s):
                _note_released(self.name)
                return _s

            def __exit__(_s, *exc):
                _held_stack().append(self.name)
                return False
        return _P()

    def wait(self, timeout=None):
        with self._paused():
            return self._inner.wait(timeout)

    def wait_for(self, predicate, timeout=None):
        with self._paused():
            return self._inner.wait_for(predicate, timeout)

    def notify(self, n: int = 1):
        self._inner.notify(n)

    def notify_all(self):
        self._inner.notify_all()


def make_lock(name: str, *, reentrant: bool = False):
    """A named ``threading.Lock`` (or ``RLock``). ``name`` is the
    lock's path RELATIVE to the defining module — ``"_lock"`` for a
    module global, ``"Class._attr"`` for an instance attribute — and
    is prefixed with the caller's dotted module path to form the
    canonical id the static analyzer derives structurally. Witness
    off: returns the plain primitive, zero overhead."""
    inner = threading.RLock() if reentrant else threading.Lock()
    if not witness_enabled():
        return inner
    _arm_atexit()
    return _WitnessLock(f"{_caller_module()}.{name}", inner)


def make_condition(name: str, lock=None):
    """A named ``threading.Condition`` (see :func:`make_lock` for the
    naming rule). ``lock`` may be a :func:`make_lock` result — the
    condition then shares that lock's witness identity, matching the
    static analyzer's aliasing of ``Condition(existing_lock)``."""
    if not witness_enabled():
        return threading.Condition(lock)
    _arm_atexit()
    if isinstance(lock, _WitnessLock):
        # share the inner primitive AND the existing name: holding
        # either handle is holding one lock
        return _WitnessCondition(lock.name,
                                 threading.Condition(lock._inner))
    return _WitnessCondition(f"{_caller_module()}.{name}",
                             threading.Condition(lock))


# ------------------------------------------------------ guarded fields
class guarded_by:
    """Class-level declaration that a field must only be accessed with
    a named lock held::

        class Publisher:
            _seq = guarded_by("_pub_lock")

    The static analyzer (PTA502) reads the declaration from source;
    with the witness armed every runtime access additionally asserts
    the named lock appears in the current thread's held stack. The
    lock token is the attribute name of a sibling lock on the same
    class (or a module-global lock name)."""

    __slots__ = ("lock_attr", "default", "_name")

    def __init__(self, lock_attr: str, default=None):
        self.lock_attr = str(lock_attr)
        self.default = default
        self._name = None

    def __set_name__(self, owner, name):
        self._name = f"__guarded_{name}"

    def _check(self, obj):
        if not witness_enabled():
            return
        lock = getattr(obj, self.lock_attr, None)
        name = getattr(lock, "name", None)
        if name is not None and name not in _held_stack():
            raise RuntimeError(
                f"guarded field access without {name} held "
                f"(thread {threading.current_thread().name!r})")

    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        self._check(obj)
        return getattr(obj, self._name, self.default)

    def __set__(self, obj, value):
        self._check(obj)
        setattr(obj, self._name, value)


# -------------------------------------------------------- persistence
def witness_edges() -> List[Tuple[str, str, int]]:
    with _state_lock:
        return sorted((a, b, n) for (a, b), n in _edges.items())


def witness_nodes() -> Dict[str, int]:
    with _state_lock:
        return dict(_nodes)


def reset_witness():
    """Tests: clear the witness graph (held stacks are per-thread and
    self-correcting)."""
    with _state_lock:
        _edges.clear()
        _nodes.clear()


def save_witness(path: Optional[str] = None) -> Optional[str]:
    """Persist the witness graph as JSON. With ``path=None`` the
    ``PADDLE_LOCK_WITNESS_DIR`` directory is used (file named
    ``witness_<rank>_<pid>.json``); returns the path written, or None
    when there is nowhere to write."""
    if path is None:
        base = os.environ.get("PADDLE_LOCK_WITNESS_DIR", "")
        if not base:
            return None
        os.makedirs(base, exist_ok=True)
        rank = os.environ.get("PADDLE_TRAINER_ID", "0") or "0"
        path = os.path.join(base, f"witness_{rank}_{os.getpid()}.json")
    doc = {
        "version": 1,
        "pid": os.getpid(),
        "rank": int(os.environ.get("PADDLE_TRAINER_ID", "0") or 0),
        "nodes": witness_nodes(),
        "edges": [[a, b, n] for a, b, n in witness_edges()],
    }
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(doc, f, indent=2, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)
    return path


def load_witness(path: str) -> dict:
    with open(path, "r", encoding="utf-8") as f:
        doc = json.load(f)
    if not isinstance(doc.get("edges"), list):
        raise ValueError(f"{path}: not a witness file (no edges list)")
    return doc


def _arm_atexit():
    global _atexit_armed
    if _atexit_armed or not os.environ.get("PADDLE_LOCK_WITNESS_DIR"):
        return
    _atexit_armed = True
    atexit.register(save_witness)
