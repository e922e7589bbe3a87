"""Named-thread registry: every runtime thread is spawned here.

A copy of ``paddle_tpu/observability/threads.py`` (pure Python).

The repo's threaded subsystems (scheduler workers, readback drainers,
the telemetry publisher, watchdog, gateway housekeeper, failure-plane
heartbeats, …) each used to call ``threading.Thread`` directly, which
left two recurring costs:

- flight dumps keyed stacks by ``"<tid>:<name>"`` with whatever ad-hoc
  name (or ``Thread-7``) the spawn site chose — postmortems had to map
  tids to subsystems by reading stack frames;
- the commit-exit-under-lock revive protocol (worker clears its own
  handle under the guarding lock; ``start()`` checks the handle and
  revives or spawns INSIDE the same lock — the scheduler's protocol) was
  hand-rolled at each site, and new sites kept re-introducing the
  spawn/exit race it exists to prevent.

:func:`spawn` is now the ONE way a runtime thread starts — the static
analyzer enforces it (PTA504, docs/static_analysis.md): a bare
``threading.Thread(...)`` anywhere else in ``paddle_tpu/`` is a
lifecycle violation. The registry records name/subsystem/ident for
every live spawned thread; :func:`registry_snapshot` flows into
``flight_recorder.dump()`` so a wedged rank's stacks carry subsystem
names, not tids. :class:`ThreadSlot` packages the revive protocol for
sites that want it ready-made.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Optional

__all__ = ["spawn", "registry_snapshot", "live_count", "spawned_total",
           "ThreadSlot"]

_lock = threading.Lock()
_live: Dict[int, dict] = {}       # ident -> {name, subsystem, ...}
_spawned = 0                      # total threads ever spawned here


def spawn(name: str, target: Callable, *, args: tuple = (),
          kwargs: Optional[dict] = None, daemon: bool = True,
          subsystem: Optional[str] = None,
          start: bool = True) -> threading.Thread:
    """Create (and by default start) a registered runtime thread.

    ``name`` becomes the ``Thread.name`` verbatim — flight-recorder
    stack keys are ``"<tid>:<name>"``, so keep the repo convention of
    ``pt-<subsystem>[-<instance>]``. ``subsystem`` defaults to the
    first dotted segment after the ``pt-`` prefix. The target is
    wrapped to register on entry and unregister on exit, so the
    registry only ever lists threads whose target is actually running.
    """
    global _spawned
    sub = subsystem or (name[3:] if name.startswith("pt-") else name)
    kw = dict(kwargs or {})

    def _run():
        ident = threading.get_ident()
        with _lock:
            _live[ident] = {"name": name, "subsystem": sub,
                            "ident": ident, "daemon": daemon,
                            "started": time.time()}
        try:
            target(*args, **kw)
        finally:
            with _lock:
                _live.pop(ident, None)

    t = threading.Thread(target=_run, name=name, daemon=daemon)
    with _lock:
        _spawned += 1
    if start:
        t.start()
    return t


def registry_snapshot() -> dict:
    """Live registered threads keyed by name (``flight_recorder.dump``
    embeds this so ``thread_stacks`` keys resolve to subsystems)."""
    with _lock:
        out = {}
        for info in _live.values():
            out[info["name"]] = {k: info[k] for k in
                                 ("subsystem", "ident", "daemon",
                                  "started")}
        return out


def live_count() -> int:
    with _lock:
        return len(_live)


def spawned_total() -> int:
    with _lock:
        return _spawned


class ThreadSlot:
    """The commit-exit-under-lock revive protocol, packaged.

    The owner guards the slot with ITS lock (or condition) — the same
    one the worker's queue/state lives under::

        self._cv = concurrency.make_condition("Sched._cv")
        self._slot = threads.ThreadSlot("pt-serve-a", subsystem="serving")

        def submit(self, item):
            with self._cv:
                self._queue.append(item)
                self._slot.ensure(self._worker)   # revive-or-spawn
                self._cv.notify_all()

        def _worker(self):
            while True:
                with self._cv:
                    while not self._queue and not self._idle_deadline():
                        self._cv.wait(0.05)
                    if not self._queue:
                        self._slot.commit_exit()  # still under _cv
                        return
                    batch = self._drain()
                ...

    ``ensure`` and ``commit_exit`` MUST be called with the guarding
    lock held (that is the whole protocol: the exit decision and the
    next spawn are serialized by one lock, so no item can land between
    "queue empty" and "handle cleared", and no second worker can spawn
    while the first is still draining).
    """

    def __init__(self, name: str, subsystem: Optional[str] = None,
                 daemon: bool = True):
        self.name = name
        self.subsystem = subsystem
        self.daemon = daemon
        self._thread: Optional[threading.Thread] = None

    def alive(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    def ensure(self, target: Callable, *, args: tuple = (),
               kwargs: Optional[dict] = None) -> bool:
        """Spawn the worker unless one is already committed to run.
        Caller holds the guarding lock. Returns True when a thread was
        spawned."""
        if self._thread is not None:
            return False
        self._thread = spawn(self.name, target, args=args, kwargs=kwargs,
                             daemon=self.daemon, subsystem=self.subsystem)
        return True

    def commit_exit(self):
        """Worker commits its exit. Caller (the worker) holds the
        guarding lock; after this a concurrent ``ensure`` spawns a
        fresh worker instead of assuming this one will drain."""
        self._thread = None

    def handle(self) -> Optional[threading.Thread]:
        return self._thread

    def join(self, timeout: Optional[float] = None):
        """Join the current worker from OUTSIDE the guarding lock
        (joining under it would deadlock against commit_exit)."""
        t = self._thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout)
