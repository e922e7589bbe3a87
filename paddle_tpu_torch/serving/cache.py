"""Persistent executable cache: what a warm boot needs to skip.

Port of ``paddle_tpu/serving/cache.py``: the same fingerprint-keyed
layout, the same size-capped LRU, the same provenance sidecars::

    key = sha256(program fingerprint, params digest, bucket key,
                 fetch names, torch version, device type)
    <dir>/<key>.ptserve          the entry (JSON, below)
    <dir>/<key>.ptserve.meta.json
                                 provenance (model label, fingerprint,
                                 bucket spec, fetch names, created-at)

The reference stores a serialized ``jax.export`` artifact, so a warm
boot skips the trace and the XLA compile. The port's per-bucket
executable is the program closure itself (``inference._pure_fn``),
which costs nothing to rebuild; what a bucket's first preparation pays
is the two-batch shape probe that decides which fetches are sliced per
request (``ServedModel.out_slicing``). So an entry holds the bucket
signature, the feed and fetch names and the per-fetch batch-major
flags, and a warm boot reads the flags instead of probing. There is no
counterpart of ``enable_jax_compilation_cache``: no compiled binary
sits below the closure (cuBLAS and cuDNN choose their kernels at run
time).

Keys include the torch version and the device type because the flags
were probed on that stack; an entry from another stack, or an
unreadable one, is a clean miss, never a crash.
"""
from __future__ import annotations

import hashlib
import json
import os
import time
from typing import Dict, Optional

import torch

from ..core.flags import get_flag
from ..observability import metrics as _metrics

ARTIFACT_SUFFIX = ".ptserve"


def enforce_size_cap(directory: Optional[str],
                     keep: Optional[str] = None,
                     max_mb: Optional[float] = None,
                     namespace: str = "serving") -> list:
    """Size-capped LRU over a cache directory's entries: while they
    total more than ``max_mb`` (``FLAGS_exec_cache_max_mb`` when None;
    0 = uncapped), the least-recently-USED entry (entry mtime; ``load``
    touches it) is deleted with its meta sidecar. ``keep`` is never
    evicted (the entry the caller just stored). Returns the evicted
    paths; each eviction bumps ``cache/evictions`` (+``/<namespace>``)."""
    if not directory:
        return []
    if max_mb is None:
        try:
            max_mb = float(get_flag("exec_cache_max_mb"))
        except (TypeError, ValueError):
            max_mb = 0.0
    if max_mb <= 0:
        return []
    cap = max_mb * (1 << 20)
    entries = []
    total = 0
    try:
        names = os.listdir(directory)
    except OSError:
        return []
    for fn in names:
        if not fn.endswith(ARTIFACT_SUFFIX):
            continue
        path = os.path.join(directory, fn)
        try:
            st = os.stat(path)
        except OSError:
            continue
        total += st.st_size
        entries.append((st.st_mtime, st.st_size, path))
    entries.sort()                      # oldest use first
    evicted = []
    for mtime, size, path in entries:
        if total <= cap:
            break
        if keep and os.path.abspath(path) == os.path.abspath(keep):
            continue
        try:
            os.remove(path)
        except OSError:
            continue
        try:
            os.remove(path + ".meta.json")
        except OSError:
            pass
        total -= size
        evicted.append(path)
        _metrics.counter_add("cache/evictions")
        _metrics.counter_add(f"cache/evictions/{namespace}")
    return evicted


def cache_key(fingerprint: str, bucket_key: str, fetch_names=(),
              platform: Optional[str] = None,
              params_digest: str = "") -> str:
    """Deterministic cache key for one (model, bucket) entry.

    ``params_digest`` hashes the parameter VALUES the executable closes
    over: the program fingerprint hashes only the IR, so without it a
    retrained model (same graph, new weights) or two tenants sharing an
    architecture would collide. ``platform`` defaults to the device
    type of :func:`paddle_tpu_torch.device.get_device`."""
    if platform is None:
        try:
            from ..device import get_device
            platform = get_device().type
        except Exception:       # noqa: BLE001 - key must never raise
            platform = "unknown"
    payload = json.dumps({
        "fingerprint": str(fingerprint),
        "params": str(params_digest),
        "bucket": str(bucket_key),
        "fetch_names": list(fetch_names),
        "torch": torch.__version__,
        "platform": platform,
    }, sort_keys=True)
    return hashlib.sha256(payload.encode()).hexdigest()


class ExecutableCache:
    """Disk-backed store of entries. A ``None`` directory is a pure
    in-process miss (the server still works; every boot probes)."""

    def __init__(self, directory: Optional[str]):
        self.directory = os.path.abspath(directory) if directory else None
        if self.directory:
            os.makedirs(self.directory, exist_ok=True)

    def _path(self, key: str) -> str:
        return os.path.join(self.directory, key + ARTIFACT_SUFFIX)

    def load(self, key: Optional[str]) -> Optional[dict]:
        """The entry stored under ``key``, or None (miss / unreadable /
        disabled; ``key`` is None when no directory is configured)."""
        if not self.directory:
            _metrics.counter_add("serving/exec_cache_miss")
            return None
        path = self._path(key)
        try:
            with open(path, "r", encoding="utf-8") as f:
                entry = json.load(f)
            if not isinstance(entry, dict):
                raise ValueError("not an entry")
        except (OSError, ValueError):
            # unreadable entries are a miss: the caller probes and
            # overwrites
            _metrics.counter_add("serving/exec_cache_miss")
            return None
        try:
            os.utime(path, None)        # recency for the LRU
        except OSError:
            pass
        _metrics.counter_add("serving/exec_cache_hit")
        return entry

    def store(self, key: Optional[str], entry: dict,
              meta: Optional[Dict] = None):
        """Persist an entry atomically (pid-suffixed tmp + rename: a
        concurrently booting server never reads a torn file). A no-op
        without a directory."""
        if not self.directory:
            return
        path = self._path(key)
        try:
            blob = json.dumps(entry, sort_keys=True)
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "w", encoding="utf-8") as f:
                f.write(blob)
            os.replace(tmp, path)
            mtmp = f"{path}.meta.json.tmp.{os.getpid()}"
            with open(mtmp, "w", encoding="utf-8") as f:
                json.dump({"created_at": time.time(),
                           "bytes": len(blob), **(meta or {})}, f)
            os.replace(mtmp, path + ".meta.json")
        except (OSError, TypeError, ValueError):
            return                      # the cache is an optimization
        _metrics.counter_add("serving/exec_cache_store")
        enforce_size_cap(self.directory, keep=path)

    def known_signatures(self, fingerprint: str):
        """Feed signatures of entries a PRIOR boot stored for this
        program fingerprint: the observed, already-bucketed traffic
        shapes that make the PTA301 lint actionable at admission."""
        out = []
        for meta in self.entries().values():
            if meta.get("fingerprint") != fingerprint:
                continue
            bucket = meta.get("bucket")
            if isinstance(bucket, dict):
                try:
                    out.append({n: (tuple(int(d) for d in v["shape"]),
                                    str(v["dtype"]))
                                for n, v in bucket.items()})
                except (KeyError, TypeError, ValueError):
                    continue    # foreign/old sidecar: skip, never raise
        return out

    def entries(self) -> Dict[str, dict]:
        """key -> meta for every persisted entry (provenance view)."""
        out: Dict[str, dict] = {}
        if not self.directory:
            return out
        for fn in sorted(os.listdir(self.directory)):
            if not fn.endswith(ARTIFACT_SUFFIX):
                continue
            key = fn[:-len(ARTIFACT_SUFFIX)]
            meta_path = os.path.join(self.directory, fn + ".meta.json")
            try:
                with open(meta_path, "r", encoding="utf-8") as f:
                    out[key] = json.load(f)
            except (OSError, ValueError):
                out[key] = {}
        return out
