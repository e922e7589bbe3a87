"""ServedModel: one admitted model and its per-bucket executables.

Port of ``paddle_tpu/serving/model.py``. Load path A: a
``save_inference_model`` directory is loaded into a private scope on
:func:`paddle_tpu_torch.device.get_device`, the static analyzer gates
admission (:mod:`.admission`), and the program is closed over its
parameters as a feed->fetch function (``inference._pure_fn``), the
executable every bucket runs. Load path B: a file is a ``torch.export``
archive (``inference.export_stablehlo``'s ``.pt2``, where the reference
loads a serialized ``jax.export`` blob), run on the device it was
exported on. Its fingerprint is the file's sha256, the shapes it was
exported at are its one bucket (a different declared bucket is refused
at load), its sidecar's batch-major flags are taken where they match
its outputs (else an output whose leading dim is that bucket's batch
is batch-major), and admission is opaque. Any other file, such as a JAX
package's ``.jaxexport`` blob, is refused.

A bucket's first preparation is the two-batch shape probe that decides
which fetches are sliced per request (:meth:`ServedModel.out_slicing`,
on ``meta`` tensors where the reference runs ``jax.eval_shape``). Its
result lands in the persistent :class:`~.cache.ExecutableCache`, so a
warm boot reads it instead. The counters keep the reference's names:

- ``serving/compiles``         first preparations of a bucket in this
                               process (the probe ran);
- ``serving/warm_loads``       buckets prepared from the cache;
- ``serving/steady_compiles``  preparations after the bucket set froze,
                               the steady-state number held at zero.

Execution is asynchronous on the card: :meth:`ServedModel.run_padded`
stages the padded batch through pinned host memory and enqueues the
program on the calling thread's current stream, and
:meth:`ServedModel.readback` enqueues the device-to-host copies behind
it with an event, which the scheduler's readback thread waits on.
"""
from __future__ import annotations

import hashlib
import json
import os
import zipfile
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import dtype as dtypes
from ..core.enforce import InvalidArgumentError, enforce
from ..core.executor import Executor
from ..core.scope import Scope
from ..device import get_device
from ..observability import metrics as _metrics
from . import admission as _admission
from .buckets import Bucket, BucketPolicy
from .cache import ExecutableCache, cache_key
from .. import concurrency as _concurrency


def _param_bytes(t: torch.Tensor) -> Tuple[str, bytes]:
    """(dtype name, raw bytes in C order) of one parameter: the bytes
    numpy's ``tobytes`` gives for the same array in the JAX package.
    bfloat16 has no numpy dtype: its name is "bfloat16" (ml_dtypes'
    ``str(dtype)``) and its bytes are the 2-byte words as they lie in
    memory, read through an int16 view."""
    t = t.detach().contiguous()
    if t.dtype == torch.bfloat16:
        return "bfloat16", t.view(torch.int16).cpu().numpy().tobytes()
    a = t.cpu().numpy()
    return str(a.dtype), a.tobytes()


def _params_digest(params) -> str:
    """sha256 over the parameter VALUES a program closes over (name,
    dtype, shape, bytes; sorted by name), as the reference's: the IR
    fingerprint cannot see the weights, so they enter the cache key
    here."""
    h = hashlib.sha256()
    for name in sorted(params):
        t = params[name]
        dt, raw = _param_bytes(t)
        h.update(name.encode())
        h.update(dt.encode())
        h.update(repr(tuple(int(d) for d in t.shape)).encode())
        h.update(raw)
    return h.hexdigest()


class Readback:
    """One batch's fetches on their way to the host. On the card the
    device-to-host copies are enqueued on the dispatching thread's
    stream, right behind the batch, into pinned buffers, and an event
    marks their end, so :meth:`wait` (the readback thread) blocks on
    that event alone and never serializes behind a later batch. A
    bfloat16 fetch is copied as its int16 words and viewed as
    ``ml_dtypes.bfloat16`` on the host (float32 where ml_dtypes does
    not import, ``core.dtype.host_array``)."""

    __slots__ = ("_host", "_event", "_words")

    def __init__(self, outs: Sequence[torch.Tensor]):
        self._event = None
        outs = [o.detach() for o in outs]
        if not outs or outs[0].device.type != "cuda":
            self._host = outs
            return
        stream = torch.cuda.current_stream(outs[0].device)
        self._words = [o.dtype == torch.bfloat16 and
                       dtypes.NP_BFLOAT16 is not None for o in outs]
        host = []
        for o, words in zip(outs, self._words):
            if words:
                o = o.view(torch.int16)
            elif o.dtype == torch.bfloat16:
                o = o.float()
            h = torch.empty(o.shape, dtype=o.dtype, pin_memory=True)
            h.copy_(o, non_blocking=True)
            host.append(h)
        self._host = host
        self._event = torch.cuda.Event()
        self._event.record(stream)

    def wait(self) -> List[np.ndarray]:
        if self._event is None:
            return [dtypes.host_array(h) for h in self._host]
        self._event.synchronize()
        return [dtypes.host_bfloat16(h.numpy()) if words else h.numpy()
                for h, words in zip(self._host, self._words)]


class ServedModel:
    """One tenant's model: program + bucket policy + per-bucket
    executables (the program closure, with its probed slicing)."""

    def __init__(self, label: str, path: str,
                 buckets: Optional[Sequence[Dict]] = None,
                 cache: Optional[ExecutableCache] = None,
                 admission_check: bool = True,
                 donate_inputs: bool = False):
        self.label = str(label)
        self.path = path
        self.cache = cache or ExecutableCache(None)
        # accepted for the reference's signature; a closure over torch
        # tensors has no input buffers to donate
        self.donate_inputs = bool(donate_inputs)
        self._placement = None          # serving.placement.Placement
        auto_buckets = buckets == "auto"
        if auto_buckets:
            buckets = None
        self.policy = BucketPolicy(declared=buckets)
        self.declared_at_load = bool(buckets)
        self.auto_buckets_applied = False
        self._exec: Dict[str, Callable] = {}
        self._slicing: Dict[str, Tuple[bool, ...]] = {}
        self._compile_lock = _concurrency.make_lock(
            "ServedModel._compile_lock")
        self.compiles = 0
        self.warm_loads = 0
        self.steady_compiles = 0
        self.placement_compiles = 0
        # steady accounting arms AFTER the cold path is paid (prewarm
        # of declared buckets / server.freeze() for learned ones)
        self.steady_armed = False
        self._params_digest = None
        self._exported = None           # load path B's ExportedProgram
        if os.path.isdir(path):
            self._load_program_dir(path, admission_check)
        else:
            self._load_exported(path, admission_check)
        if auto_buckets and self._exported is None:
            # an exported archive has one intrinsic bucket
            self._apply_auto_buckets()

    def _apply_auto_buckets(self):
        from ..analysis.recompile_lint import suggest_buckets
        observed = getattr(self, "_observed_signatures", None)
        if observed is None:        # admission_check=False load path
            observed = (self.cache.known_signatures(self.fingerprint)
                        if self.cache.directory else [])
        applied = suggest_buckets(observed) if observed else []
        if not applied:
            return              # cold cache: learn this boot, apply next
        for spec in applied:
            self.policy.add(spec)
        self.policy.frozen = True
        self.declared_at_load = True
        self.auto_buckets_applied = True
        _metrics.counter_add("serving/auto_buckets_applied",
                             len(applied))

    def _load_program_dir(self, model_dir: str, admission_check: bool):
        from ..inference import _meta_fn, _model_params, _pure_fn
        from ..io import load_inference_model
        self.device = get_device()
        self._scope = Scope()
        prog, feeds, fetches = load_inference_model(
            model_dir, Executor(self.device), scope=self._scope)
        self._program = prog
        self.feed_names: List[str] = list(feeds)
        self.fetch_names: List[str] = list(fetches)
        self.fingerprint = str(prog.fingerprint())
        params = _model_params(prog, self._scope)
        self._params = params
        scope_names = self._scope.local_var_names()
        if admission_check:
            # prior-boot provenance makes the PTA3xx lint actionable
            observed = (self.cache.known_signatures(self.fingerprint)
                        if self.cache.directory else [])
            self._observed_signatures = observed
            self.admission = _admission.admit_program(
                prog, self.feed_names, self.fetch_names,
                scope_names=scope_names, label=self.label,
                observed_signatures=observed or None)
        else:
            self.admission = _admission.AdmissionReport(
                self.label, [], checked=False)
        self._fn = _pure_fn(prog, self._scope, self.feed_names,
                            self.fetch_names, params=params)
        self._meta = _meta_fn(prog, self.feed_names, self.fetch_names,
                              params)

    def _load_exported(self, path: str, admission_check: bool):
        """Load path B: a ``torch.export`` archive (see the module
        docstring)."""
        from ..inference import _exported_call, _exported_signature
        enforce(zipfile.is_zipfile(path),
                f"model {self.label!r}: {path!r} is neither a "
                f"save_inference_model directory nor a torch.export "
                f"archive, which load path B takes (export_stablehlo "
                f"writes one; a jax.export blob is not one)",
                InvalidArgumentError)
        digest = hashlib.sha256()
        with open(path, "rb") as f:
            for chunk in iter(lambda: f.read(1 << 20), b""):
                digest.update(chunk)
        self.fingerprint = digest.hexdigest()
        self._exported = torch.export.load(path)
        ins, outs = _exported_signature(self._exported)
        self.device = ins[0].device
        self._params = {}
        self._params_digest = ""        # the fingerprint hashes the weights
        meta = {}
        try:
            with open(path + ".meta.json", "r", encoding="utf-8") as f:
                meta = json.load(f)
        except (OSError, ValueError):
            pass
        self.feed_names = list(meta.get("feed_names")
                               or [f"arg{i}" for i in range(len(ins))])
        self.fetch_names = list(meta.get("fetch_names")
                                or [f"out{i}" for i in range(len(outs))])
        # the export fixed the shapes: its inputs are the ONE bucket
        intrinsic = BucketPolicy(declared=[{
            n: (tuple(int(d) for d in t.shape), dtypes.dtype_name(t.dtype))
            for n, t in zip(self.feed_names, ins)}])
        declared = self.policy.buckets
        enforce(not declared or
                {b.key for b in declared} == {intrinsic.buckets[0].key},
                f"model {self.label!r}: a torch.export archive serves only "
                f"its intrinsic bucket {intrinsic.buckets[0].key}; the "
                f"declared buckets {[b.key for b in declared]} don't "
                f"match; omit buckets= for exported archives",
                InvalidArgumentError)
        self.policy = intrinsic
        # the flags export_stablehlo decided where the program was still
        # traceable at two batch sizes, taken only where they match the
        # archive's outputs; else (no sidecar, or a foreign one) an
        # output whose leading dim is the bucket's batch is batch-major,
        # as the reference's scheduler decides it
        flags = meta.get("out_batch_major")
        key = intrinsic.buckets[0].key
        if (isinstance(flags, list) and len(flags) == len(self.fetch_names)
                and len(flags) == len(outs)):
            self._slicing[key] = tuple(bool(f) for f in flags)
        else:
            batch = intrinsic.buckets[0].batch
            self._slicing[key] = tuple(bool(o.ndim and o.shape[0] == batch)
                                       for o in outs)
        self.admission = (_admission.admit_opaque(self.label)
                          if admission_check else
                          _admission.AdmissionReport(self.label, [],
                                                     checked=False))
        self._exec[intrinsic.buckets[0].key] = _exported_call(
            self._exported)

    @property
    def params_digest(self) -> str:
        """Hash of the param values (part of the cache key). Lazy: it
        costs a device-to-host pass over every weight, paid only when a
        persistent cache directory needs a key."""
        if self._params_digest is None:
            self._params_digest = _params_digest(self._params)
        return self._params_digest

    # ------------------------------------------------------- executables
    def executable_for(self, bucket: Bucket) -> Callable:
        """The callable for one bucket: in-memory memo, else the
        persistent cache's entry (warm load: no probe), else the first
        preparation (probe + persist)."""
        fn = self._exec.get(bucket.key)
        if fn is not None:
            return fn
        with self._compile_lock:
            fn = self._exec.get(bucket.key)
            if fn is not None:
                return fn
            enforce(self._exported is None,
                    f"model {self.label!r}: an exported archive serves "
                    f"only its intrinsic bucket, not {bucket.key}",
                    InvalidArgumentError)
            # a directory-less cache never hits or stores: skip the key
            # (and with it the params digest's device-to-host pass)
            key = (cache_key(self.fingerprint, bucket.key,
                             self.fetch_names,
                             platform=self.device.type,
                             params_digest=self.params_digest)
                   if self.cache.directory else None)
            flags = self._entry_flags(self.cache.load(key), bucket)
            if flags is not None:
                self._slicing[bucket.key] = flags
                self.warm_loads += 1
                _metrics.counter_add("serving/warm_loads")
            else:
                self._compile(bucket, key)
            self._exec[bucket.key] = self._fn
            return self._fn

    def _entry_flags(self, entry: Optional[dict],
                     bucket: Bucket) -> Optional[Tuple[bool, ...]]:
        """The batch-major flags of a cache entry that matches this
        model and bucket, else None (a foreign or truncated entry is a
        miss, never a short flags tuple)."""
        if entry is None:
            return None
        flags = entry.get("out_batch_major")
        if (entry.get("bucket") != bucket.to_dict()
                or entry.get("fetch_names") != self.fetch_names
                or not isinstance(flags, list)
                or len(flags) != len(self.fetch_names)
                or not all(isinstance(f, bool) for f in flags)):
            return None
        return tuple(flags)

    def _compile(self, bucket: Bucket, key: Optional[str]):
        flags = self._probe(bucket)
        self._slicing[bucket.key] = flags
        self.compiles += 1
        _metrics.counter_add("serving/compiles")
        if self.steady_armed:
            # a preparation AFTER warmup is the churn the bucket policy
            # exists to kill
            self.steady_compiles += 1
            _metrics.counter_add("serving/steady_compiles")
        self.cache.store(key, {
            "bucket": bucket.to_dict(), "feed_names": self.feed_names,
            "fetch_names": self.fetch_names,
            "out_batch_major": list(flags)}, meta={
            "model": self.label, "fingerprint": self.fingerprint,
            "bucket": bucket.to_dict(), "fetch_names": self.fetch_names})

    def _probe(self, bucket: Bucket) -> Tuple[bool, ...]:
        """Per-fetch batch-major flags, decided exactly by evaluating
        the program on ``meta`` tensors at two batch sizes: a dim that
        grows by 1 when the batch grows by 1 IS the batch (the
        ``shape[0] == bucket.batch`` coincidence is not used)."""
        from ..inference import _probe_batch_dims

        def specs_at(extra: int):
            return [torch.empty((bucket.batch + extra,)
                                + tuple(bucket.spec[n][0][1:]),
                                dtype=dtypes.convert_dtype(
                                    bucket.spec[n][1]), device="meta")
                    for n in self.feed_names]

        flags, at_b, at_b1 = _probe_batch_dims(self._meta, specs_at)
        for i, f in enumerate(flags):
            if f is None:
                raise InvalidArgumentError(
                    f"model {self.label!r}: fetch "
                    f"{self.fetch_names[i]!r} scales its leading dim "
                    f"{tuple(at_b[i].shape[:1])}->"
                    f"{tuple(at_b1[i].shape[:1])} when the batch grows "
                    f"by 1; per-request slicing is undefined — keep the "
                    f"batch dim leading in served fetches")
        return tuple(flags)

    def prewarm(self):
        """Prepare (or warm-load) every declared bucket at load time.
        A frozen (declared) bucket set is covered afterwards, so steady
        accounting arms here; learned sets arm at ``freeze()``."""
        for b in list(self.policy.buckets):
            self.executable_for(b)
        if self.policy.frozen:
            self.steady_armed = True

    def arm_steady(self):
        """Warmup is over: any further preparation is steady churn."""
        self.steady_armed = True

    def out_slicing(self, bucket: Bucket) -> Tuple[bool, ...]:
        """Per-fetch slicing decision for the scheduler: True = the
        leading dim is the request batch (rows sliced per request),
        False = batch-invariant (every request gets the whole output).
        Prepares the bucket first when it has not been."""
        self.executable_for(bucket)
        return self._slicing[bucket.key]

    # -------------------------------------------------------- placement
    @property
    def placement(self):
        return self._placement

    def set_placement(self, decision) -> None:
        """Pin this model to its slot of the one-device serving mesh
        (:mod:`.placement`); ``None`` clears it."""
        self._placement = decision

    # -------------------------------------------------------------- run
    def stage(self, bucket: Bucket,
              padded: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """Move the padded batch to the device: through pinned host
        memory and a non-blocking copy on the card, so staging enqueues
        behind the previous batch instead of waiting for it."""
        dev = self.device if self._placement is None \
            else self._placement.devices[0]
        staged = {}
        for n in self.feed_names:
            t = torch.from_numpy(np.ascontiguousarray(padded[n]))
            if dev.type == "cuda":
                t = t.pin_memory().to(dev, non_blocking=True)
            staged[n] = t
        if self._placement is not None:
            _metrics.counter_add("serving/staged_batches")
        return staged

    def run_padded(self, bucket: Bucket, padded: Dict[str, np.ndarray],
                   replica: int = 0) -> Tuple[torch.Tensor, ...]:
        """Dispatch one padded batch; returns the fetch tuple as device
        tensors. On the card the work is enqueued, not finished: the
        caller decides where the readback waits (:meth:`readback`)."""
        fn = self.executable_for(bucket)
        staged = self.stage(bucket, padded)
        return fn(*[staged[n] for n in self.feed_names])

    @staticmethod
    def readback(outs) -> Readback:
        """Enqueue the fetches' device-to-host copies on this thread's
        stream; :meth:`Readback.wait` returns them as numpy."""
        return Readback(outs)

    def stats(self) -> dict:
        out = {"label": self.label,
               "fingerprint": self.fingerprint[:12],
               "buckets": [b.key for b in self.policy.buckets],
               "frozen": self.policy.frozen,
               "compiles": self.compiles,
               "warm_loads": self.warm_loads,
               "steady_compiles": self.steady_compiles,
               "placement_compiles": self.placement_compiles,
               "admission": self.admission.to_dict()}
        if self._placement is not None:
            out["placement"] = self._placement.to_dict()
        return out
