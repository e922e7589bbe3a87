"""Dataset / BatchSampler / DataLoader.

Port of ``paddle_tpu/io/dataloader.py`` (ref: python/paddle/fluid/
reader.py DataLoader :434, GeneratorLoader :997, python/paddle/fluid/
dataloader/ Dataset/BatchSampler; C++ side operators/reader/
buffered_reader.cc double-buffering). Batches are numpy arrays, as the
reference yields them; the executor or the user script moves them to
the device. The differences from the JAX package:

- ``DistributedBatchSampler`` takes its world size and rank from
  ``torch.distributed`` when a process group is initialised, else 1 and
  0 (what one JAX process reports);
- forked workers (``num_workers > 0``) are forked from a process that
  may hold a CUDA context and the threads of a server or a trainer. A
  worker runs only the dataset, the collate function and
  ``worker_init_fn``: it touches no CUDA state and none of the port's
  metrics, tracer or flight-recorder locks, which another thread may
  have held at the fork. The parent polls the result queue every 5 s
  and raises when a worker has died (the JAX package raises only when
  every worker has died, and otherwise waits on the dead one's batch
  for ever);
- a shared-memory batch travels in POSIX segments named after the
  parent's pid and a token drawn for each pass (``ptt<pid>_<token>_``),
  under the resource tracker the parent starts before the fork, so the
  children register their segments with it. The parent unlinks a
  segment when it reads the batch, and at the end of the pass (its
  end, an early ``break``, a worker's error) it unlinks every segment
  of that pass still present, also one a worker made but never sent;
- workers are not reseeded by the loader, as in the reference: each
  inherits the parent's numpy global state at the fork, so two workers
  draw the same numpy random numbers for their first batches, while
  Python's ``random`` is reseeded from the OS in every forked child by
  the interpreter itself (``random``'s after-fork hook), so its draws in
  a worker, those of ``vision.transforms``, cannot be reproduced by
  seeding the parent (ROADMAP Queue 3).
"""
from __future__ import annotations

import os
import queue
import secrets
import time
from typing import List, Sequence

import numpy as np

from ..observability import metrics as _metrics
from ..observability import threads as _obs_threads
from ..testing import faults as _faults

__all__ = ["Dataset", "IterableDataset", "TensorDataset", "Sampler",
           "SequenceSampler", "RandomSampler", "DistributedBatchSampler",
           "BatchSampler", "default_collate_fn", "FileDataLoader",
           "DataLoader", "PyReader"]

_SHM_DIR = "/dev/shm"


def _timed_iter(gen):
    """Instrumented pass-through over a batch iterator: per batch,
    ``dataloader/wait_ms`` records time blocked waiting on the producer
    and ``dataloader/step_ms`` the time the consumer held the batch
    (between yields). wait >> step means the input pipeline is the
    bottleneck; step >> wait means compute-bound.

    Also the dataloader's fault site: the 1-based batch ordinal feeds
    ``testing.faults.on_batch`` (``slow@ms=M,batch=N``) before the batch
    reaches the consumer.

    Closing this iterator (an early ``break``, ``close()``) closes the
    one it wraps at once, so a multiprocess pass stops its workers and
    unlinks its segments then, not when the garbage collector finds it
    (a profiler or a traceback can keep it alive)."""
    n = 0
    try:
        while True:
            t0 = time.perf_counter()
            try:
                batch = next(gen)
            except StopIteration:
                return
            n += 1
            _faults.on_batch(n)
            _metrics.counter_add("dataloader/batches")
            _metrics.hist_observe("dataloader/wait_ms",
                                  (time.perf_counter() - t0) * 1e3)
            t1 = time.perf_counter()
            yield batch
            _metrics.hist_observe("dataloader/step_ms",
                                  (time.perf_counter() - t1) * 1e3)
    finally:
        gen.close()


class Dataset:
    """Map-style dataset (ref: fluid/dataloader/dataset.py)."""

    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class IterableDataset(Dataset):
    def __iter__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise TypeError("IterableDataset is not subscriptable")

    def __len__(self):
        raise TypeError("IterableDataset has no len()")


class TensorDataset(Dataset):
    def __init__(self, tensors: Sequence):
        self.tensors = [np.asarray(t) for t in tensors]
        n = len(self.tensors[0])
        assert all(len(t) == n for t in self.tensors)

    def __getitem__(self, idx):
        return tuple(t[idx] for t in self.tensors)

    def __len__(self):
        return len(self.tensors[0])


class Sampler:
    def __init__(self, data_source=None):
        self.data_source = data_source


class SequenceSampler(Sampler):
    def __iter__(self):
        return iter(range(len(self.data_source)))

    def __len__(self):
        return len(self.data_source)


class RandomSampler(Sampler):
    def __init__(self, data_source, replacement=False, num_samples=None,
                 generator=None):
        super().__init__(data_source)
        self.replacement = replacement
        self._num = num_samples or len(data_source)
        self._rng = np.random.RandomState()

    def __iter__(self):
        n = len(self.data_source)
        if self.replacement:
            return iter(self._rng.randint(0, n, self._num).tolist())
        return iter(self._rng.permutation(n)[:self._num].tolist())

    def __len__(self):
        return self._num


def _world():
    """(world size, rank) of the torch.distributed process group, or
    (1, 0) without one."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


class DistributedBatchSampler(Sampler):
    """Shard samples across data-parallel ranks (ref:
    python/paddle/fluid/dataloader/batch_sampler.py / incubate fleet)."""

    def __init__(self, dataset, batch_size, num_replicas=None, rank=None,
                 shuffle=False, drop_last=False):
        world, me = _world()
        self.dataset = dataset
        self.batch_size = batch_size
        self.nranks = num_replicas if num_replicas is not None else world
        self.rank = rank if rank is not None else me
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __iter__(self):
        n = len(self.dataset)
        indices = np.arange(n)
        if self.shuffle:
            rng = np.random.RandomState(self.epoch)
            rng.shuffle(indices)
        # pad so every rank sees the same number of samples
        per_rank = int(np.ceil(n / self.nranks))
        padded = np.concatenate([indices, indices[:per_rank * self.nranks - n]])
        local = padded[self.rank::self.nranks]
        batch = []
        for idx in local:
            batch.append(int(idx))
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        per_rank = int(np.ceil(len(self.dataset) / self.nranks))
        if self.drop_last:
            return per_rank // self.batch_size
        return int(np.ceil(per_rank / self.batch_size))


class BatchSampler(Sampler):
    def __init__(self, dataset=None, sampler=None, shuffle=False,
                 batch_size=1, drop_last=False):
        self.batch_size = batch_size
        self.drop_last = drop_last
        if sampler is not None:
            self.sampler = sampler
        elif shuffle:
            self.sampler = RandomSampler(dataset)
        else:
            self.sampler = SequenceSampler(dataset)

    def __iter__(self):
        batch = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size


def default_collate_fn(batch: List):
    """Stack samples into batch arrays (ref: dataloader/collate.py)."""
    sample = batch[0]
    if isinstance(sample, (list, tuple)):
        return tuple(default_collate_fn([b[i] for b in batch])
                     for i in range(len(sample)))
    if isinstance(sample, dict):
        return {k: default_collate_fn([b[k] for b in batch]) for k in sample}
    return np.stack([np.asarray(b) for b in batch])


class FileDataLoader:
    """Native multi-threaded file loader (ref: Dataset/DataFeed PS-mode
    input pipeline, framework/data_feed.h MultiSlotDataFeed): dense-slot
    text shards parsed by C++ reader threads, batches popped GIL-free.

        loader = FileDataLoader(file_list, batch_size=256, dim=39)
        for feats, labels in loader:   # float32 [n, dim], int64 [n]
            ...
    """

    def __init__(self, files, batch_size: int, dim: int,
                 num_threads: int = 4, queue_capacity: int = 64):
        self._args = (list(files), batch_size, dim, num_threads,
                      queue_capacity)

    def __iter__(self):
        from ..native import FileFeeder
        return _timed_iter(iter(FileFeeder(*self._args)))


def _worker_loop(dataset, collate_fn, index_q, result_q, shm_prefix,
                 worker_init_fn, worker_id):
    """Subprocess body (ref: fluid/reader.py:722 DygraphGeneratorLoader
    child + dataloader/worker.py _worker_loop): pull index batches, run
    __getitem__ + collate, push results, through POSIX shared-memory
    segments named ``<shm_prefix><batch>_<k>`` when ``shm_prefix`` is
    set, else pickled. Touches no CUDA state and no lock of the port's
    observability modules (see the module docstring)."""
    try:
        if worker_init_fn is not None:
            worker_init_fn(worker_id)
        while True:
            item = index_q.get()
            if item is None:
                break
            bid, indices = item
            try:
                batch = collate_fn([dataset[i] for i in indices])
                if shm_prefix:
                    batch = _batch_to_shm(batch, f"{shm_prefix}{bid}_")
                result_q.put((bid, batch, None))
            except Exception:                          # noqa: BLE001
                import traceback
                result_q.put((bid, None, traceback.format_exc()))
    except KeyboardInterrupt:
        pass


def _batch_to_shm(batch, prefix):
    """numpy arrays -> shared-memory descriptors (zero pipe traffic for
    the bulk data; only names/metadata get pickled). Each array is
    written straight into its segment."""
    from multiprocessing import shared_memory
    out = []
    for k, a in enumerate(batch):
        a = np.ascontiguousarray(a)            # at least 1-d, as the reference
        shm = shared_memory.SharedMemory(name=f"{prefix}{k}", create=True,
                                         size=max(a.nbytes, 1))
        try:
            np.ndarray(a.shape, a.dtype, buffer=shm.buf)[...] = a
        finally:
            shm.close()
        out.append(("__shm__", shm.name, a.shape, str(a.dtype)))
    return out


def _is_shm(item):
    return isinstance(item, tuple) and len(item) == 4 and \
        item[0] == "__shm__"


def _unlink(name):
    from multiprocessing import shared_memory
    try:
        shm = shared_memory.SharedMemory(name=name)
    except FileNotFoundError:
        return
    shm.close()
    try:
        shm.unlink()
    except FileNotFoundError:
        pass


def _release_shm(batch):
    """Unlink shm segments of an undelivered batch without reading."""
    for item in batch:
        if _is_shm(item):
            _unlink(item[1])


def _sweep_shm(prefix):
    """Unlink every segment whose name starts with ``prefix``: what a
    pass left behind (a batch in flight at a ``break``, a segment a
    worker made but never sent)."""
    if not os.path.isdir(_SHM_DIR):
        return
    for name in os.listdir(_SHM_DIR):
        if name.startswith(prefix):
            _unlink(name)


def _batch_from_shm(batch):
    from multiprocessing import shared_memory
    out = []
    for item in batch:
        if _is_shm(item):
            _, name, shape, dtype = item
            shm = shared_memory.SharedMemory(name=name)
            try:
                arr = np.ndarray(shape, np.dtype(dtype),
                                 buffer=shm.buf).copy()
            finally:
                shm.close()
                shm.unlink()
            out.append(arr)
        else:
            out.append(item)
    return out


def shm_prefix_of() -> str:
    """The name prefix of the shared-memory segments of this process's
    loaders."""
    return f"ptt{os.getpid()}_"


class DataLoader:
    """ref: fluid/reader.py DataLoader + dataloader/dataloader_iter.py.

    num_workers>0 forks SUBPROCESS workers (the reference's
    DygraphGeneratorLoader multiprocess mode, fluid/reader.py:722) with
    an optional shared-memory return path; ``use_multiprocess=False``
    falls back to a thread pool (fine when __getitem__ releases the
    GIL). prefetch_factor batches are staged ahead either way — the
    double-buffer/BufferedReader analogue.
    """

    def __init__(self, dataset, feed_list=None, places=None,
                 return_list=True, batch_sampler=None, batch_size=1,
                 shuffle=False, drop_last=False, collate_fn=None,
                 num_workers=0, use_buffer_reader=True, prefetch_factor=2,
                 use_shared_memory=True, timeout=0, worker_init_fn=None,
                 use_multiprocess=True):
        self.dataset = dataset
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = num_workers
        self.use_shared_memory = use_shared_memory
        self.use_multiprocess = use_multiprocess
        self.worker_init_fn = worker_init_fn
        self.timeout = timeout
        self.prefetch = max(prefetch_factor, 1) if use_buffer_reader else 0
        if batch_sampler is not None:
            self.batch_sampler = batch_sampler
        else:
            self.batch_sampler = BatchSampler(
                dataset, shuffle=shuffle, batch_size=batch_size,
                drop_last=drop_last)

    def __len__(self):
        return len(self.batch_sampler)

    def _produce(self, indices):
        samples = [self.dataset[i] for i in indices]
        return self.collate_fn(samples)

    def __iter__(self):
        return _timed_iter(self._iter_impl())

    def _iter_impl(self):
        if isinstance(self.dataset, IterableDataset):
            yield from map(lambda s: self.collate_fn([s]), self.dataset)
            return
        if self.num_workers <= 0 and not self.prefetch:
            for indices in self.batch_sampler:
                yield self._produce(indices)
            return
        if self.num_workers > 0 and self.use_multiprocess:
            yield from self._multiprocess_iter()
            return
        yield from self._prefetch_iter()

    def _multiprocess_iter(self):
        """Subprocess fan-out with in-order delivery and bounded
        in-flight depth (backpressure)."""
        import multiprocessing as mp
        ctx = mp.get_context("fork")
        prefix = ""
        if self.use_shared_memory:
            from multiprocessing import resource_tracker
            # started before the fork, so every worker registers its
            # segments with the parent's tracker, which unlinks what is
            # left if this process dies
            resource_tracker.ensure_running()
            prefix = f"{shm_prefix_of()}{secrets.token_hex(4)}_"
        index_qs = [ctx.Queue() for _ in range(self.num_workers)]
        result_q = ctx.Queue()
        procs = []
        done = {}
        try:
            for wid, iq in enumerate(index_qs):
                p = ctx.Process(
                    target=_worker_loop,
                    args=(self.dataset, self.collate_fn, iq, result_q,
                          prefix, self.worker_init_fn, wid),
                    daemon=True)
                p.start()
                procs.append(p)

            batches = list(self.batch_sampler)
            depth = self.num_workers * (self.prefetch or 1)
            sent = 0
            next_out = 0

            def dispatch():
                nonlocal sent
                while sent < len(batches) and sent - next_out < depth:
                    index_qs[sent % self.num_workers].put(
                        (sent, batches[sent]))
                    sent += 1

            def get_result():
                """Poll with liveness checks; timeout=0 means wait
                forever (paddle contract) as long as every worker
                lives."""
                waited = 0.0
                while True:
                    try:
                        return result_q.get(timeout=5)
                    except queue.Empty:
                        waited += 5
                        dead = [(i, p.exitcode) for i, p in enumerate(procs)
                                if not p.is_alive()]
                        if dead:
                            raise RuntimeError(
                                f"DataLoader workers (id, exit code) {dead} "
                                f"died without delivering results "
                                f"(OOM-killed?)") from None
                        if self.timeout and waited >= self.timeout:
                            raise RuntimeError(
                                f"DataLoader timed out after "
                                f"{self.timeout}s waiting for batch "
                                f"{next_out}") from None

            dispatch()
            while next_out < len(batches):
                while next_out not in done:
                    bid, batch, err = get_result()
                    if err is not None:
                        raise RuntimeError(
                            f"DataLoader worker failed on batch {bid}:\n"
                            f"{err}")
                    done[bid] = batch
                batch = done.pop(next_out)
                if self.use_shared_memory:
                    batch = _batch_from_shm(batch)
                next_out += 1
                dispatch()
                yield batch
        finally:
            for iq in index_qs:
                try:
                    iq.put(None)
                except (OSError, ValueError):
                    pass
            for p in procs:
                p.join(timeout=5)
                if p.is_alive():
                    p.terminate()
                    p.join(timeout=5)
            # early exit (break/exception) strands in-flight shm
            # segments in result_q / done: unlink them, then whatever
            # else of this pass is left
            if self.use_shared_memory:
                for leftover in done.values():
                    _release_shm(leftover)
                while True:
                    try:
                        _, leftover, _ = result_q.get_nowait()
                        if leftover is not None:
                            _release_shm(leftover)
                    except (queue.Empty, OSError, ValueError):
                        break
                _sweep_shm(prefix)
            for q in (*index_qs, result_q):
                q.close()
                q.join_thread()

    def _prefetch_iter(self):
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch or 1)
        stop = object()

        def worker():
            try:
                if self.num_workers > 1:
                    from collections import deque
                    from concurrent.futures import ThreadPoolExecutor
                    # keep at most workers + prefetch batches in flight so
                    # the queue provides real backpressure (a full-epoch
                    # submit would materialize every batch in memory)
                    depth = self.num_workers + (self.prefetch or 1)
                    with ThreadPoolExecutor(self.num_workers) as pool:
                        pending = deque()
                        it = iter(self.batch_sampler)
                        for idxs in it:
                            pending.append(pool.submit(self._produce, idxs))
                            if len(pending) >= depth:
                                q.put(pending.popleft().result())
                        while pending:
                            q.put(pending.popleft().result())
                else:
                    for idxs in self.batch_sampler:
                        q.put(self._produce(idxs))
            except BaseException as e:  # surface worker errors to consumer
                q.put(e)
            finally:
                q.put(stop)

        _obs_threads.spawn("pt-dataloader-worker", worker, subsystem="io")
        while True:
            item = q.get()
            if item is stop:
                break
            if isinstance(item, BaseException):
                raise item
            yield item

    @staticmethod
    def from_generator(feed_list=None, capacity=16, use_double_buffer=True,
                       iterable=True, return_list=True, **kw):
        """fluid-style factory (ref: reader.py:434)."""
        return _GeneratorLoader(capacity)


class _GeneratorLoader:
    """fluid DataLoader.from_generator parity: user registers a batch
    generator; iteration yields feed dicts/lists."""

    def __init__(self, capacity):
        self._capacity = capacity
        self._gen = None

    def set_batch_generator(self, generator, places=None):
        self._gen = generator
        return self

    def set_sample_list_generator(self, generator, places=None):
        self._gen = generator
        return self

    def __iter__(self):
        return iter(self._gen())


def _feed_samples(feed_list, rows):
    """A list of per-sample tuples -> the executor feed dict, each column
    shaped to its feed var (the port's copy of the ``paddle.fluid``
    shim's ``DataFeeder.feed``): a lod_level 1 slot padded to the batch's
    longest sequence beside its ``@seq_len`` lengths, a deeper one as a
    LoD tensor of offsets, the rest stacked and reshaped to the var's
    per-sample shape."""
    from ..core.dtype import dtype_name
    from ..core.tensor import TpuTensor
    rows = list(rows)
    out = {}
    for j, var in enumerate(feed_list):
        if isinstance(var, str):
            out[var] = np.stack([np.asarray(r[j]) for r in rows])
            continue
        lod_level = getattr(var, "lod_level", 0) or getattr(
            getattr(var, "desc", None), "lod_level", 0) or 0
        dtype = dtype_name(var.dtype) if getattr(var, "dtype", None) \
            is not None else None
        if lod_level >= 2:
            level, lod = [r[j] for r in rows], []
            for _ in range(lod_level):
                offsets = np.cumsum([0] + [len(s) for s in level])
                lod.append([int(o) for o in offsets])
                level = [item for s in level for item in s]
            arr = np.asarray(level, dtype)
            out[var.name] = TpuTensor(arr.reshape(len(level), -1)
                                      if arr.ndim <= 1 else arr, lod)
        elif lod_level == 1:
            step = tuple(int(d) for d in (var.shape or [])[2:]
                         if int(d) > 0)
            seqs = [np.asarray(r[j]).reshape((-1,) + step) for r in rows]
            lens = np.asarray([s.shape[0] for s in seqs], np.int64)
            arr = np.zeros((len(rows), max(int(lens.max()), 1)) + step,
                           dtype or "int64")
            for i, s in enumerate(seqs):
                arr[i, :s.shape[0]] = s
            out[var.name] = arr
            out[getattr(var, "lod_companion", None)
                or var.name + "@seq_len"] = lens
        else:
            arr = np.stack([np.asarray(r[j]) for r in rows])
            per = list(var.shape or [])[1:]
            if per and all(int(d) > 0 for d in per):
                arr = arr.reshape((len(rows),) + tuple(int(d) for d in per))
            out[var.name] = arr if dtype is None else arr.astype(dtype)
    return out


class PyReader:
    """1.x fluid.reader.PyReader (ref: fluid/reader.py PyReader — the
    decorate-then-iterate feeder over a blocking queue). The executor
    pulls whole feed dicts per run, so the queue/double-buffer
    machinery reduces to generator iteration; the decorate_* surface
    and the iterable/return_list contracts are the reference's."""

    def __init__(self, feed_list=None, capacity=8,
                 use_double_buffer=True, iterable=True,
                 return_list=False):
        self._feed_list = list(feed_list or [])
        self._iterable = iterable
        self._return_list = return_list
        self._gen = None
        self._kind = None
        self._started = False

    # -- decorators (ref: PyReader.decorate_*) --
    def decorate_sample_list_generator(self, reader, places=None):
        self._gen, self._kind = reader, "sample_list"
        return self

    def decorate_batch_generator(self, reader, places=None):
        self._gen, self._kind = reader, "batch"
        return self

    def decorate_sample_generator(self, sample_generator, batch_size,
                                  drop_last=True, places=None):
        def batched():
            batch = []
            for sample in sample_generator():
                batch.append(sample)
                if len(batch) == batch_size:
                    yield batch
                    batch = []
            if batch and not drop_last:
                yield batch

        self._gen, self._kind = batched, "sample_list"
        return self

    # -- non-iterable-mode lifecycle (queue start/reset in the
    # reference; here iteration state only) --
    def start(self):
        self._started = True

    def reset(self):
        self._started = False

    def _convert(self, item):
        if self._kind == "sample_list":
            feed = _feed_samples(self._feed_list, item)
        else:
            names = [v if isinstance(v, str) else v.name
                     for v in self._feed_list]
            arrs = item if isinstance(item, (list, tuple)) else [item]
            feed = {n: np.asarray(a) for n, a in zip(names, arrs)}
        if self._return_list:
            return [feed[v if isinstance(v, str) else v.name]
                    for v in self._feed_list if
                    (v if isinstance(v, str) else v.name) in feed]
        return feed

    def __call__(self):
        from ..core.enforce import InvalidArgumentError, enforce
        enforce(self._gen is not None,
                "PyReader: call decorate_sample_list_generator / "
                "decorate_batch_generator first", InvalidArgumentError)
        for item in self._gen():
            yield self._convert(item)

    def __iter__(self):
        return self.__call__()
