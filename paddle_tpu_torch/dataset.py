"""Dataset / DataFeed runtime (ref: python/paddle/fluid/dataset.py
DatasetFactory/InMemoryDataset/QueueDataset; C++ framework/data_set.h:43
DatasetImpl, framework/data_feed.h:117 MultiSlotDataFeed).

Port of ``paddle_tpu/dataset.py``, a copy over the port's ``native``
feeder. The reference streams MultiSlot-format text files through C++
reader threads into per-worker channels, with optional in-memory (local
or fleet-global) shuffle. Here:

- the file format and Dataset surface are kept (MultiSlot text:
  each line is, per slot, "<n> v1 ... vn" — float values for dense
  float32 slots, uint64 feasign ids for sparse int64 slots);
- reader threads shard the file list like DatasetImpl; a QueueDataset
  with no pipe command and no ``drop_last`` takes the native C++
  MultiSlot feeder (``native/src/datafeed.cc``, counted in
  ``dataset/native_batches``); the general MultiSlot parser is python;
- batches surface as {var_name: np.ndarray} dicts — dense slots must
  match the declared var shape, sparse slots are padded to their
  declared dim + "<name>@LEN" lengths (``trainer.run_trainer`` feeds a
  length only to a program that declares a var of that name);
- global_shuffle keeps a deterministic hash partition, synchronized
  through a duck-typed parameter-server client's barrier (the
  parameter server is ROADMAP Queue 1 item 8).
"""
from __future__ import annotations

import glob as _glob
import os
import queue
import subprocess
import threading
from typing import Dict, List, Optional, Sequence

import numpy as np

from .observability import threads as _obs_threads
from .core.enforce import (InvalidArgumentError, PreconditionNotMetError,
                           UnimplementedError, enforce)

__all__ = ["DatasetFactory", "DatasetBase", "QueueDataset",
           "InMemoryDataset"]


class _SlotSpec:
    def __init__(self, name: str, dtype: str, dim: int):
        self.name = name
        self.dtype = dtype      # "float32" (dense) | "int64" (sparse)
        self.dim = dim          # dense: values per instance; sparse: pad


def _parse_multislot_line(line: str, slots: List[_SlotSpec]):
    """One MultiSlot line → list of per-slot 1-D arrays."""
    toks = line.split()
    out = []
    pos = 0
    for spec in slots:
        enforce(pos < len(toks),
                f"multislot line ended before slot {spec.name!r}",
                InvalidArgumentError)
        n = int(toks[pos])
        pos += 1
        vals = toks[pos:pos + n]
        enforce(len(vals) == n,
                f"slot {spec.name!r} declares {n} values, line has "
                f"{len(vals)}", InvalidArgumentError)
        pos += n
        if spec.dtype == "int64":
            out.append(np.array([int(v) for v in vals], np.int64))
        else:
            out.append(np.array([float(v) for v in vals], np.float32))
    return out


class DatasetBase:
    """ref: fluid/dataset.py DatasetBase — config surface."""

    def __init__(self):
        self.batch_size = 1
        self.thread_num = 1
        self.filelist: List[str] = []
        self.slots: List[_SlotSpec] = []
        self.pipe_command: Optional[str] = None
        self.drop_last = False
        self._seed: Optional[int] = None

    # ------------------------------------------------------ config API
    def set_batch_size(self, batch_size: int):
        self.batch_size = int(batch_size)

    def set_thread(self, thread_num: int):
        self.thread_num = max(1, int(thread_num))

    def set_filelist(self, filelist: Sequence[str]):
        files = []
        for f in filelist:
            hits = sorted(_glob.glob(f)) or [f]
            files.extend(hits)
        for f in files:
            if not os.path.exists(f):
                raise FileNotFoundError(f"dataset file not found: {f}")
        self.filelist = files

    def set_use_var(self, var_list):
        """Feeding slots, in file order. Accepts static Variables (name
        + shape + dtype) or (name, dtype, dim) tuples."""
        self.slots = []
        for v in var_list:
            if isinstance(v, tuple):
                name, dtype, dim = v
            else:
                name = v.name
                dtype = str(getattr(v, "dtype", "float32"))
                # fluid data vars lead with the batch dim (usually -1):
                # the per-instance dim is the product of the REMAINING
                # dims, whether or not the batch dim is symbolic
                shape = list(v.shape or [])
                data_dims = [d for d in shape[1:] if d and d > 0]
                dim = int(np.prod(data_dims)) if data_dims else 1
            self.slots.append(_SlotSpec(name, "int64" if "int" in dtype
                                        else "float32", int(dim)))

    def set_pipe_command(self, pipe_command: str):
        """ref: each file is piped through this shell command before
        parsing (dataset.py set_pipe_command)."""
        self.pipe_command = pipe_command

    def set_hdfs_config(self, fs_name, fs_ugi):
        raise UnimplementedError(
            "HDFS-backed filelists are not supported in this build; "
            "stage files on local disk (or a FUSE mount) instead")

    def set_download_cmd(self, download_cmd):
        raise UnimplementedError(
            "download_cmd is not supported in this build (zero-egress "
            "environments); pre-download the filelist instead")

    # ----------------------------------------------------- record io
    def _read_file(self, path: str):
        """Line-streamed (never slurps the file — QueueDataset's
        contract is bounded memory regardless of part-file size)."""
        if self.pipe_command:
            with open(path, "rb") as fin:
                proc = subprocess.Popen(self.pipe_command, shell=True,
                                        stdin=fin,
                                        stdout=subprocess.PIPE)
                try:
                    for raw in proc.stdout:
                        line = raw.decode().strip()
                        if line:
                            yield _parse_multislot_line(line, self.slots)
                finally:
                    proc.stdout.close()
                    rc = proc.wait()
            enforce(rc == 0, f"pipe_command {self.pipe_command!r} "
                    f"exited with {rc} on {path}", InvalidArgumentError)
        else:
            with open(path) as f:
                for raw in f:
                    line = raw.strip()
                    if line:
                        yield _parse_multislot_line(line, self.slots)

    def _batches_from_records(self, records):
        """Pack per-instance records into {name: array} batches."""
        bs = self.batch_size
        for lo in range(0, len(records), bs):
            chunk = records[lo:lo + bs]
            if self.drop_last and len(chunk) < bs:
                return
            yield self._pack(chunk)

    def _pack(self, chunk) -> Dict[str, np.ndarray]:
        batch: Dict[str, np.ndarray] = {}
        for si, spec in enumerate(self.slots):
            rows = [rec[si] for rec in chunk]
            if spec.dtype == "float32":
                for r in rows:
                    enforce(r.size == spec.dim,
                            f"dense slot {spec.name!r} expects "
                            f"{spec.dim} values, got {r.size}",
                            InvalidArgumentError)
                batch[spec.name] = np.stack(rows).astype(np.float32)
            else:
                # sparse slot: the declared dim IS the static pad
                # width — rows with more feasigns are truncated (the
                # native parser shares this exact contract; declare a
                # dim sized for the longest expected row)
                width = max(spec.dim, 1)
                dense = np.zeros((len(rows), width), np.int64)
                lens = np.empty((len(rows),), np.int64)
                for i, r in enumerate(rows):
                    n = min(r.size, width)
                    dense[i, :n] = r[:n]
                    lens[i] = n
                batch[spec.name] = dense
                batch[spec.name + "@LEN"] = lens
        return batch

    # --------------------------------------------------- iteration API
    def _batch_iter(self):
        raise NotImplementedError

    def desc(self) -> dict:
        """JSON desc (the data_feed.proto analogue)."""
        return {"batch_size": self.batch_size,
                "thread_num": self.thread_num,
                "filelist": list(self.filelist),
                "pipe_command": self.pipe_command,
                "slots": [{"name": s.name, "dtype": s.dtype,
                           "dim": s.dim} for s in self.slots]}


class QueueDataset(DatasetBase):
    """Streaming dataset (ref: dataset.py QueueDataset / C++
    MultiSlotDataFeed): reader threads shard the filelist and parse
    into a bounded queue; batches are consumed as they arrive —
    nothing is held in memory."""

    def _batch_iter(self):
        enforce(self.filelist, "QueueDataset: set_filelist first",
                PreconditionNotMetError)
        enforce(self.slots, "QueueDataset: set_use_var first",
                PreconditionNotMetError)
        if self.pipe_command is None and not self.drop_last:
            # fast path: the native C++ MultiSlot parser (GIL-free
            # reader threads; framework/data_feed.cc architecture)
            try:
                from .native import MultiSlotFeeder, available
                if available():
                    feeder = MultiSlotFeeder(
                        self.filelist, self.batch_size,
                        [(s.name, s.dtype, s.dim) for s in self.slots],
                        num_threads=self.thread_num)
                    try:
                        yield from feeder
                        return
                    except ValueError as e:
                        raise InvalidArgumentError(str(e)) from e
            except ImportError:
                pass
        q: "queue.Queue" = queue.Queue(maxsize=64)
        n_threads = min(self.thread_num, len(self.filelist))
        files_per = [self.filelist[i::n_threads] for i in range(n_threads)]
        errors: List[BaseException] = []

        def reader(files):
            try:
                pending = []
                for path in files:
                    for rec in self._read_file(path):
                        pending.append(rec)
                        if len(pending) == self.batch_size:
                            q.put(self._pack(pending))
                            pending = []
                if pending and not self.drop_last:
                    q.put(self._pack(pending))
            except BaseException as e:
                errors.append(e)
            finally:
                q.put(None)

        threads = [_obs_threads.spawn(f"pt-dataset-reader-{i}", reader,
                                      args=(fl,), subsystem="dataset")
                   for i, fl in enumerate(files_per)]
        live = len(threads)
        while live:
            item = q.get()
            if item is None:
                live -= 1
                continue
            yield item
        if errors:
            raise errors[0]


class InMemoryDataset(DatasetBase):
    """ref: dataset.py InMemoryDataset — load once, shuffle in memory,
    then batch; global_shuffle partitions by instance hash across
    trainers over the PS plane."""

    def __init__(self):
        super().__init__()
        self._records: List = []
        self._loaded = False

    def load_into_memory(self):
        enforce(self.filelist, "InMemoryDataset: set_filelist first",
                PreconditionNotMetError)
        enforce(self.slots, "InMemoryDataset: set_use_var first",
                PreconditionNotMetError)
        n_threads = min(self.thread_num, len(self.filelist))
        # per-FILE result slots keyed by filelist index, concatenated
        # in filelist order afterwards: the record order (and thus any
        # index-keyed global partition) is deterministic regardless of
        # thread scheduling
        per_file: List[Optional[List]] = [None] * len(self.filelist)
        errors: List[BaseException] = []

        def reader(tidx):
            try:
                for fi in range(tidx, len(self.filelist), n_threads):
                    per_file[fi] = list(self._read_file(
                        self.filelist[fi]))
            except BaseException as e:
                errors.append(e)

        threads = [_obs_threads.spawn(f"pt-dataset-load-{i}", reader,
                                      args=(i,), subsystem="dataset")
                   for i in range(n_threads)]
        [t.join() for t in threads]
        if errors:
            raise errors[0]
        records: List = []
        for chunk in per_file:
            records.extend(chunk or [])
        self._records = records
        self._loaded = True

    def local_shuffle(self, seed: Optional[int] = None):
        enforce(self._loaded, "load_into_memory before local_shuffle",
                PreconditionNotMetError)
        rs = np.random.RandomState(self._seed if seed is None else seed)
        rs.shuffle(self._records)

    def global_shuffle(self, ps_client=None, trainer_id: int = 0,
                       num_trainers: int = 1, seed: int = 0):
        """ref: DatasetImpl global shuffle ships instances between
        trainers via fleet RPC. Here: every trainer keeps the hash
        partition assigned to it (deterministic across trainers given
        the same filelist), synchronized through a PS barrier when a
        client is given."""
        enforce(self._loaded, "load_into_memory before global_shuffle",
                PreconditionNotMetError)
        if ps_client is not None:
            ps_client.barrier("dataset_global_shuffle_in")
        if num_trainers > 1:
            kept = []
            for i, rec in enumerate(self._records):
                h = hash((seed, i)) % num_trainers
                if h == trainer_id:
                    kept.append(rec)
            self._records = kept
        self.local_shuffle(seed=seed + trainer_id)
        if ps_client is not None:
            ps_client.barrier("dataset_global_shuffle_out")

    def release_memory(self):
        self._records = []
        self._loaded = False

    def get_memory_data_size(self) -> int:
        return len(self._records)

    def get_shuffle_data_size(self) -> int:
        return len(self._records)

    def _batch_iter(self):
        enforce(self._loaded, "InMemoryDataset: load_into_memory first",
                PreconditionNotMetError)
        yield from self._batches_from_records(self._records)


class DatasetFactory:
    """ref: fluid/dataset.py:22."""

    _CLASSES = {"QueueDataset": QueueDataset,
                "InMemoryDataset": InMemoryDataset}

    def create_dataset(self, datafeed_class: str = "QueueDataset"):
        cls = self._CLASSES.get(datafeed_class)
        if cls is None:
            raise InvalidArgumentError(
                f"dataset class {datafeed_class!r} does not exist "
                f"(choose from {sorted(self._CLASSES)})")
        return cls()
