"""Trainer / DeviceWorker runtime (ref: C++ framework/trainer.h:51
TrainerBase/MultiTrainer/DistMultiTrainer, device_worker.h:146
DeviceWorker/HogwildWorker/DownpourWorker; python config mirrors
fluid/trainer_desc.py, device_worker.py, trainer_factory.py).

A copy of ``paddle_tpu/trainer.py`` over the port's scope and tensor.
Reference architecture: one thread per device, each running the op
list directly against a thread-local scope, fed by DataFeed channels;
PS workers interleave pull_dense/push_sparse RPC with compute. Here
one executor drives one device, so thread-per-device dissolves. What
remains real, and is kept:

- reader parallelism (Dataset threads shard and parse files),
- the Trainer/DeviceWorker *config* surface (TrainerDesc → JSON desc
  in place of trainer_desc.proto) driving executor entry points,
- Hogwild semantics = consecutive ``Executor.run`` steps over the
  stream on the executor's device,
- Downpour (PS) semantics: pull dense vars from the pserver before
  the pass, push per-batch grads (async) through a bound PSClient
  (duck-typed; the parameter server is ROADMAP Queue 1 item 8).

A batch's ``<name>@LEN`` sparse-slot lengths are fed only when the
program declares a var of that name. A fluid ``data(lod_level=1)``
var pairs with ``<name>@seq_len`` (``static.data``), which the
dataset does not produce: such a slot is fed as its padded ids and its
length companion stays unfed, as in the JAX package.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional

import numpy as np

from .core.enforce import InvalidArgumentError, enforce

__all__ = ["TrainerDesc", "MultiTrainer", "DistMultiTrainer",
           "DeviceWorker", "Hogwild", "DownpourSGD", "TrainerFactory"]


class DeviceWorker:
    """ref: fluid/device_worker.py DeviceWorker — config object the
    trainer desc embeds."""

    name = "DeviceWorkerBase"

    def __init__(self):
        self._fleet_desc = None
        self._infer = False

    def _set_fleet_desc(self, fleet_desc):
        self._fleet_desc = fleet_desc

    def _set_infer(self, infer: bool):
        self._infer = bool(infer)

    def _gen_worker_desc(self) -> dict:
        return {"class": self.name, "infer": self._infer}


class Hogwild(DeviceWorker):
    """ref: device_worker.py Hogwild / C++ HogwildWorker
    (device_worker.h:230)."""

    name = "HogwildWorker"


class DownpourSGD(DeviceWorker):
    """ref: device_worker.py DownpourSGD / C++ DownpourWorker
    (device_worker.h:261) — PS-coupled worker. dense_vars are pulled
    from the pserver before the pass and their grads pushed per batch."""

    name = "DownpourWorker"

    def __init__(self, dense_vars: Optional[List[str]] = None,
                 sparse_tables: Optional[List[str]] = None):
        super().__init__()
        self.dense_vars = list(dense_vars or [])
        self.sparse_tables = list(sparse_tables or [])

    def _gen_worker_desc(self) -> dict:
        d = super()._gen_worker_desc()
        d["dense_vars"] = self.dense_vars
        d["sparse_tables"] = self.sparse_tables
        return d


class TrainerDesc:
    """ref: fluid/trainer_desc.py:24 — fills trainer_desc.proto; here
    the desc is a JSON-able dict with the same fields."""

    def __init__(self):
        self._worker: DeviceWorker = Hogwild()
        self._thread_num = 1
        self._infer = False
        self._debug = False
        self._fetch_vars: List[str] = []
        self._fetch_info: List[str] = []
        self._print_period = 100
        self._program = None

    def _set_device_worker(self, worker: DeviceWorker):
        self._worker = worker

    def _set_thread(self, thread_num: int):
        self._thread_num = max(1, int(thread_num))

    def _set_infer(self, infer: bool):
        self._infer = bool(infer)
        self._worker._set_infer(infer)

    def _set_debug(self, debug: bool):
        self._debug = bool(debug)

    def _set_program(self, program):
        self._program = program

    def _set_fetch_var_and_info(self, fetch_vars, fetch_info,
                                print_period):
        self._fetch_vars = [getattr(v, "name", v) for v in fetch_vars]
        self._fetch_info = list(fetch_info or self._fetch_vars)
        self._print_period = int(print_period)

    def _gen_trainer_desc(self) -> dict:
        return {"class": self.__class__.__name__,
                "thread_num": self._thread_num,
                "device_worker": self._worker._gen_worker_desc(),
                "fetch_vars": self._fetch_vars,
                "fetch_info": self._fetch_info,
                "print_period": self._print_period,
                "debug": self._debug}

    def _desc(self) -> str:
        return json.dumps(self._gen_trainer_desc(), indent=2)


class MultiTrainer(TrainerDesc):
    """ref: trainer_desc.py MultiTrainer / C++ MultiTrainer
    (trainer.h:95)."""


class DistMultiTrainer(TrainerDesc):
    """ref: trainer_desc.py DistMultiTrainer (trainer.h:121) — the PS
    variant; pairs with DownpourSGD workers."""


class TrainerFactory:
    """ref: fluid/trainer_factory.py — builds (trainer, worker) from
    an opt_info dict."""

    def _create_trainer(self, opt_info: Optional[dict] = None
                        ) -> TrainerDesc:
        opt_info = opt_info or {}
        trainer_name = opt_info.get("trainer", "MultiTrainer")
        worker_name = opt_info.get("device_worker", "Hogwild")
        trainers = {"MultiTrainer": MultiTrainer,
                    "DistMultiTrainer": DistMultiTrainer}
        workers = {"Hogwild": Hogwild, "DownpourSGD": DownpourSGD}
        enforce(trainer_name in trainers,
                f"unknown trainer {trainer_name!r}", InvalidArgumentError)
        enforce(worker_name in workers,
                f"unknown device worker {worker_name!r}",
                InvalidArgumentError)
        trainer = trainers[trainer_name]()
        if worker_name == "DownpourSGD":
            worker = DownpourSGD(
                dense_vars=opt_info.get("dense_vars"),
                sparse_tables=opt_info.get("sparse_tables"))
        else:
            worker = workers[worker_name]()
        if "fleet_desc" in opt_info:
            worker._set_fleet_desc(opt_info["fleet_desc"])
        trainer._set_device_worker(worker)
        if "thread" in opt_info:
            trainer._set_thread(opt_info["thread"])
        return trainer


def run_trainer(executor, program, dataset, trainer: TrainerDesc,
                scope=None, ps_client=None,
                fetch_handler=None) -> Dict[str, List[float]]:
    """The MultiTrainer::Run analogue: stream dataset batches through
    the jitted program. Returns {fetch_name: [values at print ticks]}.

    fetch_handler (ref: executor.py FetchHandler): called every
    print_period steps with {name: np.ndarray} — an object with a
    .handler method or a plain callable.

    Downpour coupling: with a DownpourSGD worker and a bound PSClient,
    dense_vars are pulled into the scope before the pass and each
    batch's fresh values pushed back as deltas (async PS contract)."""
    from .core.scope import global_scope
    from .core.tensor import TpuTensor

    scope = scope or global_scope()
    worker = trainer._worker
    desc = trainer._gen_trainer_desc()
    fetch_vars = desc["fetch_vars"]
    period = max(1, desc["print_period"])
    is_downpour = isinstance(worker, DownpourSGD)

    if is_downpour and ps_client is not None:
        for name in worker.dense_vars:
            value = ps_client.pull_dense(name)
            scope.var(name).set(TpuTensor(value))

    history: Dict[str, List[float]] = {n: [] for n in fetch_vars}
    prev_dense: Dict[str, np.ndarray] = {}
    if is_downpour and ps_client is not None:
        prev_dense = {n: np.asarray(scope.find_var(n).get().numpy())
                      for n in worker.dense_vars}

    block = program.global_block()
    step = 0
    for batch in dataset._batch_iter():
        # "<name>@LEN" sparse-slot lengths are fed when the program
        # declares a matching var (the dense+Length LoD mapping);
        # otherwise they're dataset metadata and are dropped
        feed = {k: v for k, v in batch.items()
                if not k.endswith("@LEN") or block.has_var(k)}
        fetches = executor.run(program, feed=feed,
                               fetch_list=fetch_vars, scope=scope)
        step += 1
        if fetch_vars and step % period == 0:
            for name, val in zip(fetch_vars, fetches):
                history[name].append(float(np.asarray(val).mean()))
            if fetch_handler is not None:
                payload = {n: np.asarray(v)
                           for n, v in zip(fetch_vars, fetches)}
                handler = getattr(fetch_handler, "handler",
                                  fetch_handler)
                handler(payload)
        if is_downpour and ps_client is not None:
            for name in worker.dense_vars:
                fresh = np.asarray(scope.find_var(name).get().numpy())
                # push the local update as a delta; the pserver's
                # add_delta keeps trainers loosely consistent (async)
                ps_client.push_delta(name, fresh - prev_dense[name])
                merged = ps_client.pull_dense(name)
                scope.var(name).set(TpuTensor(merged))
                prev_dense[name] = merged
    return history


class DataFeedDesc:
    """ref: fluid/data_feed_desc.py:21 — wraps a data_feed.proto text
    file describing the MultiSlot input format. The proto-text subset
    those files use (name/batch_size/multi_slot_desc.slots) is parsed
    directly; accessors mirror the reference (set_batch_size,
    set_dense_slots, set_use_slots, desc)."""

    def __init__(self, proto_file: str):
        self._name = "MultiSlotDataFeed"
        self._batch_size = 1
        self._slots = []        # [{name, type, is_dense, is_used}]
        with open(proto_file) as f:
            cur = None
            for raw in f:
                line = raw.strip().rstrip("{").strip()
                if line.startswith("name:") and cur is None:
                    self._name = line.split(":", 1)[1].strip().strip('"')
                elif line.startswith("batch_size:"):
                    self._batch_size = int(line.split(":", 1)[1])
                elif line.startswith("slots"):
                    cur = {"name": "", "type": "float", "is_dense": False,
                           "is_used": False}
                    self._slots.append(cur)
                elif cur is not None and line.startswith("name:"):
                    cur["name"] = line.split(":", 1)[1].strip().strip('"')
                elif cur is not None and line.startswith("type:"):
                    cur["type"] = line.split(":", 1)[1].strip().strip('"')
                elif cur is not None and line.startswith("is_dense:"):
                    cur["is_dense"] = "true" in line
                elif cur is not None and line.startswith("is_used:"):
                    cur["is_used"] = "true" in line
        self._index = {s["name"]: s for s in self._slots}

    def set_batch_size(self, batch_size: int):
        self._batch_size = int(batch_size)

    def set_dense_slots(self, dense_slots_name):
        for n in dense_slots_name:
            enforce(n in self._index,
                    f"slot {n!r} not declared in the proto file",
                    InvalidArgumentError)
            self._index[n]["is_dense"] = True

    def set_use_slots(self, use_slots_name):
        for n in use_slots_name:
            enforce(n in self._index,
                    f"slot {n!r} not declared in the proto file",
                    InvalidArgumentError)
            self._index[n]["is_used"] = True

    def desc(self) -> str:
        """Proto-text round trip (ref: desc() returns the message)."""
        lines = [f'name: "{self._name}"',
                 f"batch_size: {self._batch_size}",
                 "multi_slot_desc {"]
        for s in self._slots:
            lines += ["  slots {",
                      f'    name: "{s["name"]}"',
                      f'    type: "{s["type"]}"',
                      f'    is_dense: {str(s["is_dense"]).lower()}',
                      f'    is_used: {str(s["is_used"]).lower()}',
                      "  }"]
        lines.append("}")
        return "\n".join(lines) + "\n"
