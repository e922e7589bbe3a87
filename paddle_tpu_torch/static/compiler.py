"""CompiledProgram + Build/ExecutionStrategy (ref:
python/paddle/fluid/compiler.py:87 CompiledProgram, with_data_parallel
:160 -> core.ParallelExecutor :394; framework/details/build_strategy.h).

Port of ``paddle_tpu/static/compiler.py``. The reference's
``with_data_parallel`` replicates the graph on each device and
all-reduces the gradients; the JAX package shards the feeds over a
device mesh and lets GSPMD insert the all-reduces. The port runs on one
device: ``with_data_parallel`` over one place runs the program as it is
(a data-parallel world of 1, where ``CoeffNumDevice`` divides the loss
gradient by 1). More than one place raises: data parallelism across
cards is ROADMAP Queue 1 item 8, and nothing runs the places one after
another in its stead.

``BuildStrategy`` / ``ExecutionStrategy`` keep the reference's fields
and defaults; the executor interprets the block op by op, so the fusion,
memory and scheduling knobs are accepted and change nothing.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..core.enforce import (InvalidArgumentError, UnimplementedError,
                            enforce)
from ..core.program import Program

__all__ = ["CompiledProgram", "BuildStrategy", "ExecutionStrategy"]


class BuildStrategy:
    """ref: framework/details/build_strategy.h: graph-build knobs. The
    fusion passes, reduce strategy, in-place and memory reuse are
    accepted and ignored; gradient_scale_strategy CoeffNumDevice divides
    by the data-parallel size, 1 here."""

    class ReduceStrategy:
        AllReduce = 0
        Reduce = 1

    class GradientScaleStrategy:
        CoeffNumDevice = 0
        One = 1
        Customized = 2

    def __init__(self):
        self.reduce_strategy = BuildStrategy.ReduceStrategy.AllReduce
        self.gradient_scale_strategy = \
            BuildStrategy.GradientScaleStrategy.CoeffNumDevice
        self.fuse_elewise_add_act_ops = False
        self.fuse_bn_act_ops = False
        self.fuse_all_optimizer_ops = False
        self.fuse_all_reduce_ops = False
        self.enable_inplace = True
        self.memory_optimize = True
        self.sync_batch_norm = False
        self.num_trainers = 1
        self.trainer_id = 0


class ExecutionStrategy:
    """ref: framework/details/execution_strategy.h: scheduler knobs,
    kept for API parity (the block runs op by op on one stream)."""

    def __init__(self):
        self.num_threads = 0
        self.num_iteration_per_drop_scope = 100
        self.num_iteration_per_run = 1
        self.use_thread_barrier = False


def _place(p) -> torch.device:
    return p if isinstance(p, torch.device) else torch.device(p)


class CompiledProgram:
    """ref: fluid/compiler.py:87: a Program wrapped for data-parallel or
    inference execution. ``Executor.run`` takes it where it takes a
    Program."""

    def __init__(self, program_or_graph, build_strategy: Optional[
            BuildStrategy] = None):
        enforce(isinstance(program_or_graph, Program),
                "CompiledProgram wraps a Program", InvalidArgumentError)
        self.program = program_or_graph
        self.build_strategy = build_strategy or BuildStrategy()
        self.exec_strategy = None
        self._places = None
        self._loss_name = None
        self._is_inference = False
        self._infer_config = None

    def _with_inference_optimize(self, config) -> "CompiledProgram":
        """ref: compiler.py:199: mark the program as an inference target
        driven by positional C-API feeds (``Executor.run`` with a list of
        ``inference.capi.PaddleTensor``s in the feed-target order gives
        the fetch targets as ``PaddleTensor``s); the config is kept for
        introspection."""
        self._is_inference = True
        self._infer_config = config
        return self

    def with_data_parallel(self, loss_name: Optional[str] = None,
                           build_strategy: Optional[BuildStrategy] = None,
                           exec_strategy: Optional[ExecutionStrategy] = None,
                           share_vars_from=None,
                           places: Optional[Sequence] = None
                           ) -> "CompiledProgram":
        """ref: compiler.py:160. ``places`` defaults to the port's one
        device (``device.get_device()``); one place runs the program as it
        is. More than one raises ``UnimplementedError``."""
        if build_strategy is not None:
            self.build_strategy = build_strategy
        self.exec_strategy = exec_strategy or ExecutionStrategy()
        if places is None:
            from ..device import get_device
            places = [get_device()]
        places = [_place(p) for p in places]
        enforce(len(places) >= 1, "with_data_parallel needs at least one "
                "place", InvalidArgumentError)
        if len(places) > 1:
            raise UnimplementedError(
                f"with_data_parallel over {len(places)} places: data "
                f"parallelism across cards is not ported (ROADMAP Queue 1 "
                f"item 8)")
        self._places = places
        self._loss_name = loss_name
        return self

    @property
    def data_parallel_world_size(self) -> int:
        return len(self._places) if self._places is not None else 1

    @property
    def place(self) -> Optional[torch.device]:
        """The one place ``with_data_parallel`` runs on, or None."""
        return self._places[0] if self._places else None


class ParallelExecutor:
    """1.x ParallelExecutor (ref: fluid/parallel_executor.py): a front
    over ``CompiledProgram.with_data_parallel`` and the regular
    Executor."""

    def __init__(self, use_cuda, loss_name=None, main_program=None,
                 share_vars_from=None, exec_strategy=None,
                 build_strategy=None, num_trainers=1, trainer_id=0,
                 scope=None):
        from ..core.executor import Executor
        from ..core.program import default_main_program
        program = main_program or default_main_program()
        self._compiled = CompiledProgram(
            program, build_strategy).with_data_parallel(
                loss_name=loss_name, exec_strategy=exec_strategy,
                share_vars_from=getattr(share_vars_from, "_compiled",
                                        share_vars_from))
        self._exe = Executor()
        self._scope = scope

    def run(self, fetch_list, feed=None, feed_dict=None,
            return_numpy=True):
        """ref: parallel_executor.py run: feed_dict is the deprecated 1.x
        spelling of feed."""
        feed = feed if feed is not None else feed_dict
        return self._exe.run(self._compiled, feed=feed,
                             fetch_list=list(fetch_list),
                             scope=self._scope,
                             return_numpy=return_numpy)

    def drop_local_exe_scopes(self):
        """ref: parallel_executor.py drop_local_exe_scopes: there are no
        per-device scopes to drop."""
        return None
