"""Executor: runs a Program block op by op on one device.

Port of ``paddle_tpu/core/executor.py`` (ref:
paddle/fluid/framework/executor.cc:180 Run, :376 Prepare; python wrapper
python/paddle/fluid/executor.py:915). Where the JAX executor traces the
whole block into one jitted XLA program, this one interprets the block
in eager torch, op after op, on :func:`paddle_tpu_torch.device.get_device`
(or the ``place`` it was given): the reference's own design, each op
dispatching to torch's CUDA kernels (cuBLAS, cuDNN) and the port's own
(K1-K3 for ``flash_attention``).

Grad ops (``<type>_grad``, ``core/backward.py``) take their gradient
from torch autograd, by one of two routes:

- record: a forward op that has a grad op later in the block runs with
  autograd on, its graph chained to the graphs of the recorded ops
  before it as in dygraph, and keeps its graph's edges, keyed by the
  op's index, until its grad op takes the gradients of its own inputs
  from them (``torch.autograd.grad`` between the two sets of edges) and
  frees its buffers; the forward runs once, and what the graph does not
  save is freed as in dygraph.
- recompute: a grad op whose forward ran in another ``run`` (a program
  of grad ops alone) runs its forward again under autograd, as the JAX
  package's grad ops all do (XLA's CSE removes the copy there; here it
  is a second run of the forward's kernels).

A forward op with a gradient of its own (``OpDef.grad``: ``dropout``,
whose second run would draw another mask) is never recorded: its grad
op calls that gradient on the forward's saved outputs, as the JAX
executor does.

Names written twice (``batch_norm``'s ``MeanOut`` is its ``Mean``, an
optimizer's ``ParamOut`` its ``Param``) rebind the name in the run's
environment: no tensor is changed in place, so a kept graph still holds
the values its forward saw. A name leaves the environment after the
last op that touches it, unless it is fetched or goes back to the scope
(the reference's eager deletion, executor.cc's garbage collector).
Persistables the block writes go back to the scope only after the whole
block has run, so a failed run leaves the scope as it was.

A feed of flat rows with a level-1 LoD (a ``TpuTensor`` or a
``LoDTensorView`` over one) becomes the padded [B, T, ...] tensor and
its ``{name}@seq_len`` lengths where the program declares that
companion (``static.data(..., lod_level=1)``), as the JAX executor's
``_lod_to_padded`` does; otherwise the rows stay flat, the scope holds
the fed tensor, and the run publishes its LoD through ``core.lodctx``,
interpreting the block as the JAX executor's eager path does.

Control-flow ops (``ops/control_flow_ops.py``) interpret their
sub-blocks op by op through :func:`run_op_desc`, finding them in the
program :func:`current_program` publishes for the run. A control-flow op
is one forward op to the grad route: recorded, its graph runs through
every op of every iteration it ran, and its grad op takes the gradients
of its ``Captured`` inputs (the weights a body reads) from it.
"""
from __future__ import annotations

import contextlib
import threading
from collections import Counter
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from . import flags, lodctx, rng
from .dtype import from_host, host_array
from .enforce import (EnforceNotMet, InvalidArgumentError, NotFoundError,
                      PreconditionNotMetError, UnimplementedError, enforce,
                      op_scope)
from .program import GRAD_SUFFIX, Block, OpDesc, Program, default_main_program
from .registry import OpInfoMap, not_ported, vjp_backward, vjp_forward
from .scope import Scope, global_scope
from .tensor import TpuTensor

_SKIP_OPS = frozenset({"feed", "fetch"})

# the op types whose JAX kernels read their inputs on the host on every
# call: a block holding one runs the JAX executor's eager interpreter,
# where the LoD side channel (core/lodctx.py) is active
REFERENCE_EAGER_OPS = frozenset({
    "split_lod_tensor", "merge_lod_tensor", "merge_lod_tensor_infer",
    "assert", "tdm_sampler", "filter_by_instag", "py_func", "save",
    "save_combine", "run_program", "tree_conv",
    # ops/rcnn_ops.py: all but target_assign and multiclass_nms2
    "generate_proposals", "rpn_target_assign", "retinanet_target_assign",
    "generate_proposal_labels", "generate_mask_labels",
    "collect_fpn_proposals", "distribute_fpn_proposals",
    "mine_hard_examples", "box_decoder_and_assign", "locality_aware_nms",
    "detection_map", "roi_perspective_transform",
    "retinanet_detection_output"})

# attrs naming a control-flow op's sub-blocks
_BLOCK_ATTRS = ("cond_block", "body_block", "true_block", "false_block",
                "sub_block")

# ---- program context: control-flow ops resolve their sub-blocks through
# the Program being run (the reference's ExecutorPrepareContext carrying
# the ProgramDesc into nested block execution, executor.cc:376) ----
_prog_tls = threading.local()


def current_program():
    return getattr(_prog_tls, "program", None)


@contextlib.contextmanager
def program_ctx(program):
    prev = getattr(_prog_tls, "program", None)
    _prog_tls.program = program
    try:
        yield
    finally:
        _prog_tls.program = prev


def sub_blocks(program, op: OpDesc) -> list:
    """The sub-blocks a control-flow op interprets."""
    idx = [op.attrs[a] for a in _BLOCK_ATTRS if op.attrs.get(a) is not None]
    idx += list(op.attrs.get("blocks") or [])
    return [program.blocks[int(i)] for i in idx]


def random_draws(program, block: Block) -> int:
    """The random ops a run of ``block`` draws for, once each: sub-blocks
    count once, as a body traced once under ``lax.scan`` draws in the JAX
    package."""
    n = 0
    for op in block.ops:
        if op.type in rng.RANDOM_OPS:
            n += 1
        elif program is not None:
            n += sum(random_draws(program, b) for b in sub_blocks(program, op))
    return n


def _reference_eager(program, block: Block) -> bool:
    """Whether the JAX executor would interpret ``block`` eagerly for its
    ops: a host-side op anywhere in it, sub-blocks included."""
    for op in block.ops:
        if op.type in REFERENCE_EAGER_OPS:
            return True
        if any(_reference_eager(program, b) for b in sub_blocks(program, op)):
            return True
    return False


def _name_of(fetch) -> str:
    if isinstance(fetch, str):
        return fetch
    name = getattr(fetch, "name", None)
    enforce(name is not None, f"cannot resolve fetch target {fetch!r}")
    return name


def _fwd_attrs(op: OpDesc) -> dict:
    return {k: v for k, v in op.attrs.items() if not k.startswith("__")}


def _write_outputs(op: OpDesc, outs: Dict[str, list], env):
    for slot, names in op.outputs.items():
        vals = outs.get(slot)
        if vals is None:
            continue
        for name, val in zip(names, vals):
            if name and val is not None:
                env[name] = val


def run_op_desc(op: OpDesc, env: Dict[str, torch.Tensor]):
    """Run one OpDesc against an env of tensors (the analogue of
    OperatorWithKernel::RunImpl, ref: operator.cc:1017): gather inputs,
    run the registered compute (or the generic gradient of a ``*_grad``
    op, by recompute), write the outputs. The op is the LoD side
    channel's current op while it runs."""
    with op_scope(op.type), lodctx.op_scope(op):
        Executor._run_op(op, env, None, None, None)


def _custom_grad(fwd_type: str) -> bool:
    info = OpInfoMap.instance()
    return info.has(fwd_type) and info.get(fwd_type).grad is not None


def _run_generic_grad(op: OpDesc, env, record=None):
    """A grad op: the input gradients of its forward op, from ``record``
    (the forward's kept graph), from the op's own gradient, or by running
    the forward again. The grad OpDesc carries the forward's slot layout
    in its attrs."""
    fwd_type = op.attrs.get("__fwd_type__") or op.type[:-len("_grad")]
    in_slots = op.attrs.get("__fwd_input_slots__") or []
    out_slots = op.attrs.get("__fwd_output_slots__") or []
    out_grads = {s: [env.get(n) if n else None
                     for n in op.inputs.get(s + GRAD_SUFFIX, [])]
                 for s in out_slots}
    if record is None:
        opdef = OpInfoMap.instance().get(fwd_type)
        inputs = {s: [env[n] for n in op.inputs.get(s, []) if n]
                  for s in in_slots}
        if opdef.grad is not None:
            outputs = {s: [env[n] for n in op.inputs.get(s, []) if n]
                       for s in out_slots}
            in_grads = opdef.grad(inputs, outputs, out_grads, _fwd_attrs(op))
            _write_outputs(op, {s + GRAD_SUFFIX: g
                                for s, g in in_grads.items()}, env)
            return
        _, record = vjp_forward(opdef, inputs, _fwd_attrs(op))
    in_grads = vjp_backward(record, out_grads)
    _write_outputs(op, {s + GRAD_SUFFIX: g for s, g in in_grads.items()},
                   env)


def _analyze_block(block: Block, feed_names) -> tuple:
    """Classify vars: external reads (scope state) vs written names."""
    feed_set = set(feed_names)
    written: List[str] = []
    written_set = set()
    external: List[str] = []
    external_set = set()
    for op in block.ops:
        if op.type in _SKIP_OPS:
            continue
        for name in op.input_names():
            if (name and name not in written_set and name not in feed_set
                    and name not in external_set):
                external.append(name)
                external_set.add(name)
        for name in op.output_names():
            if name and name not in written_set:
                written.append(name)
                written_set.add(name)
    return external, written


def _pair_grad_ops(block: Block) -> Dict[int, int]:
    """{grad op index: index of the forward op it differentiates}. The
    forward is the latest earlier op, not yet paired, of the grad op's
    forward type with the same inputs, outputs and attrs: append_backward
    emits grad ops in reverse forward order, so an op repeated in place
    pairs with its own grad op. An op with a gradient of its own is not
    paired: its grad op reads the forward's outputs instead."""
    pairs: Dict[int, int] = {}
    taken = set()
    for j, op in enumerate(block.ops):
        fwd_type = op.attrs.get("__fwd_type__")
        if fwd_type is None or _custom_grad(fwd_type):
            continue
        ins = {s: op.inputs.get(s, [])
               for s in op.attrs.get("__fwd_input_slots__") or []}
        outs = {s: op.inputs.get(s, [])
                for s in op.attrs.get("__fwd_output_slots__") or []}
        attrs = _fwd_attrs(op)
        for i in range(j - 1, -1, -1):
            f = block.ops[i]
            if (i not in taken and f.type == fwd_type and f.inputs == ins
                    and f.outputs == outs and f.attrs == attrs):
                pairs[j] = i
                taken.add(i)
                break
    return pairs


class _Analysis:
    __slots__ = ("fetch_only", "const_names", "mut_names", "writeback",
                 "pairs", "recorded", "live", "dead_after", "salts",
                 "eager")

    def __init__(self, program, block: Block, feed_names, fetch_names,
                 record: bool):
        external, written = _analyze_block(block, feed_names)
        ext_set, written_set = set(external), set(written)
        # fetch targets the block never touches (e.g. reading a param
        # after startup) are pulled straight from the scope
        self.fetch_only = [n for n in dict.fromkeys(fetch_names)
                           if n not in written_set and n not in feed_names
                           and n not in ext_set]
        external += self.fetch_only
        ext_set.update(self.fetch_only)
        self.const_names = [n for n in external if n not in written_set]
        self.mut_names = sorted(ext_set & written_set)
        # persistable outputs not read first (e.g. freshly created params
        # in a startup program) also go back to the scope
        out_persist = [n for n in written
                       if block.has_var(n) and block.var(n).persistable]
        self.writeback = sorted(set(self.mut_names) | set(out_persist))
        self.pairs = _pair_grad_ops(block)
        # {index of an op that draws: draws before it in the block},
        # counted over every op, run or not, a control-flow op drawing
        # for the random ops of its sub-blocks: the op's RNG salt. A
        # paired grad op takes its forward's, so a forward run again for
        # its gradient draws the masks it drew
        self.salts, base = {}, 0
        for i, op in enumerate(block.ops):
            n = 1 if op.type in rng.RANDOM_OPS else sum(
                random_draws(program, b) for b in sub_blocks(program, op))
            if n:
                self.salts[i] = base
            base += n
        self.salts.update({j: self.salts[i] for j, i in self.pairs.items()
                           if i in self.salts})
        self.eager = _reference_eager(program, block)
        self.recorded = frozenset(self.pairs.values())
        # the ops to run: those whose outputs a later op reads or the run
        # keeps (fetches, writebacks), a recorded forward whose grad op
        # runs, and an op of no registered type (so it raises). The rest
        # are dead (append_backward's closing assigns of merged gradients
        # nobody fetches) and are skipped, as XLA drops them from the JAX
        # package's jitted block.
        keep = set(fetch_names) | set(self.writeback)
        grad_op = {i: j for j, i in self.pairs.items()}
        info = OpInfoMap.instance()
        live, self.live = set(keep), set()
        for idx in range(len(block.ops) - 1, -1, -1):
            op = block.ops[idx]
            outs = [n for n in op.output_names() if n]
            if op.type in _SKIP_OPS or not (
                    live.intersection(outs) or
                    (record and grad_op.get(idx) in self.live) or
                    not info.has(op.attrs.get("__fwd_type__", op.type))):
                continue
            self.live.add(idx)
            live.difference_update(outs)
            live.update(n for n in _reads(op, record and idx in self.pairs)
                        if n)
        # {op index: names no later op touches}, fetches and writebacks
        # aside: the env drops them once that op has run. A grad op reads
        # its out-grads and, unless its forward's graph is kept, its
        # forward's inputs; never its forward's outputs
        last = {}
        for idx in sorted(self.live):
            op = block.ops[idx]
            for n in _reads(op, record and idx in self.pairs) + \
                    op.output_names():
                if n:
                    last[n] = idx
        self.dead_after: Dict[int, List[str]] = {}
        for n, idx in last.items():
            if n not in keep:
                self.dead_after.setdefault(idx, []).append(n)


def _reads(op: OpDesc, recorded: bool) -> List[str]:
    """The names ``op`` reads from the env when it runs."""
    fwd_type = op.attrs.get("__fwd_type__")
    if fwd_type is None or _custom_grad(fwd_type):
        return op.input_names()
    names = [n for s in op.attrs.get("__fwd_output_slots__") or []
             for n in op.inputs.get(s + GRAD_SUFFIX, [])]
    if not recorded:
        names += [n for s in op.attrs.get("__fwd_input_slots__") or []
                  for n in op.inputs.get(s, [])]
    return names


SEQ_LEN_SUFFIX = "@seq_len"


def _feed_tensor(value, dev) -> torch.Tensor:
    if isinstance(value, TpuTensor):
        value = value.value
    if isinstance(value, torch.Tensor):
        return value.to(dev)
    return from_host(value).to(dev)


def lod_to_padded(t: TpuTensor, dev):
    """Flat rows + level-1 LoD -> (padded [B, T, ...], lengths [B]
    int64) on ``dev``, T the longest row (at least 1), padding zero: the
    JAX executor's ``_lod_to_padded``."""
    offs = [int(o) for o in t.lod[-1]]
    lens = [b - a for a, b in zip(offs, offs[1:])]
    rows = t.value.to(dev)
    tail = tuple(rows.shape[1:])
    tmax = max(max(lens), 1) if lens else 1
    padded = rows.new_zeros((len(lens), tmax) + tail)
    if lens and offs[-1] > offs[0]:
        seqs = rows[offs[0]:offs[-1]].split(lens)
        got = torch.nn.utils.rnn.pad_sequence(seqs, batch_first=True)
        padded[:, :got.shape[1]] = got
    return padded, from_host(np.asarray(lens, np.int64)).to(dev)


def _to_numpy(v: torch.Tensor) -> np.ndarray:
    """A host copy in the fluid Executor's convention: a 0-d fetch comes
    back as shape [1] (the reference's reductions emit [1] tensors);
    bfloat16, which numpy lacks, as ml_dtypes' bfloat16 (float32 where
    that does not import, ``dtype.host_array``)."""
    arr = host_array(v)
    return arr.reshape(1) if arr.ndim == 0 else arr


class Executor:
    """User-facing executor (ref: python/paddle/fluid/executor.py:915).

    ``place``: the device the block runs on ("cpu", "cuda", a
    ``torch.device``); None is :func:`paddle_tpu_torch.device.get_device`
    at each run, which raises when there is no card and the caller has
    not asked for the CPU. ``stats`` counts block-analysis cache hits and
    misses."""

    # True sends every grad op down the recompute route (see the module
    # docstring); set on an instance to check or time that route
    _force_recompute = False

    def __init__(self, place=None):
        self.place = place
        self._cache: Dict[tuple, _Analysis] = {}
        self._step = 0
        self.stats = Counter()

    def close(self):
        self._cache.clear()

    def _device(self) -> torch.device:
        if self.place is None:
            from ..device import get_device
            return get_device()
        return torch.device(self.place)

    # -- public API --
    def run(self, program: Optional[Program] = None, feed: Optional[Dict] = None,
            fetch_list: Optional[Sequence] = None, scope: Optional[Scope] = None,
            return_numpy: bool = True, use_program_cache: bool = True):
        """Run the program's global block once; returns the fetches as
        numpy arrays (``return_numpy``, one device-to-host copy each) or
        as ``TpuTensor`` on the device. ``program`` may be a
        ``CompiledProgram`` (ref: executor.py:1103 dispatches Program and
        CompiledProgram): it runs its Program, on its one place where
        ``with_data_parallel`` gave it one."""
        from ..device import op_device
        place = None
        if program is not None and hasattr(program, "with_data_parallel"):
            compiled, program = program, program.program
            if compiled._is_inference and isinstance(feed, (list, tuple)):
                raise UnimplementedError(
                    "a positional C-API feed list into an inference "
                    "CompiledProgram needs inference/capi.py (ROADMAP "
                    "Queue 1 item 7)")
            place = compiled.place
        dev = place if place is not None and self.place is None \
            else self._device()
        enforce(place is None or place == dev,
                f"the CompiledProgram runs on {place}, this Executor on "
                f"{dev}", InvalidArgumentError)
        program = program or default_main_program()
        feed = feed or {}
        fetch_names = [_name_of(f) for f in (fetch_list or [])]
        scope = scope or global_scope()
        block = program.global_block()
        feed_vals, feed_lods = {}, {}
        for name, value in feed.items():
            value = getattr(value, "_t", value)       # a LoDTensorView
            if isinstance(value, TpuTensor) and value.lod:
                comp = name + SEQ_LEN_SUFFIX
                if block.has_var(comp) and comp not in feed:
                    feed_vals[name], feed_vals[comp] = lod_to_padded(
                        value, dev)
                    continue
                # a host-side LoD program (beam decode): the flat rows,
                # and the LoD through the eager side channel
                scope.var(name).set(value)
                feed_lods[name] = value.lod
            feed_vals[name] = _feed_tensor(value, dev)

        an = self._analysis(program, block, feed_vals, fetch_names,
                            use_program_cache)
        for n in an.fetch_only:
            if scope.find_var(n) is None:
                raise NotFoundError(
                    f"fetch target {n!r} is neither produced by the "
                    f"program nor present in the scope")
        env: Dict[str, torch.Tensor] = {}
        env.update(self._gather_state(scope, an.const_names, dev))
        env.update(self._gather_state(scope, an.mut_names, dev))
        env.update(feed_vals)

        self._step += 1
        check = flags.get_flag("check_nan_inf")
        records = None if self._force_recompute else {}
        # the LoD side channel is active where the JAX executor would
        # interpret the block eagerly (its debug modes, or a host-side
        # op in the block): tensor arrays then take their list form
        eager = an.eager or check or not use_program_cache or \
            not flags.get_flag("executor_cache_programs") or bool(feed_lods)
        with torch.no_grad(), rng.step_scope(self._step), op_device(dev), \
                program_ctx(program), (
                    lodctx.lod_scope(feed_lods) if eager
                    else contextlib.nullcontext({})) as lods:
            for idx, op in enumerate(block.ops):
                if idx not in an.live:
                    continue
                if idx in an.salts:
                    rng.set_op_salt(an.salts[idx])
                with op_scope(op.type), lodctx.op_scope(op):
                    self._run_op(op, env, idx, records, an)
                if check:
                    self._check_finite(op, env)
                for n in an.dead_after.get(idx, ()):
                    env.pop(n, None)

        for n in an.writeback:
            if n in env:
                var = scope.var(n)
                old = var.get()
                var.set(TpuTensor(env[n].detach(), old.lod if isinstance(
                    old, TpuTensor) else []))
        fetches = [env[n].detach() for n in fetch_names]
        if return_numpy:
            return [_to_numpy(v) for v in fetches]
        # an eager run's fetches keep the LoD their ops declared
        return [TpuTensor(v, lods.get(n)) for n, v in zip(fetch_names,
                                                          fetches)]

    # -- internals --
    def _analysis(self, program, block, feed_vals, fetch_names,
                  use_program_cache) -> _Analysis:
        cached = use_program_cache and flags.get_flag(
            "executor_cache_programs")
        record = not self._force_recompute
        key = (program.fingerprint(), tuple(sorted(feed_vals)),
               tuple(fetch_names), record)
        an = self._cache.get(key) if cached else None
        if an is None:
            self.stats["analysis_cache_miss"] += 1
            an = _Analysis(program, block, set(feed_vals), fetch_names,
                           record)
            if cached:
                self._cache[key] = an
        else:
            self.stats["analysis_cache_hit"] += 1
        return an

    @staticmethod
    def _run_op(op: OpDesc, env, idx, records, an):
        info = OpInfoMap.instance()
        if info.has(op.type):
            opdef = info.get(op.type)
            inputs = {slot: [env[n] for n in names if n]
                      for slot, names in op.inputs.items()}
            if records is not None and idx in an.recorded:
                outs, records[idx] = vjp_forward(opdef, inputs, op.attrs)
            else:
                outs = opdef.compute(inputs, op.attrs)
            _write_outputs(op, outs, env)
            return
        if op.type.endswith("_grad"):
            record = None
            if records is not None and idx in an.pairs:
                # its forward ran earlier in this run and kept its graph
                record = records.pop(an.pairs[idx])
            _run_generic_grad(op, env, record)
            return
        raise NotFoundError(f"no kernel registered for op {op.type!r}"
                            f"{not_ported(op.type)}")

    @staticmethod
    def _gather_state(scope: Scope, names, dev) -> Dict[str, torch.Tensor]:
        """Scope values of ``names`` on ``dev``. A value on another device
        moves there once: the scope then holds the moved tensor (the
        same numbers)."""
        state = {}
        for n in names:
            var = scope.find_var(n)
            if var is None or not var.is_initialized():
                raise PreconditionNotMetError(
                    f"var {n!r} is read by the program but not initialized "
                    f"in scope (run the startup program first?)")
            value = var.get()
            t = value.value if isinstance(value, TpuTensor) else value
            if not isinstance(t, torch.Tensor):
                t = from_host(t)
            if t.device != dev:
                t = t.to(dev)
                var.set(TpuTensor(t, value.lod if isinstance(
                    value, TpuTensor) else []))
            state[n] = t
        return state

    @staticmethod
    def _check_finite(op: OpDesc, env):
        """FLAGS_check_nan_inf (ref: framework/operator.cc:1129-1131
        CheckOpHasNanOrInf): one host sync an output."""
        for name in op.output_names():
            val = env.get(name)
            # a tensor array's list form holds no tensor of its own
            if isinstance(val, torch.Tensor) and val.is_floating_point() \
                    and not bool(torch.isfinite(val).all()):
                raise EnforceNotMet(
                    f"Operator {op.type} output {name!r} contains Inf/Nan")

    # -- dataset training entry points (ref: executor.py:1456-1469
    # train_from_dataset/infer_from_dataset -> C++ Trainer runtime) --
    def train_from_dataset(self, program=None, dataset=None, scope=None,
                           thread: int = 0, debug: bool = False,
                           fetch_list=None, fetch_info=None,
                           print_period: int = 100, fetch_handler=None,
                           opt_info=None, ps_client=None):
        """Run the whole dataset through the program once (one pass),
        the MultiTrainer/HogwildWorker path: every batch is one
        :meth:`run` on this executor's device. Returns the fetch history
        dict produced by the trainer."""
        return self._run_from_dataset(
            program, dataset, scope, thread, debug, fetch_list,
            fetch_info, print_period, opt_info, ps_client,
            fetch_handler, infer=False)

    def infer_from_dataset(self, program=None, dataset=None, scope=None,
                           thread: int = 0, debug: bool = False,
                           fetch_list=None, fetch_info=None,
                           print_period: int = 100, fetch_handler=None,
                           opt_info=None, ps_client=None):
        """Inference pass: same streaming loop with the worker marked
        infer (callers pass a program without optimizer ops, as the
        reference does)."""
        return self._run_from_dataset(
            program, dataset, scope, thread, debug, fetch_list,
            fetch_info, print_period, opt_info, ps_client,
            fetch_handler, infer=True)

    def _run_from_dataset(self, program, dataset, scope, thread, debug,
                          fetch_list, fetch_info, print_period, opt_info,
                          ps_client, fetch_handler, infer):
        from ..trainer import TrainerFactory, run_trainer
        if dataset is None:
            raise NotFoundError("train_from_dataset needs a dataset")
        program = program or default_main_program()
        trainer = TrainerFactory()._create_trainer(opt_info)
        if thread:
            trainer._set_thread(thread)
            dataset.set_thread(thread)
        trainer._set_debug(debug)
        trainer._set_infer(infer)
        trainer._set_program(program)
        trainer._set_fetch_var_and_info(fetch_list or [], fetch_info,
                                        print_period)
        return run_trainer(self, program, dataset, trainer, scope=scope,
                           ps_client=ps_client,
                           fetch_handler=fetch_handler)
