"""Inference engine: the single-request predictor.

Port of ``Config``, ``PredictorTensor``, ``Predictor``,
``create_predictor``, ``_model_params`` and ``_pure_fn`` from
``paddle_tpu/inference/__init__.py`` (ref: paddle/fluid/inference/ —
AnalysisConfig + AnalysisPredictor, api/analysis_predictor.cc:82,152,
235,302,754). A saved inference model (``io.save_inference_model``'s
JSON program + ``params.npz``, the layout both packages share) loads
into a private scope on :func:`paddle_tpu_torch.device.get_device`, and
each ``run`` interprets the program op by op there through the port's
``Executor``, the reference's NaiveExecutor route; ``copy_to_cpu`` is
the one device-to-host copy. ``_pure_fn`` closes a program over its
parameters as a feed->fetch function, the per-bucket executable of the
serving plane (``paddle_tpu_torch.serving``).

Shipping a model as one file: :func:`export_stablehlo` keeps the
reference's name and signature, but what it writes is a ``torch.export``
program (``torch.export.save``'s ``.pt2`` zip: the graph, at the fixed
shapes of ``input_specs``, and the weights as buffers), not StableHLO.
The graph calls K1 as the ``paddle_tpu_torch::flash_fwd`` custom op, so
importing this package is what a loader needs. :func:`load_exported`
runs such an archive, and the serving plane loads it as its load path
B. ``capi.py`` holds the C-API structs of the positional
``CompiledProgram`` run. ``export_pjrt_artifact`` and
``export_pjrt_train_artifact`` (StableHLO for the PJRT C client of
``clients/c/``) raise: their twin, with a C++ loader of ``.pt2``, is
ROADMAP Queue 1 item 7b.
"""
from __future__ import annotations

import io
import json
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core.dtype import convert_dtype, from_host, host_array
from ..core.enforce import (InvalidArgumentError, UnimplementedError,
                            enforce)
from ..core.executor import Executor, run_op_desc
from ..core.program import Program
from ..core.registry import OpInfoMap, run_meta
from ..core.scope import Scope
from ..core.tensor import TpuTensor
from ..device import get_device, op_device
from ..io import load_inference_model


class Config:
    """AnalysisConfig parity (ref: inference/api/paddle_analysis_config.h).

    The IR-pass, GPU, TensorRT and MKLDNN toggles are accepted for
    source compatibility and recorded; the device is
    :func:`paddle_tpu_torch.device.get_device` and the ops run on
    torch's kernels and the port's own, so the knobs change nothing.
    """

    def __init__(self, model_dir: Optional[str] = None,
                 params_file: Optional[str] = None):
        self._model_dir = model_dir
        self._prog_file = None
        self._params_file = params_file
        self._ir_optim = True
        self._memory_optim = False
        self._enable_profile = False
        self._glog_info = True
        self._options: Dict[str, object] = {}

    # -- model paths --
    def set_model(self, model_dir, params_file=None):
        self._model_dir = model_dir
        self._params_file = params_file

    def set_prog_file(self, path):
        self._prog_file = path

    def set_params_file(self, path):
        self._params_file = path

    def model_dir(self):
        return self._model_dir

    def prog_file(self):
        return self._prog_file

    def params_file(self):
        return self._params_file

    # -- toggles (recorded) --
    def switch_ir_optim(self, x=True):
        self._ir_optim = bool(x)

    def ir_optim(self):
        return self._ir_optim

    def enable_memory_optim(self):
        self._memory_optim = True

    def enable_profile(self):
        self._enable_profile = True

    def disable_glog_info(self):
        self._glog_info = False

    @staticmethod
    def _noop_warn(knob):
        # a compat knob that does nothing says so, once
        import warnings
        warnings.warn(
            f"inference.Config.{knob}: recorded but has no effect on "
            f"the port (the device is paddle_tpu_torch.set_device's, "
            f"and no TensorRT / MKLDNN backend is wired in)",
            stacklevel=3)

    def enable_use_gpu(self, memory_pool_init_size_mb=100, device_id=0):
        self._noop_warn("enable_use_gpu")
        self._options["use_gpu"] = True

    def disable_gpu(self):
        self._options["use_gpu"] = False

    def enable_mkldnn(self):
        self._noop_warn("enable_mkldnn")
        self._options["mkldnn"] = True

    def set_cpu_math_library_num_threads(self, n):
        self._noop_warn("set_cpu_math_library_num_threads")
        self._options["cpu_threads"] = int(n)

    def enable_tensorrt_engine(self, **kw):
        self._noop_warn("enable_tensorrt_engine")
        self._options["tensorrt"] = kw

    def switch_use_feed_fetch_ops(self, x):
        self._noop_warn("switch_use_feed_fetch_ops")

    def switch_specify_input_names(self, x=True):
        pass


class PredictorTensor:
    """Zero-copy input/output handle (ref: ZeroCopyTensor,
    inference/api/details/zero_copy_tensor.cc). Holds a device tensor;
    ``copy_from_cpu`` stages the next run's input on the predictor's
    device, ``copy_to_cpu`` copies device to host."""

    def __init__(self, name: str, device: torch.device):
        self.name = name
        self._device = device
        self._value: Optional[torch.Tensor] = None

    def reshape(self, shape):
        pass  # shape comes from the staged array

    def copy_from_cpu(self, arr: np.ndarray):
        self._value = from_host(arr).to(self._device)

    def copy_to_cpu(self) -> np.ndarray:
        enforce(self._value is not None,
                f"output {self.name!r} not produced yet (call run())",
                InvalidArgumentError)
        return host_array(self._value)

    def shape(self):
        return list(self._value.shape) if self._value is not None else []

    # paddle 2.x alias
    def numpy(self):
        return self.copy_to_cpu()


class Predictor:
    """AnalysisPredictor parity: load, then run.

    (ref: analysis_predictor.cc Init:152, Run/ZeroCopyRun:302,754)
    """

    def __init__(self, config: Config):
        self._config = config
        enforce(config.model_dir() is not None,
                "Config.set_model(model_dir) required", InvalidArgumentError)
        self._device = get_device()
        self._scope = Scope()
        self._exe = Executor(self._device)
        prog, feeds, fetches = load_inference_model(
            config.model_dir(), self._exe,
            model_filename=config.prog_file(),
            params_filename=config.params_file(), scope=self._scope)
        self._program: Program = prog
        self._feed_names: List[str] = list(feeds)
        self._fetch_names: List[str] = list(fetches)
        self._inputs = {n: PredictorTensor(n, self._device)
                        for n in self._feed_names}
        self._outputs = {n: PredictorTensor(n, self._device)
                         for n in self._fetch_names}

    # -- handles --
    def get_input_names(self):
        return list(self._feed_names)

    def get_output_names(self):
        return list(self._fetch_names)

    def get_input_handle(self, name) -> PredictorTensor:
        return self._inputs[name]

    def get_output_handle(self, name) -> PredictorTensor:
        return self._outputs[name]

    # 1.x zero-copy surface (ref: analysis_predictor.cc
    # GetInputTensor/GetOutputTensor:666,684, ZeroCopyRun:754)
    def get_input_tensor(self, name) -> PredictorTensor:
        return self.get_input_handle(name)

    def get_output_tensor(self, name) -> PredictorTensor:
        return self.get_output_handle(name)

    def zero_copy_run(self):
        return self.run()

    # -- execution --
    def run(self, inputs: Optional[List[np.ndarray]] = None):
        """ZeroCopyRun (staged handles) or Run(list) (positional)."""
        if inputs is not None:
            for n, a in zip(self._feed_names, inputs):
                self._inputs[n].copy_from_cpu(np.asarray(a))
        feed = {}
        for n in self._feed_names:
            enforce(self._inputs[n]._value is not None,
                    f"input {n!r} not set", InvalidArgumentError)
            feed[n] = self._inputs[n]._value
        outs = self._exe.run(self._program, feed=feed,
                             fetch_list=self._fetch_names,
                             scope=self._scope, return_numpy=False)
        for n, v in zip(self._fetch_names, outs):
            self._outputs[n]._value = v.value
        if inputs is not None:
            return [self._outputs[n].copy_to_cpu()
                    for n in self._fetch_names]
        return True


def create_predictor(config: Config) -> Predictor:
    """ref: CreatePaddlePredictor (analysis_predictor.cc:1075)."""
    return Predictor(config)


# ---------------------------------------------------------------------------
# the program closure the serving plane executes
# ---------------------------------------------------------------------------
def _model_params(program: Program, scope: Scope) -> Dict[str, torch.Tensor]:
    """The parameter tensors a program closes over: every initialized
    scope var some op reads. Shared by :func:`_pure_fn` (the closure)
    and the serving plane, which hashes exactly these values into the
    executable-cache key."""
    block = program.global_block()
    needed = set()
    for op in block.ops:
        needed.update(op.input_names())
    params = {}
    for name in needed:
        var = scope.find_var(name)
        if var is not None and var.is_initialized():
            t = var.get()
            params[name] = t.value if isinstance(t, TpuTensor) else t
    return params


def _last_uses(ops, fetch_names) -> List[List[str]]:
    """For each op, the names no later op reads, fetches aside: the
    closure drops each intermediate after its last reader, as the
    executor's eager deletion (and XLA's buffer assignment in the
    reference)."""
    last = {}
    for i, op in enumerate(ops):
        for n in op.input_names() + op.output_names():
            if n:
                last[n] = i
    dead: List[List[str]] = [[] for _ in ops]
    for n, i in last.items():
        if n not in fetch_names:
            dead[i].append(n)
    return dead


def _program_ops(program: Program):
    """The program's ops less feed and fetch."""
    return [op for op in program.global_block().ops
            if op.type not in ("feed", "fetch")]


def _steps(ops, fetch_names):
    """``ops``, each with the names to drop after it
    (:func:`_last_uses`)."""
    return list(zip(ops, _last_uses(ops, set(fetch_names))))


def _pure_fn(program: Program, scope: Scope, feed_names, fetch_names,
             params=None):
    """Close the program over its params as a pure feed->fetch function
    of device tensors, run op by op through ``run_op_desc`` on the
    feeds' device, with no autograd graph. ``params`` takes a dict
    already collected by :func:`_model_params`."""
    if params is None:
        params = _model_params(program, scope)
    steps = _steps(_program_ops(program), fetch_names)

    def fn(*feeds):
        env = dict(params)
        env.update(zip(feed_names, feeds))
        with torch.no_grad(), op_device(feeds[0].device):
            for op, gone in steps:
                run_op_desc(op, env)
                for n in gone:
                    env.pop(n, None)
        return tuple(env[n] for n in fetch_names)

    return fn


def _meta_fn(program: Program, feed_names, fetch_names, params):
    """:func:`_pure_fn`'s shapes and dtypes: the same ops on ``meta``
    tensors (each op's ``infer_meta`` rule or its compute), no data and
    no kernel. The port's ``jax.eval_shape`` of the closure."""
    block = program.global_block()
    info = OpInfoMap.instance()
    metas = {n: torch.empty(p.shape, dtype=p.dtype, device="meta")
             for n, p in params.items()}

    def fn(*feeds):
        env = dict(metas)
        env.update(zip(feed_names, feeds))
        for op in block.ops:
            if op.type in ("feed", "fetch"):
                continue
            inputs = {slot: [env[n] for n in names if n]
                      for slot, names in op.inputs.items()}
            outs = run_meta(info.get(op.type), inputs, op.attrs)
            for slot, names in op.outputs.items():
                for n, v in zip(names, outs.get(slot) or ()):
                    if n and v is not None:
                        env[n] = v
        return tuple(env[n] for n in fetch_names)

    return fn


def _classify_batch_dims(at_b, at_b1):
    """Per-output batch-dim classification from the shapes at batch b
    and b+1: True (leading dim tracks the batch), False
    (batch-invariant), None (undecidable scaling). The reference's one
    rule, copied."""
    flags = []
    for a, c in zip(at_b, at_b1):
        d0 = a.shape[0] if a.shape else None
        d1 = c.shape[0] if c.shape else None
        if d0 == d1:
            flags.append(False)         # batch-invariant output
        elif d0 is not None and d1 == d0 + 1:
            flags.append(True)          # leading dim IS the batch
        else:
            flags.append(None)          # undecidable
    return flags


def _probe_batch_dims(fn, specs_at):
    """The two-batch-size probe: evaluate ``fn`` (a :func:`_meta_fn`) at
    ``specs_at(0)`` and ``specs_at(1)`` (every feed's batch grown by the
    argument) and classify each output's leading dim. Returns ``(flags,
    at_b, at_b1)``."""
    at_b = fn(*specs_at(0))
    at_b1 = fn(*specs_at(1))
    return _classify_batch_dims(at_b, at_b1), at_b, at_b1


# ---------------------------------------------------------------------------
# the exported artifact: a torch.export program (load path B)
# ---------------------------------------------------------------------------
def _fold_constants(ops, params: Dict[str, torch.Tensor], fetch_names,
                    device):
    """Constant folding, as XLA does for the JAX export: an op that has
    inputs, all of them parameters or outputs of such ops, and writes
    only names no op before it wrote runs once, here, on ``device``; a
    name that an op left to trace writes is no longer known. Returns
    the parameters and folded outputs that an op left to trace reads or
    the program fetches, and the ops left to trace."""
    env, known, written, rest = dict(params), set(params), set(params), []
    with torch.no_grad(), op_device(device):
        for op in ops:
            ins = [n for n in op.input_names() if n]
            outs = [n for n in op.output_names() if n]
            if ins and known.issuperset(ins) and written.isdisjoint(outs):
                run_op_desc(op, env)
                known.update(outs)
            else:
                rest.append(op)
                known.difference_update(outs)
            written.update(outs)
    needed = set(fetch_names).union(*(op.input_names() for op in rest))
    return {n: env[n] for n in sorted(needed) if n in env}, rest


class _ProgramModule(torch.nn.Module):
    """A loaded inference program as the module ``torch.export`` traces:
    the ops that read parameters only run once at export
    (:func:`_fold_constants`); the parameters and folded outputs that
    the other ops read or the program fetches are buffers (``b0``,
    ``b1``, ... in the order of their sorted names); ``forward(*feeds)``
    runs the other ops as :func:`_pure_fn` does and returns the
    fetches. An op that reads a feed's value on the host (``.item()``,
    ``.tolist()``, numpy) does not trace and fails the export naming its
    type."""

    def __init__(self, program: Program, params: Dict[str, torch.Tensor],
                 feed_names, fetch_names, device):
        super().__init__()
        bound, ops = _fold_constants(_program_ops(program), params,
                                     fetch_names, device)
        # (program name, buffer name) of every value bound before the feeds
        self._bound = [(n, f"b{i}") for i, n in enumerate(bound)]
        for n, buf in self._bound:
            self.register_buffer(buf, bound[n])
        self._feed_names = list(feed_names)
        self._fetch_names = list(fetch_names)
        self._steps = _steps(ops, fetch_names)

    def forward(self, *feeds):
        env = {n: getattr(self, buf) for n, buf in self._bound}
        env.update(zip(self._feed_names, feeds))
        with op_device(feeds[0].device):
            for op, gone in self._steps:
                try:
                    run_op_desc(op, env)
                except Exception as e:  # noqa: BLE001 - re-raised, named
                    raise UnimplementedError(
                        f"export_stablehlo: op {op.type!r} does not trace "
                        f"under torch.export ({type(e).__name__}: {e}); an "
                        f"op that reads a feed's value on the host "
                        f"cannot be exported, as under jax.export") from e
                for n in gone:
                    env.pop(n, None)
        return tuple(env[n] for n in self._fetch_names)


def _feed_specs(feeds, input_specs, dtypes, device, extra=0):
    """A tensor a feed at its spec's shape (the batch grown by
    ``extra``) and dtype (float32 unless ``dtypes`` names it)."""
    out = []
    for n in feeds:
        shape = tuple(int(d) for d in input_specs[n])
        if extra:
            if not shape:
                raise ValueError(f"feed {n!r} has no batch axis")
            shape = (shape[0] + extra,) + shape[1:]
        out.append(torch.zeros(shape, device=device, dtype=convert_dtype(
            (dtypes or {}).get(n, "float32"))))
    return out


def _batch_major_flags(fn, feeds, input_specs, dtypes):
    """Per-fetch True/False: does the fetch's leading dim track the
    batch? Decided by ``fn`` (a :func:`_meta_fn`) at two batch sizes.
    None when the probe cannot decide (0-d feeds, odd scaling): the
    sidecar then omits the field."""
    try:
        flags, _, _ = _probe_batch_dims(fn, lambda extra: _feed_specs(
            feeds, input_specs, dtypes, "meta", extra))
    except (ValueError, TypeError, RuntimeError):   # best-effort flags
        return None
    return None if any(f is None for f in flags) else flags


def _export_model(model_dir, input_specs, dtypes):
    """Load the saved model into a private scope on
    :func:`paddle_tpu_torch.device.get_device` and trace it with
    ``torch.export`` at the fixed shapes of ``input_specs``. Returns the
    ``ExportedProgram``, the feed and fetch names and the program's
    :func:`_meta_fn` (for the batch-major probe)."""
    scope = Scope()
    dev = get_device()
    prog, feeds, fetches = load_inference_model(model_dir, Executor(dev),
                                                scope=scope)
    params = _model_params(prog, scope)
    module = _ProgramModule(prog, params, feeds, fetches, dev)
    args = tuple(_feed_specs(feeds, input_specs, dtypes, dev))
    exported = torch.export.export(module, args, strict=False)
    return exported, feeds, fetches, _meta_fn(prog, feeds, fetches, params)


def export_stablehlo(model_dir: str, input_specs: Dict[str, tuple],
                     output_path: Optional[str] = None,
                     dtypes: Optional[Dict[str, str]] = None) -> bytes:
    """Export a saved inference model as one self-contained file: a
    ``torch.export`` program, NOT StableHLO (the name and signature are
    the reference's, so its scripts run). ``input_specs``: feed name ->
    shape; ``dtypes``: feed name -> dtype (float32 otherwise). The
    archive holds the graph at those fixed shapes and the weights as
    buffers, on the device the model loaded on; :func:`load_exported`
    runs it there. Returns the ``torch.export.save`` bytes, also
    written to ``output_path`` with a ``.meta.json`` sidecar beside it:
    ``feed_names``, ``fetch_names``, ``input_specs`` and, where the
    two-batch probe decides it, ``out_batch_major`` (which fetches the
    serving scheduler slices per request), as the reference writes it.
    """
    exported, feeds, fetches, meta_fn = _export_model(
        model_dir, input_specs, dtypes)
    buf = io.BytesIO()
    torch.export.save(exported, buf)
    blob = buf.getvalue()
    if output_path:
        with open(output_path, "wb") as f:
            f.write(blob)
        meta = {"feed_names": feeds, "fetch_names": fetches,
                "input_specs": {
                    n: {"shape": list(input_specs[n]),
                        "dtype": (dtypes or {}).get(n, "float32")}
                    for n in feeds}}
        flags = _batch_major_flags(meta_fn, feeds, input_specs, dtypes)
        if flags is not None:
            meta["out_batch_major"] = list(flags)
        with open(output_path + ".meta.json", "w") as f:
            json.dump(meta, f)
    return blob


def _exported_signature(exported):
    """(input metas, output metas) of an ``ExportedProgram``: one fake
    tensor a user input and a user output, in order (shape, dtype and
    device as traced)."""
    sig = exported.graph_signature
    user_in, user_out = set(sig.user_inputs), set(sig.user_outputs)
    ins = [n.meta["val"] for n in exported.graph.nodes
           if n.op == "placeholder" and n.name in user_in]
    out = next(n for n in exported.graph.nodes if n.op == "output")
    outs = [a.meta["val"] for a in out.args[0]
            if getattr(a, "name", None) in user_out]
    return ins, outs


def _exported_call(exported):
    """The feed->fetches callable of an ``ExportedProgram``: tensors or
    numpy arrays in, on the device it was exported on, a tuple of
    tensors out, with no autograd graph."""
    module = exported.module()
    dev = _exported_signature(exported)[0][0].device

    def call(*feeds):
        feeds = [f if isinstance(f, torch.Tensor) else
                 from_host(np.asarray(f)).to(dev) for f in feeds]
        with torch.no_grad():
            return tuple(module(*feeds))

    return call


def load_exported(path_or_bytes):
    """Load an archive :func:`export_stablehlo` wrote (a path, or its
    bytes) -> callable(*feeds) -> tuple of fetch tensors."""
    src = (path_or_bytes if isinstance(path_or_bytes, str)
           else io.BytesIO(path_or_bytes))
    return _exported_call(torch.export.load(src))


# reference names whose twin waits for ROADMAP Queue 1 item 7b: the PJRT
# C client's artifacts (StableHLO MLIR for ``clients/c/``), whose port is
# a C++ loader of the torch.export archive
DEFERRED = ("export_pjrt_artifact", "export_pjrt_train_artifact")


def __getattr__(name):
    if name in DEFERRED:
        raise UnimplementedError(
            f"inference.{name}: the PJRT C client's artifact is not ported; "
            f"its twin, a C++ loader of the torch.export archive, is ROADMAP "
            f"Queue 1 item 7b")
    raise AttributeError(name)
