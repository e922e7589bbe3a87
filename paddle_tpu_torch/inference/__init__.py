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

Not ported yet (ROADMAP Queue 1 item 7): ``export_stablehlo`` and the
``export_pjrt_*`` functions (their twin is a ``torch.export``
artifact), ``load_exported``, ``capi.py`` and ``proto_program.py``.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..core.dtype import from_host, host_array
from ..core.enforce import InvalidArgumentError, enforce
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


def _pure_fn(program: Program, scope: Scope, feed_names, fetch_names,
             params=None):
    """Close the program over its params as a pure feed->fetch function
    of device tensors, run op by op through ``run_op_desc`` on the
    feeds' device, with no autograd graph. ``params`` takes a dict
    already collected by :func:`_model_params`."""
    block = program.global_block()
    if params is None:
        params = _model_params(program, scope)
    ops = [op for op in block.ops if op.type not in ("feed", "fetch")]
    dead = _last_uses(ops, set(fetch_names))

    def fn(*feeds):
        env = dict(params)
        env.update(zip(feed_names, feeds))
        with torch.no_grad(), op_device(feeds[0].device):
            for op, gone in zip(ops, dead):
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
