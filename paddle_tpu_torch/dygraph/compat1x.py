"""fluid.dygraph 1.x export surface.

Port of ``paddle_tpu/dygraph/compat1x.py:16-308``: mode control, the
single-process parallel environment, state-dict and layer persistence,
``TranslatedLayer`` over the inference-model IO, ``declarative`` and
``dygraph_to_static_func`` (``jit.to_static``), the dy2static and
profiler switches, and the 1.x layers ``BilinearTensorProduct``,
``GRUUnit``, ``NCE`` and ``TreeConv``. ``DataParallel``, in
:data:`DEFERRED`, needs modules not ported yet: it raises with the
ROADMAP item that brings it.
"""
from __future__ import annotations

import json
import os
import pickle

import numpy as np
import torch

from ..core.enforce import InvalidArgumentError, UnimplementedError, enforce
from .layers import Layer
from .tracer import no_grad, trace_op

# name -> ROADMAP Queue 1 item that ports what it needs
DEFERRED = {
    "DataParallel": "8 (distributed/parallel.py)",
}


def deferred(name: str):
    """The error a name of :data:`DEFERRED` raises."""
    return UnimplementedError(
        f"dygraph.{name} is not ported yet: ROADMAP Queue 1 item "
        f"{DEFERRED[name]}")


# -------------------------------------------------------- mode control
def enabled() -> bool:
    """ref: dygraph/base.py enabled: dygraph is the default mode."""
    from ..static import in_dynamic_mode
    return in_dynamic_mode()


def enable_dygraph(place=None):
    from ..static import disable_static
    disable_static()


def disable_dygraph():
    from ..static import enable_static
    enable_static()


no_grad_ = no_grad


# ------------------------------------------------------------ parallel
class ParallelEnv:
    """ref: dygraph/parallel.py ParallelEnv: rank and world from the
    launcher's environment."""

    def __init__(self):
        self.rank = int(os.environ.get("PADDLE_TRAINER_ID", 0))
        self.world_size = int(os.environ.get("PADDLE_TRAINERS_NUM", 1))
        eps = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "")
        self.trainer_endpoints = [e for e in eps.split(",") if e]
        self.current_endpoint = os.environ.get("PADDLE_CURRENT_ENDPOINT",
                                               "")

    @property
    def local_rank(self):
        return self.rank

    @property
    def nranks(self):
        return self.world_size


def prepare_context(strategy=None):
    """ref: dygraph/parallel.py prepare_context. One process: its
    :class:`ParallelEnv`. Several ranks need ``init_parallel_env``,
    ROADMAP Queue 1 item 8."""
    env = ParallelEnv()
    if env.world_size > 1:
        raise UnimplementedError(
            f"prepare_context over {env.world_size} ranks needs "
            f"init_parallel_env: ROADMAP Queue 1 item 8")
    return env


# ------------------------------------------------------------ save/load
class SaveLoadConfig:
    """ref: dygraph/jit.py SaveLoadConfig: save_inference_model options."""

    def __init__(self):
        self.output_spec = None
        self.model_filename = None
        self.params_filename = None
        self.separate_params = False
        self.keep_name_table = False


def save_dygraph(state_dict, model_path):
    from ..io import save_dygraph as _s
    return _s(state_dict, model_path)


def load_dygraph(model_path):
    from ..io import load_dygraph as _l
    return _l(model_path)


def save(layer, model_path, input_spec=None, configs=None):
    """ref: dygraph/jit.py save: run the layer once on the example
    inputs, then write its state dict (``params``), its class (which
    must be importable) and a format tag under ``model_path``."""
    from .varbase import to_variable
    enforce(input_spec, "dygraph.save needs input_spec (example "
            "inputs) to trace/validate the layer", InvalidArgumentError)
    inputs = [v if isinstance(v, torch.Tensor) else
              to_variable(np.asarray(v)) for v in input_spec]
    layer.eval()
    with no_grad():
        layer(*inputs)
    os.makedirs(model_path, exist_ok=True)
    save_dygraph(layer.state_dict(), os.path.join(model_path, "params"))
    try:
        with open(os.path.join(model_path, "__layer__.pkl"), "wb") as f:
            pickle.dump(layer.__class__, f)
    except (pickle.PicklingError, AttributeError) as e:
        raise InvalidArgumentError(
            "dygraph.save: the Layer class must be importable "
            f"(module-level) to reconstruct on load ({e}); for local "
            "classes save a static inference model instead") from e
    with open(os.path.join(model_path, "__meta__.json"), "w") as f:
        json.dump({"format": "dygraph_layer"}, f)
    return layer


def load(model_path, configs=None):
    """ref: dygraph/jit.py load: the layer :func:`save` wrote (its class,
    built with no arguments, then its state dict), or a
    ``save_inference_model`` directory as a :class:`TranslatedLayer`.
    Reads back only what :func:`save` wrote: the class is unpickled."""
    meta = os.path.join(model_path, "__meta__.json")
    if os.path.exists(meta):
        with open(meta) as f:
            fmt = json.load(f).get("format")
        if fmt == "dygraph_layer":
            with open(os.path.join(model_path, "__layer__.pkl"), "rb") as f:
                cls = pickle.load(f)
            state, _ = load_dygraph(os.path.join(model_path, "params"))
            try:
                layer = cls()
            except TypeError as e:
                raise InvalidArgumentError(
                    "dygraph.load: the saved Layer class needs a no-arg "
                    f"__init__ to reconstruct ({e}); use TranslatedLayer "
                    "with a static save_inference_model dir otherwise") \
                    from e
            layer.set_state_dict(state)
            return layer
    return TranslatedLayer(model_path)


class TranslatedLayer(Layer):
    """ref: dygraph/io.py TranslatedLayer: a saved inference model
    reloaded as a callable Layer (forward runs the program through the
    executor and returns tensors on the current device)."""

    def __init__(self, dirname, model_filename=None, params_filename=None):
        super().__init__()
        from .. import Executor, Scope
        from ..io import load_inference_model
        self._scope = Scope()
        self._exe = Executor()
        self._program, self._feeds, self._fetches = load_inference_model(
            dirname, self._exe, model_filename=model_filename,
            params_filename=params_filename, scope=self._scope)

    def forward(self, *inputs):
        feed = dict(zip(self._feeds, inputs))
        outs = self._exe.run(self._program, feed=feed,
                             fetch_list=self._fetches, scope=self._scope,
                             return_numpy=False)
        outs = [o.value for o in outs]
        return outs[0] if len(outs) == 1 else outs


# ------------------------------------------------------- dy2static API
def declarative(fn=None, **kwargs):
    """ref: dygraph/jit.py declarative → jit.to_static (kwargs such as
    input_spec pass through)."""
    from ..jit import to_static
    if fn is not None:
        return to_static(fn, **kwargs)
    return lambda f: to_static(f, **kwargs)


dygraph_to_static_func = declarative

_DY2STATIC_VERBOSITY = {"code_level": 0, "verbosity": 0}


def set_code_level(level=100):
    """ref: dygraph_to_static logging_utils.set_code_level (recorded)."""
    _DY2STATIC_VERBOSITY["code_level"] = int(level)


def set_verbosity(level=0):
    _DY2STATIC_VERBOSITY["verbosity"] = int(level)


# -------------------------------------------------------- profiler glue
def start_gperf_profiler():
    """ref: dygraph/profiler.py: turns span tracing on (the profiler's
    event table is ROADMAP Queue 1 item 11)."""
    from ..observability import tracer
    tracer.enable()


def stop_gperf_profiler():
    from ..observability import tracer
    tracer.disable()


# -------------------------------------------------------- 1.x layers
class BilinearTensorProduct(Layer):
    """ref: dygraph/nn.py BilinearTensorProduct, the 1.x spelling of
    ``nn.Bilinear`` (its parameters under ``_b``), with an activation
    op by name."""

    def __init__(self, input1_dim, input2_dim, output_dim, name=None,
                 act=None, param_attr=None, bias_attr=None):
        super().__init__()
        from ..nn import Bilinear
        self._b = Bilinear(input1_dim, input2_dim, output_dim,
                           weight_attr=param_attr, bias_attr=bias_attr)
        self._act = act

    def forward(self, x, y):
        out = self._b(x, y)
        if self._act:
            out = trace_op(self._act, {"X": [out]}, {},
                           out_slots=["Out"])[0]
        return out


class GRUUnit(Layer):
    """ref: dygraph/nn.py GRUUnit: one gru step over a pre-projected
    input [B, 3D]; returns (hidden, reset_hidden_prev, gate)."""

    def __init__(self, size, param_attr=None, bias_attr=None,
                 activation="tanh", gate_activation="sigmoid",
                 origin_mode=False, dtype="float32"):
        super().__init__()
        from ..nn import _init_of
        d = size // 3
        self.weight = self.create_parameter(
            (d, 3 * d), default_initializer=_init_of(param_attr, None))
        self.bias = None if bias_attr is False else self.create_parameter(
            (1, 3 * d), is_bias=True,
            default_initializer=_init_of(bias_attr, None))
        codes = {"identity": 0, "sigmoid": 1, "tanh": 2, "relu": 3}
        self._attrs = {"activation": codes[activation],
                       "gate_activation": codes[gate_activation],
                       "origin_mode": origin_mode}

    def forward(self, input, hidden):
        ins = {"Input": [input], "HiddenPrev": [hidden],
               "Weight": [self.weight]}
        if self.bias is not None:
            ins["Bias"] = [self.bias]
        return tuple(trace_op("gru_unit", ins, self._attrs,
                              out_slots=["Hidden", "ResetHiddenPrev",
                                         "Gate"]))


class NCE(Layer):
    """ref: dygraph/nn.py NCE: the nce op over a [num_total_classes, dim]
    weight and a bias; uniform negatives only."""

    def __init__(self, num_total_classes, dim, sample_weight=None,
                 param_attr=None, bias_attr=None, num_neg_samples=10,
                 sampler="uniform", custom_dist=None, seed=0,
                 is_sparse=False, dtype="float32"):
        super().__init__()
        from ..nn import _bias, _init_of
        self.num_total_classes = num_total_classes
        self.num_neg_samples = num_neg_samples
        self.sampler = sampler
        self.seed = seed
        self.weight = self.create_parameter(
            (num_total_classes, dim),
            default_initializer=_init_of(param_attr, None))
        self.bias = _bias(self, num_total_classes, bias_attr)

    def forward(self, input, label, sample_weight=None):
        ins = {"Input": [input], "Weight": [self.weight], "Label": [label]}
        if self.bias is not None:
            ins["Bias"] = [self.bias]
        if sample_weight is not None:
            ins["SampleWeight"] = [sample_weight]
        return trace_op("nce", ins,
                        {"num_total_classes": self.num_total_classes,
                         "num_neg_samples": self.num_neg_samples,
                         "sampler": self.sampler, "seed": self.seed},
                        out_slots=["Cost"])[0]


class TreeConv(Layer):
    """ref: dygraph/nn.py TreeConv (TBCNN): the tree_conv op over a
    [feature_size, 3, output_size, num_filters] filter, then a bias and
    an activation op by name."""

    def __init__(self, feature_size, output_size, num_filters=1,
                 max_depth=2, act="tanh", param_attr=None,
                 bias_attr=None, name=None):
        super().__init__()
        from ..nn import _bias, _init_of
        self.max_depth = max_depth
        self._act = act
        self.weight = self.create_parameter(
            (feature_size, 3, output_size, num_filters),
            default_initializer=_init_of(param_attr, None))
        self.bias = _bias(self, num_filters, bias_attr)

    def forward(self, nodes_vector, edge_set):
        out = trace_op("tree_conv",
                       {"NodesVector": [nodes_vector],
                        "EdgeSet": [edge_set], "Filter": [self.weight]},
                       {"max_depth": self.max_depth},
                       out_slots=["Out"])[0]
        if self.bias is not None:
            out = out + self.bias
        if self._act:
            out = trace_op(self._act, {"X": [out]}, {},
                           out_slots=["Out"])[0]
        return out
