"""Dygraph (eager) mode: tensors, the tracer, the backward engine, Layer
and the fluid.dygraph 1.x export surface."""
import contextlib

from torch import is_grad_enabled  # noqa: F401

from .engine import grad, run_backward  # noqa: F401
from .layers import (Layer, LayerList, ParameterList,  # noqa: F401
                     Sequential)
from .tracer import (amp_level, amp_state, no_grad, set_amp_level,  # noqa: F401
                     trace_op)
from .varbase import Parameter, VarBase, to_variable  # noqa: F401
from .compat1x import (  # noqa: F401
    NCE, BilinearTensorProduct, GRUUnit, ParallelEnv, SaveLoadConfig, TranslatedLayer, TreeConv, disable_dygraph,
    enable_dygraph, enabled, load, load_dygraph, no_grad_, prepare_context,
    save, save_dygraph, set_code_level, set_verbosity, start_gperf_profiler,
    stop_gperf_profiler)

_LR_1X = ("CosineDecay", "ExponentialDecay", "InverseTimeDecay",
          "LambdaDecay", "LinearLrWarmup", "MultiStepDecay",
          "NaturalExpDecay", "NoamDecay", "PiecewiseDecay",
          "PolynomialDecay", "ReduceLROnPlateau", "StepDecay")


@contextlib.contextmanager
def guard(place=None):
    """fluid.dygraph.guard parity: dygraph is the default mode, so the
    guard exists for script compatibility."""
    yield


# 1.x aliases of nn classes -> their 2.0 names
_NN_1X = {"PRelu": "PReLU", "InstanceNorm": "InstanceNorm2D"}


def __getattr__(name):
    """The 1.x learning-rate names and nn aliases (resolved late: the
    optimizer and nn import dygraph), and the names not ported yet,
    which raise with their ROADMAP item."""
    if name in _LR_1X:
        from .. import optimizer
        return getattr(optimizer, name)
    if name in _NN_1X:
        from .. import nn
        return getattr(nn, _NN_1X[name])
    from .compat1x import DEFERRED, deferred
    if name in DEFERRED:
        raise deferred(name)
    raise AttributeError(name)
