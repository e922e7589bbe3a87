"""Dygraph (eager) mode: tensors, the tracer and Layer."""
from .layers import Layer, LayerList, Sequential  # noqa: F401
from .tracer import amp_level, no_grad, set_amp_level, trace_op  # noqa: F401
from .varbase import Parameter, to_variable  # noqa: F401
