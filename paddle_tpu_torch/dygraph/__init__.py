"""Dygraph (eager) mode: tensors, the tracer and Layer."""
from .layers import Layer, LayerList, Sequential  # noqa: F401
from .tracer import (amp_level, amp_state, no_grad, set_amp_level,  # noqa: F401
                     trace_op)
from .varbase import Parameter, to_variable  # noqa: F401
