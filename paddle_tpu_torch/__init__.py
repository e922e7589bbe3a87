"""paddle_tpu_torch: the PyTorch / CUDA port of ``paddle_tpu``.

Mirrors the JAX package's module names; never imports JAX or
``paddle_tpu``. Entry points run on ``cuda`` unless the caller asks for
the CPU with :func:`paddle_tpu_torch.device.set_device`.
"""
import importlib as _importlib

from . import ops  # noqa: F401  (registers every op type)
from . import metric  # noqa: F401
from . import tensor_array  # noqa: F401
from . import dataset  # noqa: F401
from . import trainer  # noqa: F401
from .dataset import DatasetFactory  # noqa: F401
from .hapi import Model  # noqa: F401
from .core import rng as _rng
from .core.backward import append_backward, gradients  # noqa: F401
from .core.dtype import (bfloat16, bool_, complex64, complex128,  # noqa: F401
                         float16, float32, float64, int8, int16, int32,
                         int64, uint8)
from .core.executor import Executor  # noqa: F401
from .core.flags import get_flags, set_flags  # noqa: F401
from .core.program import (Program, default_main_program,  # noqa: F401
                           default_startup_program, program_guard)
from .core.scope import Scope, global_scope, scope_guard  # noqa: F401
from .static.compiler import (BuildStrategy, CompiledProgram,  # noqa: F401,E501
                              ExecutionStrategy)
from .core.tensor import TpuTensor  # noqa: F401
from .device import get_device, set_device  # noqa: F401
from .dygraph.engine import grad  # noqa: F401
from .tensor_api import *  # noqa: F401,F403  (paddle.* 2.0 tensor API)
# ``clip`` is the fluid.clip module, which also answers paddle.clip calls
clip = _importlib.import_module(".clip", __name__)


def to_tensor(data, dtype=None, place=None, stop_gradient=True):
    """paddle.to_tensor parity (2.0 API): a new tensor on the current
    device holding a COPY of ``data`` (a tensor passed in is never
    shared), cast to ``dtype`` when given. Complex data needs
    ``incubate.complex``, ROADMAP Queue 1 item 12."""
    import numpy as np
    import torch
    from .core.dtype import convert_dtype, from_host
    from .core.enforce import UnimplementedError
    if isinstance(data, torch.Tensor):
        t = data.detach().to(get_device(), copy=True)
    else:
        arr = np.asarray(data)
        if np.iscomplexobj(arr) or str(dtype).startswith("complex"):
            raise UnimplementedError(
                "to_tensor of complex data builds a ComplexVariable "
                "(incubate.complex): ROADMAP Queue 1 item 12")
        t = from_host(arr).to(get_device())
    if dtype is not None:
        t = t.to(convert_dtype(dtype))
    t.stop_gradient = stop_gradient
    return t


def seed(value: int):
    """paddle.seed parity: seed the eager RNG stream and the default
    programs (ref ``paddle_tpu/__init__.py:79-83``)."""
    _rng.global_seed(value)
    default_main_program().random_seed = value
    default_startup_program().random_seed = value
