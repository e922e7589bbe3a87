"""paddle_tpu_torch: the PyTorch / CUDA port of ``paddle_tpu``.

Mirrors the JAX package's module names; never imports JAX or
``paddle_tpu``. Entry points run on ``cuda`` unless the caller asks for
the CPU with :func:`paddle_tpu_torch.device.set_device`.
"""
from . import ops  # noqa: F401  (registers every op type)
from .core.backward import append_backward, gradients  # noqa: F401
from .core.executor import Executor  # noqa: F401
from .core.flags import get_flags, set_flags  # noqa: F401
from .core.program import (Program, default_main_program,  # noqa: F401
                           default_startup_program, program_guard)
from .core.rng import global_seed as seed  # noqa: F401
from .core.scope import Scope, global_scope, scope_guard  # noqa: F401
from .core.tensor import TpuTensor  # noqa: F401
from .device import get_device, set_device  # noqa: F401
