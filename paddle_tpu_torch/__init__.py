"""paddle_tpu_torch: the PyTorch / CUDA port of ``paddle_tpu``.

Mirrors the JAX package's module names; never imports JAX or
``paddle_tpu``. Entry points run on ``cuda`` unless the caller asks for
the CPU with :func:`paddle_tpu_torch.device.set_device`.
"""
from . import ops  # noqa: F401  (registers every op type)
from .core.rng import global_seed as seed  # noqa: F401
from .device import get_device, set_device  # noqa: F401
