"""fluid.clip parity (ref: python/paddle/fluid/clip.py —
GradientClipByValue :159, GradientClipByNorm :301,
GradientClipByGlobalNorm :456; ErrorClipByValue :42): the 1.x spellings
of the optimizer's clip objects. Port of ``paddle_tpu/clip.py``.

The package's top-level name ``clip`` is this module and, called, the
2.0 function ``paddle.clip`` (``tensor_api.clip``): the two share the
name, so ``from paddle_tpu_torch import clip`` gives the module and
``paddle_tpu_torch.clip(x, min, max)`` clips a tensor."""
import sys
import types

from .optimizer import (ClipGradByGlobalNorm, ClipGradByNorm,  # noqa: F401
                        ClipGradByValue)

GradientClipByValue = ClipGradByValue
GradientClipByNorm = ClipGradByNorm
GradientClipByGlobalNorm = ClipGradByGlobalNorm


class ErrorClipByValue:
    """ref: clip.py:42 — per-var backward error clipping, kept as an
    attribute holder as in the reference: nothing reads it."""

    def __init__(self, max, min=None):
        import warnings
        warnings.warn(
            "ErrorClipByValue is an attribute holder only: nothing in "
            "this framework's backward reads it automatically — clip "
            "out-grads explicitly (e.g. ClipGradByValue on the "
            "optimizer) instead", UserWarning, stacklevel=2)
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max


__all__ = ["GradientClipByValue", "GradientClipByNorm",
           "GradientClipByGlobalNorm", "ErrorClipByValue",
           "ClipGradByValue", "ClipGradByNorm", "ClipGradByGlobalNorm"]


class _ClipModule(types.ModuleType):
    def __call__(self, x, min=None, max=None, name=None):
        from .tensor_api import clip
        return clip(x, min, max, name)


sys.modules[__name__].__class__ = _ClipModule
