"""Parameter initializers drawing from an explicit ``torch.Generator``.

Port of ``paddle_tpu/nn/initializer.py`` (Constant, Normal,
XavierNormal, XavierUniform, KaimingNormal). Each is a callable
``(shape, dtype) -> CPU tensor``; the values come from ``generator`` when
one is given, else from the thread's default generator
(``core/rng.default_generator``).
"""
from __future__ import annotations

import math

import torch

from ..core import dtype as dtypes, rng


def _fan_in_out(shape):
    shape = list(shape)
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = 1
    for s in shape[2:]:
        receptive *= s
    return shape[1] * receptive, shape[0] * receptive


class Initializer:
    def __init__(self, generator=None):
        self.generator = generator

    def _gen(self):
        return self.generator or rng.default_generator()

    def __call__(self, shape, dtype):
        raise NotImplementedError


class Constant(Initializer):
    def __init__(self, value=0.0):
        super().__init__()
        self.value = value

    def __call__(self, shape, dtype):
        return torch.full(tuple(shape), self.value,
                          dtype=dtypes.convert_dtype(dtype))


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0, generator=None):
        super().__init__(generator)
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype):
        x = torch.randn(tuple(shape), generator=self._gen())
        return (self.mean + self.std * x).to(dtypes.convert_dtype(dtype))


class XavierUniform(Initializer):
    def __init__(self, fan_in=None, fan_out=None, generator=None):
        super().__init__(generator)
        self.fan_in, self.fan_out = fan_in, fan_out

    def __call__(self, shape, dtype):
        fi, fo = _fan_in_out(shape)
        limit = math.sqrt(6.0 / ((self.fan_in or fi) + (self.fan_out or fo)))
        x = torch.empty(tuple(shape)).uniform_(-limit, limit,
                                               generator=self._gen())
        return x.to(dtypes.convert_dtype(dtype))


class XavierNormal(Initializer):
    def __init__(self, fan_in=None, fan_out=None, generator=None):
        super().__init__(generator)
        self.fan_in, self.fan_out = fan_in, fan_out

    def __call__(self, shape, dtype):
        fi, fo = _fan_in_out(shape)
        std = math.sqrt(2.0 / ((self.fan_in or fi) + (self.fan_out or fo)))
        x = torch.randn(tuple(shape), generator=self._gen())
        return (std * x).to(dtypes.convert_dtype(dtype))


class KaimingNormal(Initializer):
    """He normal: std sqrt(2 / fan_in), fan_in of an OIHW filter being
    I * H * W unless given."""

    def __init__(self, fan_in=None, generator=None):
        super().__init__(generator)
        self.fan_in = fan_in

    def __call__(self, shape, dtype):
        fi, _ = _fan_in_out(shape)
        std = math.sqrt(2.0 / (self.fan_in or fi))
        x = torch.randn(tuple(shape), generator=self._gen())
        return (std * x).to(dtypes.convert_dtype(dtype))
