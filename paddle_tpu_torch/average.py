"""fluid.average (ref: python/paddle/fluid/average.py:40
WeightedAverage — host-side weighted running mean between executor
runs). A copy of ``paddle_tpu/average.py`` (pure Python)."""
from __future__ import annotations

import numpy as np

from .core.enforce import InvalidArgumentError, enforce

__all__ = ["WeightedAverage"]


def _is_number_or_matrix(v) -> bool:
    return isinstance(v, (int, float, np.ndarray)) or np.isscalar(v)


class WeightedAverage:
    """ref: average.py:40."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.numerator = None
        self.denominator = None

    def add(self, value, weight):
        enforce(_is_number_or_matrix(value),
                "WeightedAverage.add: value must be a number or "
                "ndarray", InvalidArgumentError)
        enforce(np.isscalar(weight) or isinstance(weight, (int, float)),
                "WeightedAverage.add: weight must be a number",
                InvalidArgumentError)
        # elementwise, like the reference: an ndarray value keeps its
        # shape through the running average (eval() returns an array)
        v = np.asarray(value, np.float64)
        w = float(weight)
        if self.numerator is None:
            self.numerator, self.denominator = v * w, w
        else:
            self.numerator = self.numerator + v * w
            self.denominator += w

    def eval(self):
        enforce(self.denominator is not None and self.denominator > 0,
                "There is no data in WeightedAverage, call add first",
                InvalidArgumentError)
        out = self.numerator / self.denominator
        return float(out) if np.ndim(out) == 0 else out
