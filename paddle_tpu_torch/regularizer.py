"""fluid.regularizer parity (ref: python/paddle/fluid/regularizer.py —
L1DecayRegularizer :161, L2DecayRegularizer :257): re-exports of the
optimizer's decay objects, applied inside ``functional_step``. Port of
``paddle_tpu/regularizer.py``."""
from .optimizer import L1Decay, L2Decay  # noqa: F401

L1DecayRegularizer = L1Decay
L2DecayRegularizer = L2Decay

__all__ = ["L1Decay", "L2Decay", "L1DecayRegularizer",
           "L2DecayRegularizer"]
