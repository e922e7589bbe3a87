"""Vision models (ref: python/paddle/vision/). The JAX package's
transforms, datasets and detection models are not ported yet."""
from . import models  # noqa: F401
