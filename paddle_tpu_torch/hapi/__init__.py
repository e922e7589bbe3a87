"""paddle.hapi parity: Model train-loop API + callbacks (port of
``paddle_tpu/hapi/``)."""
from .callbacks import (Callback, EarlyStopping,  # noqa: F401
                        LRSchedulerCallback, ModelCheckpoint, ProgBarLogger)
from .model import InputSpec, Model  # noqa: F401
