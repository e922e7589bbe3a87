"""Registered ops. Importing this package registers every op type."""
from . import (detection_ops, flash_attention, math, nn_ops,  # noqa: F401
               optimizer_ops, tensor_ops)
