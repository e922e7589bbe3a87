"""Registered ops. Importing this package registers every op type."""
from . import (detection_ops, flash_attention, math, moe_ops,  # noqa: F401
               nn_ops, optimizer_ops, tensor_ops)
