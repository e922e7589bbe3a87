"""Registered ops. Importing this package registers every op type."""
from . import flash_attention, math, nn_ops, optimizer_ops, tensor_ops  # noqa: F401
