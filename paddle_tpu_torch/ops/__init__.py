"""Registered ops. Importing this package registers every op type."""
from . import (decode_ops, detection_ops, flash_attention,  # noqa: F401
               loss_ops, math, moe_ops, nn_ops, optimizer_ops, rnn_ops,
               sequence_ops, tensor_ops)
