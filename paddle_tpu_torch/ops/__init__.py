"""Registered ops. Importing this package registers every op type."""
from . import (decode_ops, detection_ops, flash_attention,  # noqa: F401
               linalg_ops, long_tail_ops, loss_ops, math, moe_ops, nn_ops,
               optimizer_ops, parity_ops, rnn_ops, sequence_ops, tensor_ops,
               vision_ops)
