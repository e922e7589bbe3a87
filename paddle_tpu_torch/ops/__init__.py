"""Registered ops. Importing this package registers every op type."""
from . import (array_ops, control_flow_ops, decode_ops,  # noqa: F401
               detection_ops, flash_attention, fusion_ops, linalg_ops,
               long_tail_ops, loss_ops, math, misc_ops, moe_ops, nn_ops,
               optimizer_ops, parity_ops, rcnn_ops, rnn_ops, sequence_ops,
               special_ops, tensor_ops, vision_ops)
