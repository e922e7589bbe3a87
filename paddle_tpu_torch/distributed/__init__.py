"""Distributed training (ref ``paddle_tpu/distributed/``). Only the MoE
layer is ported; on one device it needs no mesh."""
from .moe import MoELayer  # noqa: F401
