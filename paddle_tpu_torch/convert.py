"""Carry weights from the JAX package's model into the port's.

``load_state_dict(model, state)`` takes the JAX model's ``state_dict()``
as ``{structured_name: np.ndarray}``. That dict holds the buffers too
(the BN running statistics ``<layer>._mean`` / ``<layer>._variance``),
and so does the port's ``state_dict``, so they load with the parameters.
Layouts are the same in both packages (``Linear`` is ``[in, out]``,
``Conv2D`` OIHW in either data format), so no array is transposed. A
parameter the port shares between names (the tied MLM decoder weight)
must arrive with equal arrays under every name, and is loaded once.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .core.enforce import InvalidArgumentError


def load_state_dict(model: torch.nn.Module, state: Dict[str, np.ndarray]):
    """Load ``state`` into ``model``; raises on a missing, extra or
    misshapen name, or on tied names whose arrays differ."""
    own = model.state_dict(keep_vars=True)
    missing = sorted(set(own) - set(state))
    extra = sorted(set(state) - set(own))
    if missing or extra:
        raise InvalidArgumentError(
            f"state dict mismatch: missing {missing}, extra {extra}")
    groups: Dict[int, list] = {}
    for name, tensor in own.items():
        arr = np.asarray(state[name])
        if tuple(arr.shape) != tuple(tensor.shape):
            raise InvalidArgumentError(
                f"{name}: shape {tuple(arr.shape)} != "
                f"{tuple(tensor.shape)}")
        groups.setdefault(id(tensor), []).append(name)
    with torch.no_grad():
        for names in groups.values():
            first = np.asarray(state[names[0]])
            for other in names[1:]:
                if not np.array_equal(first, np.asarray(state[other])):
                    raise InvalidArgumentError(
                        f"tied names {names[0]} and {other} carry "
                        f"different arrays")
            tgt = own[names[0]]
            tgt.copy_(torch.from_numpy(np.array(first, copy=True)).to(
                dtype=tgt.dtype, device=tgt.device))
    return model
