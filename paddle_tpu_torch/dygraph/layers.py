"""Layer: the dygraph module base class, an ``nn.Module``.

Port of ``paddle_tpu/dygraph/layers.py``. Sublayer and parameter
registration, ``train``/``eval`` and the module tree are ``nn.Module``'s.
Structured names match the JAX package's: a parameter shared by two
layers (a tied weight) appears in ``state_dict`` under both names, as in
the reference (``:100-169``), but ``named_parameters`` yields it once.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import dtype as dtypes
from ..device import get_device


class Layer(torch.nn.Module):
    def __init__(self, dtype=None):
        super().__init__()
        self._dtype = dtypes.convert_dtype(dtype or "float32")

    def create_parameter(self, shape, dtype=None, is_bias: bool = False,
                         default_initializer=None,
                         attr=None) -> torch.nn.Parameter:
        """A parameter drawn on the CPU from the initializer's generator,
        then moved to the current device. ``attr`` (a ``ParamAttr``) is
        taken for the reference's signature (``:64``), which reads only
        its name: a parameter here is named by its place in the tree."""
        from ..nn import initializer as init
        dtype = dtypes.convert_dtype(dtype or self._dtype)
        if default_initializer is None:
            default_initializer = (init.Constant(0.0) if is_bias
                                   else init.XavierNormal())
        return torch.nn.Parameter(
            default_initializer(shape, dtype).to(get_device()))

    def add_sublayer(self, name: str, sublayer: "Layer") -> "Layer":
        self.add_module(name, sublayer)
        return sublayer

    def set_state_dict(self, state_dict):
        """Copy values by structured name; returns the names missing from
        ``state_dict`` (the reference's contract)."""
        missing = []
        with torch.no_grad():
            for name, tgt in self.state_dict(keep_vars=True).items():
                src = state_dict.get(name)
                if src is None:
                    missing.append(name)
                    continue
                src = src if isinstance(src, torch.Tensor) else \
                    torch.from_numpy(np.asarray(src))
                tgt.copy_(src.to(dtype=tgt.dtype, device=tgt.device))
        return missing


class Sequential(Layer):
    """ref: fluid/dygraph/container.py Sequential. ``Sequential(a, b)``
    names its sublayers "0", "1", ...; ``Sequential([("n", a), ...])``
    or ``Sequential(("n", a), ...)`` names them."""

    def __init__(self, *layers):
        super().__init__()
        if len(layers) == 1 and isinstance(layers[0], (list, tuple)) and \
                layers[0] and isinstance(layers[0][0], (list, tuple)):
            for name, layer in layers[0]:
                self.add_sublayer(name, layer)
        else:
            for i, layer in enumerate(layers):
                if isinstance(layer, tuple):
                    self.add_sublayer(layer[0], layer[1])
                else:
                    self.add_sublayer(str(i), layer)

    def forward(self, x):
        for layer in self._modules.values():
            x = layer(x)
        return x

    def __getitem__(self, idx):
        return list(self._modules.values())[idx]

    def __len__(self):
        return len(self._modules)


class LayerList(Layer):
    def __init__(self, sublayers=None):
        super().__init__()
        for i, layer in enumerate(sublayers or []):
            self.add_sublayer(str(i), layer)

    def append(self, layer):
        self.add_sublayer(str(len(self._modules)), layer)
        return self

    def __getitem__(self, idx):
        return list(self._modules.values())[idx]

    def __iter__(self):
        return iter(self._modules.values())

    def __len__(self):
        return len(self._modules)
