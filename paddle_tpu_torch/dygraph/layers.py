"""Layer: the dygraph module base class, an ``nn.Module``.

Port of ``paddle_tpu/dygraph/layers.py``. Sublayer and parameter
registration, ``train``/``eval`` and the module tree are ``nn.Module``'s.
Structured names match the JAX package's: a parameter shared by two
layers (a tied weight) appears in ``state_dict`` under both names, as in
the reference (``:100-169``), but ``named_parameters`` yields it once.
The reference's own members keep its meaning where torch spells them
otherwise: ``parameters()`` is a list, ``sublayers`` and ``apply`` walk
the tree parent first and ``named_sublayers`` children first, ``to``
casts the parameters (not the buffers), and a forward pre hook and a
``register_forward_post_hook`` hook replace the arguments or the output
with what they return, as torch's hooks do.
"""
from __future__ import annotations

from typing import Dict, List

import torch

from ..core import dtype as dtypes
from ..device import get_device
from .varbase import Parameter

_layer_name_counters: Dict[str, int] = {}


def _unique_layer_name(prefix: str) -> str:
    n = _layer_name_counters.get(prefix, 0)
    _layer_name_counters[prefix] = n + 1
    return f"{prefix}_{n}" if n else prefix


class Layer(torch.nn.Module):
    def __init__(self, name_scope=None, dtype=None):
        super().__init__()
        self._full_name = _unique_layer_name(
            name_scope or self.__class__.__name__.lower())
        self._dtype = dtypes.convert_dtype(dtype or "float32")

    def create_parameter(self, shape, dtype=None, is_bias: bool = False,
                         default_initializer=None,
                         attr=None) -> Parameter:
        """A parameter drawn on the CPU from the initializer's generator,
        then moved to the current device, named by ``attr.name`` or
        after the layer (the reference's contract, ``:64``); in
        ``state_dict`` it is named by its place in the tree."""
        from ..nn import initializer as init
        dtype = dtypes.convert_dtype(dtype or self._dtype)
        if default_initializer is None:
            default_initializer = (init.Constant(0.0) if is_bias
                                   else init.XavierNormal())
        name = getattr(attr, "name", None) or _unique_layer_name(
            self._full_name + ".w")
        return Parameter(default_initializer(shape, dtype).to(get_device()),
                         name=name)

    def add_parameter(self, name: str, parameter: Parameter) -> Parameter:
        self.register_parameter(name, parameter)
        return parameter

    def add_sublayer(self, name: str, sublayer: "Layer") -> "Layer":
        self.add_module(name, sublayer)
        return sublayer

    def full_name(self) -> str:
        return self._full_name

    def parameters(self, include_sublayers: bool = True) -> List[Parameter]:
        return [p for _, p in self.named_parameters(
            recurse=include_sublayers)]

    def sublayers(self, include_self: bool = False) -> List["Layer"]:
        """Every layer below this one, each before its own sublayers."""
        out = [self] if include_self else []
        for layer in self._modules.values():
            out.append(layer)
            out.extend(layer.sublayers())
        return out

    def named_sublayers(self, prefix: str = "", include_self: bool = False):
        """(structured name, layer) pairs, each layer after its own
        sublayers (the reference's order)."""
        if include_self:
            yield prefix, self
        for name, layer in self._modules.items():
            sub_prefix = f"{prefix}.{name}" if prefix else name
            yield from layer.named_sublayers(sub_prefix)
            yield sub_prefix, layer

    def apply(self, fn):
        for layer in self.sublayers(include_self=True):
            fn(layer)
        return self

    def clear_gradients(self):
        for p in self.parameters():
            p.clear_gradient()

    def register_forward_post_hook(self, hook):
        """``hook(layer, args, output)`` runs after ``forward``; what it
        returns (not None) takes the output's place (torch's forward
        hook). ``register_forward_pre_hook`` is torch's as it is:
        ``hook(layer, args)``, whose result (not None) takes the
        arguments' place. Both return a handle whose ``remove()`` takes
        the hook off."""
        return self.register_forward_hook(hook)

    def to(self, device=None, dtype=None, blocking=None):
        """Moves to ``device`` when given, and casts the parameters (not
        the buffers) to ``dtype``, keeping each Parameter object."""
        if isinstance(device, torch.dtype):
            device, dtype = None, device
        if device is not None:
            super().to(torch.device(str(device).replace("gpu", "cuda")))
        if dtype is not None:
            dt = dtypes.convert_dtype(dtype)
            for p in self.parameters():
                p.data = p.data.to(dt)
        return self

    def set_state_dict(self, state_dict, use_structured_name: bool = True):
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
                    dtypes.from_host(src)
                tgt.copy_(src.to(dtype=tgt.dtype, device=tgt.device))
        return missing

    set_dict = set_state_dict
    load_dict = set_state_dict


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


class ParameterList(Layer):
    def __init__(self, parameters=None):
        super().__init__()
        for i, p in enumerate(parameters or []):
            self.register_parameter(str(i), p)

    def append(self, parameter):
        self.register_parameter(str(len(self._parameters)), parameter)
        return self

    def __getitem__(self, idx):
        return list(self._parameters.values())[idx]

    def __iter__(self):
        return iter(self._parameters.values())

    def __len__(self):
        return len(self._parameters)
