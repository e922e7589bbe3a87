"""Carry weights from the JAX package's model into the port's.

``load_state_dict(model, state)`` takes the JAX model's ``state_dict()``
as ``{structured_name: np.ndarray}``. That dict holds the buffers too
(the BN running statistics ``<layer>._mean`` / ``<layer>._variance``),
and so does the port's ``state_dict``, so they load with the parameters.
Layouts are the same in both packages (``Linear`` is ``[in, out]``,
``Conv2D`` OIHW in either data format, the transposed convs [in, out /
groups, k...]), so no array is transposed. ``SpectralNorm``'s power
iteration vectors ``weight_u`` / ``weight_v`` are parameters with
``stop_gradient`` in both packages' ``state_dict`` and load with the
rest; ``data_norm``'s batch statistics exist only in static programs,
whose persistables ``io`` carries by name. A
parameter the port shares between names (the tied MLM decoder weight)
must arrive with equal arrays under every name, and is loaded once.
bf16 arrays (ml_dtypes' ``bfloat16``, which ``torch.from_numpy`` does
not take) cross as their bits.

``load_train_state(step, state)`` carries a JAX ``TrainStep.state_dict()``
(params, optimizer slots, fp32 masters, step) into the port's
``TrainStep``: the reference keeps a tied weight under each of its names,
the port under one.

The recurrent layers (``nn.LSTM`` / ``GRU`` / ``SimpleRNN``,
``RowConv``, ``dygraph.GRUUnit``) load by structured name like the rest,
and the fluid ``lstm`` / ``gru`` / ``lstmp`` parameters are
persistables that ``io`` carries by name: both packages keep the same
layouts. Between the two LSTM forms the gate blocks move:
:func:`fluid_lstm_to_rnn_gates` reorders the fluid ``lstm`` op's
(c, i, f, o) to ``rnn_scan``'s (i, f, g, o), and
:func:`lstm_state_from_cudnn` / :func:`lstm_state_from_cells` give
``nn.LSTM``'s parameters from a ``cudnn_lstm`` WeightList or from
per-layer cells whose [x; h] weight is one matrix (the static PTB
script's).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .core.enforce import InvalidArgumentError


def to_tensor(arr) -> torch.Tensor:
    """A numpy (or JAX) array as a CPU tensor of the same dtype and
    values; bf16 goes across as its 16 bits."""
    arr = np.array(arr, copy=True)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _one_per_parameter(group: Dict, aliases: Dict[str, str], what: str):
    """``group`` without the tied names in ``aliases``, after checking
    that each carries what its kept name carries."""
    out = {}
    for name, value in group.items():
        keep = aliases.get(name)
        if keep is None:
            out[name] = value
            continue
        same = (value.keys() == group[keep].keys() and all(
            np.array_equal(np.asarray(v), np.asarray(group[keep][k]))
            for k, v in value.items())) if isinstance(value, dict) else \
            np.array_equal(np.asarray(value), np.asarray(group[keep]))
        if not same:
            raise InvalidArgumentError(
                f"{what}: tied names {keep} and {name} carry different "
                f"values")
    return out


def load_train_state(step, state: Dict):
    """Install a JAX ``TrainStep.state_dict()`` into the port's
    ``TrainStep`` ``step``: params, buffers, optimizer slots and fp32
    masters by structured name (a tied weight's second name dropped
    once its values are checked equal), and ``meta.step``."""
    aliases = step.aliases
    out = {"meta": {"step": int(np.asarray(
        (state.get("meta") or {}).get("step", 0)))}}
    for group in ("params", "buffers", "masters"):
        if state.get(group):
            out[group] = {k: to_tensor(v) for k, v in _one_per_parameter(
                state[group], aliases, group).items()}
    if state.get("opt_states"):
        out["opt_states"] = {
            n: {k: to_tensor(v) for k, v in st.items()}
            for n, st in _one_per_parameter(
                state["opt_states"], aliases, "opt_states").items()}
    step.set_state_dict(out)
    return step


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
            tgt.copy_(to_tensor(first).to(dtype=tgt.dtype,
                                          device=tgt.device))
    return model


# the fluid lstm op's gate blocks are (c, i, f, o); rnn_scan's and
# cuDNN's (i, f, g, o), g being the candidate c
_FLUID_TO_RNN = (1, 2, 0, 3)


def fluid_lstm_to_rnn_gates(arr) -> np.ndarray:
    """A fluid ``lstm`` weight or bias, its last axis the four gate
    blocks in (c, i, f, o), with them in ``rnn_scan``'s (i, f, g, o)."""
    blocks = np.split(np.asarray(arr), 4, axis=-1)
    return np.concatenate([blocks[k] for k in _FLUID_TO_RNN], axis=-1)


def lstm_state_from_cudnn(weight_list, num_layers: int) -> Dict:
    """A one-direction ``nn.LSTM``'s parameters from a ``cudnn_lstm``
    WeightList ([Wx [I, 4H], Wh [H, 4H], B [4H]] a layer; gates
    (i, f, g, o) in both): ``weight_ih_l{k}`` = Wx^T, ``weight_hh_l{k}``
    = Wh^T, ``bias_ih_l{k}`` = B, ``bias_hh_l{k}`` = 0."""
    out = {}
    for k in range(num_layers):
        wx, wh, b = (np.asarray(v) for v in weight_list[3 * k:3 * k + 3])
        out[f"weight_ih_l{k}"] = np.ascontiguousarray(wx.T)
        out[f"weight_hh_l{k}"] = np.ascontiguousarray(wh.T)
        out[f"bias_ih_l{k}"] = b.copy()
        out[f"bias_hh_l{k}"] = np.zeros_like(b)
    return out


def lstm_state_from_cells(weights, biases) -> Dict:
    """``nn.LSTM``'s parameters from one-direction cells that multiply
    [x; h] by W [I + H, 4H] and add b [4H], a layer each, gates
    (i, f, g, o)."""
    weight_list = []
    for w, b in zip(weights, biases):
        w = np.asarray(w)
        h = w.shape[1] // 4
        weight_list += [w[:w.shape[0] - h], w[w.shape[0] - h:], b]
    return lstm_state_from_cudnn(weight_list, len(weight_list) // 3)
