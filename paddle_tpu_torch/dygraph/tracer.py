"""Eager op execution with the reference's AMP casts.

Port of ``paddle_tpu/dygraph/tracer.py``. ``trace_op`` looks the op up in
the registry, applies the O1/O2 input cast with the reference's white and
black lists (``:94-143``; not ``torch.autocast``'s own lists) and runs
it. Torch autograd records the graph, so the JAX package's tape nodes
and ``trace_with_fn`` have no counterpart; an input slot the op declares
non-differentiable enters detached, as the reference records no
gradient for it.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core import dtype as dtypes
from ..core.enforce import op_scope
from ..core.registry import OpInfoMap
from .varbase import to_variable

no_grad = torch.no_grad

_tls = threading.local()


def _state():
    """The calling thread's AMP state (ref ``:30-38``): level, low
    precision dtype (bf16 unless set) and the custom op lists."""
    if not hasattr(_tls, "amp_level"):
        _tls.amp_level = "O0"
        _tls.amp_dtype = dtypes.bfloat16
        _tls.amp_custom_white = set()
        _tls.amp_custom_black = set()
    return _tls


# ---- AMP autocast lists (ref: imperative/amp_auto_cast.cc:38,42) ----
AMP_WHITE_LIST = {
    "conv2d", "matmul", "matmul_v2", "mul", "bmm", "depthwise_conv2d",
    "conv3d", "addmm",
}
AMP_BLACK_LIST = {
    "exp", "log", "log2", "log10", "mean", "reduce_mean", "reduce_sum",
    "softmax", "log_softmax", "softmax_with_cross_entropy", "cross_entropy",
    "cross_entropy2", "sigmoid_cross_entropy_with_logits",
    "layer_norm", "p_norm", "squared_l2_norm", "cumsum",
}


def set_amp_level(level: str, dtype=None, custom_white=None,
                  custom_black=None):
    """The calling thread's AMP level ("O0" off, "O1", "O2"), its low
    precision dtype (kept when None) and custom op lists (ref ``:99-106``:
    each call replaces the lists)."""
    st = _state()
    st.amp_level = level
    if dtype is not None:
        st.amp_dtype = dtypes.convert_dtype(dtype)
    st.amp_custom_white = set(custom_white or ())
    st.amp_custom_black = set(custom_black or ())


def amp_state():
    """(level, low precision dtype) of the calling thread."""
    st = _state()
    return st.amp_level, st.amp_dtype


def amp_level() -> str:
    return _state().amp_level


def _amp_cast_inputs(op_type: str, raw_inputs: Dict[str, List]):
    """O1/O2 autocast (ref: amp_auto_cast.cc:116 AutoCastInputs): a custom
    white entry wins over the black list and the reverse."""
    st = _state()
    white = (AMP_WHITE_LIST | st.amp_custom_white) - st.amp_custom_black
    black = (AMP_BLACK_LIST | st.amp_custom_black) - st.amp_custom_white
    if op_type in white:
        target = st.amp_dtype
    elif op_type in black:
        target = dtypes.float32
    else:
        return raw_inputs
    castable = (dtypes.float32, dtypes.float16, dtypes.bfloat16)
    return {slot: [v.to(target) if v.dtype in castable and v.dtype != target
                   else v for v in vals]
            for slot, vals in raw_inputs.items()}


def trace_op(op_type: str, inputs: Dict[str, Sequence],
             attrs: Optional[dict] = None,
             out_slots: Optional[Sequence[str]] = None) -> List[torch.Tensor]:
    """Run a registered op eagerly; returns its outputs in ``out_slots``
    order (every output slot when None)."""
    attrs = dict(attrs or {})
    opdef = OpInfoMap.instance().get(op_type)
    with op_scope(op_type):
        raw_inputs = {slot: [v if isinstance(v, torch.Tensor)
                             else to_variable(np.asarray(v)) for v in vals]
                      for slot, vals in inputs.items() if vals}
        for slot in opdef.non_differentiable_inputs:
            # no gradient flows into these slots (ref ``:174``)
            if any(v.requires_grad for v in raw_inputs.get(slot, ())):
                raw_inputs[slot] = [v.detach() for v in raw_inputs[slot]]
        if amp_level() in ("O1", "O2"):
            raw_inputs = _amp_cast_inputs(op_type, raw_inputs)
        outs = opdef.compute(raw_inputs, attrs)
    result: List[torch.Tensor] = []
    for slot in (out_slots if out_slots is not None else list(outs)):
        result.extend(v for v in outs.get(slot, []) if v is not None)
    return result
