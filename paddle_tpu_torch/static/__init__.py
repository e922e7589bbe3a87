"""Static-graph front end: fluid-style program building.

Port of the part of ``paddle_tpu/static/__init__.py`` that the book
programs and a static ResNet run (ref: python/paddle/fluid/framework.py
Variable :899, layers/nn.py builders, layer_helper.py): ``data`` and
the layer builders append OpDescs to the ambient main program,
parameters register init ops into the startup program, and
``Optimizer.minimize`` appends backward + update ops; the executor
(``core/executor.py``) runs them. The builders are the JAX package's,
name for name, so one builder script makes the same Program JSON in
both packages.

Shape inference (``_op``) runs each op's compute on ``meta`` tensors
(or its ``infer_meta`` rule) where the JAX package runs
``jax.eval_shape``, inside ``lodctx.infer_shape_scope`` as there (an
op over a LoD returns a shape proxy). The first simple-layer table is
ported whole: a builder whose op the port lacks builds, and running it
raises ``NotFoundError``, as the JAX package does for an unregistered
op. Of the later tables, only the builders of ops the port registers.
The control-flow builders (``control_flow.py``), the comparison and
``increment`` builders, the tensor-array surface and the step
extractors of the module-parity builders, the recurrent builders
(``dynamic_lstm``, ``dynamic_gru``, ``row_conv``) and ``dynamic_lstmp``,
``gru_unit``, ``lstm`` / ``lstm_unit`` of the RNN builders are ported,
and the decode builders: ``crf_decoding`` (reusing the CRF transition),
``beam_search`` and ``beam_search_decode``, which replace their table
forms as in the JAX package; the detection builders: the RoI pools,
the detection entries of the simple tables, ``deformable_roi_pooling``,
the detection composites of the module-parity builders (proposals,
target assignment batched with its index offsets, FPN routing,
``detection_output``), ``multi_box_head`` and ``ssd_loss`` (with the
``zeros_like`` and ``ones_like`` it calls), and ``static.detection``.
A host-side op (one that reads its inputs on the host, "eager only")
leaves its outputs' shapes unknown, as the JAX package's does. The
training surface is whole: the parameterized builders (``layer_norm``,
the transposed and 3-D convolutions, the norms, ``prelu``,
``bilinear_tensor_product``, ``spectral_norm``, ``data_norm``,
``deformable_conv``, ``inplace_abn``), the rest of the simple tables,
the tensor builders (``create_global_var``,
``autoincreased_step_counter``, ``fill_constant_batch_size_like``,
``range``, ``zeros``, ``ones``, ``eye``) and the losses of the
module-parity builders, with ``nets``, ``CompiledProgram``
(``compiler.py``) and static AMP (``amp/static_amp.py``). The cell
drivers ``rnn``, ``birnn`` and ``dynamic_decode`` unroll over the static
length (``dynamic_decode`` requires ``max_step_num``), beside the
contrib decoder (``decoder.py``), ``contrib_layers.py``,
``nest_utils.py`` and ``analysis.py``. Not ported yet: the two
selected-rows builders (ROADMAP Queue 1 item 8).
"""
from __future__ import annotations

import threading
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..core import dtype as dtypes
from ..core import lodctx
from ..core.backward import append_backward, gradients  # noqa: F401
from ..core.enforce import (InvalidArgumentError, UnimplementedError,
                            enforce)
from ..core.program import (Block, Program, VarDesc,  # noqa: F401
                            default_main_program, default_startup_program,
                            program_guard)
from ..core.registry import OpInfoMap, run_meta

_mode = threading.local()


def in_dynamic_mode() -> bool:
    return getattr(_mode, "dygraph", True)


def enable_static():
    _mode.dygraph = False


def disable_static():
    _mode.dygraph = True


class Variable:
    """Static graph var handle (ref: fluid/framework.py:899)."""

    def __init__(self, block: Block, name: str, shape=None, dtype=None,
                 stop_gradient=False, persistable=False, is_data=False,
                 lod_level=0):
        self.block = block
        self.name = name
        self.desc = block.create_var(
            name, shape=shape, dtype=dtype, stop_gradient=stop_gradient,
            persistable=persistable, is_data=is_data, lod_level=lod_level)

    @property
    def shape(self):
        return self.desc.shape

    @property
    def dtype(self):
        return self.desc.dtype

    @property
    def stop_gradient(self):
        return self.desc.stop_gradient

    @stop_gradient.setter
    def stop_gradient(self, v):
        self.desc.stop_gradient = v

    @property
    def persistable(self):
        return self.desc.persistable

    @property
    def program(self):
        return self.block.program

    def _binary(self, other, op_type, reverse=False):
        if not isinstance(other, Variable):
            other = fill_constant(shape=[1], dtype=self.dtype or "float32",
                                  value=float(other))
        x, y = (other, self) if reverse else (self, other)
        out = _new_tmp(self.block)
        _op(self.block, op_type, {"X": [x.name], "Y": [y.name]},
                             {"Out": [out.name]}, {"axis": -1})
        return out

    def __add__(self, o):
        return self._binary(o, "elementwise_add")

    __radd__ = __add__

    def __sub__(self, o):
        return self._binary(o, "elementwise_sub")

    def __rsub__(self, o):
        return self._binary(o, "elementwise_sub", reverse=True)

    def __mul__(self, o):
        return self._binary(o, "elementwise_mul")

    __rmul__ = __mul__

    def __truediv__(self, o):
        return self._binary(o, "elementwise_div")

    def __repr__(self):
        return f"static.Variable({self.name}, shape={self.shape})"


def _new_tmp(block: Block, prefix="tmp") -> Variable:
    # while tracing a control-flow sub-block, temporaries belong to the
    # sub-block even when the inputs live in an outer block
    block = block.program.current_block()
    name = block.program.unique_name(prefix)
    return Variable(block, name)


_DUMMY_BATCH = 7919  # prime sentinel standing in for the -1 batch dim



def _op(block: Block, type_: str, inputs, outputs, attrs):
    """Append an op AND infer its output VarDescs' shapes and dtypes by
    running the registered compute (or its ``infer_meta`` rule) on
    ``meta`` tensors: the InferShape analogue (ref:
    framework/operator.cc:1076) with no per-op code, where the JAX
    package runs ``jax.eval_shape``. Ops with no tensor input create on
    ``meta`` too, and the random ones draw nothing."""
    # ops always append to the program's CURRENT block (the reference's
    # LayerHelper.main_program.current_block() contract)
    block = block.program.current_block()
    op = block.append_op(type_, inputs, outputs, attrs)
    info = OpInfoMap.instance()
    if not info.has(type_):
        return op
    opdef = info.get(type_)
    specs = {}
    for slot, names in op.inputs.items():
        row = []
        for n in names:
            d = block.find_var_recursive(n)
            if d is None or d.shape is None:
                # inputs with unknown metadata: shape inference is
                # impossible, outputs stay unknown (not an error)
                return op
            shape = tuple(_DUMMY_BATCH if s == -1 else int(s)
                          for s in d.shape)
            row.append(torch.empty(shape, dtype=d.dtype or torch.float32,
                                   device="meta"))
        specs[slot] = row
    try:
        with lodctx.infer_shape_scope():
            outs = run_meta(opdef, specs, attrs)
    except Exception as e:
        if "eager only" in str(e):
            # host-side ops (detection sampling, PS...) cannot be shape-
            # inferred: their outputs stay unknown and the executor runs
            # them eagerly, as every op
            return
        # all input shapes were known, so a failure here means the op is
        # genuinely mis-built (bad attr, rank mismatch): fail loudly at
        # build time like the reference's InferShape (ref: operator.cc:1076)
        raise InvalidArgumentError(
            f"InferShape of op {type_!r} failed: {e}\n  inputs: "
            + ", ".join(f"{s}={[tuple(v.shape) for v in r]}"
                        for s, r in specs.items())) from e
    for slot, names in op.outputs.items():
        vals = outs.get(slot)
        if vals is None:
            continue
        for n, v in zip(names, vals):
            if not n or v is None:
                continue
            d = block.find_var_recursive(n)
            if d is not None:
                d.shape = tuple(-1 if s == _DUMMY_BATCH else int(s)
                                for s in v.shape)
                d.dtype = v.dtype
    return op


def _current_block() -> Block:
    return default_main_program().current_block()


SEQ_LEN_SUFFIX = "@seq_len"


def data(name: str, shape: Sequence[int], dtype="float32",
         lod_level: int = 0) -> Variable:
    """ref: fluid.data / fluid.layers.data — feed slot declaration.
    Leading -1 means runtime batch dim (jit re-specializes per shape).

    lod_level >= 1 (ragged sequences) maps to the dense-padding
    convention: the var is fed PADDED ([B, T, ...]) alongside a hidden
    companion length var ``{name}@seq_len`` ([B] int64) that sequence
    ops consume; ``Variable.lod_companion`` carries the association and
    lod-aware builders (embedding, sequence_*) propagate it."""
    v = Variable(_current_block(), name, shape=shape, dtype=dtype,
                 is_data=True, stop_gradient=True, lod_level=lod_level)
    if lod_level == 1:
        # level-1 ragged data: dense padding + companion. Deeper lod
        # (beam structures) stays FLAT and rides the eager lod side
        # channel (core.lodctx) instead.
        ln = Variable(_current_block(), name + SEQ_LEN_SUFFIX,
                      shape=[-1], dtype="int64", is_data=True,
                      stop_gradient=True)
        v.lod_companion = ln.name
    return v


def create_parameter(shape, dtype="float32", name=None, attr=None,
                     is_bias=False, default_initializer=None) -> Variable:
    """Parameter: persistable var + init op in the startup program (ref:
    fluid/layer_helper_base.py create_parameter)."""
    from ..nn import initializer as init_mod
    main = default_main_program()
    startup = default_startup_program()
    if isinstance(attr, str):          # fluid allows param_attr='name'
        name = attr
    elif attr is not None and getattr(attr, "name", None):
        name = attr.name
    name = name or main.unique_name("param_w")
    if name in main.global_block().vars:
        # named param reuse (fluid contract: ParamAttr(name=...) shares
        # one parameter across layers — e.g. crf_decoding reading the
        # linear_chain_crf transition, word2vec's shared embeddings)
        existing = main.global_block().vars[name]
        enforce(existing.shape is None or list(existing.shape) ==
                list(shape),
                f"shared parameter {name!r} shape mismatch: existing "
                f"{existing.shape} vs requested {list(shape)}",
                InvalidArgumentError)
        return Variable(main.global_block(), name)
    var = Variable(main.global_block(), name, shape=shape, dtype=dtype,
                   persistable=True)
    startup.global_block().create_var(name, shape=shape, dtype=dtype,
                                      persistable=True)
    initializer = default_initializer
    if initializer is None and attr is not None:
        initializer = getattr(attr, "initializer", None)
    if initializer is None:
        initializer = (init_mod.Constant(0.0) if is_bias
                       else init_mod.XavierNormal())
    _append_init_op(startup.global_block(), name, shape, dtype, initializer)
    return var


def _append_init_op(block: Block, name, shape, dtype, initializer):
    from ..nn import initializer as I
    dt = dtypes.convert_dtype(dtype)
    shape = list(shape)
    if isinstance(initializer, I.Constant):
        _op(block, "fill_constant", {}, {"Out": [name]},
                        {"shape": shape, "value": initializer.value,
                         "dtype": dtypes.dtype_name(dt)})
    elif isinstance(initializer, I.Uniform):
        _op(block, "uniform_random", {}, {"Out": [name]},
                        {"shape": shape, "min": initializer.low,
                         "max": initializer.high,
                         "seed": getattr(initializer, "seed", 0),
                         "dtype": dtypes.dtype_name(dt)})
    elif isinstance(initializer, I.Normal):
        _op(block, "gaussian_random", {}, {"Out": [name]},
                        {"shape": shape, "mean": initializer.mean,
                         "std": initializer.std,
                         "seed": getattr(initializer, "seed", 0),
                         "dtype": dtypes.dtype_name(dt)})
    elif isinstance(initializer, I.TruncatedNormal):
        _op(block, "truncated_gaussian_random", {}, {"Out": [name]},
                        {"shape": shape, "mean": initializer.mean,
                         "std": initializer.std, "seed": initializer.seed,
                         "dtype": dtypes.dtype_name(dt)})
    elif isinstance(initializer, I.Assign):
        _op(block, "assign_value", {}, {"Out": [name]},
                        {"shape": shape, "dtype": dtypes.dtype_name(dt),
                         "values": np.asarray(initializer.value).reshape(-1)
                         .tolist()})
    else:
        # fan-based initializers: compute the bound host-side
        import math
        fi, fo = I._fan_in_out(shape)
        if isinstance(initializer, I.XavierUniform):
            limit = math.sqrt(6.0 / (fi + fo))
            _op(block, "uniform_random", {}, {"Out": [name]},
                            {"shape": shape, "min": -limit, "max": limit,
                             "dtype": dtypes.dtype_name(dt)})
        elif isinstance(initializer, I.XavierNormal):
            std = math.sqrt(2.0 / (fi + fo))
            _op(block, "gaussian_random", {}, {"Out": [name]},
                            {"shape": shape, "std": std, "dtype": dtypes.dtype_name(dt)})
        elif isinstance(initializer, I.KaimingUniform):
            limit = math.sqrt(6.0 / fi)
            _op(block, "uniform_random", {}, {"Out": [name]},
                            {"shape": shape, "min": -limit, "max": limit,
                             "dtype": dtypes.dtype_name(dt)})
        elif isinstance(initializer, I.KaimingNormal):
            std = math.sqrt(2.0 / fi)
            _op(block, "gaussian_random", {}, {"Out": [name]},
                            {"shape": shape, "std": std, "dtype": dtypes.dtype_name(dt)})
        else:
            raise InvalidArgumentError(
                f"unsupported static initializer {type(initializer)}")


def fill_constant(shape, dtype, value, name=None) -> Variable:
    out = _new_tmp(_current_block(), name or "fill")
    out.desc.dtype = dtypes.convert_dtype(dtype)
    out.desc.shape = tuple(shape)
    _op(_current_block(), 
        "fill_constant", {}, {"Out": [out.name]},
        {"shape": list(shape), "value": value,
         "dtype": dtypes.dtype_name(dtype)})
    return out


def _infer_conv_out(hw, k, s, p):
    return (hw + 2 * p - k) // s + 1


def _ntuple(v, n):
    """Normalize a scalar-or-sequence arg to an n-list (a (2,1) tuple
    must NOT become [2,2] — the repeat idiom corrupted per-axis args)."""
    if isinstance(v, (list, tuple)):
        enforce(len(v) == n, f"expected {n} values, got {list(v)}",
                InvalidArgumentError)
        return [int(x) for x in v]
    return [int(v)] * n


# fluid/layers/control_flow.py less_than :1012, increment :944 and the
# other comparisons
def _cmp_builder(op_type, force_cpu_third: bool = False):
    """1.x spells the in-place result var ``cond=`` (ref:
    layers/control_flow.py); the positional order matches the 1.x
    signatures — less_than alone has force_cpu third. ``out=`` is this
    repo's internal keyword alias for the same slot; ``force_cpu`` is a
    placement hint the port ignores (the executor places every op)."""
    if force_cpu_third:
        def builder(x: Variable, y: Variable, force_cpu=None,
                    cond: Optional[Variable] = None, name=None,
                    out: Optional[Variable] = None) -> Variable:
            return _cmp_impl(op_type, x, y, out if out is not None
                             else cond)
    else:
        def builder(x: Variable, y: Variable,
                    cond: Optional[Variable] = None, name=None,
                    out: Optional[Variable] = None,
                    force_cpu=None) -> Variable:
            return _cmp_impl(op_type, x, y, out if out is not None
                             else cond)
    builder.__name__ = op_type
    return builder


def _cmp_impl(op_type, x, y, out):
    if out is None:
        out = _new_tmp(x.block, op_type)
    _op(_current_block(), op_type, {"X": [x.name], "Y": [y.name]},
        {"Out": [out.name]}, {})
    return out


less_than = _cmp_builder("less_than", force_cpu_third=True)
less_equal = _cmp_builder("less_equal")
greater_than = _cmp_builder("greater_than")
greater_equal = _cmp_builder("greater_equal")
equal = _cmp_builder("equal")
not_equal = _cmp_builder("not_equal")
logical_and = _cmp_builder("logical_and")
logical_or = _cmp_builder("logical_or")


def increment(x: Variable, value: float = 1.0,
              in_place: bool = True) -> Variable:
    out = x if in_place else _new_tmp(x.block, "increment")
    _op(_current_block(), "increment", {"X": [x.name]},
        {"Out": [out.name]}, {"step": float(value)})
    return out


def assign(input: Variable, output: Optional[Variable] = None) -> Variable:
    if output is None:
        output = _new_tmp(input.block, "assign")
    _op(_current_block(), "assign", {"X": [input.name]},
        {"Out": [output.name]}, {})
    return output


class nn:
    """fluid.layers.* builders (static). Grouped as a namespace class so
    ``from paddle_tpu.static import nn; nn.fc(...)`` mirrors
    fluid.layers usage."""

    @staticmethod
    def fc(input, size: int, num_flatten_dims: int = 1, act=None,
           param_attr=None, bias_attr=None, name=None) -> Variable:
        """ref: fluid/layers/nn.py fc. ``input`` may be a list/tuple of
        vars (their projections are summed, the 1.x contract). A ragged
        (lod-companion) input means per-timestep projection — the dense
        analogue of fc over a LoD [total, D] tensor — and the companion
        propagates to the output."""
        ins = list(input) if isinstance(input, (list, tuple)) else [input]
        comp = next((getattr(v, "lod_companion", None) for v in ins
                     if getattr(v, "lod_companion", None)), None)
        block = ins[0].block
        projected = []
        for v in ins:
            in_shape = v.shape
            enforce(in_shape is not None, "fc requires known input shape")
            nfd = num_flatten_dims
            if getattr(v, "lod_companion", None) and len(in_shape) >= 3:
                nfd = len(in_shape) - 1       # per-timestep projection
            flat = 1
            for d in in_shape[nfd:]:
                flat *= int(d)
            w = create_parameter([flat, size], v.dtype or "float32",
                                 attr=param_attr)
            out = _new_tmp(block, name or "fc")
            _op(block, "mul", {"X": [v.name], "Y": [w.name]},
                {"Out": [out.name]},
                {"x_num_col_dims": nfd, "y_num_col_dims": 1})
            projected.append(out)
        out = projected[0]
        for p in projected[1:]:
            s = _new_tmp(block, "fc_sum")
            _op(block, "elementwise_add", {"X": [out.name], "Y": [p.name]},
                {"Out": [s.name]}, {"axis": -1})
            out = s
        if bias_attr is not False:
            b = create_parameter([size], ins[0].dtype or "float32",
                                 is_bias=True, attr=bias_attr)
            out2 = _new_tmp(block, "fc_bias")
            _op(block, "elementwise_add",
                            {"X": [out.name], "Y": [b.name]},
                            {"Out": [out2.name]},
                            {"axis": -1})
            out = out2
        out = nn._maybe_act(out, act)
        if comp:
            out.lod_companion = comp
        return out

    @staticmethod
    def conv2d(input: Variable, num_filters: int, filter_size, stride=1,
               padding=0, dilation=1, groups=1, act=None, param_attr=None,
               bias_attr=None, name=None) -> Variable:
        block = input.block
        k = filter_size if isinstance(filter_size, (list, tuple)) else \
            (filter_size, filter_size)
        in_c = input.shape[1]
        from ..nn import initializer as I
        fan_in = in_c * k[0] * k[1] // (groups or 1)
        w = create_parameter(
            [num_filters, in_c // (groups or 1), k[0], k[1]],
            input.dtype or "float32", attr=param_attr,
            default_initializer=(getattr(param_attr, "initializer", None)
                                 if param_attr else None) or
            I.KaimingNormal(fan_in))
        out = _new_tmp(block, name or "conv2d")
        _op(block, 
            "conv2d", {"Input": [input.name], "Filter": [w.name]},
            {"Output": [out.name]},
            {"strides": _ntuple(stride, 2),
             "paddings": _ntuple(padding, 2),
             "dilations": _ntuple(dilation, 2),
             "groups": groups or 1})
        if bias_attr is not False:
            b = create_parameter([num_filters], input.dtype or "float32",
                                 is_bias=True, attr=bias_attr)
            out2 = _new_tmp(block, "conv_bias")
            _op(block, "elementwise_add",
                            {"X": [out.name], "Y": [b.name]},
                            {"Out": [out2.name]}, {"axis": 1})
            out = out2
        return nn._maybe_act(out, act)

    @staticmethod
    def pool2d(input: Variable, pool_size=-1, pool_type="max",
               pool_stride=1, pool_padding=0, global_pooling=False,
               ceil_mode=False, exclusive=True, name=None) -> Variable:
        out = _new_tmp(input.block, name or "pool2d")
        _op(input.block, 
            "pool2d", {"X": [input.name]}, {"Out": [out.name]},
            {"ksize": _ntuple(pool_size, 2),
             "pooling_type": pool_type,
             "strides": _ntuple(pool_stride, 2),
             "paddings": _ntuple(pool_padding, 2),
             "global_pooling": global_pooling, "ceil_mode": ceil_mode,
             "exclusive": exclusive})
        return out

    @staticmethod
    def batch_norm(input: Variable, act=None, momentum=0.9, epsilon=1e-5,
                   param_attr=None, bias_attr=None, is_test=False,
                   name=None, moving_mean_name=None,
                   moving_variance_name=None) -> Variable:
        from ..nn import initializer as I
        block = input.block
        c = input.shape[1]
        scale = create_parameter([c], "float32", attr=param_attr,
                                 default_initializer=I.Constant(1.0))
        bias = create_parameter([c], "float32", is_bias=True, attr=bias_attr)
        # named moving stats (ref: fluid/layers/nn.py batch_norm
        # moving_mean_name/moving_variance_name): reference checkpoints
        # address the running stats by these names, and two layers can
        # share one stat pair by naming it
        mean = create_parameter([c], "float32", name=moving_mean_name,
                                default_initializer=I.Constant(0.0))
        var = create_parameter([c], "float32", name=moving_variance_name,
                               default_initializer=I.Constant(1.0))
        mean.desc.stop_gradient = True
        var.desc.stop_gradient = True
        out = _new_tmp(block, name or "batch_norm")
        saved_m = _new_tmp(block, "bn_saved_mean")
        saved_v = _new_tmp(block, "bn_saved_var")
        _op(block, 
            "batch_norm",
            {"X": [input.name], "Scale": [scale.name], "Bias": [bias.name],
             "Mean": [mean.name], "Variance": [var.name]},
            {"Y": [out.name], "MeanOut": [mean.name],
             "VarianceOut": [var.name], "SavedMean": [saved_m.name],
             "SavedVariance": [saved_v.name]},
            {"momentum": momentum, "epsilon": epsilon, "is_test": is_test})
        return nn._maybe_act(out, act)

    @staticmethod
    def embedding(input: Variable, size, is_sparse=False,
                  is_distributed=False, padding_idx=None,
                  param_attr=None, dtype="float32") -> Variable:
        w = create_parameter(list(size), dtype, attr=param_attr)
        out = _new_tmp(input.block, "embedding")
        # 1.x lod data declares a trailing [.., 1] ids dim; the dense
        # convention feeds [B, T] — lookup_table squeezes a trailing 1.
        # is_sparse is inert (the gather is dense); is_distributed is
        # recorded so contrib lookup_table_utils can find + convert the
        # op (ref: layers/nn.py embedding signature)
        _op(input.block,
            "lookup_table", {"W": [w.name], "Ids": [input.name]},
            {"Out": [out.name]},
            {"padding_idx": -1 if padding_idx is None else padding_idx,
             "is_sparse": bool(is_sparse),
             "is_distributed": bool(is_distributed)})
        comp = getattr(input, "lod_companion", None)
        if comp:
            out.lod_companion = comp       # ragged length rides along
        return out

    @staticmethod
    def dropout(x: Variable, dropout_prob, is_test=False, seed=None,
                dropout_implementation="downgrade_in_infer") -> Variable:
        out = _new_tmp(x.block, "dropout")
        mask = _new_tmp(x.block, "dropout_mask")
        _op(x.block, 
            "dropout", {"X": [x.name]},
            {"Out": [out.name], "Mask": [mask.name]},
            {"dropout_prob": dropout_prob, "is_test": is_test,
             "seed": seed or 0,
             "dropout_implementation": dropout_implementation})
        return out

    @staticmethod
    def _maybe_act(out: Variable, act: Optional[str]) -> Variable:
        if not act:
            return out
        out2 = _new_tmp(out.block, act)
        _op(out.block, act, {"X": [out.name]}, {"Out": [out2.name]}, {})
        return out2

    # -- losses / math --
    @staticmethod
    def softmax_with_cross_entropy(logits: Variable, label: Variable,
                                   soft_label=False, ignore_index=-100,
                                   return_softmax=False, axis=-1):
        block = logits.block
        loss = _new_tmp(block, "ce_loss")
        softmax = _new_tmp(block, "softmax")
        _op(block, 
            "softmax_with_cross_entropy",
            {"Logits": [logits.name], "Label": [label.name]},
            {"Loss": [loss.name], "Softmax": [softmax.name]},
            {"soft_label": soft_label, "ignore_index": ignore_index,
             "axis": axis})
        if return_softmax:
            return loss, softmax
        return loss

    @staticmethod
    def cross_entropy(input: Variable, label: Variable, soft_label=False,
                      ignore_index=-100) -> Variable:
        out = _new_tmp(input.block, "cross_entropy")
        _op(input.block, 
            "cross_entropy", {"X": [input.name], "Label": [label.name]},
            {"Y": [out.name]}, {"soft_label": soft_label,
                                "ignore_index": ignore_index})
        return out

    @staticmethod
    def mean(x: Variable, name=None) -> Variable:
        out = _new_tmp(x.block, name or "mean")
        out.desc.shape = ()
        _op(x.block, "mean", {"X": [x.name]}, {"Out": [out.name]}, {})
        return out

    @staticmethod
    def reduce_mean(x: Variable, dim=None, keep_dim=False) -> Variable:
        out = _new_tmp(x.block, "reduce_mean")
        attrs = {"keep_dim": keep_dim}
        if dim is None:
            attrs["reduce_all"] = True
        else:
            attrs["dim"] = dim if isinstance(dim, (list, tuple)) else [dim]
        _op(x.block, "reduce_mean", {"X": [x.name]},
                          {"Out": [out.name]}, attrs)
        return out

    @staticmethod
    def reduce_sum(x: Variable, dim=None, keep_dim=False) -> Variable:
        out = _new_tmp(x.block, "reduce_sum")
        attrs = {"keep_dim": keep_dim}
        if dim is None:
            attrs["reduce_all"] = True
        else:
            attrs["dim"] = dim if isinstance(dim, (list, tuple)) else [dim]
        _op(x.block, "reduce_sum", {"X": [x.name]},
                          {"Out": [out.name]}, attrs)
        return out

    @staticmethod
    def accuracy(input: Variable, label: Variable, k=1) -> Variable:
        block = input.block
        topk_out = _new_tmp(block, "topk_out")
        topk_idx = _new_tmp(block, "topk_idx")
        _op(block, "top_k", {"X": [input.name]},
                        {"Out": [topk_out.name], "Indices": [topk_idx.name]},
                        {"k": k})
        acc = _new_tmp(block, "accuracy")
        correct = _new_tmp(block, "correct")
        total = _new_tmp(block, "total")
        _op(block, 
            "accuracy",
            {"Out": [topk_out.name], "Indices": [topk_idx.name],
             "Label": [label.name]},
            {"Accuracy": [acc.name], "Correct": [correct.name],
             "Total": [total.name]}, {})
        return acc

    @staticmethod
    def relu(x: Variable) -> Variable:
        return nn._maybe_act(x, "relu")

    @staticmethod
    def softmax(x: Variable, axis=-1) -> Variable:
        out = _new_tmp(x.block, "softmax")
        _op(x.block, "softmax", {"X": [x.name]}, {"Out": [out.name]},
                          {"axis": axis})
        return out

    @staticmethod
    def reshape(x: Variable, shape) -> Variable:
        out = _new_tmp(x.block, "reshape")
        _op(x.block, "reshape", {"X": [x.name]}, {"Out": [out.name]},
                          {"shape": list(shape)})
        return out

    @staticmethod
    def concat(inputs: List[Variable] = None, axis=0, name=None,
               input=None) -> Variable:
        # fluid 1.x scripts say concat(input=[...]); 2.x says concat(x=...)
        inputs = inputs if inputs is not None else input
        out = _new_tmp(inputs[0].block, "concat")
        _op(inputs[0].block,
            "concat", {"X": [v.name for v in inputs]}, {"Out": [out.name]},
            {"axis": axis})
        return out

    @staticmethod
    def scale(x: Variable, scale=1.0, bias=0.0) -> Variable:
        out = _new_tmp(x.block, "scale")
        _op(x.block, "scale", {"X": [x.name]}, {"Out": [out.name]},
                          {"scale": scale, "bias": bias})
        return out

    @staticmethod
    def matmul(x: Variable, y: Variable, transpose_x=False,
               transpose_y=False) -> Variable:
        out = _new_tmp(x.block, "matmul")
        _op(x.block, "matmul_v2", {"X": [x.name], "Y": [y.name]},
            {"Out": [out.name]},
            {"trans_x": transpose_x, "trans_y": transpose_y})
        return out

    @staticmethod
    def argmax(x: Variable, axis=-1, dtype="int64") -> Variable:
        out = _new_tmp(x.block, "argmax")
        _op(x.block, "arg_max", {"X": [x.name]}, {"Out": [out.name]},
            {"axis": axis, "dtype": dtype})
        return out

    @staticmethod
    def embedding_lookup(w: Variable, ids: Variable,
                         padding_idx=None) -> Variable:
        """Lookup into an existing parameter (the decode-loop form of
        embedding — ref: lookup_table_v2_op.cc)."""
        out = _new_tmp(w.block, "emb_lookup")
        _op(w.block, "lookup_table_v2",
            {"W": [w.name], "Ids": [ids.name]}, {"Out": [out.name]},
            {"padding_idx": -1 if padding_idx is None else padding_idx})
        return out

    @staticmethod
    def scatter_write(x: Variable, index: Variable,
                      updates: Variable) -> Variable:
        """x.at[index] = updates (ref: scatter_op.cc, overwrite mode)."""
        out = _new_tmp(x.block, "scatter")
        _op(x.block, "scatter",
            {"X": [x.name], "Ids": [index.name], "Updates": [updates.name]},
            {"Out": [out.name]}, {"overwrite": True})
        return out


class StaticOptimizerMixin:
    """Static-mode minimize for our optimizer classes (ref:
    fluid/optimizer.py Optimizer.minimize :56 — backward + accumulators
    + per-param update ops)."""

    def minimize_static(self, loss, startup_program: Optional[Program] = None,
                        parameter_list=None, no_grad_set=None):
        main = loss.program if hasattr(loss, "program") else \
            default_main_program()
        startup = startup_program or default_startup_program()
        param_grads = append_backward(
            loss if isinstance(loss, str) else loss.name,
            parameter_list=parameter_list, no_grad_set=no_grad_set,
            program=main)
        self._append_lr_and_update_ops(main, startup, param_grads)
        return [], param_grads

    def _append_lr_and_update_ops(self, main, startup, params_grads):
        """Create the lr var (+init) and one update op per (param, grad);
        shared by plain minimize and the static-AMP decorator."""
        block = main.global_block()
        lr_name = main.unique_name("learning_rate")
        block.create_var(lr_name, shape=(1,), persistable=True)
        startup.global_block().create_var(lr_name, shape=(1,),
                                          persistable=True)
        _op(startup.global_block(),
            "fill_constant", {}, {"Out": [lr_name]},
            {"shape": [1], "value": float(self.get_lr()),
             "dtype": "float32"})
        for p, g in params_grads:
            self._append_update_ops(block, startup.global_block(), p, g,
                                    lr_name, main)

    def _append_update_ops(self, block, startup_block, p, g, lr_name, main):
        op_type = self._op_type
        pdesc = block.var(p)
        inputs = {"Param": [p], "Grad": [g], "LearningRate": [lr_name]}
        outputs = {"ParamOut": [p]}
        state_out = self._op_state_outputs()
        pshape = list(pdesc.shape) if pdesc.shape else [1]
        for state_name in self._state_spec_names():
            sname = f"{p}@{op_type}@{state_name}"
            block.create_var(sname, persistable=True)
            startup_block.create_var(sname, persistable=True)
            init_val, init_shape = self._state_init(state_name, pshape)
            _op(startup_block, 
                "fill_constant", {}, {"Out": [sname]},
                {"shape": init_shape, "value": init_val, "dtype": "float32"})
            inputs[state_name] = [sname]
            if state_name in state_out:
                outputs[state_out[state_name]] = [sname]
        attrs = self._attrs()
        per_param = getattr(self, "_per_param_attrs", None)
        if per_param:
            attrs = dict(attrs, **per_param(p))
        _op(block, op_type, inputs, outputs, attrs)

    def _state_spec_names(self):
        return list(self._state_spec(torch.zeros((1,))).keys())

    def _state_init(self, state_name, pshape):
        if state_name == "Beta1Pow":
            return getattr(self, "_beta1", 0.9), [1]
        if state_name == "Beta2Pow":
            return getattr(self, "_beta2", 0.999), [1]
        if state_name == "Step":            # dpsgd noise counter
            return 0.0, [1]
        return 0.0, pshape


# --------------------------------------------------------------------
# Generated fluid.layers builders
#
# The long tail of fluid/layers/nn.py (214 defs) is mostly one op +
# attrs; a declarative table keeps the builder surface at parity
# without 150 hand-written functions. Each entry:
#   layer name: (op_type, [(python arg, input slot), ...],
#                [output slots], {attr name: default})
# Generated builders take the listed Variables positionally, then
# attr keyword args; extra outputs are returned as a tuple in slot
# order. Parameterized layers (weights) stay hand-written above/below.
# ---- control flow (sub-block builders; see control_flow.py) ----
from .control_flow import (DynamicRNN, StaticRNN, While, case, cond,  # noqa: E402,F401
                           switch_case, while_loop)

_SIMPLE_LAYERS = {
    # activations (fluid/layers/ops.py autogen family)
    **{name: (name, [("x", "X")], ["Out"], {})
       for name in [
           "sigmoid", "logsigmoid", "exp", "tanh", "tanh_shrink", "sqrt",
           "rsqrt", "abs", "ceil", "floor", "cos", "sin", "tan", "acos",
           "asin", "atan", "sinh", "cosh", "round", "reciprocal",
           "square", "softplus", "softsign", "relu6", "gelu", "erf",
           "silu", "mish", "log", "log2", "log10", "log1p", "sign"]},
    "leaky_relu": ("leaky_relu", [("x", "X")], ["Out"], {"alpha": 0.02}),
    "elu": ("elu", [("x", "X")], ["Out"], {"alpha": 1.0}),
    "selu": ("selu", [("x", "X")], ["Out"],
             {"scale": 1.0507009873554805, "alpha": 1.6732632423543772}),
    "hard_shrink": ("hard_shrink", [("x", "X")], ["Out"],
                    {"threshold": 0.5}),
    "soft_shrink": ("soft_shrink", [("x", "X")], ["Out"],
                    {"lambda": 0.5}),
    "hard_sigmoid": ("hard_sigmoid", [("x", "X")], ["Out"],
                     {"slope": 0.2, "offset": 0.5}),
    "hard_swish": ("hard_swish", [("x", "X")], ["Out"],
                   {"threshold": 6.0, "scale": 6.0, "offset": 3.0}),
    "swish": ("swish", [("x", "X")], ["Out"], {"beta": 1.0}),
    "thresholded_relu": ("thresholded_relu", [("x", "X")], ["Out"],
                         {"threshold": 1.0}),
    "stanh": ("stanh", [("x", "X")], ["Out"],
              {"scale_a": 0.67, "scale_b": 1.7159}),
    "log_softmax": ("log_softmax", [("x", "X")], ["Out"], {"axis": -1}),
    # elementwise binary
    **{f"elementwise_{k}": (f"elementwise_{k}",
                            [("x", "X"), ("y", "Y")], ["Out"],
                            {"axis": -1})
       for k in ["add", "sub", "mul", "div", "max", "min", "mod",
                 "floordiv", "pow"]},
    "maximum": ("maximum", [("x", "X"), ("y", "Y")], ["Out"], {}),
    "minimum": ("minimum", [("x", "X"), ("y", "Y")], ["Out"], {}),
    "pow": ("pow", [("x", "X")], ["Out"], {"factor": 1.0}),
    # tensor manipulation
    "transpose": ("transpose2", [("x", "X")], ["Out"], {"axis": []}),
    "unsqueeze": ("unsqueeze2", [("x", "X")], ["Out"], {"axes": []}),
    "squeeze": ("squeeze2", [("x", "X")], ["Out"], {"axes": []}),
    "flatten": ("flatten2", [("x", "X")], ["Out"], {"axis": 1}),
    "stack": ("stack", [("x", "X*")], ["Y"], {"axis": 0}),
    "unstack": ("unstack", [("x", "X")], ["Y*"], {"axis": 0}),
    "gather": ("gather", [("input", "X"), ("index", "Index")], ["Out"],
               {}),
    "gather_nd": ("gather_nd", [("input", "X"), ("index", "Index")],
                  ["Out"], {}),
    "scatter": ("scatter", [("input", "X"), ("index", "Ids"),
                            ("updates", "Updates")], ["Out"],
                {"overwrite": True}),
    "scatter_nd_add": ("scatter_nd_add",
                       [("ref", "X"), ("index", "Index"),
                        ("updates", "Updates")], ["Out"], {}),
    "where": ("where", [("condition", "Condition"), ("x", "X"),
                        ("y", "Y")], ["Out"], {}),
    "where_index": ("where_index", [("condition", "Condition")],
                    ["Out"], {}),
    "topk": ("top_k_v2", [("input", "X")], ["Out", "Indices"],
             {"k": 1, "axis": -1, "largest": True, "sorted": True}),
    "argsort": ("argsort", [("input", "X")], ["Out", "Indices"],
                {"axis": -1, "descending": False}),
    "argmax": ("arg_max", [("x", "X")], ["Out"],
               {"axis": -1, "keepdims": False}),
    "argmin": ("arg_min", [("x", "X")], ["Out"],
               {"axis": -1, "keepdims": False}),
    "cast": ("cast", [("x", "X")], ["Out"], {"out_dtype": "float32"}),
    "clip": ("clip", [("x", "X")], ["Out"], {"min": -1.0, "max": 1.0}),
    "clip_by_norm": ("clip_by_norm", [("x", "X")], ["Out"],
                     {"max_norm": 1.0}),
    "cumsum": ("cumsum", [("x", "X")], ["Out"],
               {"axis": -1, "exclusive": False, "reverse": False}),
    "flip": ("flip", [("x", "X")], ["Out"], {"axis": [0]}),
    "roll": ("roll", [("x", "X")], ["Out"], {"shifts": [0], "axis": []}),
    "pad": ("pad", [("x", "X")], ["Out"],
            {"paddings": [], "pad_value": 0.0}),
    "pad2d": ("pad2d", [("x", "X")], ["Out"],
              {"paddings": [0, 0, 0, 0], "mode": "constant",
               "pad_value": 0.0, "data_format": "NCHW"}),
    "shape": ("shape", [("x", "X")], ["Out"], {}),
    "slice": ("slice", [("input", "Input")], ["Out"],
              {"axes": [], "starts": [], "ends": []}),
    "strided_slice": ("strided_slice", [("input", "X")], ["Out"],
                      {"axes": [], "starts": [], "ends": [],
                       "strides": []}),
    "split": ("split", [("input", "X")], ["Out*"],
              {"num": 2, "sections": [], "axis": 0}),
    "expand": ("expand", [("x", "X")], ["Out"], {"expand_times": []}),
    "expand_as": ("expand_as_v2", [("x", "X"), ("y", "Y")], ["Out"], {}),
    "tile": ("tile", [("x", "X")], ["Out"], {"repeat_times": []}),
    "reverse": ("reverse", [("x", "X")], ["Out"], {"axis": [0]}),
    "one_hot": ("one_hot_v2", [("input", "X")], ["Out"], {"depth": 1}),
    "reduce_max": ("reduce_max", [("input", "X")], ["Out"],
                   {"dim": [], "keep_dim": False, "reduce_all": False}),
    "reduce_min": ("reduce_min", [("input", "X")], ["Out"],
                   {"dim": [], "keep_dim": False, "reduce_all": False}),
    "reduce_prod": ("reduce_prod", [("input", "X")], ["Out"],
                    {"dim": [], "keep_dim": False, "reduce_all": False}),
    "meshgrid": ("meshgrid", [("x", "X*")], ["Out*"], {}),
    "unbind": ("unbind", [("input", "X")], ["Out*"], {"axis": 0}),
    "masked_select": ("masked_select",
                      [("input", "X"), ("mask", "Mask")], ["Y"], {}),
    "index_sample": ("index_sample",
                     [("x", "X"), ("index", "Index")], ["Out"], {}),
    "index_select": ("index_select",
                     [("x", "X"), ("index", "Index")], ["Out"],
                     {"dim": 0}),
    "multiplex": ("multiplex", [("inputs", "X*"), ("index", "Ids")],
                  ["Out"], {}),
    "gather_tree": ("gather_tree", [("ids", "Ids"),
                                    ("parents", "Parents")], ["Out"],
                    {}),
    # math / linalg
    "matmul_v2": ("matmul_v2", [("x", "X"), ("y", "Y")], ["Out"],
                  {"trans_x": False, "trans_y": False}),
    "bmm": ("bmm", [("x", "X"), ("y", "Y")], ["Out"], {}),
    "mv": ("mv", [("x", "X"), ("vec", "Vec")], ["Out"], {}),
    "dot": ("dot", [("x", "X"), ("y", "Y")], ["Out"], {}),
    "addmm": ("addmm", [("input", "Input"), ("x", "X"), ("y", "Y")],
              ["Out"], {"alpha": 1.0, "beta": 1.0}),
    "kron": ("kron", [("x", "X"), ("y", "Y")], ["Out"], {}),
    "cross": ("cross", [("x", "X"), ("y", "Y")], ["Out"], {"dim": 9}),
    "dist": ("dist", [("x", "X"), ("y", "Y")], ["Out"], {"p": 2.0}),
    "trace": ("trace", [("input", "Input")], ["Out"],
              {"offset": 0, "axis1": 0, "axis2": 1}),
    "inverse": ("inverse", [("input", "Input")], ["Output"], {}),
    "cholesky": ("cholesky", [("x", "X")], ["Out"], {"upper": False}),
    "logsumexp": ("logsumexp", [("x", "X")], ["Out"],
                  {"axis": [], "keepdim": False, "reduce_all": False}),
    "frobenius_norm": ("frobenius_norm", [("x", "X")], ["Out"],
                       {"dim": [], "keep_dim": False,
                        "reduce_all": False}),
    "l1_norm": ("l1_norm", [("x", "X")], ["Out"], {}),
    "l2_normalize": ("norm", [("x", "X")], ["Out"],
                     {"axis": -1, "epsilon": 1e-10}),
    "cumprod": ("cumprod", [("x", "X")], ["Out"], {"dim": -1}),
    "isfinite": ("isfinite", [("x", "X")], ["Out"], {}),
    "increment_op": ("increment", [("x", "X")], ["Out"], {"step": 1.0}),
    # losses
    "mse_loss": ("mse_loss", [("input", "X"), ("label", "Label")],
                 ["Out"], {}),
    "huber_loss": ("huber_loss", [("input", "X"), ("label", "Y")],
                   ["Out"], {"delta": 1.0}),
    "bce_loss": ("bce_loss", [("input", "X"), ("label", "Label")],
                 ["Out"], {}),
    "kldiv_loss": ("kldiv_loss", [("x", "X"), ("target", "Target")],
                   ["Loss"], {"reduction": "mean"}),
    "log_loss": ("log_loss", [("input", "Predicted"),
                              ("label", "Labels")], ["Loss"],
                 {"epsilon": 1e-4}),
    "hinge_loss": ("hinge_loss", [("input", "Logits"),
                                  ("label", "Labels")], ["Loss"], {}),
    "rank_loss": ("rank_loss", [("label", "Label"), ("left", "Left"),
                                ("right", "Right")], ["Out"], {}),
    "margin_rank_loss": ("margin_rank_loss",
                         [("label", "Label"), ("left", "X1"),
                          ("right", "X2")], ["Out"], {"margin": 0.1}),
    "bpr_loss": ("bpr_loss", [("input", "X"), ("label", "Label")],
                 ["Y"], {}),
    "nll_loss": ("nll_loss", [("input", "X"), ("label", "Label")],
                 ["Out"], {"reduction": "mean", "ignore_index": -100}),
    "sigmoid_focal_loss": ("sigmoid_focal_loss",
                           [("x", "X"), ("label", "Label"),
                            ("fg_num", "FgNum")], ["Out"],
                           {"gamma": 2.0, "alpha": 0.25}),
    "smooth_l1": ("smooth_l1_loss", [("x", "X"), ("y", "Y")], ["Out"],
                  {"sigma": 1.0}),
    "sigmoid_cross_entropy_with_logits":
        ("sigmoid_cross_entropy_with_logits",
         [("x", "X"), ("label", "Label")], ["Out"],
         {"ignore_index": -100, "normalize": False}),
    "cos_sim": ("cos_sim", [("x", "X"), ("y", "Y")], ["Out"], {}),
    "minus": ("minus", [("x", "X"), ("y", "Y")], ["Out"], {}),
    "label_smooth": ("label_smooth", [("label", "X")], ["Out"],
                     {"epsilon": 0.1}),
    "warpctc": ("warpctc", [("input", "Logits"), ("label", "Label")],
                ["Loss"], {"blank": 0, "norm_by_times": False}),
    "edit_distance": ("edit_distance", [("input", "Hyps"),
                                        ("label", "Refs")],
                      ["Out", "SequenceNum"], {"normalized": False}),
    "ctc_greedy_decoder": ("ctc_align", [("input", "Input")],
                           ["Output", "OutputLength"], {"blank": 0}),
    "linear_chain_crf_loss": ("linear_chain_crf",
                              [("input", "Emission"),
                               ("transition", "Transition"),
                               ("label", "Label")],
                              ["LogLikelihood"], {}),
    "crf_decoding": ("crf_decoding", [("input", "Emission"),
                                      ("transition", "Transition")],
                     ["ViterbiPath"], {}),
    # vision
    "image_resize": ("bilinear_interp", [("input", "X")], ["Out"],
                     {"out_h": 0, "out_w": 0, "scale": 0.0,
                      "align_corners": True, "align_mode": 1}),
    "resize_bilinear": ("bilinear_interp", [("input", "X")], ["Out"],
                        {"out_h": 0, "out_w": 0, "scale": 0.0,
                         "align_corners": True, "align_mode": 1}),
    "resize_nearest": ("nearest_interp", [("input", "X")], ["Out"],
                       {"out_h": 0, "out_w": 0, "scale": 0.0,
                        "align_corners": True}),
    "resize_trilinear": ("trilinear_interp", [("input", "X")], ["Out"],
                         {"out_d": 0, "out_h": 0, "out_w": 0,
                          "scale": 0.0, "align_corners": True,
                          "align_mode": 1}),
    "resize_bicubic": ("bicubic_interp", [("input", "X")], ["Out"],
                       {"out_h": 0, "out_w": 0, "scale": 0.0,
                        "align_corners": True}),
    "grid_sampler": ("grid_sampler", [("x", "X"), ("grid", "Grid")],
                     ["Output"], {"mode": "bilinear",
                                  "padding_mode": "zeros",
                                  "align_corners": True}),
    "affine_grid": ("affine_grid", [("theta", "Theta")], ["Output"],
                    {"output_shape": [], "align_corners": True}),
    "affine_channel": ("affine_channel",
                       [("x", "X"), ("scale", "Scale"),
                        ("bias", "Bias")], ["Out"],
                       {"data_layout": "NCHW"}),
    "pixel_shuffle": ("pixel_shuffle", [("x", "X")], ["Out"],
                      {"upscale_factor": 1, "data_format": "NCHW"}),
    "shuffle_channel": ("shuffle_channel", [("x", "X")], ["Out"],
                        {"group": 1}),
    "space_to_depth": ("space_to_depth", [("x", "X")], ["Out"],
                       {"blocksize": 1}),
    "temporal_shift": ("temporal_shift", [("x", "X")], ["Out"],
                       {"seg_num": 1, "shift_ratio": 0.25}),
    "crop": ("crop", [("x", "X")], ["Out"],
             {"offsets": [], "shape": []}),
    "crop_tensor": ("crop_tensor", [("x", "X")], ["Out"],
                    {"offsets": [], "shape": []}),
    "pad_constant_like": ("pad_constant_like",
                          [("x", "X"), ("y", "Y")], ["Out"],
                          {"pad_value": 0.0}),
    "unfold": ("unfold", [("x", "X")], ["Y"],
               {"kernel_sizes": [1, 1], "strides": [1, 1],
                "paddings": [0, 0], "dilations": [1, 1]}),
    "unpool": ("unpool", [("x", "X"), ("indices", "Indices")], ["Out"],
               {"unpooled_size": []}),
    "pool3d": ("pool3d", [("input", "X")], ["Out"],
               {"pooling_type": "max", "ksize": [1, 1, 1],
                "strides": [1, 1, 1], "paddings": [0, 0, 0],
                "global_pooling": False, "exclusive": True,
                "adaptive": False}),
    "max_pool2d_with_index": ("max_pool2d_with_index", [("x", "X")],
                              ["Out", "Mask"],
                              {"ksize": [1, 1], "strides": [1, 1],
                               "paddings": [0, 0],
                               "global_pooling": False}),
    "lrn": ("lrn", [("input", "X")], ["Out"],
            {"n": 5, "k": 2.0, "alpha": 1e-4, "beta": 0.75}),
    "fsp_matrix": ("fsp", [("x", "X"), ("y", "Y")], ["Out"], {}),
    "row_conv": ("row_conv", [("input", "X"), ("filter", "Filter")],
                 ["Out"], {}),
    "conv_shift": ("conv_shift", [("x", "X"), ("y", "Y")], ["Out"], {}),
    # sequence family (dense-padded)
    "sequence_softmax": ("sequence_softmax", [("input", "X")], ["Out"],
                         {}),
    "sequence_reverse": ("sequence_reverse", [("x", "X")], ["Y"], {}),
    "sequence_concat": ("sequence_concat", [("x", "X*")], ["Out"], {}),
    "sequence_expand": ("sequence_expand", [("x", "X"), ("y", "Y")],
                        ["Out"], {"ref_level": -1}),
    "sequence_pad": ("sequence_pad",
                     [("x", "X"), ("pad_value", "PadValue")],
                     ["Out", "Length"], {"padded_length": -1}),
    "sequence_unpad": ("sequence_unpad",
                       [("x", "X"), ("length", "Length")], ["Out"], {}),
    "sequence_mask": ("sequence_mask", [("x", "X")], ["Y"],
                      {"maxlen": -1, "out_dtype": "int64"}),
    # misc
    "beam_search": ("beam_search",
                    [("pre_ids", "pre_ids"),
                     ("pre_scores", "pre_scores"),
                     ("scores", "scores")],
                    ["selected_ids", "selected_scores", "parent_idx"],
                    {"beam_size": 4, "end_id": 0}),
    "shard_index": ("shard_index", [("input", "X")], ["Out"],
                    {"index_num": 0, "nshards": 1, "shard_id": 0,
                     "ignore_value": -1}),
}


# simple-layer builders that preserve the [B, T, ...] layout and so
# propagate a ragged input's @seq_len companion to their output
_LOD_PRESERVING = {"sums", "elementwise_add", "elementwise_sub",
                   "elementwise_mul", "relu", "tanh", "sigmoid",
                   "dropout", "scale", "softmax", "leaky_relu", "gelu",
                   "sequence_softmax"}


def companion_length_of(input, length=None):
    """THE length resolver for sequence builders (fluid.layers,
    static nn, nets share it): explicit ``length`` wins, then the
    ragged input's @seq_len companion, then full-window lengths for a
    statically-shaped dense input. A dynamic-shape input whose
    companion was lost raises with the op to fix."""
    if length is not None:
        return length
    comp = getattr(input, "lod_companion", None)
    if comp:
        return Variable(input.block, comp)
    b = int(input.shape[0]) if input.shape else -1
    t = int(input.shape[1]) if input.shape and len(input.shape) > 1 else -1
    enforce(b > 0 and t > 0,
            f"sequence op on {input.name!r}: no @seq_len companion and "
            f"shape {input.shape} is dynamic — the producing op dropped "
            f"the ragged-length association (extend _LOD_PRESERVING or "
            f"pass length= explicitly)", InvalidArgumentError)
    return fill_constant([b], "int64", t)


def _make_simple_layer(lname, op_type, arg_slots, out_slots, defaults):
    def builder(*args, name=None, act=None, **kwargs):
        # fluid also allows input vars by their python arg names
        # (`elementwise_add(x=a, y=b)`) — lift those out of kwargs
        if len(args) < len(arg_slots):
            lifted = list(args)
            for pname, _slot in arg_slots[len(args):]:
                for key in (pname, pname.upper(), pname.capitalize()):
                    if key in kwargs:       # fluid also spells cos_sim(X=,Y=)
                        lifted.append(kwargs.pop(key))
                        break
            args = tuple(lifted)
        # exact positional arity: silently dropping a positional (e.g. a
        # fluid-style positional attr like topk(x, 5)) would build a
        # wrong graph with no error
        enforce(len(args) == len(arg_slots),
                f"{lname} takes exactly {len(arg_slots)} positional "
                f"input(s) ({[p for p, _ in arg_slots]}), got "
                f"{len(args)}; pass attributes as keywords "
                f"(valid: {sorted(defaults)})", InvalidArgumentError)
        inputs = {}
        for (pname, slot), a in zip(arg_slots, args):
            if slot.endswith("*"):          # list-of-vars slot
                vs = a if isinstance(a, (list, tuple)) else [a]
                inputs[slot[:-1]] = [v.name for v in vs]
                block = vs[0].block
            else:
                inputs[slot] = [a.name]
                block = a.block
        attrs = dict(defaults)
        for k, v in kwargs.items():
            enforce(k in defaults,
                    f"{lname}: unknown attr {k!r} (valid: "
                    f"{sorted(defaults)})", InvalidArgumentError)
            attrs[k] = v
        outs = []
        outputs = {}
        for slot in out_slots:
            if slot.endswith("*"):
                # variadic outputs sized from the attrs / input shape
                n_out = attrs.get("sections") or attrs.get("num", 2)
                if isinstance(n_out, (list, tuple)):
                    n_out = len(n_out)
                first = block.find_var_recursive(
                    next(iter(inputs.values()))[0])
                if lname in ("unstack", "unbind", "meshgrid"):
                    if lname == "meshgrid":
                        n_out = len(inputs["X"])
                    else:
                        ax = attrs.get("axis", 0)
                        enforce(first is not None and first.shape and
                                int(first.shape[ax]) > 0,
                                f"{lname} needs a static positive dim "
                                f"on axis {ax} to size its outputs, got "
                                f"shape {first.shape if first else None}",
                                InvalidArgumentError)
                        n_out = int(first.shape[ax])
                vs = [_new_tmp(block, f"{lname}_{slot[:-1].lower()}{i}")
                      for i in range(int(n_out))]
                outputs[slot[:-1]] = [v.name for v in vs]
                outs.append(vs)
            else:
                v = _new_tmp(block, f"{lname}_{slot.lower()}")
                outputs[slot] = [v.name]
                outs.append(v)
        _op(block, op_type, inputs, outputs, attrs)
        if lname in _LOD_PRESERVING and len(outs) == 1:
            # shape-preserving ops keep the ragged-length association
            first = args[0][0] if isinstance(args[0], (list, tuple)) \
                else args[0]
            comp = getattr(first, "lod_companion", None)
            if comp:
                outs[0].lod_companion = comp
        if act is not None and len(outs) == 1:
            return nn._maybe_act(outs[0], act)
        return outs[0] if len(outs) == 1 else tuple(outs)

    builder.__name__ = lname
    builder.__doc__ = (f"fluid.layers.{lname} parity builder "
                       f"(op: {op_type}).")
    return staticmethod(builder)


for _lname, (_otype, _slots, _osl, _defs) in _SIMPLE_LAYERS.items():
    if not hasattr(nn, _lname):
        setattr(nn, _lname, _make_simple_layer(_lname, _otype, _slots,
                                               _osl, _defs))


def _sequence_conv(input, num_filters, filter_size=3, filter_stride=1,
                   padding=True, padding_start=None, act=None,
                   param_attr=None, bias_attr=None, name=None):

    d = input.shape[-1]
    w = create_parameter([filter_size * int(d), num_filters],
                         "float32", attr=param_attr)
    out = _new_tmp(input.block, name or "seq_conv")
    start = (padding_start if padding_start is not None
             else -(filter_size // 2))
    _op(input.block, "sequence_conv",
        {"X": [input.name], "Filter": [w.name]},
        {"Out": [out.name]},
        {"contextLength": int(filter_size),
         "contextStart": int(start),
         "contextStride": int(filter_stride)})
    if bias_attr is not False:
        b = create_parameter([num_filters], "float32", is_bias=True,
                             attr=bias_attr)
        out2 = _new_tmp(input.block, "seq_conv_bias")
        _op(input.block, "elementwise_add",
            {"X": [out.name], "Y": [b.name]}, {"Out": [out2.name]},
            {"axis": 2})
        out = out2
    return nn._maybe_act(out, act)


_sequence_conv.__name__ = "sequence_conv"
nn.sequence_conv = staticmethod(_sequence_conv)


def _recurrent_builders():
    """The JAX package's fluid builders of the recurrent ops
    (``paddle_tpu/static/__init__.py:1352-1454``): ``dynamic_lstm``
    (whose ragged input hands its @seq_len companion to the op's Length
    and on to Hidden and Cell), ``dynamic_gru`` and ``row_conv``, each
    creating its parameters."""

    def dynamic_lstm(input, size, h_0=None, c_0=None, param_attr=None,
                     bias_attr=None, use_peepholes=True,
                     is_reverse=False, gate_activation="sigmoid",
                     cell_activation="tanh",
                     candidate_activation="tanh", name=None):
        """ref: fluid/layers/nn.py dynamic_lstm: input is the
        pre-projected [B, T, 4D] sequence (fc + lstm pairing).
        use_peepholes defaults True like the reference (bias is then
        [1, 7D]: gate biases + W_ic/W_fc/W_oc peephole weights)."""
        d = size // 4
        w = create_parameter([d, 4 * d], "float32", attr=param_attr)
        b = create_parameter([1, 7 * d if use_peepholes else 4 * d],
                             "float32", is_bias=True, attr=bias_attr)
        ins = {"Input": [input.name], "Weight": [w.name],
               "Bias": [b.name]}
        comp = getattr(input, "lod_companion", None)
        if comp:        # ragged batch: per-sequence lengths (and reverse)
            ins["Length"] = [comp]
        if h_0 is not None:
            ins["H0"] = [h_0.name]
        if c_0 is not None:
            ins["C0"] = [c_0.name]
        hidden = _new_tmp(input.block, name or "lstm_hidden")
        cell = _new_tmp(input.block, "lstm_cell")
        bg = _new_tmp(input.block, "lstm_gates")
        bc = _new_tmp(input.block, "lstm_preact")
        _op(input.block, "lstm", ins,
            {"Hidden": [hidden.name], "Cell": [cell.name],
             "BatchGate": [bg.name], "BatchCellPreAct": [bc.name]},
            {"use_peepholes": use_peepholes, "is_reverse": is_reverse,
             "gate_activation": gate_activation,
             "cell_activation": cell_activation,
             "candidate_activation": candidate_activation})
        if comp:
            hidden.lod_companion = comp
            cell.lod_companion = comp
        return hidden, cell

    def dynamic_gru(input, size, h_0=None, param_attr=None,
                    bias_attr=None, is_reverse=False,
                    gate_activation="sigmoid", candidate_activation="tanh",
                    origin_mode=False, name=None):
        """ref: fluid/layers/nn.py dynamic_gru: input [B, T, 3D]."""
        w = create_parameter([size, 3 * size], "float32",
                             attr=param_attr)
        b = create_parameter([1, 3 * size], "float32", is_bias=True,
                             attr=bias_attr)
        ins = {"Input": [input.name], "Weight": [w.name],
               "Bias": [b.name]}
        if h_0 is not None:
            ins["H0"] = [h_0.name]
        hidden = _new_tmp(input.block, name or "gru_hidden")
        bg = _new_tmp(input.block, "gru_gates")
        br = _new_tmp(input.block, "gru_reset")
        bh = _new_tmp(input.block, "gru_hidden_b")
        _op(input.block, "gru", ins,
            {"Hidden": [hidden.name], "BatchGate": [bg.name],
             "BatchResetHiddenPrev": [br.name],
             "BatchHidden": [bh.name]},
            {"is_reverse": is_reverse, "origin_mode": origin_mode,
             "gate_activation": gate_activation,
             "activation": candidate_activation})
        return hidden

    def row_conv(input, future_context_size, param_attr=None,
                 act=None, name=None):
        d = input.shape[-1]
        w = create_parameter([future_context_size, int(d)], "float32",
                             attr=param_attr)
        out = _new_tmp(input.block, name or "row_conv")
        _op(input.block, "row_conv",
            {"X": [input.name], "Filter": [w.name]},
            {"Out": [out.name]}, {})
        return nn._maybe_act(out, act)

    for fn in (dynamic_lstm, dynamic_gru, row_conv):
        setattr(nn, fn.__name__, staticmethod(fn))


_recurrent_builders()


# ------------------------------------------------------------------
# The JAX package's parameterized fluid.layers builders
# (``paddle_tpu/static/__init__.py:1213-1462``) that the recurrent ones
# above leave: they create their weights, then append their op, and
# replace a same-named table builder.
def _param_layer_ns():
    def conv2d_transpose(input, num_filters, filter_size, stride=1,
                         padding=0, output_padding=0, dilation=1,
                         groups=1, act=None, param_attr=None,
                         bias_attr=None, name=None):
        """ref: fluid/layers/nn.py conv2d_transpose."""
        k = filter_size if isinstance(filter_size, (list, tuple)) else \
            (filter_size, filter_size)
        in_c = input.shape[1]
        w = create_parameter(
            [in_c, num_filters // (groups or 1), k[0], k[1]],
            input.dtype or "float32", attr=param_attr)
        out = _new_tmp(input.block, name or "conv2dT")
        _op(input.block, "conv2d_transpose",
            {"Input": [input.name], "Filter": [w.name]},
            {"Output": [out.name]},
            {"strides": _ntuple(stride, 2),
             "paddings": _ntuple(padding, 2),
             "output_padding": _ntuple(output_padding, 2),
             "dilations": _ntuple(dilation, 2),
             "groups": groups or 1})
        if bias_attr is not False:
            b = create_parameter([num_filters], input.dtype or "float32",
                                 is_bias=True, attr=bias_attr)
            out2 = _new_tmp(input.block, "convT_bias")
            _op(input.block, "elementwise_add",
                {"X": [out.name], "Y": [b.name]}, {"Out": [out2.name]},
                {"axis": 1})
            out = out2
        return nn._maybe_act(out, act)

    def conv3d(input, num_filters, filter_size, stride=1, padding=0,
               dilation=1, groups=1, act=None, param_attr=None,
               bias_attr=None, name=None):
        k = filter_size if isinstance(filter_size, (list, tuple)) else \
            (filter_size,) * 3
        in_c = input.shape[1]
        w = create_parameter(
            [num_filters, in_c // (groups or 1), k[0], k[1], k[2]],
            input.dtype or "float32", attr=param_attr)
        out = _new_tmp(input.block, name or "conv3d")
        _op(input.block, "conv3d",
            {"Input": [input.name], "Filter": [w.name]},
            {"Output": [out.name]},
            {"strides": _ntuple(stride, 3),
             "paddings": _ntuple(padding, 3),
             "dilations": _ntuple(dilation, 3),
             "groups": groups or 1})
        if bias_attr is not False:
            b = create_parameter([num_filters], input.dtype or "float32",
                                 is_bias=True, attr=bias_attr)
            out2 = _new_tmp(input.block, "conv3d_bias")
            _op(input.block, "elementwise_add",
                {"X": [out.name], "Y": [b.name]}, {"Out": [out2.name]},
                {"axis": 1})
            out = out2
        return nn._maybe_act(out, act)

    def layer_norm(input, scale=True, shift=True, begin_norm_axis=1,
                   epsilon=1e-5, param_attr=None, bias_attr=None,
                   act=None, name=None):
        """ref: fluid/layers/nn.py layer_norm."""
        from ..nn import initializer as I
        norm_size = 1
        for d in input.shape[begin_norm_axis:]:
            norm_size *= int(d)
        ins = {"X": [input.name]}
        if scale:
            s = create_parameter([norm_size], "float32", attr=param_attr,
                                 default_initializer=I.Constant(1.0))
            ins["Scale"] = [s.name]
        if shift:
            b = create_parameter([norm_size], "float32", is_bias=True,
                                 attr=bias_attr)
            ins["Bias"] = [b.name]
        out = _new_tmp(input.block, name or "layer_norm")
        mean = _new_tmp(input.block, "ln_mean")
        var = _new_tmp(input.block, "ln_var")
        _op(input.block, "layer_norm", ins,
            {"Y": [out.name], "Mean": [mean.name],
             "Variance": [var.name]},
            {"begin_norm_axis": int(begin_norm_axis),
             "epsilon": float(epsilon)})
        return nn._maybe_act(out, act)

    def group_norm(input, groups, epsilon=1e-5, param_attr=None,
                   bias_attr=None, act=None, name=None):
        from ..nn import initializer as I
        c = input.shape[1]
        ins = {"X": [input.name]}
        if param_attr is not False:
            s = create_parameter([c], "float32", attr=param_attr,
                                 default_initializer=I.Constant(1.0))
            ins["Scale"] = [s.name]
        if bias_attr is not False:
            b = create_parameter([c], "float32", is_bias=True,
                                 attr=bias_attr)
            ins["Bias"] = [b.name]
        out = _new_tmp(input.block, name or "group_norm")
        mean = _new_tmp(input.block, "gn_mean")
        var = _new_tmp(input.block, "gn_var")
        _op(input.block, "group_norm", ins,
            {"Y": [out.name], "Mean": [mean.name],
             "Variance": [var.name]},
            {"groups": int(groups), "epsilon": float(epsilon)})
        return nn._maybe_act(out, act)

    def instance_norm(input, epsilon=1e-5, param_attr=None,
                      bias_attr=None, name=None):
        from ..nn import initializer as I
        c = input.shape[1]
        s = create_parameter([c], "float32", attr=param_attr,
                             default_initializer=I.Constant(1.0))
        b = create_parameter([c], "float32", is_bias=True,
                             attr=bias_attr)
        out = _new_tmp(input.block, name or "instance_norm")
        mean = _new_tmp(input.block, "in_mean")
        var = _new_tmp(input.block, "in_var")
        _op(input.block, "instance_norm",
            {"X": [input.name], "Scale": [s.name], "Bias": [b.name]},
            {"Y": [out.name], "SavedMean": [mean.name],
             "SavedVariance": [var.name]},
            {"epsilon": float(epsilon)})
        return out

    def prelu(x, mode="all", param_attr=None, name=None):
        from ..nn import initializer as I
        shape = {"all": [1], "channel": [x.shape[1]],
                 "element": [int(np.prod(x.shape[1:]))]}[mode]
        alpha = create_parameter(shape, "float32", attr=param_attr,
                                 default_initializer=I.Constant(0.25))
        out = _new_tmp(x.block, name or "prelu")
        _op(x.block, "prelu",
            {"X": [x.name], "Alpha": [alpha.name]},
            {"Out": [out.name]}, {"mode": mode})
        return out

    for fn in (conv2d_transpose, conv3d, layer_norm, group_norm,
               instance_norm, prelu):
        setattr(nn, fn.__name__, staticmethod(fn))


_param_layer_ns()


# The JAX package's _SIMPLE_LAYERS_2 (less the two selected-rows
# builders, which come with their ops in ROADMAP item 8), with sum,
# sequence_pool and yolov3_loss of its later tables.
_SIMPLE_LAYERS_2 = {
    "logical_and": ("logical_and", [("x", "X"), ("y", "Y")], ["Out"], {}),
    "logical_or": ("logical_or", [("x", "X"), ("y", "Y")], ["Out"], {}),
    "logical_xor": ("logical_xor", [("x", "X"), ("y", "Y")], ["Out"], {}),
    "logical_not": ("logical_not", [("x", "X")], ["Out"], {}),
    "reduce_all": ("reduce_all", [("input", "X")], ["Out"],
                   {"dim": None, "keep_dim": False}),
    "reduce_any": ("reduce_any", [("input", "X")], ["Out"],
                   {"dim": None, "keep_dim": False}),
    "maxout": ("maxout", [("x", "X")], ["Out"], {"groups": 1, "axis": 1}),
    "mul": ("mul", [("x", "X"), ("y", "Y")], ["Out"],
            {"x_num_col_dims": 1, "y_num_col_dims": 1}),
    "im2sequence": ("im2sequence", [("input", "X")], ["Out"],
                    {"kernels": [1, 1], "strides": [1, 1],
                     "paddings": [0, 0, 0, 0]}),
    "roi_align": ("roi_align", [("input", "X"), ("rois", "ROIs")],
                  ["Out"],
                  {"pooled_height": 1, "pooled_width": 1,
                   "spatial_scale": 1.0, "sampling_ratio": -1}),
    "adaptive_pool2d": ("adaptive_pool2d", [("input", "X")], ["Out"],
                        {"pool_size": [1, 1], "pool_type": "max"}),
    "adaptive_pool3d": ("adaptive_pool3d", [("input", "X")], ["Out"],
                        {"pool_size": [1, 1, 1], "pool_type": "max"}),
    "brelu": ("brelu", [("x", "X")], ["Out"],
              {"t_min": 0.0, "t_max": 24.0}),
    "soft_relu": ("soft_relu", [("x", "X")], ["Out"],
                  {"threshold": 40.0}),
    "hash": ("hash", [("input", "X")], ["Out"],
             {"num_hash": 1, "mod_by": 1}),
    "sampling_id": ("sampling_id", [("x", "X")], ["Out"],
                    {"min": 0.0, "max": 1.0, "seed": 0}),
    "mean_iou": ("mean_iou",
                 [("input", "Predictions"), ("label", "Labels")],
                 ["OutMeanIou", "OutWrong", "OutCorrect"],
                 {"num_classes": 2}),
    "add_position_encoding": ("add_position_encoding", [("input", "X")],
                              ["Out"], {"alpha": 1.0, "beta": 1.0}),
    "unique": ("unique", [("x", "X")], ["Out", "Index"], {}),
    "unique_with_counts": ("unique_with_counts", [("x", "X")],
                           ["Out", "Index", "Count"], {}),
    "random_crop": ("random_crop", [("x", "X")], ["Out"],
                    {"shape": [], "seed": 0}),
    "similarity_focus": ("similarity_focus", [("input", "X")], ["Out"],
                         {"axis": 1, "indexes": [0]}),
    "scatter_nd": ("scatter_nd",
                   [("index", "Index"), ("updates", "Updates")],
                   ["Out"], {"shape": []}),
    "filter_by_instag": ("filter_by_instag",
                         [("ins", "Ins"), ("ins_tag", "Ins_tag"),
                          ("filter_tag", "Filter_tag")],
                         ["Out", "LossWeight"],
                         {"out_val_if_empty": 0.0}),
    "continuous_value_model": ("cvm", [("input", "X")], ["Y"],
                               {"use_cvm": True}),
    "uniform_random_batch_size_like": (
        "uniform_random_batch_size_like", [("input", "Input")], ["Out"],
        {"shape": [], "min": -1.0, "max": 1.0, "seed": 0,
         "input_dim_idx": 0, "output_dim_idx": 0}),
    "gaussian_random_batch_size_like": (
        "gaussian_random_batch_size_like", [("input", "Input")], ["Out"],
        {"shape": [], "mean": 0.0, "std": 1.0, "seed": 0,
         "input_dim_idx": 0, "output_dim_idx": 0}),
    "chunk_eval": ("chunk_eval",
                   [("input", "Inference"), ("label", "Label")],
                   ["Precision", "Recall", "F1-Score", "NumInferChunks",
                    "NumLabelChunks", "NumCorrectChunks"],
                   {"num_chunk_types": 1, "chunk_scheme": "iob"}),
    "sum": ("sum", [("x", "X*")], ["Out"], {}),
    "sequence_pool": ("sequence_pool",
                      [("input", "X"), ("length", "Length")], ["Out"],
                      {"pooltype": "SUM"}),
    "sums": ("sum", [("input", "X*")], ["Out"], {}),
    # fluid contract: lod_reset returns ONE var (the data with new lod);
    # OutLength is internal dense-convention plumbing
    "lod_reset": ("lod_reset", [("x", "X"), ("y", "Y")],
                  ["Out"], {}),
    "yolov3_loss": ("yolov3_loss",
                    [("x", "X"), ("gt_box", "GTBox"),
                     ("gt_label", "GTLabel")], ["Loss"],
                    {"anchors": [], "anchor_mask": [], "class_num": 1,
                     "ignore_thresh": 0.7, "downsample_ratio": 32,
                     "use_label_smooth": True}),
}
for _lname, (_otype, _slots, _osl, _defs) in _SIMPLE_LAYERS_2.items():
    if not hasattr(nn, _lname):
        setattr(nn, _lname, _make_simple_layer(_lname, _otype, _slots,
                                               _osl, _defs))


def _param_layer_ns_2():
    """The JAX package's remaining parameterized builders
    (``paddle_tpu/static/__init__.py:1565-1834``), ``deformable_roi_pooling``
    aside (the detection builders below)."""

    def bilinear_tensor_product(x, y, size, act=None, name=None,
                                param_attr=None, bias_attr=None):
        """ref: fluid/layers/nn.py bilinear_tensor_product:
        out_s = x·W_s·yᵀ (+ b)."""
        m = int(x.shape[-1])
        n_ = int(y.shape[-1])
        w = create_parameter([size, m, n_], "float32", attr=param_attr)
        out = _new_tmp(x.block, name or "bilinear_tp")
        _op(x.block, "bilinear_tensor_product",
            {"X": [x.name], "Y": [y.name], "Weight": [w.name]},
            {"Out": [out.name]}, {})
        if bias_attr is not False:
            b = create_parameter([size], "float32", is_bias=True,
                                 attr=bias_attr)
            out2 = _new_tmp(x.block, "bilinear_tp_bias")
            _op(x.block, "elementwise_add",
                {"X": [out.name], "Y": [b.name]}, {"Out": [out2.name]},
                {"axis": -1})
            out = out2
        return nn._maybe_act(out, act)

    def spectral_norm(weight, dim=0, power_iters=1, eps=1e-12,
                      name=None):
        """ref: nn.py spectral_norm: creates the persistent U/V
        power-iteration vectors."""
        from ..nn import initializer as I
        shape = weight.shape
        perm_rows = int(shape[dim])
        cols = 1
        for i, d in enumerate(shape):
            if i != dim:
                cols *= int(d)
        u = create_parameter([perm_rows], "float32",
                             default_initializer=I.Normal(0.0, 1.0))
        v = create_parameter([cols], "float32",
                             default_initializer=I.Normal(0.0, 1.0))
        u.desc.stop_gradient = True
        v.desc.stop_gradient = True
        out = _new_tmp(weight.block, name or "spectral_norm")
        _op(weight.block, "spectral_norm",
            {"Weight": [weight.name], "U": [u.name], "V": [v.name]},
            {"Out": [out.name]},
            {"dim": int(dim), "power_iters": int(power_iters),
             "eps": float(eps)})
        return out

    def data_norm(input, act=None, epsilon=1e-5, param_attr=None,
                  name=None, **kwargs):
        """ref: nn.py data_norm: creates the accumulated batch-stat
        params (reference init: size 1e4, sum 0, square_sum 1e4)."""
        from ..nn import initializer as I
        c = int(input.shape[-1])
        bsize = create_parameter([c], "float32",
                                 default_initializer=I.Constant(1e4))
        bsum = create_parameter([c], "float32",
                                default_initializer=I.Constant(0.0))
        bsq = create_parameter([c], "float32",
                               default_initializer=I.Constant(1e4))
        out = _new_tmp(input.block, name or "data_norm")
        means = _new_tmp(input.block, "dn_means")
        scales = _new_tmp(input.block, "dn_scales")
        _op(input.block, "data_norm",
            {"X": [input.name], "BatchSize": [bsize.name],
             "BatchSum": [bsum.name], "BatchSquareSum": [bsq.name]},
            {"Y": [out.name], "Means": [means.name],
             "Scales": [scales.name]}, {"epsilon": float(epsilon)})
        return nn._maybe_act(out, act)

    def deformable_conv(input, offset, mask, num_filters, filter_size,
                        stride=1, padding=0, dilation=1, groups=1,
                        deformable_groups=1, im2col_step=1,
                        param_attr=None, bias_attr=None,
                        modulated=True, name=None):
        """ref: nn.py deformable_conv: creates the Filter param; v1
        (modulated=False) drops the Mask input."""
        k = filter_size if isinstance(filter_size, (list, tuple)) else \
            (filter_size, filter_size)
        in_c = int(input.shape[1])
        w = create_parameter([num_filters, in_c // (groups or 1),
                              k[0], k[1]], "float32", attr=param_attr)
        out = _new_tmp(input.block, name or "deformable_conv")
        ins = {"Input": [input.name], "Offset": [offset.name],
               "Filter": [w.name]}
        op_type = "deformable_conv" if modulated else \
            "deformable_conv_v1"
        if modulated:
            ins["Mask"] = [mask.name]
        _op(input.block, op_type, ins, {"Output": [out.name]},
            {"strides": _ntuple(stride, 2),
             "paddings": _ntuple(padding, 2),
             "dilations": _ntuple(dilation, 2),
             "groups": groups or 1,
             "deformable_groups": deformable_groups or 1})
        if bias_attr is not False:
            b = create_parameter([num_filters], "float32", is_bias=True,
                                 attr=bias_attr)
            out2 = _new_tmp(input.block, "dcn_bias")
            _op(input.block, "elementwise_add",
                {"X": [out.name], "Y": [b.name]}, {"Out": [out2.name]},
                {"axis": 1})
            out = out2
        return out


    def dice_loss(input, label, epsilon=1e-5):
        """ref: nn.py dice_loss: label is one-hot'd to the class dim,
        dice computed per sample then averaged (the reference's exact
        composition; no dedicated kernel there either)."""
        depth = int(input.shape[-1])
        # v1 one_hot semantics (the reference's): a trailing 1-dim is
        # REPLACED by depth, so label [N,1] one-hots to [N, depth]
        lab = _new_tmp(label.block, "dice_onehot")
        _op(label.block, "one_hot", {"X": [label.name]},
            {"Out": [lab.name]}, {"depth": depth})
        # the reference reduces ONLY over the last dim (reduce_dim =
        # len(input.shape) - 1), not all non-batch dims
        reduce_dim = [len(input.shape) - 1]
        inse = nn.reduce_sum(nn.elementwise_mul(input, lab),
                             dim=reduce_dim)
        denom = nn.elementwise_add(
            nn.reduce_sum(input, dim=reduce_dim),
            nn.reduce_sum(lab, dim=reduce_dim))
        two_inse = nn.scale(inse, scale=2.0)
        denom_eps = nn.scale(denom, scale=1.0, bias=float(epsilon))
        score = nn.scale(nn.elementwise_div(two_inse, denom_eps),
                         scale=-1.0, bias=1.0)
        return nn.reduce_mean(score)

    def autoincreased_step_counter(counter_name=None, begin=1, step=1):
        """ref: nn.py autoincreased_step_counter: persistable int
        counter bumped by `step` each execution; the init lives in the
        STARTUP program (create_parameter's pattern) so the value
        survives across Executor.run calls."""
        from ..nn import initializer as I
        main = default_main_program()
        startup = default_startup_program()
        name = counter_name or "@STEP_COUNTER@"
        block = main.global_block()
        if not block.has_var(name):
            block.create_var(name, shape=(1,), dtype="int64",
                             persistable=True)
            startup.global_block().create_var(
                name, shape=(1,), dtype="int64", persistable=True)
            _append_init_op(startup.global_block(), name, (1,),
                            "int64", I.Constant(float(begin - step)))
        var = Variable(block, name, shape=(1,), dtype="int64",
                       persistable=True)   # create_var is idempotent
        _op(block, "increment", {"X": [name]}, {"Out": [name]},
            {"step": float(step)})
        return var

    def rank(input):
        """ref: nn.py rank: static ndim as a constant."""
        return fill_constant([1], "int32", len(input.shape or []))

    def image_resize_short(input, out_short_len,
                           resample="BILINEAR"):
        """ref: nn.py image_resize_short: scale so the short side
        equals out_short_len."""
        h, w = int(input.shape[2]), int(input.shape[3])
        short = min(h, w)
        oh = int(round(h * out_short_len / short))
        ow = int(round(w * out_short_len / short))
        op_type = "bilinear_interp" if resample.upper() == "BILINEAR" \
            else "nearest_interp"
        out = _new_tmp(input.block, "resize_short")
        _op(input.block, op_type, {"X": [input.name]},
            {"Out": [out.name]},
            {"out_h": oh, "out_w": ow, "align_corners": False})
        return out

    def resize_linear(input, out_shape=None, scale=None, name=None,
                      align_corners=True, align_mode=1):
        """ref: nn.py resize_linear: 1-D linear interpolation over
        [N, C, W]."""
        w = int(input.shape[-1])
        ow = int(out_shape[0]) if out_shape else int(w * scale)
        out = _new_tmp(input.block, name or "resize_linear")
        _op(input.block, "linear_interp", {"X": [input.name]},
            {"Out": [out.name]},
            {"out_w": ow, "align_corners": bool(align_corners),
             "align_mode": int(align_mode)})
        return out

    def lod_append(x, level):
        """ref: nn.py lod_append: dense mapping: attach a Length
        vector (level must be a Variable holding lengths)."""
        out = _new_tmp(x.block, "lod_append")
        outlen = _new_tmp(x.block, "lod_append_len")
        _op(x.block, "lod_reset", {"X": [x.name], "Y": [level.name]},
            {"Out": [out.name], "OutLength": [outlen.name]}, {})
        return out

    def uniform_random(shape, dtype="float32", min=-1.0, max=1.0,
                       seed=0, name=None):
        """ref: nn.py uniform_random: zero-input op; the output var
        anchors to the current block."""
        block = _current_block()
        out = _new_tmp(block, name or "uniform_random")
        _op(block, "uniform_random", {}, {"Out": [out.name]},
            {"shape": list(shape), "min": float(min), "max": float(max),
             "seed": int(seed), "dtype": dtypes.dtype_name(dtype)})
        return out

    def gaussian_random(shape, mean=0.0, std=1.0, seed=0,
                        dtype="float32", name=None):
        """ref: nn.py gaussian_random."""
        block = _current_block()
        out = _new_tmp(block, name or "gaussian_random")
        _op(block, "gaussian_random", {}, {"Out": [out.name]},
            {"shape": list(shape), "mean": float(mean),
             "std": float(std), "seed": int(seed),
             "dtype": dtypes.dtype_name(dtype)})
        return out

    def py_func(func, x, out, backward_func=None,
                skip_vars_in_backward_input=None):
        """ref: nn.py py_func: host callback; backward_func is not
        wired (eager-only op; use dygraph for differentiable host
        code)."""
        from ..ops.misc_ops import register_py_func
        fid = register_py_func(func)
        xs = x if isinstance(x, (list, tuple)) else [x]
        outs = out if isinstance(out, (list, tuple)) else [out]
        block = xs[0].block
        _op(block, "py_func", {"X": [v.name for v in xs]},
            {"Out": [v.name for v in outs]},
            {"forward_callable_id": fid})
        return out

    for fn in (bilinear_tensor_product, spectral_norm, data_norm,
               deformable_conv, dice_loss, autoincreased_step_counter, rank,
               image_resize_short, resize_linear, lod_append, uniform_random,
               gaussian_random, py_func):
        if not hasattr(nn, fn.__name__):
            setattr(nn, fn.__name__, staticmethod(fn))


_param_layer_ns_2()


# the JAX package's _SIMPLE_LAYERS_3: its last thin wrappers
_SIMPLE_LAYERS_3 = {
    "sum": ("sum", [("x", "X*")], ["Out"], {}),
    "sequence_pool": ("sequence_pool",
                      [("input", "X"), ("length", "Length")], ["Out"],
                      {"pooltype": "SUM"}),
    "sequence_softmax": ("sequence_softmax",
                         [("input", "X"), ("length", "Length")],
                         ["Out"], {}),
    "size": ("size", [("input", "Input")], ["Out"], {}),
}
for _lname, (_otype, _slots, _osl, _defs) in _SIMPLE_LAYERS_3.items():
    if not hasattr(nn, _lname):
        setattr(nn, _lname, _make_simple_layer(_lname, _otype, _slots,
                                               _osl, _defs))


def _last_builders():
    def conv3d_transpose(input, num_filters, filter_size, stride=1,
                         padding=0, dilation=1, groups=1, act=None,
                         param_attr=None, bias_attr=None, name=None):
        """ref: nn.py conv3d_transpose."""
        k = filter_size if isinstance(filter_size, (list, tuple)) else \
            (filter_size,) * 3
        in_c = int(input.shape[1])
        w = create_parameter([in_c, num_filters // (groups or 1),
                              k[0], k[1], k[2]], "float32",
                             attr=param_attr)
        out = _new_tmp(input.block, name or "conv3d_transpose")
        _op(input.block, "conv3d_transpose",
            {"Input": [input.name], "Filter": [w.name]},
            {"Output": [out.name]},
            {"strides": _ntuple(stride, 3),
             "paddings": _ntuple(padding, 3),
             "dilations": _ntuple(dilation, 3), "groups": groups or 1})
        if bias_attr is not False:
            b = create_parameter([num_filters], "float32", is_bias=True,
                                 attr=bias_attr)
            out2 = _new_tmp(input.block, "c3dt_bias")
            _op(input.block, "elementwise_add",
                {"X": [out.name], "Y": [b.name]}, {"Out": [out2.name]},
                {"axis": 1})
            out = out2
        return nn._maybe_act(out, act)

    def inplace_abn(input, act="identity", momentum=0.9, epsilon=1e-5,
                    param_attr=None, bias_attr=None, is_test=False,
                    act_alpha=1.0, name=None):
        """ref: nn.py inplace_abn: batch_norm fused with activation
        (parameters created exactly like batch_norm)."""
        from ..nn import initializer as I
        block = input.block
        c = int(input.shape[1])
        scale = create_parameter([c], "float32", attr=param_attr,
                                 default_initializer=I.Constant(1.0))
        bias = create_parameter([c], "float32", is_bias=True,
                                attr=bias_attr)
        mean = create_parameter([c], "float32",
                                default_initializer=I.Constant(0.0))
        var = create_parameter([c], "float32",
                               default_initializer=I.Constant(1.0))
        mean.desc.stop_gradient = True
        var.desc.stop_gradient = True
        out = _new_tmp(block, name or "inplace_abn")
        saved_m = _new_tmp(block, "abn_saved_mean")
        saved_v = _new_tmp(block, "abn_saved_var")
        _op(block, "inplace_abn",
            {"X": [input.name], "Scale": [scale.name],
             "Bias": [bias.name], "Mean": [mean.name],
             "Variance": [var.name]},
            {"Y": [out.name], "MeanOut": [mean.name],
             "VarianceOut": [var.name], "SavedMean": [saved_m.name],
             "SavedVariance": [saved_v.name]},
            {"momentum": momentum, "epsilon": epsilon,
             "is_test": is_test, "activation": act or "identity",
             "alpha": float(act_alpha)})
        return out

    for fn in (conv3d_transpose, inplace_abn):
        if not hasattr(nn, fn.__name__):
            setattr(nn, fn.__name__, staticmethod(fn))


_last_builders()


def _linear_chain_crf(input, label, length=None, param_attr=None):

    """ref: nn.py linear_chain_crf — creates the transition
    param [num_tags+2, num_tags]. A ragged emission input's
    @seq_len companion supplies Length automatically."""
    num_tags = int(input.shape[-1])
    trans = create_parameter([num_tags + 2, num_tags], "float32",
                             attr=param_attr)
    block = input.block
    ll = _new_tmp(block, "crf_loglik")
    alpha = _new_tmp(block, "crf_alpha")
    ins = {"Emission": [input.name], "Transition": [trans.name],
           "Label": [label.name]}
    if length is None:
        comp = getattr(input, "lod_companion", None)
        if comp:
            ins["Length"] = [comp]
    else:
        ins["Length"] = [length.name]
    _op(block, "linear_chain_crf", ins,
        {"LogLikelihood": [ll.name], "Alpha": [alpha.name]}, {})
    return ll


_linear_chain_crf.__name__ = "linear_chain_crf"
nn.linear_chain_crf = staticmethod(_linear_chain_crf)


# The JAX package's _SIMPLE_LAYERS_4: its layers/tensor.py,
# layers/control_flow.py, sequence_lod.py and loss.py groups (the
# detection entries are in _DETECTION_LAYERS below).
_SIMPLE_LAYERS_4 = {
    # --- layers/tensor.py
    "diag": ("diag", [("diagonal", "Diagonal")], ["Out"], {}),
    "linspace": ("linspace", [("start", "Start"), ("stop", "Stop"),
                              ("num", "Num")], ["Out"], {}),
    "sums": ("sum", [("input", "X*")], ["Out"], {}),
    "triu": ("tril_triu", [("input", "X")], ["Out"],
             {"diagonal": 0, "lower": False}),
    "tensor_array_to_tensor": ("tensor_array_to_tensor",
                               [("input", "X")], ["Out", "OutIndex"],
                               {"axis": 0, "use_stack": False}),
    "has_inf": ("isinf", [("x", "X")], ["Out"], {}),
    "has_nan": ("isnan", [("x", "X")], ["Out"], {}),
    # --- layers/control_flow.py
    "array_read": ("read_from_array", [("array", "X"), ("i", "I")],
                   ["Out"], {}),
    "array_length": ("array_length", [("array", "X")], ["Out"], {}),
    "is_empty": ("is_empty", [("x", "X")], ["Out"], {}),
    "lod_rank_table": ("lod_rank_table", [("x", "X")], ["Out"], {}),
    "max_sequence_len": ("max_sequence_len",
                         [("rank_table", "RankTable")], ["Out"], {}),
    "reorder_lod_tensor_by_rank": (
        "reorder_lod_tensor_by_rank",
        [("x", "X"), ("rank_table", "RankTable")], ["Out"], {}),
    "select_input": ("select_input",
                     [("inputs", "X*"), ("mask", "Mask")], ["Out"], {}),
    "shrink_memory": ("shrink_rnn_memory",
                      [("x", "X"), ("i", "I"), ("table", "Length")],
                      ["Out"], {}),
    "lod_tensor_to_array": ("lod_tensor_to_array", [("x", "X")],
                            ["Out"], {}),
    "array_to_lod_tensor": ("array_to_lod_tensor", [("x", "X")],
                            ["Out"], {}),
    "Print": ("print", [("input", "In")], ["Out"],
              {"message": "", "first_n": -1}),
    # --- layers/sequence_lod.py
    "sequence_enumerate": ("sequence_enumerate", [("input", "X")],
                           ["Out"], {"win_size": 2, "pad_value": 0}),
    "sequence_expand_as": ("sequence_expand_as",
                           [("x", "X"), ("y", "RefLength")], ["Out"],
                           {"max_len": 0}),
    "sequence_reshape": ("sequence_reshape", [("input", "X")],
                         ["Out", "OutLength"], {"new_dim": 1}),
    "sequence_scatter": ("sequence_scatter",
                         [("input", "X"), ("index", "Ids"),
                          ("updates", "Updates")], ["Out"], {}),
    "sequence_slice": ("sequence_slice",
                       [("input", "X"), ("offset", "Offset"),
                        ("length", "Length")], ["Out", "OutLength"],
                       {"max_out_len": -1}),
    # --- layers/detection.py
    "polygon_box_transform": ("polygon_box_transform",
                              [("input", "Input")], ["Output"], {}),
    # --- layers/loss.py
    "teacher_student_sigmoid_loss": (
        "teacher_student_sigmoid_loss",
        [("input", "X"), ("label", "Label")], ["Y"],
        {"soft_max_up_bound": 15.0, "soft_max_lower_bound": -15.0}),
    "cross_entropy2": ("cross_entropy2",
                       [("input", "X"), ("label", "Label")], ["Y"],
                       {"ignore_index": -100}),
}
for _lname, (_otype, _slots, _osl, _defs) in _SIMPLE_LAYERS_4.items():
    if not hasattr(nn, _lname):
        setattr(nn, _lname, _make_simple_layer(_lname, _otype, _slots,
                                               _osl, _defs))


def _control_flow_array_builders():
    """The JAX package's module-parity builders over this port's ops:
    the tensor-array surface, the mask routing and the IO ops
    (``paddle_tpu/static/__init__.py:2173-2234``)."""

    def save(x, file_path, overwrite=True):
        _op(x.block, "save", {"X": [x.name]}, {},
            {"file_path": file_path, "overwrite": overwrite})

    def save_combine(x_list, file_path, overwrite=True):
        _op(x_list[0].block, "save_combine",
            {"X": [v.name for v in x_list]}, {},
            {"file_path": file_path, "overwrite": overwrite})

    def load_combine(out, file_path):
        _op(out[0].block, "load_combine", {},
            {"Out": [v.name for v in out]}, {"file_path": file_path})

    def create_array(dtype, initialized_list=None):
        """ref: control_flow.py create_array — a TensorArray handle;
        the dense buffer is created by the first array_write with a
        'max_size' attr (static capacity convention)."""
        block = _current_block()
        return Variable(block,
                        default_main_program().unique_name("array"),
                        dtype=dtype)

    def array_write(x, i, array=None, max_size=64):
        out = array if array is not None else create_array(x.dtype)
        ins = {"X": [x.name], "I": [i.name]}
        attrs = {}
        if array is not None and array.shape is not None:
            ins["Array"] = [array.name]
        else:
            attrs["max_size"] = int(max_size)
        _op(x.block, "write_to_array", ins, {"Out": [out.name]}, attrs)
        return out

    def split_lod_tensor(input, mask, level=0):
        t = _new_tmp(input.block, "split_true")
        f = _new_tmp(input.block, "split_false")
        _op(input.block, "split_lod_tensor",
            {"X": [input.name], "Mask": [mask.name]},
            {"OutTrue": [t.name], "OutFalse": [f.name]}, {})
        return t, f

    def merge_lod_tensor(in_true, in_false, x, mask, level=0):
        out = _new_tmp(in_true.block, "merge_lod")
        _op(in_true.block, "merge_lod_tensor",
            {"InTrue": [in_true.name], "InFalse": [in_false.name],
             "Mask": [mask.name]}, {"Out": [out.name]}, {})
        return out

    def select_output(input, outputs, mask):
        _op(input.block, "select_output",
            {"X": [input.name], "Mask": [mask.name]},
            {"Out": [v.name for v in outputs]},
            {"num_outputs": len(outputs)})
        return outputs

    def Assert(cond, data=None, summarize=20, name=None):
        ins = {"Cond": [cond.name]}
        if data:
            ins["Data"] = [v.name for v in data]
        _op(cond.block, "assert", ins, {}, {"summarize": summarize})

    for fn in (save, save_combine, load_combine, create_array,
               array_write, split_lod_tensor, merge_lod_tensor,
               select_output, Assert):
        if not hasattr(nn, fn.__name__):
            setattr(nn, fn.__name__, staticmethod(fn))


_control_flow_array_builders()


def _module_parity_builders():
    """The JAX package's module-parity builders of the tensor and loss
    modules (``paddle_tpu/static/__init__.py:2087-2362``): the tensor
    builders (``create_tensor``, ``create_global_var``, ``eye``,
    ``zeros``, ``ones``, ``range``, ``fill_constant_batch_size_like``)
    and the losses from ``square_error_cost`` to
    ``sampled_softmax_with_cross_entropy``."""

    def create_tensor(dtype, name=None, persistable=False):
        """ref: layers/tensor.py create_tensor."""
        block = _current_block()
        return Variable(block, name or
                        default_main_program().unique_name("ct"),
                        dtype=dtype, persistable=persistable)

    def create_global_var(shape, value, dtype, persistable=False,
                          force_cpu=False, name=None):
        """ref: layers/tensor.py create_global_var: persistable var
        initialized in the startup program."""
        from ..nn import initializer as I
        main = default_main_program()
        startup = default_startup_program()
        name = name or main.unique_name("gvar")
        var = Variable(main.global_block(), name, shape=shape,
                       dtype=dtype, persistable=persistable)
        startup.global_block().create_var(name, shape=shape,
                                          dtype=dtype,
                                          persistable=persistable)
        _append_init_op(startup.global_block(), name, shape, dtype,
                        I.Constant(float(value)))
        return var

    def eye(num_rows, num_columns=None, batch_shape=None,
            dtype="float32", name=None):
        block = _current_block()
        out = _new_tmp(block, name or "eye")
        _op(block, "eye", {}, {"Out": [out.name]},
            {"num_rows": int(num_rows),
             "num_columns": int(num_columns or num_rows),
             "dtype": dtypes.dtype_name(dtype)})
        if batch_shape:
            reps = list(batch_shape) + [1, 1]
            tiled = _new_tmp(block, "eye_tiled")
            _op(block, "expand",
                {"X": [nn.reshape(out, shape=[1] * len(batch_shape) +
                                  [int(num_rows),
                                   int(num_columns or num_rows)]).name]},
                {"Out": [tiled.name]}, {"expand_times": reps})
            return tiled
        return out

    def zeros(shape, dtype="float32", force_cpu=False):
        return fill_constant(shape, dtype, 0.0)

    def ones(shape, dtype="float32", force_cpu=False):
        return fill_constant(shape, dtype, 1.0)

    def range_(start, end, step, dtype="float32", name=None):
        block = _current_block()
        out = _new_tmp(block, name or "range")
        _op(block, "range", {}, {"Out": [out.name]},
            {"start": float(start), "end": float(end),
             "step": float(step),
             "dtype": dtypes.dtype_name(dtype)})
        return out

    def fill_constant_batch_size_like(input, shape, dtype, value,
                                      input_dim_idx=0,
                                      output_dim_idx=0):
        out = _new_tmp(input.block, "fcbsl")
        _op(input.block, "fill_constant_batch_size_like",
            {"Input": [input.name]}, {"Out": [out.name]},
            {"shape": list(shape),
             "dtype": dtypes.dtype_name(dtype),
             "value": float(value), "input_dim_idx": input_dim_idx,
             "output_dim_idx": output_dim_idx})
        return out

    def square_error_cost(input, label):
        d = nn.elementwise_sub(input, label)
        return nn.elementwise_mul(d, d)

    def npair_loss(anchor, positive, labels, l2_reg=0.002):
        """ref: layers/loss.py npair_loss: cross-entropy over
        anchor·positiveᵀ similarities with same-label targets + L2."""
        sim = nn.matmul(anchor, positive, transpose_y=True)
        b = int(anchor.shape[0])
        lab = nn.reshape(labels, shape=[b, 1])
        eq = nn.cast(nn.equal(lab, nn.reshape(labels, shape=[1, b])),
                     out_dtype="float32") \
            if hasattr(nn, "equal") else None
        if eq is None:
            raise UnimplementedError("npair_loss needs equal")
        row_sum = nn.reduce_sum(eq, dim=[1], keep_dim=True)
        tgt = nn.elementwise_div(eq, row_sum)
        ce = nn.softmax_with_cross_entropy(sim, tgt, soft_label=True)
        l2 = nn.scale(nn.elementwise_add(
            nn.reduce_sum(nn.elementwise_mul(anchor, anchor)),
            nn.reduce_sum(nn.elementwise_mul(positive, positive))),
            scale=l2_reg * 0.25 / b)
        return nn.elementwise_add(nn.reduce_mean(ce), l2)

    def center_loss(input, label, num_classes, alpha, param_attr=None,
                    update_center=True):
        """ref: layers/loss.py center_loss: creates the Centers
        param."""
        from ..nn import initializer as I
        d = int(input.shape[-1])
        centers = create_parameter([num_classes, d], "float32",
                                   attr=param_attr,
                                   default_initializer=I.Constant(0.0))
        lr = fill_constant([1], "float32", alpha)
        out = _new_tmp(input.block, "center_loss")
        cdiff = _new_tmp(input.block, "center_diff")
        _op(input.block, "center_loss",
            {"X": [input.name], "Label": [label.name],
             "Centers": [centers.name], "CenterUpdateRate": [lr.name]},
            {"Loss": [out.name], "SampleCenterDiff": [cdiff.name],
             "CentersOut": [centers.name]},
            {"cluster_num": num_classes, "alpha": alpha,
             "need_update": update_center})
        return out

    def hsigmoid(input, label, num_classes, param_attr=None,
                 bias_attr=None, name=None):
        """ref: layers/loss.py hsigmoid: creates W/Bias."""
        d = int(input.shape[-1])
        w = create_parameter([num_classes - 1, d], "float32",
                             attr=param_attr)
        out = _new_tmp(input.block, name or "hsigmoid")
        pre = _new_tmp(input.block, "hsig_preout")
        ins = {"X": [input.name], "W": [w.name],
               "Label": [label.name]}
        if bias_attr is not False:
            b = create_parameter([num_classes - 1, 1], "float32",
                                 is_bias=True, attr=bias_attr)
            ins["Bias"] = [b.name]
        _op(input.block, "hierarchical_sigmoid", ins,
            {"Out": [out.name], "PreOut": [pre.name]},
            {"num_classes": num_classes})
        return out

    def nce(input, label, num_total_classes, sample_weight=None,
            param_attr=None, bias_attr=None, num_neg_samples=None,
            name=None, sampler="uniform", custom_dist=None, seed=0,
            is_sparse=False):
        """ref: layers/loss.py nce: creates Weight/Bias."""
        d = int(input.shape[-1])
        w = create_parameter([num_total_classes, d], "float32",
                             attr=param_attr)
        out = _new_tmp(input.block, name or "nce")
        slogits = _new_tmp(input.block, "nce_slogits")
        slabels = _new_tmp(input.block, "nce_slabels")
        ins = {"Input": [input.name], "Weight": [w.name],
               "Label": [label.name]}
        if bias_attr is not False:
            b = create_parameter([num_total_classes], "float32",
                                 is_bias=True, attr=bias_attr)
            ins["Bias"] = [b.name]
        _op(input.block, "nce", ins,
            {"Cost": [out.name], "SampleLogits": [slogits.name],
             "SampleLabels": [slabels.name]},
            {"num_total_classes": num_total_classes,
             "num_neg_samples": num_neg_samples or 10,
             "sampler": sampler, "seed": seed})
        return out

    def sampled_softmax_with_cross_entropy(logits, label, num_samples,
                                           num_true=1,
                                           remove_accidental_hits=True,
                                           use_customized_samples=False,
                                           customized_samples=None,
                                           customized_probabilities=None,
                                           seed=0):
        """ref: layers/loss.py: sample_logits →
        softmax_with_cross_entropy over the sampled classes."""
        block = logits.block
        sl = _new_tmp(block, "ssce_logits")
        slb = _new_tmp(block, "ssce_labels")
        samples = _new_tmp(block, "ssce_samples")
        probs = _new_tmp(block, "ssce_probs")
        ld = _new_tmp(block, "ssce_ld")
        lbd = _new_tmp(block, "ssce_lbd")
        ins = {"Logits": [logits.name], "Labels": [label.name]}
        if use_customized_samples:
            ins["CustomizedSamples"] = [customized_samples.name]
            ins["CustomizedProbabilities"] = [
                customized_probabilities.name]
        _op(block, "sample_logits", ins,
            {"SampledLogits": [sl.name], "SampledLabels": [slb.name],
             "Samples": [samples.name], "Probabilities": [probs.name],
             "LogitsDim": [ld.name], "LabelsDim": [lbd.name]},
            {"num_samples": int(num_samples),
             "remove_accidental_hits": bool(remove_accidental_hits),
             "seed": int(seed)})
        return nn.softmax_with_cross_entropy(sl, slb)

    for fn in (create_tensor, create_global_var, eye, zeros, ones,
               fill_constant_batch_size_like, square_error_cost, npair_loss,
               center_loss, hsigmoid, nce,
               sampled_softmax_with_cross_entropy):
        if not hasattr(nn, fn.__name__):
            setattr(nn, fn.__name__, staticmethod(fn))
    if not hasattr(nn, "range"):
        nn.range = staticmethod(range_)


_module_parity_builders()


def _lstm_builders():
    """``dynamic_lstmp``, ``gru_unit``, ``lstm_unit`` and ``lstm`` of the
    JAX package's RNN builders (``paddle_tpu/static/__init__.py:
    2629-2741``, ref: layers/rnn.py; ``lstm`` appends ``cudnn_lstm``
    with the structured WeightList), and the step extractors
    ``sequence_first_step`` / ``sequence_last_step`` over
    ``sequence_pool`` (``:2236-2242``)."""

    def dynamic_lstmp(input, size, proj_size, h_0=None, c_0=None,
                      param_attr=None, bias_attr=None,
                      use_peepholes=True, is_reverse=False,
                      gate_activation="sigmoid", cell_activation="tanh",
                      candidate_activation="tanh",
                      proj_activation="tanh", name=None):
        """ref: layers/rnn.py dynamic_lstmp: LSTM with a projection
        (lstmp op); input pre-projected [B, T, 4D]."""
        d = size // 4
        w = create_parameter([proj_size, 4 * d], "float32",
                             attr=param_attr)
        proj = create_parameter([d, proj_size], "float32",
                                attr=param_attr)
        b = create_parameter([1, 7 * d if use_peepholes else 4 * d],
                             "float32", is_bias=True, attr=bias_attr)
        ins = {"Input": [input.name], "Weight": [w.name],
               "ProjWeight": [proj.name], "Bias": [b.name]}
        if h_0 is not None:
            ins["H0"] = [h_0.name]
        if c_0 is not None:
            ins["C0"] = [c_0.name]
        hidden = _new_tmp(input.block, name or "lstmp_proj")
        cell = _new_tmp(input.block, "lstmp_cell")
        bg = _new_tmp(input.block, "lstmp_gates")
        bc = _new_tmp(input.block, "lstmp_preact")
        bh = _new_tmp(input.block, "lstmp_hidden")
        _op(input.block, "lstmp", ins,
            {"Projection": [hidden.name], "Cell": [cell.name],
             "BatchGate": [bg.name], "BatchCellPreAct": [bc.name],
             "BatchHidden": [bh.name]},
            {"use_peepholes": use_peepholes, "is_reverse": is_reverse,
             "gate_activation": gate_activation,
             "cell_activation": cell_activation,
             "candidate_activation": candidate_activation,
             "proj_activation": proj_activation})
        return hidden, cell

    def gru_unit(input, hidden, size, param_attr=None, bias_attr=None,
                 activation="tanh", gate_activation="sigmoid",
                 origin_mode=False):
        """ref: layers/rnn.py gru_unit: one step; input pre-projected
        [B, 3D]."""
        d = size // 3
        w = create_parameter([d, 3 * d], "float32", attr=param_attr)
        ins = {"Input": [input.name], "HiddenPrev": [hidden.name],
               "Weight": [w.name]}
        if bias_attr is not False:
            b = create_parameter([1, 3 * d], "float32", is_bias=True,
                                 attr=bias_attr)
            ins["Bias"] = [b.name]
        out = _new_tmp(input.block, "gru_unit_h")
        gate = _new_tmp(input.block, "gru_unit_gate")
        reset = _new_tmp(input.block, "gru_unit_reset")
        _op(input.block, "gru_unit", ins,
            {"Hidden": [out.name], "Gate": [gate.name],
             "ResetHiddenPrev": [reset.name]},
            {"activation": activation,
             "gate_activation": gate_activation,
             "origin_mode": origin_mode})
        return out, reset, gate

    def sequence_first_step(input, length=None):
        return nn.sequence_pool(input, companion_length_of(input, length),
                                pooltype="FIRST")

    def sequence_last_step(input, length=None):
        return nn.sequence_pool(input, companion_length_of(input, length),
                                pooltype="LAST")

    def lstm_unit(x_t, hidden_t_prev, cell_t_prev, forget_bias=0.0,
                  param_attr=None, bias_attr=None, name=None):
        """ref: layers/rnn.py lstm_unit — fc([x, h]) then one lstm
        step."""
        d = int(hidden_t_prev.shape[-1])
        cat = nn.concat([x_t, hidden_t_prev], axis=1)
        gates = nn.fc(cat, size=4 * d, param_attr=param_attr,
                      bias_attr=bias_attr)
        h = _new_tmp(x_t.block, name or "lstm_unit_h")
        c = _new_tmp(x_t.block, "lstm_unit_c")
        _op(x_t.block, "lstm_unit",
            {"X": [gates.name], "C_prev": [cell_t_prev.name]},
            {"H": [h.name], "C": [c.name]},
            {"forget_bias": float(forget_bias)})
        return h, c

    def lstm(input, init_h, init_c, max_len, hidden_size, num_layers,
             dropout_prob=0.0, is_bidirec=False, is_test=False,
             name=None, default_initializer=None, seed=-1):
        """ref: layers/rnn.py lstm (the cuDNN-backed one) — creates the
        structured WeightList the cudnn_lstm kernel consumes
        ([Wx, Wh, B] per layer per direction)."""
        dirs = 2 if is_bidirec else 1
        din = int(input.shape[-1])
        weights = []
        for layer in range(num_layers):
            layer_in = din if layer == 0 else hidden_size * dirs
            for _ in range(dirs):
                weights.append(create_parameter(
                    [layer_in, 4 * hidden_size], "float32",
                    default_initializer=default_initializer))
                weights.append(create_parameter(
                    [hidden_size, 4 * hidden_size], "float32",
                    default_initializer=default_initializer))
                weights.append(create_parameter(
                    [4 * hidden_size], "float32", is_bias=True))
        block = input.block
        out = _new_tmp(block, name or "cudnn_lstm_out")
        last_h = _new_tmp(block, "cudnn_lstm_h")
        last_c = _new_tmp(block, "cudnn_lstm_c")
        _op(block, "cudnn_lstm",
            {"Input": [input.name], "InitH": [init_h.name],
             "InitC": [init_c.name],
             "WeightList": [w.name for w in weights]},
            {"Out": [out.name], "LastH": [last_h.name],
             "LastC": [last_c.name]},
            {"num_layers": num_layers, "is_bidirec": is_bidirec})
        return out, last_h, last_c

    for fn in (dynamic_lstmp, gru_unit, lstm_unit, lstm,
               sequence_first_step, sequence_last_step):
        if not hasattr(nn, fn.__name__):
            setattr(nn, fn.__name__, staticmethod(fn))


_lstm_builders()


def _decode_builders():
    """``crf_decoding``, the form that reuses the linear-chain CRF's
    transition parameter (ParamAttr name sharing), and ``beam_search`` /
    ``beam_search_decode`` with the reference's signatures
    (layers/rnn.py); each replaces its simple-layer table form, as in
    the JAX package."""

    def crf_decoding(input, param_attr=None, label=None, length=None,
                     transition=None):
        """ref: nn.py crf_decoding — Viterbi decode reusing the
        linear_chain_crf transition param (ParamAttr name sharing)."""
        num_tags = int(input.shape[-1])
        trans = transition if transition is not None else create_parameter(
            [num_tags + 2, num_tags], "float32", attr=param_attr)
        block = input.block
        path = _new_tmp(block, "crf_path")
        ins = {"Emission": [input.name], "Transition": [trans.name]}
        if label is not None:
            ins["Label"] = [label.name]
        if length is not None:
            ins["Length"] = [length.name]
        else:
            comp = getattr(input, "lod_companion", None)
            if comp:
                ins["Length"] = [comp]
        _op(block, "crf_decoding", ins, {"ViterbiPath": [path.name]}, {})
        comp = getattr(input, "lod_companion", None)
        if comp:
            path.lod_companion = comp
        return path

    def beam_search(pre_ids, pre_scores, ids, scores, beam_size, end_id,
                    level=0, is_accumulated=True, name=None,
                    return_parent_idx=False):
        """ref: layers/rnn.py beam_search — one step; returns
        (selected_ids, selected_scores), and parent_idx when asked."""
        block = pre_ids.block
        sid = _new_tmp(block, name or "bs_ids")
        ssc = _new_tmp(block, "bs_scores")
        pidx = _new_tmp(block, "bs_parent")
        ins = {"pre_ids": [pre_ids.name], "pre_scores": [pre_scores.name],
               "scores": [scores.name]}
        if ids is not None:
            ins["ids"] = [ids.name]
        _op(block, "beam_search", ins,
            {"selected_ids": [sid.name], "selected_scores": [ssc.name],
             "parent_idx": [pidx.name]},
            {"beam_size": int(beam_size), "end_id": int(end_id),
             "level": int(level), "is_accumulated": bool(is_accumulated)})
        if return_parent_idx:
            return sid, ssc, pidx
        return sid, ssc

    def beam_search_decode(ids, scores, beam_size, end_id, name=None):
        """ref: layers/rnn.py beam_search_decode."""
        block = ids.block
        out_ids = _new_tmp(block, name or "bsd_ids")
        out_scores = _new_tmp(block, "bsd_scores")
        _op(block, "beam_search_decode",
            {"Ids": [ids.name], "Scores": [scores.name]},
            {"SentenceIds": [out_ids.name],
             "SentenceScores": [out_scores.name]},
            {"beam_size": beam_size, "end_id": end_id})
        return out_ids, out_scores

    for fn in (crf_decoding, beam_search, beam_search_decode):
        setattr(nn, fn.__name__, staticmethod(fn))


_decode_builders()


def _rnn_driver_builders():
    """``rnn``, ``birnn`` and ``dynamic_decode`` (ref: layers/rnn.py),
    copied from the JAX package's ``_rnn_module_builders``: each unrolls
    its loop over the static length and writes the same ops."""

    def rnn(cell, inputs, initial_states=None, sequence_length=None,
            time_major=False, is_reverse=False, **kwargs):
        """ref: layers/rnn.py rnn — drive an RNNCell over the time
        axis. Static-graph design: the loop is UNROLLED over the
        (static) sequence length — each step appends its cell ops to
        the program; use StaticRNN or while_loop for symbolic
        lengths."""
        t_axis = 0 if time_major else 1
        steps = int(inputs.shape[t_axis])
        states = initial_states
        outs = [None] * steps
        order = range(steps - 1, -1, -1) if is_reverse else range(steps)

        def _mask_mix(new_v, old_v, mask):
            """mask ? new : old (per batch row), broadcast on feats."""
            mixed = _new_tmp(new_v.block, "rnn_mask")
            _op(new_v.block, "where",
                {"Condition": [mask.name], "X": [new_v.name],
                 "Y": [old_v.name]}, {"Out": [mixed.name]}, {})
            return mixed

        for t in order:
            x_t = nn.slice(inputs, axes=[t_axis], starts=[t],
                           ends=[t + 1])
            x_t = nn.squeeze(x_t, axes=[t_axis])
            out, new_states = cell(x_t, states, **kwargs)
            if sequence_length is not None:
                # step valid while t < length: finished rows hold
                # state and emit zeros (the reference's mask contract)
                t_var = fill_constant(
                    [int(sequence_length.shape[0])], "int64", t)
                mask = _new_tmp(out.block, "rnn_valid")
                _op(out.block, "less_than",
                    {"X": [t_var.name], "Y": [sequence_length.name]},
                    {"Out": [mask.name]}, {})
                maskc = nn.unsqueeze(nn.cast(mask,
                                             out_dtype="float32"),
                                     axes=[1])
                out = nn.elementwise_mul(out, maskc)
                if states is not None:
                    if isinstance(new_states, (list, tuple)):
                        new_states = type(new_states)(
                            _mask_mix(nv, ov,
                                      nn.unsqueeze(mask, axes=[1]))
                            for nv, ov in zip(new_states, states))
                    else:
                        new_states = _mask_mix(
                            new_states, states,
                            nn.unsqueeze(mask, axes=[1]))
            states = new_states
            outs[t] = out
        seq = nn.stack(outs, axis=t_axis)
        return seq, states

    def birnn(cell_fw, cell_bw, inputs, initial_states=None,
              sequence_length=None, time_major=False, **kwargs):
        """ref: layers/rnn.py birnn."""
        fw_states, bw_states = (initial_states
                                if initial_states is not None
                                else (None, None))
        out_f, st_f = rnn(cell_fw, inputs, fw_states,
                          time_major=time_major, **kwargs)
        out_b, st_b = rnn(cell_bw, inputs, bw_states,
                          time_major=time_major, is_reverse=True,
                          **kwargs)
        return nn.concat([out_f, out_b], axis=-1), (st_f, st_b)

    def dynamic_decode(decoder, inits=None, max_step_num=None,
                       output_time_major=False, **kwargs):
        """ref: layers/rnn.py dynamic_decode — run a Decoder
        (initialize/step/finalize contract) until finished or
        max_step_num. Static design: the loop is unrolled to
        max_step_num (required here — the While-based variant is
        covered by static.control_flow.while_loop); finished beams keep
        stepping and the finalize mask handles them, matching the
        reference's padded semantics."""
        enforce(max_step_num is not None and max_step_num > 0,
                "dynamic_decode: max_step_num is required (the static "
                "loop is unrolled)", InvalidArgumentError)
        initial_inputs, initial_states, initial_finished = \
            decoder.initialize(inits)
        inputs, states = initial_inputs, initial_states
        finished = initial_finished
        step_outputs = []
        for step in range(int(max_step_num)):
            outputs, states, inputs, finished = decoder.step(
                step, inputs, states, **kwargs)
            step_outputs.append(outputs)
        outs = nn.stack(step_outputs,
                        axis=0 if output_time_major else 1)
        if hasattr(decoder, "finalize"):
            return decoder.finalize(outs, states, None)
        return outs, states

    for fn in (rnn, birnn, dynamic_decode):
        if not hasattr(nn, fn.__name__):
            setattr(nn, fn.__name__, staticmethod(fn))


_rnn_driver_builders()


# The RoI pooling builders of the JAX package's simple tables
# (its _SIMPLE_LAYERS_2) and the detection entries of its
# _SIMPLE_LAYERS_4 (layers/detection.py, ops in ops/rcnn_ops.py).
_DETECTION_LAYERS = {
    "roi_pool": ("roi_pool", [("input", "X"), ("rois", "ROIs")], ["Out"],
                 {"pooled_height": 1, "pooled_width": 1,
                  "spatial_scale": 1.0}),
    "prroi_pool": ("prroi_pool", [("input", "X"), ("rois", "ROIs")],
                   ["Out"],
                   {"pooled_height": 1, "pooled_width": 1,
                    "spatial_scale": 1.0, "sample_num": 4}),
    "psroi_pool": ("psroi_pool", [("input", "X"), ("rois", "ROIs")],
                   ["Out"],
                   {"output_channels": 1, "spatial_scale": 1.0,
                    "pooled_height": 1, "pooled_width": 1}),
    "target_assign": ("target_assign",
                      [("input", "X"),
                       ("matched_indices", "MatchIndices")],
                      ["Out", "OutWeight"], {"mismatch_value": 0.0}),
    "detection_map": ("detection_map",
                      [("detect_res", "DetectRes"), ("label", "Label")],
                      ["MAP", "AccumPosCount", "AccumTruePos",
                       "AccumFalsePos"],
                      {"overlap_threshold": 0.5,
                       "ap_type": "integral",
                       "background_label": 0,
                       "evaluate_difficult": True,
                       "class_num": 0}),
    "locality_aware_nms": ("locality_aware_nms",
                           [("bboxes", "BBoxes"), ("scores", "Scores")],
                           ["Out"],
                           {"score_threshold": 0.0,
                            "nms_threshold": 0.3, "nms_top_k": -1,
                            "keep_top_k": -1, "background_label": 0}),
    "roi_perspective_transform": (
        "roi_perspective_transform", [("input", "X"), ("rois", "ROIs")],
        ["Out", "Mask", "TransformMatrix", "Out2InIdx",
         "Out2InWeights"],
        {"transformed_height": 8, "transformed_width": 8,
         "spatial_scale": 1.0}),
    "collect_fpn_proposals": (
        "collect_fpn_proposals",
        [("multi_rois", "MultiLevelRois*"),
         ("multi_scores", "MultiLevelScores*")],
        ["FpnRois", "RoisNum"], {"post_nms_topN": 1000}),
}
for _lname, (_otype, _slots, _osl, _defs) in _DETECTION_LAYERS.items():
    if not hasattr(nn, _lname):
        setattr(nn, _lname, _make_simple_layer(_lname, _otype, _slots,
                                               _osl, _defs))


def _detection_builders():
    """The JAX package's ``deformable_roi_pooling`` (its
    ``_param_layer_ns_2``) and the detection composites of its
    module-parity builders (``paddle_tpu/static/__init__.py:2364-2604``):
    ``detection_output``, the proposal, target-assign and FPN builders,
    with ``_target_assign_batched``, the per-image loop that offsets the
    emitted anchor indices into the batch's rows."""

    def deformable_roi_pooling(input, rois, trans, no_trans=False,
                               spatial_scale=1.0, group_size=(1, 1),
                               pooled_height=1, pooled_width=1,
                               part_size=None, sample_per_part=1,
                               trans_std=0.1, position_sensitive=False,
                               name=None):
        """ref: nn.py deformable_roi_pooling →
        deformable_psroi_pooling op. position_sensitive=False (the
        reference default) keeps C output channels; True maps channel
        groups to bins (psroi), requiring C % (ph·pw) == 0."""
        c = int(input.shape[1])
        out_dim = c // (pooled_height * pooled_width) \
            if position_sensitive else c
        out = _new_tmp(input.block, name or "deform_roi_pool")
        top = _new_tmp(input.block, "deform_roi_top")
        ins = {"Input": [input.name], "ROIs": [rois.name]}
        if not no_trans and trans is not None:
            ins["Trans"] = [trans.name]
        _op(input.block, "deformable_psroi_pooling", ins,
            {"Output": [out.name], "TopCount": [top.name]},
            {"no_trans": bool(no_trans),
             "spatial_scale": float(spatial_scale),
             "output_dim": out_dim,
             "pooled_height": int(pooled_height),
             "pooled_width": int(pooled_width),
             "sample_per_part": int(sample_per_part),
             "trans_std": float(trans_std)})
        return out

    # --- detection composites
    def detection_output(loc, scores, prior_box, prior_box_var,
                         background_label=0, nms_threshold=0.3,
                         nms_top_k=400, keep_top_k=200,
                         score_threshold=0.01, nms_eta=1.0):
        """ref: layers/detection.py detection_output — box_coder decode
        + multiclass_nms."""
        decoded = _new_tmp(loc.block, "det_decoded")
        _op(loc.block, "box_coder",
            {"PriorBox": [prior_box.name],
             "PriorBoxVar": [prior_box_var.name],
             "TargetBox": [loc.name]},
            {"OutputBox": [decoded.name]},
            {"code_type": "decode_center_size", "box_normalized": True})
        out = _new_tmp(loc.block, "det_out")
        _op(loc.block, "multiclass_nms",
            {"BBoxes": [decoded.name], "Scores": [scores.name]},
            {"Out": [out.name]},
            {"background_label": background_label,
             "nms_threshold": nms_threshold, "nms_top_k": nms_top_k,
             "keep_top_k": keep_top_k,
             "score_threshold": score_threshold, "nms_eta": nms_eta})
        return out

    def _mk(block, prefix):
        return _new_tmp(block, prefix)

    def generate_proposals(scores, bbox_deltas, im_info, anchors,
                           variances, pre_nms_top_n=6000,
                           post_nms_top_n=1000, nms_thresh=0.5,
                           min_size=0.1, eta=1.0,
                           return_rois_num=False):
        block = scores.block
        rois = _mk(block, "gp_rois")
        probs = _mk(block, "gp_probs")
        num = _mk(block, "gp_num")
        _op(block, "generate_proposals",
            {"Scores": [scores.name], "BboxDeltas": [bbox_deltas.name],
             "ImInfo": [im_info.name], "Anchors": [anchors.name],
             "Variances": [variances.name]},
            {"RpnRois": [rois.name], "RpnRoiProbs": [probs.name],
             "RpnRoisNum": [num.name]},
            {"pre_nms_topN": pre_nms_top_n,
             "post_nms_topN": post_nms_top_n, "nms_thresh": nms_thresh,
             "min_size": min_size, "eta": eta})
        return (rois, probs, num) if return_rois_num else (rois, probs)

    def _anchor_count(anchor_box):
        shp = [d for d in (anchor_box.shape or (1,))[:-1]]
        n = 1
        for d in shp:
            n *= int(d)
        return max(n, 1)

    def _target_assign_batched(op_type, bbox_pred, anchor_box, per_image,
                               attrs, out_slots):
        """Run a single-image target-assign op per batch image (the op
        kernel's 'batch handled by the caller' contract), offsetting the
        emitted anchor indices by image*num_anchors so they index the
        batch-flattened prediction rows, then concat all outputs."""
        block = anchor_box.block
        batch = 1
        if bbox_pred.shape and len(bbox_pred.shape) >= 3 \
                and int(bbox_pred.shape[0]) > 0:
            batch = int(bbox_pred.shape[0])
        a_count = _anchor_count(anchor_box)
        rows = {slot: [] for slot in out_slots}
        for bi in range(batch):
            ins = {"Anchor": [anchor_box.name]}
            for slot, var in per_image.items():
                if var is None:
                    continue
                if batch == 1:
                    ins[slot] = [var.name]
                else:
                    sl = nn.slice(var, axes=[0], starts=[bi],
                                  ends=[bi + 1])
                    if slot in ("GtBoxes", "GtLabels"):
                        sl = nn.squeeze(sl, axes=[0])
                    ins[slot] = [sl.name]
            outs = {slot: _mk(block, f"ta_{slot}{bi}")
                    for slot in out_slots}
            _op(block, op_type, ins,
                {slot: [v.name] for slot, v in outs.items()}, attrs)
            for slot in ("ScoreIndex", "LocationIndex"):
                if slot in outs and bi:
                    off = fill_constant([1], "int32", bi * a_count)
                    outs[slot] = nn.elementwise_add(outs[slot], off)
            for slot in out_slots:
                rows[slot].append(outs[slot])
        if batch == 1:
            return {slot: rows[slot][0] for slot in out_slots}
        return {slot: nn.concat(rows[slot], axis=0)
                for slot in out_slots}

    def rpn_target_assign(bbox_pred, cls_logits, anchor_box,
                          anchor_var, gt_boxes, is_crowd, im_info,
                          rpn_batch_size_per_im=256,
                          rpn_straddle_thresh=0.0,
                          rpn_fg_fraction=0.5,
                          rpn_positive_overlap=0.7,
                          rpn_negative_overlap=0.3, use_random=True):
        outs = _target_assign_batched(
            "rpn_target_assign", bbox_pred, anchor_box,
            {"GtBoxes": gt_boxes, "IsCrowd": is_crowd,
             "ImInfo": im_info},
            {"rpn_batch_size_per_im": rpn_batch_size_per_im,
             "rpn_straddle_thresh": rpn_straddle_thresh,
             "rpn_fg_fraction": rpn_fg_fraction,
             "rpn_positive_overlap": rpn_positive_overlap,
             "rpn_negative_overlap": rpn_negative_overlap,
             "use_random": use_random},
            ("ScoreIndex", "LocationIndex", "TargetLabel",
             "TargetBBox", "BBoxInsideWeight"))
        # ref detection.py rpn_target_assign returns *gathered
        # predictions*, not the raw index tensors: logits/deltas are
        # flattened then indexed by Score/LocationIndex so losses see
        # (predicted, target) pairs directly.
        pred_cls = nn.gather(nn.reshape(cls_logits, shape=[-1, 1]),
                             outs["ScoreIndex"])
        pred_loc = nn.gather(nn.reshape(bbox_pred, shape=[-1, 4]),
                             outs["LocationIndex"])
        return (pred_cls, pred_loc, outs["TargetLabel"],
                outs["TargetBBox"], outs["BBoxInsideWeight"])

    def generate_proposal_labels(rpn_rois, gt_classes, is_crowd,
                                 gt_boxes, im_info,
                                 batch_size_per_im=256,
                                 fg_fraction=0.25, fg_thresh=0.25,
                                 bg_thresh_hi=0.5, bg_thresh_lo=0.0,
                                 bbox_reg_weights=[0.1, 0.1, 0.2, 0.2],
                                 class_nums=None, use_random=True,
                                 is_cls_agnostic=False,
                                 is_cascade_rcnn=False):
        block = rpn_rois.block
        outs = [_mk(block, p) for p in
                ("gpl_rois", "gpl_labels", "gpl_tgts", "gpl_win",
                 "gpl_wout", "gpl_num")]
        _op(block, "generate_proposal_labels",
            {"RpnRois": [rpn_rois.name], "GtClasses": [gt_classes.name],
             "IsCrowd": [is_crowd.name], "GtBoxes": [gt_boxes.name],
             "ImInfo": [im_info.name]},
            {"Rois": [outs[0].name], "LabelsInt32": [outs[1].name],
             "BboxTargets": [outs[2].name],
             "BboxInsideWeights": [outs[3].name],
             "BboxOutsideWeights": [outs[4].name],
             "RoisNum": [outs[5].name]},
            {"batch_size_per_im": batch_size_per_im,
             "fg_fraction": fg_fraction, "fg_thresh": fg_thresh,
             "bg_thresh_hi": bg_thresh_hi, "bg_thresh_lo": bg_thresh_lo,
             "class_nums": class_nums or 81})
        return tuple(outs[:5])

    def generate_mask_labels(im_info, gt_classes, is_crowd, gt_segms,
                             rois, labels_int32, num_classes,
                             resolution):
        block = rois.block
        outs = [_mk(block, p) for p in ("gml_rois", "gml_has",
                                        "gml_mask")]
        _op(block, "generate_mask_labels",
            {"ImInfo": [im_info.name], "GtClasses": [gt_classes.name],
             "IsCrowd": [is_crowd.name], "GtSegms": [gt_segms.name],
             "Rois": [rois.name], "LabelsInt32": [labels_int32.name]},
            {"MaskRois": [outs[0].name],
             "RoiHasMaskInt32": [outs[1].name],
             "MaskInt32": [outs[2].name]},
            {"num_classes": num_classes, "resolution": resolution})
        return tuple(outs)

    def distribute_fpn_proposals(fpn_rois, min_level, max_level,
                                 refer_level, refer_scale,
                                 rois_num=None):
        block = fpn_rois.block
        n_levels = max_level - min_level + 1
        multi = [_mk(block, f"dfp_l{i}") for i in range(n_levels)]
        nums = [_mk(block, f"dfp_n{i}") for i in range(n_levels)]
        restore = _mk(block, "dfp_restore")
        _op(block, "distribute_fpn_proposals",
            {"FpnRois": [fpn_rois.name]},
            {"MultiFpnRois": [v.name for v in multi],
             "RestoreIndex": [restore.name],
             "MultiLevelRoIsNum": [v.name for v in nums]},
            {"min_level": min_level, "max_level": max_level,
             "refer_level": refer_level, "refer_scale": refer_scale})
        return multi, restore

    def box_decoder_and_assign(prior_box, prior_box_var, target_box,
                               box_score, box_clip=None):
        block = prior_box.block
        dec = _mk(block, "bda_dec")
        assign = _mk(block, "bda_assign")
        _op(block, "box_decoder_and_assign",
            {"PriorBox": [prior_box.name],
             "PriorBoxVar": [prior_box_var.name],
             "TargetBox": [target_box.name],
             "BoxScore": [box_score.name]},
            {"DecodeBox": [dec.name], "OutputAssignBox": [assign.name]},
            {})
        return dec, assign

    def retinanet_target_assign(bbox_pred, cls_logits, anchor_box,
                                anchor_var, gt_boxes, gt_labels,
                                is_crowd, im_info, num_classes=1,
                                positive_overlap=0.5,
                                negative_overlap=0.4):
        outs = _target_assign_batched(
            "retinanet_target_assign", bbox_pred, anchor_box,
            {"GtBoxes": gt_boxes, "GtLabels": gt_labels,
             "IsCrowd": is_crowd, "ImInfo": im_info},
            {"positive_overlap": positive_overlap,
             "negative_overlap": negative_overlap},
            ("ScoreIndex", "LocationIndex", "TargetLabel",
             "TargetBBox", "BBoxInsideWeight", "ForegroundNumber"))
        # ref detection.py retinanet_target_assign: gather predicted
        # logits/deltas by the assigned indices; 6-tuple is
        # (predict_scores, predict_location, target_label, target_bbox,
        #  bbox_inside_weight, fg_num).
        pred_cls = nn.gather(
            nn.reshape(cls_logits, shape=[-1, num_classes]),
            outs["ScoreIndex"])
        pred_loc = nn.gather(nn.reshape(bbox_pred, shape=[-1, 4]),
                             outs["LocationIndex"])
        return (pred_cls, pred_loc, outs["TargetLabel"],
                outs["TargetBBox"], outs["BBoxInsideWeight"],
                outs["ForegroundNumber"])

    def retinanet_detection_output(bboxes, scores, anchors, im_info,
                                   score_threshold=0.05, nms_top_k=1000,
                                   keep_top_k=100, nms_threshold=0.3,
                                   nms_eta=1.0):
        block = im_info.block
        out = _mk(block, "rdo_out")
        _op(block, "retinanet_detection_output",
            {"BBoxes": [v.name for v in bboxes],
             "Scores": [v.name for v in scores],
             "Anchors": [v.name for v in anchors],
             "ImInfo": [im_info.name]},
            {"Out": [out.name]},
            {"score_threshold": score_threshold, "nms_top_k": nms_top_k,
             "keep_top_k": keep_top_k, "nms_threshold": nms_threshold})
        return out

    for fn in (deformable_roi_pooling, detection_output, generate_proposals,
               rpn_target_assign, generate_proposal_labels,
               generate_mask_labels, distribute_fpn_proposals,
               box_decoder_and_assign, retinanet_target_assign,
               retinanet_detection_output):
        if not hasattr(nn, fn.__name__):
            setattr(nn, fn.__name__, staticmethod(fn))


_detection_builders()


def _ssd_builders():
    """fluid/layers/detection.py multi_box_head (:1840) + ssd_loss
    (:1461), the SSD training composites (``paddle_tpu/static/
    __init__.py:2883-3119``), with the ``zeros_like`` and ``ones_like``
    builders that ``ssd_loss`` calls (the JAX package's module-parity
    builders)."""

    def zeros_like(x, out=None):
        o = _new_tmp(x.block, "zeros_like")
        _op(x.block, "fill_zeros_like", {"X": [x.name]},
            {"Out": [o.name]}, {})
        return o

    def ones_like(x, out=None):
        o = _new_tmp(x.block, "ones_like")
        _op(x.block, "fill_any_like", {"X": [x.name]},
            {"Out": [o.name]}, {"value": 1.0})
        return o

    def multi_box_head(inputs, image, base_size, num_classes,
                       aspect_ratios, min_ratio=None, max_ratio=None,
                       min_sizes=None, max_sizes=None, steps=None,
                       step_w=None, step_h=None, offset=0.5,
                       variance=[0.1, 0.1, 0.2, 0.2], flip=True,
                       clip=False, kernel_size=1, pad=0, stride=1,
                       name=None, min_max_aspect_ratios_order=False):
        """Per feature map: a 3x3/1x1 conv head for loc (4/prior) and
        conf (C/prior) + prior_box; outputs concatenated across maps
        (the reference's layout: mbox_locs [N, P, 4],
        mbox_confs [N, P, C], boxes/vars [P, 4])."""
        enforce(isinstance(inputs, (list, tuple)) and inputs,
                "multi_box_head needs a feature-map list",
                InvalidArgumentError)
        n_maps = len(inputs)
        if min_sizes is None:
            enforce(min_ratio is not None and max_ratio is not None,
                    "need min/max_ratio or explicit min/max_sizes",
                    InvalidArgumentError)
            step = int((max_ratio - min_ratio) / max(n_maps - 2, 1))
            min_sizes, max_sizes = [base_size * 0.1], [base_size * 0.2]
            for r in range(min_ratio, max_ratio + 1, step):
                min_sizes.append(base_size * r / 100.0)
                max_sizes.append(base_size * (r + step) / 100.0)
            min_sizes = min_sizes[:n_maps]
            max_sizes = max_sizes[:n_maps]
        locs, confs, boxes, pvars = [], [], [], []
        for i, feat in enumerate(inputs):
            ar = aspect_ratios[i] if isinstance(aspect_ratios[0],
                                                (list, tuple)) \
                else aspect_ratios
            # build the priors FIRST: the op's ratio expansion (1.0
            # prepended, dedup, reciprocals) owns the prior count —
            # the conv head sizes follow its output shape
            box = _new_tmp(feat.block, f"mbh_box{i}")
            var = _new_tmp(feat.block, f"mbh_var{i}")
            _op(feat.block, "prior_box",
                {"Input": [feat.name], "Image": [image.name]},
                {"Boxes": [box.name], "Variances": [var.name]},
                {"min_sizes": [float(min_sizes[i])],
                 "max_sizes": [float(max_sizes[i])] if max_sizes
                 else [],
                 "aspect_ratios": [float(a) for a in ar],
                 "variances": list(variance), "flip": flip,
                 "clip": clip, "offset": offset,
                 "min_max_aspect_ratios_order":
                     min_max_aspect_ratios_order,
                 "step_w": (steps[i] if steps else (step_w or 0.0)),
                 "step_h": (steps[i] if steps else (step_h or 0.0))})
            n_prior = int(box.shape[2])     # [H, W, P, 4]
            loc = nn.conv2d(feat, num_filters=n_prior * 4,
                            filter_size=kernel_size, padding=pad,
                            stride=stride)
            conf = nn.conv2d(feat, num_filters=n_prior * num_classes,
                             filter_size=kernel_size, padding=pad,
                             stride=stride)
            # [N, P*4, H, W] → [N, H*W*P, 4]
            loc_t = nn.transpose(loc, axis=[0, 2, 3, 1])
            b = int(feat.shape[0])
            locs.append(nn.reshape(loc_t, shape=[b, -1, 4]))
            conf_t = nn.transpose(conf, axis=[0, 2, 3, 1])
            confs.append(nn.reshape(conf_t,
                                    shape=[b, -1, num_classes]))
            h_i, w_i = int(feat.shape[2]), int(feat.shape[3])
            boxes.append(nn.reshape(box, shape=[h_i * w_i * n_prior,
                                                4]))
            pvars.append(nn.reshape(var, shape=[h_i * w_i * n_prior,
                                                4]))
        mbox_locs = nn.concat(locs, axis=1)
        mbox_confs = nn.concat(confs, axis=1)
        all_boxes = nn.concat(boxes, axis=0)
        all_vars = nn.concat(pvars, axis=0)
        return mbox_locs, mbox_confs, all_boxes, all_vars

    def ssd_loss(location, confidence, gt_box, gt_label, prior_box,
                 prior_box_var=None, background_label=0,
                 overlap_threshold=0.5, neg_pos_ratio=3.0,
                 neg_overlap=0.5, loc_loss_weight=1.0,
                 conf_loss_weight=1.0, match_type="per_prediction",
                 mining_type="max_negative", normalize=True,
                 sample_size=None):
        """ref: detection.py ssd_loss — match priors to gt
        (bipartite/per-prediction via iou + bipartite_match), assign
        loc/conf targets, hard-mine negatives, smooth_l1 + softmax CE.
        Dense contract: gt_box [B, G, 4], gt_label [B, G, 1]."""
        block = location.block
        b_sz = int(location.shape[0])
        g_sz = int(gt_box.shape[1])

        # per-image matching (iou_similarity/bipartite_match are 2-D,
        # like the reference kernels; the LoD batch walk becomes a
        # static python loop). Matched indices are offset by image so
        # they index the flattened [B*G, ...] gt tensors that
        # target_assign consumes.
        match_rows = []
        for bi in range(b_sz):
            gt_b = nn.squeeze(nn.slice(gt_box, axes=[0], starts=[bi],
                                       ends=[bi + 1]), axes=[0])
            iou = _new_tmp(block, f"ssd_iou{bi}")
            _op(block, "iou_similarity",
                {"X": [gt_b.name], "Y": [prior_box.name]},
                {"Out": [iou.name]}, {})
            mi = _new_tmp(block, f"ssd_match{bi}")
            md = _new_tmp(block, f"ssd_dist{bi}")
            _op(block, "bipartite_match", {"DistMat": [iou.name]},
                {"ColToRowMatchIndices": [mi.name],
                 "ColToRowMatchDist": [md.name]},
                {"match_type": match_type,
                 "dist_threshold": overlap_threshold})
            if bi:
                # offset matched (>=0) indices into the flat gt rows
                off = nn.scale(
                    nn.cast(greater_equal(mi, nn.zeros_like(mi)),
                            out_dtype="int32"),
                    scale=float(bi * g_sz))
                mi = nn.elementwise_add(mi, nn.cast(off,
                                                    out_dtype="int32"))
            match_rows.append(mi)
        match_idx = nn.concat(match_rows, axis=0) if b_sz > 1 else             match_rows[0]

        # conf loss per prior (against matched gt labels; bg elsewhere)
        tgt_lab = _new_tmp(block, "ssd_tlab")
        tgt_lab_w = _new_tmp(block, "ssd_tlabw")
        _op(block, "target_assign",
            {"X": [gt_label.name], "MatchIndices": [match_idx.name]},
            {"Out": [tgt_lab.name], "OutWeight": [tgt_lab_w.name]},
            {"mismatch_value": float(background_label)})
        conf_loss_all = nn.softmax_with_cross_entropy(
            confidence, nn.cast(tgt_lab, out_dtype="int64"))
        conf_loss_2d = nn.reshape(conf_loss_all,
                                  shape=[int(location.shape[0]), -1])
        neg_idx = _new_tmp(block, "ssd_neg")
        upd_match = _new_tmp(block, "ssd_upd")
        neg_num = _new_tmp(block, "ssd_negnum")
        _op(block, "mine_hard_examples",
            {"ClsLoss": [conf_loss_2d.name],
             "MatchIndices": [match_idx.name]},
            {"NegIndices": [neg_idx.name],
             "UpdatedMatchIndices": [upd_match.name],
             "NegIndicesNum": [neg_num.name]},
            {"neg_pos_ratio": float(neg_pos_ratio),
             "neg_dist_threshold": float(neg_overlap),
             "mining_type": mining_type})

        # conf target weights including mined negatives
        tgt_lab2 = _new_tmp(block, "ssd_tlab2")
        tgt_lab2_w = _new_tmp(block, "ssd_tlab2w")
        _op(block, "target_assign",
            {"X": [gt_label.name], "MatchIndices": [upd_match.name],
             "NegIndices": [neg_idx.name]},
            {"Out": [tgt_lab2.name], "OutWeight": [tgt_lab2_w.name]},
            {"mismatch_value": float(background_label)})
        conf_loss = nn.elementwise_mul(
            nn.reshape(conf_loss_all, shape=[int(location.shape[0]),
                                             -1, 1]),
            tgt_lab2_w)

        # localization (reference order): encode ALL (gt, prior)
        # pairs per image → [G, P, 4], then per prior p select row
        # match[p] via a one-hot contraction (trace-friendly gather)
        enc_sel_rows, w_rows = [], []
        p_sz = int(prior_box.shape[0])
        for bi in range(b_sz):
            gt_b = nn.squeeze(nn.slice(gt_box, axes=[0], starts=[bi],
                                       ends=[bi + 1]), axes=[0])
            enc = _new_tmp(block, f"ssd_enc{bi}")
            ins = {"PriorBox": [prior_box.name],
                   "TargetBox": [gt_b.name]}
            if prior_box_var is not None:
                ins["PriorBoxVar"] = [prior_box_var.name]
            _op(block, "box_coder", ins, {"OutputBox": [enc.name]},
                {"code_type": "encode_center_size",
                 "box_normalized": True})          # [G, P, 4]
            mb = match_rows[bi]                    # [1, P] (offset-free
            #                                        for bi=0 only)
            mb_local = nn.reshape(match_rows[bi], shape=[p_sz])                 if bi == 0 else nn.scale(
                    nn.reshape(match_rows[bi], shape=[p_sz]),
                    scale=1.0, bias=-float(bi * g_sz))
            clipped = nn.clip(mb_local, min=0.0, max=float(g_sz - 1))                 if hasattr(nn, "clip") else mb_local
            oh = nn.one_hot(nn.reshape(nn.cast(clipped,
                                               out_dtype="int64"),
                                       shape=[p_sz]), depth=g_sz)
            # [P, G] x [G, P, 4]: transpose enc to [P, G, 4], weight
            enc_t = nn.transpose(enc, axis=[1, 0, 2])
            sel = nn.reduce_sum(
                nn.elementwise_mul(enc_t,
                                   nn.unsqueeze(oh, axes=[2])),
                dim=[1])                           # [P, 4]
            enc_sel_rows.append(sel)
            zero_i = fill_constant([p_sz, 1], "int32", 0)
            wmask = nn.cast(greater_equal(
                nn.reshape(mb_local, shape=[p_sz, 1]), zero_i),
                out_dtype="float32")
            w_rows.append(wmask)
        enc_all = nn.stack(enc_sel_rows, axis=0)   # [B, P, 4]
        tgt_box_w = nn.stack(w_rows, axis=0)       # [B, P, 1]
        loc_diff = nn.elementwise_sub(location, enc_all)
        abs_d = nn.abs(loc_diff)
        quad = nn.scale(nn.elementwise_mul(loc_diff, loc_diff),
                        scale=0.5)
        lin = nn.scale(abs_d, scale=1.0, bias=-0.5)
        near = _new_tmp(block, "ssd_near")
        _op(block, "less_than",
            {"X": [abs_d.name], "Y": [nn.ones_like(abs_d).name]},
            {"Out": [near.name]}, {})
        piece = _new_tmp(block, "ssd_sl1")
        _op(block, "where",
            {"Condition": [near.name], "X": [quad.name],
             "Y": [lin.name]}, {"Out": [piece.name]}, {})
        sl1 = nn.elementwise_mul(
            nn.reduce_sum(piece, dim=[2], keep_dim=True), tgt_box_w)

        total = nn.elementwise_add(
            nn.scale(sl1, scale=float(loc_loss_weight)),
            nn.scale(conf_loss, scale=float(conf_loss_weight)))
        # reference tail: per-image sum over priors → [N, 1], then
        # normalize by reduce_sum(target_loc_weight) (the number of
        # MATCHED priors), not by the constant prior count
        total = nn.reduce_sum(nn.reshape(total, shape=[b_sz, -1]),
                              dim=[1], keep_dim=True)       # [N, 1]
        if normalize:
            normalizer = nn.reduce_sum(tgt_box_w)
            total = nn.elementwise_div(total, normalizer)
        return total

    for fn in (zeros_like, ones_like, multi_box_head, ssd_loss):
        if not hasattr(nn, fn.__name__):
            setattr(nn, fn.__name__, staticmethod(fn))


_ssd_builders()


from . import nets  # noqa: E402,F401

from .compiler import (BuildStrategy, CompiledProgram,  # noqa: E402,F401
                       ExecutionStrategy)
