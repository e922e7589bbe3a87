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
``jax.eval_shape``. The first simple-layer table is ported whole: a
builder whose op the port lacks builds, and running it raises
``NotFoundError``, as the JAX package does for an unregistered op. Of
the later tables, only the builders of ops the port registers. Not
ported yet: the control-flow builders, ``CompiledProgram``, static
AMP, ``nets``, the RNN, SSD and module-parity builders and the later
tables' other builders (ROADMAP Queue 1, item 5).
"""
from __future__ import annotations

import threading
from typing import List, Optional, Sequence

import torch

from ..core import dtype as dtypes
from ..core.backward import append_backward, gradients  # noqa: F401
from ..core.enforce import InvalidArgumentError, enforce
from ..core.program import (Block, Program, VarDesc,  # noqa: F401
                            default_main_program, default_startup_program,
                            program_guard)
from ..core.registry import OpInfoMap
from ..device import op_device

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
        with torch.no_grad(), op_device("meta"):
            outs = (opdef.infer_meta or opdef.compute)(specs, dict(attrs))
    except Exception as e:
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


# builders the JAX package overrides with parameterized ones not ported
# yet: their table forms would build a different graph
_NOT_PORTED = {"crf_decoding", "row_conv", "beam_search"}

for _lname, (_otype, _slots, _osl, _defs) in _SIMPLE_LAYERS.items():
    if not hasattr(nn, _lname) and _lname not in _NOT_PORTED:
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


# The JAX package's later tranches of simple builders (its
# _SIMPLE_LAYERS_2-4), for the ops the port registers; the rest come
# with their ops.
_SIMPLE_LAYERS_2 = {
    "mul": ("mul", [("x", "X"), ("y", "Y")], ["Out"],
            {"x_num_col_dims": 1, "y_num_col_dims": 1}),
    "roi_align": ("roi_align", [("input", "X"), ("rois", "ROIs")],
                  ["Out"],
                  {"pooled_height": 1, "pooled_width": 1,
                   "spatial_scale": 1.0, "sampling_ratio": -1}),
    "sum": ("sum", [("x", "X*")], ["Out"], {}),
    "sequence_pool": ("sequence_pool",
                      [("input", "X"), ("length", "Length")], ["Out"],
                      {"pooltype": "SUM"}),
    "sums": ("sum", [("input", "X*")], ["Out"], {}),
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
