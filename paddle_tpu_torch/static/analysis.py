"""Program analysis utilities (ref: python/paddle/fluid/contrib/
memory_usage_calc.py, model_stat.py, op_frequence.py).

Port of ``paddle_tpu/static/analysis.py`` over the port's Program IR.
Static estimates: nothing here executes; the numbers are build-time
planning aids exactly like the reference's (which walks the ProgramDesc
the same way). A port ``VarDesc`` holds a torch dtype, which is sized by
its canonical name (``core/dtype.dtype_name``).
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

from ..core import dtype as dtypes
from ..core.enforce import InvalidArgumentError, enforce
from ..core.program import Program

_DTYPE_SIZE = {
    "float16": 2, "bfloat16": 2, "float32": 4, "float64": 8,
    "int16": 2, "int32": 4, "int64": 8, "bool": 1, "uint8": 1,
    "int8": 1,
}


def memory_usage(program: Program, batch_size: int):
    """Estimate activation+parameter bytes for one iteration (ref:
    memory_usage_calc.py:45 — every op output counted once, -1 dims
    substituted with ``batch_size``, 5-10% overhead band).

    Returns ``(min_total, max_total, unit_str)``.
    """
    enforce(isinstance(program, Program),
            f"memory_usage requires a Program, got {type(program)}",
            InvalidArgumentError)
    enforce(batch_size > 0, "batch_size must be positive",
            InvalidArgumentError)
    total = 0.0
    seen = set()
    block = program.global_block()
    for op in block.ops:
        for name in op.output_names():
            if name in seen:
                continue
            seen.add(name)
            var = block.vars.get(name)
            if var is None or var.type != "LOD_TENSOR" or \
                    var.shape is None:
                continue
            count, neg = 1, 0
            for d in var.shape:
                if d < 0:
                    enforce(neg == 0,
                            f"var {name} has more than one dynamic dim",
                            InvalidArgumentError)
                    neg += 1
                    count *= batch_size * (-d)
                else:
                    count *= d
            dt = (dtypes.dtype_name(var.dtype) if var.dtype is not None
                  else "float32")
            total += count * _DTYPE_SIZE.get(dt, 4)
    unit = "B"
    if total > 1024:
        total, unit = total / 1024, "KB"
        if total > 1024:
            total, unit = total / 1024, "MB"
    return total * 1.05, total * 1.1, unit


def op_freq_statistic(program: Program):
    """Single-op and adjacent-op-pair frequency tables (ref:
    op_frequence.py:23). Returns ``(uni_op_freq, adj_2_op_freq)`` as
    ordered (op_type → count) dicts, most frequent first."""
    enforce(isinstance(program, Program),
            f"op_freq_statistic requires a Program, got {type(program)}",
            InvalidArgumentError)
    block = program.global_block()
    params = {p.name for p in program.all_parameters()}

    uni: "OrderedDict[str, int]" = OrderedDict()
    for op in block.ops:
        if any(n not in params for n in op.output_names()):
            uni[op.type] = uni.get(op.type, 0) + 1

    producer: Dict[str, str] = {}
    adj: "OrderedDict[str, int]" = OrderedDict()
    for op in block.ops:
        for name in op.input_names():
            prev = producer.get(name)
            if prev is not None:
                key = f"{prev}->{op.type}"
                adj[key] = adj.get(key, 0) + 1
        for name in op.output_names():
            producer[name] = op.type
    uni = OrderedDict(sorted(uni.items(), key=lambda kv: -kv[1]))
    adj = OrderedDict(sorted(adj.items(), key=lambda kv: -kv[1]))
    return uni, adj


def _op_stat(block, op) -> Optional[Tuple[str, list, list, int, int]]:
    """(type, in_shape, out_shape, params, flops) for the op kinds the
    reference's model_stat tables (conv, fc/mul, pool, activations)."""

    def shape(name):
        v = block.vars.get(name)
        return list(v.shape) if v is not None and v.shape else []

    if op.type in ("conv2d", "depthwise_conv2d"):
        xs = shape(op.inputs["Input"][0])
        ws = shape(op.inputs["Filter"][0])
        os = shape(op.outputs["Output"][0])
        params = 1
        for d in ws:
            params *= max(int(d), 1)
        spatial = 1
        for d in os[2:]:
            spatial *= max(int(d), 1)
        kernel = 1
        for d in ws[1:]:
            kernel *= max(int(d), 1)
        flops = 2 * spatial * kernel * max(int(os[1]) if len(os) > 1
                                           else 1, 1)
        return (op.type, xs, os, params, flops)
    if op.type in ("mul", "matmul", "matmul_v2"):
        xs = shape(op.inputs["X"][0])
        ys = shape(op.inputs["Y"][0])
        os = shape(op.output_names()[0])
        yvar = block.vars.get(op.inputs["Y"][0])
        # only a persistable Y is a parameter; a data-input matmul
        # (attention scores etc.) contributes FLOPs but no PARAMs
        params = 0
        if yvar is not None and yvar.persistable:
            params = 1
            for d in ys:
                params *= max(int(d), 1)
        # contraction length = X's last dim (transpose_X is rare in
        # built programs; the reference's table makes the same call),
        # robust to batched matmul where ys[0] is the -1 batch dim
        tx = bool(op.attrs.get("transpose_X", False))
        k = max(int(xs[-2] if tx and len(xs) >= 2 else xs[-1])
                if xs else 1, 1)
        n = 1
        for d in os[1:]:
            n *= max(int(d), 1)
        return (op.type, xs, os, params, 2 * k * n)
    if op.type in ("pool2d", "relu", "sigmoid", "tanh", "softmax",
                   "batch_norm", "layer_norm"):
        first_in = op.input_names()[0] if op.input_names() else None
        first_out = op.output_names()[0] if op.output_names() else None
        xs = shape(first_in) if first_in else []
        os = shape(first_out) if first_out else []
        n = 1
        for d in os:
            n *= max(int(d), 1)
        return (op.type, xs, os, 0, n)
    return None


def summary(main_prog: Program, batch_size: int = 1) -> Dict:
    """Parameter/FLOP summary table (ref: model_stat.py:40 summary —
    prints the per-op table and totals). Returns
    ``{"table": [...], "total_params": N, "total_flops": N}`` and
    prints the formatted table like the reference."""
    enforce(isinstance(main_prog, Program),
            f"summary requires a Program, got {type(main_prog)}",
            InvalidArgumentError)
    block = main_prog.global_block()
    rows: List[Tuple] = []
    total_params = 0
    total_flops = 0
    for op in block.ops:
        st = _op_stat(block, op)
        if st is None:
            continue
        rows.append(st)
        total_params += st[3]
        total_flops += st[4] * batch_size
    header = ("op_type", "in_shape", "out_shape", "PARAMs", "FLOPs")
    widths = [12, 24, 24, 14, 16]
    lines = ["  ".join(h.ljust(w) for h, w in zip(header, widths))]
    for r in rows:
        lines.append("  ".join(
            str(c).ljust(w) for c, w in zip(r, widths)))
    lines.append(f"Total PARAMs: {total_params} "
                 f"({total_params / 1e6:.4f}M)")
    lines.append(f"Total FLOPs: {total_flops} "
                 f"({total_flops / 1e9:.2f}G)")
    print("\n".join(lines))
    return {"table": rows, "total_params": total_params,
            "total_flops": total_flops}
