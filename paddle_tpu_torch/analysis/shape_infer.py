"""Registry-driven shape/dtype propagation over the Program IR.

Port of ``paddle_tpu/analysis/shape_infer.py``. The static builder
infers each op's outputs as it appends (``static._op``); this engine
re-runs that propagation over a FINISHED program (built, loaded from
JSON, rewritten), so a malformed graph fails with a located ``PTAxxx``
diagnostic instead of an error inside the executor.

Two layers, as in the reference:

- **family checkers** (``register_shape_check``): hand-written
  contracts for the common op families (elementwise dtype equality,
  matmul/mul contract dims, concat rank agreement, integer index
  slots), which emit PTA101/PTA102 where torch would promote or
  broadcast silently. Copied, with dtypes read through torch.
- **generic propagation**: each op's registered compute (or its
  ``infer_meta`` rule) run on ``meta`` tensors, the same evaluation the
  builder does, where the reference runs ``jax.eval_shape``; operands
  it cannot compose are PTA102.

Ops with no registered kernel and no ``*_grad`` suffix get PTA103;
grad ops, host-I/O ops and ops with sub-blocks are **opaque**: their
outputs stay unknown and later checks degrade, never a false positive.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.dtype import dtype_name
from ..core.program import Block, OpDesc, Program
from .diagnostics import Diagnostic

_SKIP_OPS = frozenset({"feed", "fetch"})
# host-I/O computes must not run under analysis: meta evaluation RUNS the
# python body, and a `load` on a machine without the checkpoint files
# would turn a valid program into a false PTA102. Opaque instead.
_HOST_IO_OPS = frozenset({"save", "save_combine", "load", "load_combine",
                          "print", "assert", "py_func"})


def _dummy_dim() -> int:
    # the builder's sentinel for the -1 runtime batch dim — shared so the
    # None -> sentinel -> None round trip can never drift from the
    # convention static/__init__.py writes into VarDescs
    from ..static import _DUMMY_BATCH
    return _DUMMY_BATCH


@dataclass(frozen=True)
class VarMeta:
    """What the analyzer knows about one var: dims are ``None`` when
    unknown (serialized as -1 in VarDesc), dtype is a torch.dtype or
    None."""

    shape: Optional[Tuple[Optional[int], ...]] = None
    dtype: Optional[torch.dtype] = None

    @property
    def rank(self) -> Optional[int]:
        return None if self.shape is None else len(self.shape)

    def known(self) -> bool:
        return self.shape is not None and self.dtype is not None


def _from_desc(desc) -> VarMeta:
    shape = None
    if desc.shape is not None:
        shape = tuple(None if s in (-1, None) else int(s)
                      for s in desc.shape)
    dtype = desc.dtype
    return VarMeta(shape, dtype)


# ---- family checker registry ----
_CHECKS: Dict[str, Callable] = {}


def register_shape_check(*op_types: str):
    """Decorator: attach a contract checker to op types.

    Signature: ``check(op, ins, emit)`` where ``ins`` maps slot →
    List[Optional[VarMeta]] and ``emit(code, message, var=None)`` files a
    diagnostic located at the op."""

    def deco(fn):
        for t in op_types:
            _CHECKS[t] = fn
        return fn

    return deco


def registered_checks() -> List[str]:
    return sorted(_CHECKS)


def _dims_compatible(a: Optional[int], b: Optional[int]) -> bool:
    return a is None or b is None or a == b or a == 1 or b == 1


ELEMENTWISE_OPS = ("elementwise_add", "elementwise_sub", "elementwise_mul",
                   "elementwise_div", "elementwise_max", "elementwise_min",
                   "elementwise_pow", "elementwise_mod",
                   "elementwise_floordiv")


@register_shape_check(*ELEMENTWISE_OPS)
def _check_elementwise(op, ins, emit):
    x = _first(ins, "X")
    y = _first(ins, "Y")
    if x is None or y is None:
        return
    if x.dtype is not None and y.dtype is not None and x.dtype != y.dtype:
        emit("PTA101", f"operands disagree: X is {dtype_name(x.dtype)}, Y is "
                       f"{dtype_name(y.dtype)} (the reference rejects mixed "
                       f"elementwise dtypes; torch would silently promote)")
    if x.shape is None or y.shape is None:
        return
    xr, yr = len(x.shape), len(y.shape)
    axis = op.attrs.get("axis", -1)
    if yr <= xr:
        off = xr - yr if axis in (None, -1) else int(axis)
        pairs = [(x.shape[off + i], y.shape[i]) for i in range(yr)
                 if off + i < xr]
    else:
        pairs = [(x.shape[-1 - i], y.shape[-1 - i]) for i in range(xr)]
    for a, b in pairs:
        if not _dims_compatible(a, b):
            emit("PTA102", f"shapes {_fmt(x.shape)} and {_fmt(y.shape)} do "
                           f"not broadcast at axis={axis}")
            return


@register_shape_check("equal", "not_equal", "less_than", "less_equal",
                      "greater_than", "greater_equal")
def _check_compare(op, ins, emit):
    x, y = _first(ins, "X"), _first(ins, "Y")
    if (x is not None and y is not None and x.dtype is not None
            and y.dtype is not None and x.dtype != y.dtype):
        emit("PTA101", f"comparison operands disagree: X is {dtype_name(x.dtype)}, "
                       f"Y is {dtype_name(y.dtype)}")


@register_shape_check("sum")
def _check_sum(op, ins, emit):
    metas = [m for m in ins.get("X", []) if m is not None]
    dts = {dtype_name(m.dtype) for m in metas if m.dtype is not None}
    if len(dts) > 1:
        emit("PTA101", f"sum inputs mix dtypes {sorted(dts)}")
    shapes = {m.shape for m in metas if m.shape is not None}
    ranks = {len(s) for s in shapes}
    if len(ranks) > 1:
        emit("PTA102", f"sum inputs mix ranks {sorted(ranks)}")


@register_shape_check("concat")
def _check_concat(op, ins, emit):
    metas = [m for m in ins.get("X", []) if m is not None]
    dts = {dtype_name(m.dtype) for m in metas if m.dtype is not None}
    if len(dts) > 1:
        emit("PTA101", f"concat inputs mix dtypes {sorted(dts)}")
    ranks = {m.rank for m in metas if m.rank is not None}
    if len(ranks) > 1:
        emit("PTA102", f"concat inputs mix ranks {sorted(ranks)}")


@register_shape_check("matmul", "matmul_v2")
def _check_matmul(op, ins, emit):
    x, y = _first(ins, "X"), _first(ins, "Y")
    if x is None or y is None:
        return
    _check_num_kind(x, y, emit)
    if x.shape is None or y.shape is None:
        return
    if len(x.shape) < 1 or len(y.shape) < 1:
        emit("PTA102", "matmul operands must have rank >= 1")
        return
    tx = bool(op.attrs.get("transpose_X", op.attrs.get("trans_x", False)))
    ty = bool(op.attrs.get("transpose_Y", op.attrs.get("trans_y", False)))
    xk = x.shape[-2] if (tx and len(x.shape) > 1) else x.shape[-1]
    if len(y.shape) == 1:
        yk = y.shape[0]
    else:
        yk = y.shape[-1] if ty else y.shape[-2]
    if xk is not None and yk is not None and xk != yk:
        emit("PTA102", f"contract dims disagree: X{_fmt(x.shape)}"
                       f"{'ᵀ' if tx else ''} x Y{_fmt(y.shape)}"
                       f"{'ᵀ' if ty else ''} contracts {xk} against {yk}")


@register_shape_check("mul")
def _check_mul(op, ins, emit):
    x, y = _first(ins, "X"), _first(ins, "Y")
    if x is None or y is None:
        return
    _check_num_kind(x, y, emit)
    if x.shape is None or y.shape is None:
        return
    xnc = int(op.attrs.get("x_num_col_dims", 1))
    ync = int(op.attrs.get("y_num_col_dims", 1))
    xtail = x.shape[xnc:]
    yhead = y.shape[:ync]
    if any(d is None for d in xtail) or any(d is None for d in yhead):
        return
    kx, ky = int(np.prod(xtail or (1,))), int(np.prod(yhead or (1,)))
    if kx != ky:
        emit("PTA102", f"flattened contract dims disagree: prod(X"
                       f"{_fmt(x.shape)}[{xnc}:])={kx} vs prod(Y"
                       f"{_fmt(y.shape)}[:{ync}])={ky}")


@register_shape_check("conv2d", "depthwise_conv2d")
def _check_conv2d(op, ins, emit):
    x, w = _first(ins, "Input"), _first(ins, "Filter")
    for name, m in (("Input", x), ("Filter", w)):
        if m is not None and m.rank is not None and m.rank != 4:
            emit("PTA102", f"{name} must be rank 4, got rank {m.rank}")
            return
    if (x is None or w is None or x.shape is None or w.shape is None):
        return
    layout = op.attrs.get("data_format", "NCHW")
    cin = x.shape[1] if layout == "NCHW" else x.shape[-1]
    groups = int(op.attrs.get("groups", 1) or 1)
    wc = w.shape[1]
    if cin is not None and wc is not None and cin != wc * groups:
        emit("PTA102", f"input channels {cin} != filter in-channels {wc} "
                       f"* groups {groups}")


@register_shape_check("pool2d")
def _check_pool2d(op, ins, emit):
    x = _first(ins, "X")
    if x is not None and x.rank is not None and x.rank != 4:
        emit("PTA102", f"pool2d input must be rank 4, got rank {x.rank}")


_INT_KINDS = ("i", "u")


def _kind(dtype: torch.dtype) -> str:
    """numpy's dtype kind letter of a torch dtype."""
    if dtype.is_floating_point:
        return "f"
    if dtype.is_complex:
        return "c"
    if dtype == torch.bool:
        return "b"
    return "u" if dtype == torch.uint8 else "i"


def _int_slot(op, ins, emit, slot):
    m = _first(ins, slot)
    if m is not None and m.dtype is not None and _kind(m.dtype) not in _INT_KINDS:
        emit("PTA101", f"{slot} must be an integer tensor, got "
                       f"{dtype_name(m.dtype)}", var=_name(op, slot))


@register_shape_check("lookup_table", "lookup_table_v2")
def _check_lookup(op, ins, emit):
    _int_slot(op, ins, emit, "Ids")
    w = _first(ins, "W")
    if w is not None and w.rank is not None and w.rank != 2:
        emit("PTA102", f"embedding table W must be rank 2, got rank {w.rank}")


@register_shape_check("gather", "index_select")
def _check_gather(op, ins, emit):
    _int_slot(op, ins, emit, "Index")


@register_shape_check("one_hot", "one_hot_v2")
def _check_one_hot(op, ins, emit):
    _int_slot(op, ins, emit, "X")


@register_shape_check("cross_entropy", "softmax_with_cross_entropy")
def _check_xent(op, ins, emit):
    if not op.attrs.get("soft_label", False):
        _int_slot(op, ins, emit, "Label")


@register_shape_check("reshape", "reshape2")
def _check_reshape(op, ins, emit):
    x = _first(ins, "X")
    shape = op.attrs.get("shape")
    if (x is None or x.shape is None or not shape
            or ins.get("Shape") or ins.get("ShapeTensor")):
        return
    if any(d is None for d in x.shape):
        return
    tgt = [int(s) for s in shape]
    n_in = int(np.prod(x.shape)) if x.shape else 1
    bad0 = [i for i, s in enumerate(tgt) if s == 0 and i >= len(x.shape)]
    if bad0:
        emit("PTA102", f"reshape target {tgt} copies dim {bad0[0]} "
                       f"but input rank is {len(x.shape)}")
        return
    resolved = [x.shape[i] if s == 0 else s for i, s in enumerate(tgt)]
    if -1 in resolved:
        rest = int(np.prod([s for s in resolved if s != -1] or [1]))
        if rest == 0 or n_in % rest != 0:
            emit("PTA102", f"cannot infer -1: {n_in} elements do not divide "
                           f"into shape {tgt}")
    elif int(np.prod(resolved or [1])) != n_in:
        emit("PTA102", f"reshape target {tgt} has "
                       f"{int(np.prod(resolved or [1]))} elements, input "
                       f"{_fmt(x.shape)} has {n_in}")


# ---- sequence family (ops/sequence_ops.py: dense [B, T, ...] +
# integer Length [B] convention — the admission-control path loads
# exactly these models, so their contracts must fail at load, not as a
# masked-garbage prediction) ----

def _check_length_slot(op, ins, emit, slot="Length", x_slot="X"):
    m = _first(ins, slot)
    if m is not None and m.dtype is not None \
            and _kind(m.dtype) not in _INT_KINDS:
        emit("PTA101", f"{slot} must be an integer length tensor, got "
                       f"{dtype_name(m.dtype)}", var=_name(op, slot))
    if m is not None and m.rank is not None and m.rank != 1:
        emit("PTA102", f"{slot} must be rank 1 ([batch] lengths), got "
                       f"rank {m.rank}", var=_name(op, slot))
        return
    x = _first(ins, x_slot)
    if (x is not None and m is not None and x.shape and m.shape
            and x.shape[0] is not None and m.shape[0] is not None
            and x.shape[0] != m.shape[0]):
        emit("PTA102", f"{x_slot} batch dim {x.shape[0]} != {slot} "
                       f"batch dim {m.shape[0]}")


@register_shape_check("sequence_pool", "sequence_softmax",
                      "sequence_reverse", "sequence_pad",
                      "sequence_unpad")
def _check_sequence_dense(op, ins, emit):
    x = _first(ins, "X")
    if x is not None and x.rank is not None and x.rank < 2:
        emit("PTA102", f"X must be dense [batch, steps, ...] (rank >= "
                       f"2), got rank {x.rank}")
    _check_length_slot(op, ins, emit)


@register_shape_check("sequence_mask")
def _check_sequence_mask(op, ins, emit):
    _int_slot(op, ins, emit, "X")       # X IS the lengths vector here


@register_shape_check("sequence_expand")
def _check_sequence_expand(op, ins, emit):
    if ins.get("RefLength"):
        _check_length_slot(op, ins, emit, slot="RefLength")


@register_shape_check("sequence_concat")
def _check_sequence_concat(op, ins, emit):
    metas = [m for m in ins.get("X", []) if m is not None]
    dts = {dtype_name(m.dtype) for m in metas if m.dtype is not None}
    if len(dts) > 1:
        emit("PTA101", f"sequence_concat inputs mix dtypes "
                       f"{sorted(dts)}")
    ranks = {m.rank for m in metas if m.rank is not None}
    if len(ranks) > 1:
        emit("PTA102", f"sequence_concat inputs mix ranks "
                       f"{sorted(ranks)}")


# ---- detection family (ops/detection_ops.py) ----

def _box_slot(op, ins, emit, slot, rank=2):
    """A boxes tensor: given rank, last dim 4 (x1,y1,x2,y2)."""
    m = _first(ins, slot)
    if m is None or m.shape is None:
        return
    if m.rank != rank:
        emit("PTA102", f"{slot} must be rank {rank} boxes, got rank "
                       f"{m.rank}", var=_name(op, slot))
    elif m.shape[-1] is not None and m.shape[-1] != 4:
        emit("PTA102", f"{slot} last dim must be 4 (x1,y1,x2,y2), got "
                       f"{m.shape[-1]}", var=_name(op, slot))


@register_shape_check("yolo_box")
def _check_yolo_box(op, ins, emit):
    x = _first(ins, "X")
    if x is not None and x.rank is not None and x.rank != 4:
        emit("PTA102", f"X must be rank 4 [N, an*(5+C), H, W], got "
                       f"rank {x.rank}")
        return
    img = _first(ins, "ImgSize")
    if img is not None and img.dtype is not None \
            and _kind(img.dtype) not in _INT_KINDS:
        emit("PTA101", f"ImgSize must be an integer tensor, got "
                       f"{dtype_name(img.dtype)}", var=_name(op, "ImgSize"))
    if img is not None and img.shape is not None and (
            img.rank != 2 or (img.shape[1] is not None
                              and img.shape[1] != 2)):
        emit("PTA102", f"ImgSize must be [N, 2] (h, w), got "
                       f"{_fmt(img.shape)}", var=_name(op, "ImgSize"))
    anchors = op.attrs.get("anchors") or []
    class_num = op.attrs.get("class_num")
    if anchors and len(anchors) % 2:
        emit("PTA102", f"anchors attr must be (w, h) pairs, got "
                       f"{len(anchors)} values")
    elif (anchors and class_num and x is not None and x.shape is not None
            and x.shape[1] is not None):
        want = (len(anchors) // 2) * (5 + int(class_num))
        if x.shape[1] != want:
            emit("PTA102", f"X channels {x.shape[1]} != an*(5+C) = "
                           f"{len(anchors) // 2}*(5+{class_num}) = "
                           f"{want}")


@register_shape_check("prior_box", "density_prior_box",
                      "anchor_generator")
def _check_prior_box(op, ins, emit):
    for slot in ("Input", "Image"):
        m = _first(ins, slot)
        if m is not None and m.rank is not None and m.rank != 4:
            emit("PTA102", f"{slot} must be a rank-4 NCHW feature map, "
                           f"got rank {m.rank}", var=_name(op, slot))


@register_shape_check("box_coder")
def _check_box_coder(op, ins, emit):
    _box_slot(op, ins, emit, "PriorBox", rank=2)
    t = _first(ins, "TargetBox")
    if t is None or t.shape is None:
        return
    code_type = str(op.attrs.get("code_type", "encode_center_size"))
    want = 2 if code_type.startswith("encode") else 3
    if t.rank not in (2, 3) or (code_type.startswith("encode")
                                and t.rank != want):
        emit("PTA102", f"TargetBox must be rank {want} for "
                       f"{code_type}, got rank {t.rank}",
             var=_name(op, "TargetBox"))
    elif t.shape[-1] is not None and t.shape[-1] != 4:
        emit("PTA102", f"TargetBox last dim must be 4, got "
                       f"{t.shape[-1]}", var=_name(op, "TargetBox"))


@register_shape_check("iou_similarity")
def _check_iou_similarity(op, ins, emit):
    _box_slot(op, ins, emit, "X", rank=2)
    _box_slot(op, ins, emit, "Y", rank=2)


@register_shape_check("roi_align", "roi_pool")
def _check_roi(op, ins, emit):
    x = _first(ins, "X")
    if x is not None and x.rank is not None and x.rank != 4:
        emit("PTA102", f"X must be rank 4 [N, C, H, W], got rank "
                       f"{x.rank}")
    _box_slot(op, ins, emit, "ROIs", rank=2)


@register_shape_check("multiclass_nms", "matrix_nms")
def _check_nms(op, ins, emit):
    _box_slot(op, ins, emit, "BBoxes", rank=3)
    s = _first(ins, "Scores")
    if s is not None and s.rank is not None and s.rank != 3:
        emit("PTA102", f"Scores must be rank 3 [N, C, M], got rank "
                       f"{s.rank}", var=_name(op, "Scores"))
        return
    b = _first(ins, "BBoxes")
    if (b is not None and s is not None and b.shape and s.shape
            and b.shape[0] is not None and s.shape[0] is not None
            and b.shape[0] != s.shape[0]):
        emit("PTA102", f"BBoxes batch {b.shape[0]} != Scores batch "
                       f"{s.shape[0]}")


@register_shape_check("yolov3_loss")
def _check_yolov3_loss(op, ins, emit):
    x = _first(ins, "X")
    if x is not None and x.rank is not None and x.rank != 4:
        emit("PTA102", f"X must be rank 4 [N, an*(5+C), H, W], got "
                       f"rank {x.rank}")
    _box_slot(op, ins, emit, "GTBox", rank=3)
    _int_slot(op, ins, emit, "GTLabel")


def _check_num_kind(x: VarMeta, y: VarMeta, emit):
    if x.dtype is None or y.dtype is None:
        return
    fx, fy = _kind(x.dtype) == "f", _kind(y.dtype) == "f"
    if fx != fy:
        emit("PTA101", f"operands mix floating and integer dtypes: "
                       f"{dtype_name(x.dtype)} vs {dtype_name(y.dtype)}")


def _first(ins, slot) -> Optional[VarMeta]:
    row = ins.get(slot) or []
    return row[0] if row else None


def _name(op: OpDesc, slot: str) -> Optional[str]:
    row = op.inputs.get(slot) or []
    return row[0] if row else None


def _fmt(shape) -> str:
    return "[" + ", ".join("-1" if d is None else str(d)
                           for d in shape) + "]"


# ---- the propagation engine ----

def propagate(program: Program, label: str = "",
              block_idx: int = 0) -> Tuple[List[Diagnostic],
                                           Dict[str, VarMeta]]:
    """Run checkers + meta-tensor propagation over one block.

    Returns (diagnostics, env) where env maps var name → VarMeta as
    inferred (seeded from VarDescs, overwritten by propagation)."""
    from ..core.registry import OpInfoMap

    block = program.blocks[block_idx]
    info = OpInfoMap.instance()
    diags: List[Diagnostic] = []
    env: Dict[str, VarMeta] = {}
    for blk in program.blocks:
        for name, desc in blk.vars.items():
            env.setdefault(name, _from_desc(desc))

    dummy = _dummy_dim()
    unknown_reported = set()
    for i, op in enumerate(block.ops):
        if op.type in _SKIP_OPS:
            continue

        def emit(code, message, var=None, _i=i, _op=op):
            diags.append(Diagnostic(code, message, program=label,
                                    block_idx=block_idx, op_idx=_i,
                                    op_type=_op.type, var=var))

        ins: Dict[str, List[Optional[VarMeta]]] = {
            slot: [env.get(n) if n else None for n in names]
            for slot, names in op.inputs.items()}

        check = _CHECKS.get(op.type)
        if check is not None:
            check(op, ins, emit)

        if not info.has(op.type):
            if (not op.type.endswith("_grad")
                    and op.type not in unknown_reported):
                unknown_reported.add(op.type)
                emit("PTA103", "no TPU kernel registered (custom op not "
                               "loaded, or a typo'd op type); treated as "
                               "opaque")
            _mark_outputs_opaque(op, env)
            continue

        if op.type in _HOST_IO_OPS or _has_sub_blocks(op):
            # host-I/O computes would really execute under meta evaluation;
            # control-flow computes resolve their sub-blocks through the
            # executor's program context (ops/control_flow_ops.py), which
            # is absent during analysis — both opaque, never a false
            # positive
            _mark_outputs_opaque(op, env)
            continue

        outs = _meta_outputs(info.get(op.type), op, ins, emit, dummy)
        if outs is None:
            _mark_outputs_opaque(op, env)
            continue
        for slot, names in op.outputs.items():
            vals = outs.get(slot)
            if vals is None:
                continue
            for n, v in zip(names, vals):
                if not n or v is None:
                    continue
                inferred = VarMeta(
                    tuple(None if d == dummy else int(d)
                          for d in v.shape), v.dtype)
                _compare_declared(block, n, inferred, emit)
                env[n] = inferred

    if block_idx == 0:
        _check_sub_blocks(program, diags, label)
    return diags, env


def _check_sub_blocks(program: Program, diags: List[Diagnostic],
                      label: str):
    """Family checkers over every non-global block, metadata-only.

    Full propagation stops at control-flow boundaries (the computes need
    the executor's program context), but the declared-metadata contracts
    — dtype equality, rank agreement — hold inside loop/branch bodies
    too, so a dtype-mismatched add in a while body is still caught."""
    for blk in program.blocks[1:]:
        for i, op in enumerate(blk.ops):
            check = _CHECKS.get(op.type)
            if check is None:
                continue

            def emit(code, message, var=None, _i=i, _op=op, _b=blk.idx):
                diags.append(Diagnostic(code, message, program=label,
                                        block_idx=_b, op_idx=_i,
                                        op_type=_op.type, var=var))

            ins = {
                slot: [(_from_desc(d) if (d := blk.find_var_recursive(n))
                        is not None else None) if n else None
                       for n in names]
                for slot, names in op.inputs.items()}
            check(op, ins, emit)


def _has_sub_blocks(op: OpDesc) -> bool:
    from .dataflow import _sub_block_idxs
    return bool(_sub_block_idxs(op))


def _mark_outputs_opaque(op: OpDesc, env: Dict[str, VarMeta]):
    # opaque escape hatch: outputs keep whatever the VarDesc declared
    # (already seeded into env) — downstream checks treat missing pieces
    # as unknown rather than guessing
    for n in op.output_names():
        if n:
            env.setdefault(n, VarMeta())


def _meta_outputs(opdef, op: OpDesc, ins, emit, dummy):
    from ..core.registry import run_meta
    specs = {}
    for slot, metas in ins.items():
        row = []
        for m in metas:
            if m is None or not m.known():
                return None       # opaque: not enough input metadata
            shape = tuple(dummy if d is None else d for d in m.shape)
            row.append(torch.empty(shape, dtype=m.dtype, device="meta"))
        specs[slot] = row
    try:
        return run_meta(opdef, specs, op.attrs)
    except Exception as e:
        emit("PTA102",
             f"shape inference failed: {type(e).__name__}: {e}; inputs: "
             + ", ".join(
                 f"{s}={[_fmt(m.shape) for m in r if m is not None]}"
                 for s, r in ins.items()))
        return None


def _compare_declared(block: Block, name: str, inferred: VarMeta, emit):
    desc = block.find_var_recursive(name)
    if desc is None:
        return
    declared = _from_desc(desc)
    if (declared.dtype is not None and inferred.dtype is not None
            and declared.dtype != inferred.dtype):
        emit("PTA104", f"declared dtype {dtype_name(declared.dtype)} but ops "
                       f"produce {dtype_name(inferred.dtype)}", var=name)
    elif (declared.rank is not None and inferred.rank is not None
            and declared.rank != inferred.rank):
        emit("PTA104", f"declared shape {_fmt(declared.shape)} (rank "
                       f"{declared.rank}) but ops produce "
                       f"{_fmt(inferred.shape)} (rank {inferred.rank})",
             var=name)
