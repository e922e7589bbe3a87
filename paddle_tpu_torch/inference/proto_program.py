"""Reference-format model import/export.

Port of ``paddle_tpu/inference/proto_program.py``. The reference serves
protobuf `__model__` ProgramDesc files plus LoDTensor parameter streams
(ref: paddle/fluid/framework/framework.proto:42-217,
python/paddle/fluid/io.py:1164,1374, framework/lod_tensor.cc:243
SerializeToStream, framework/tensor_util.cc TensorToStream). This module
is a dependency-free proto2 wire codec for exactly those messages, both
directions, so a real Paddle artifact, or one the JAX package wrote,
loads here, and an export here is byte for byte the JAX package's for
the same Program JSON.

Field numbers below restate framework.proto's wire contract (the
parity surface, like an API signature); the implementation shares
nothing with the reference's generated C++/python codecs.

Where the port differs: a VarDesc holds a torch dtype (the VarType
table maps to the canonical names, ``core/dtype``), and a parameter
stream reads into and writes from a torch tensor, so bfloat16 travels
as its raw 16-bit words with no ``ml_dtypes``.
"""
from __future__ import annotations

import os
import struct
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..core import dtype as dtypes
from ..core.enforce import InvalidArgumentError, NotFoundError, enforce
from ..core.program import Block, OpDesc, Program, VarDesc

# ---------------------------------------------------------------------------
# proto2 wire primitives
# ---------------------------------------------------------------------------
_WT_VARINT, _WT_64, _WT_LEN, _WT_32 = 0, 1, 2, 5


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    out = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, pos
        shift += 7


def _write_varint(v: int) -> bytes:
    out = bytearray()
    v &= (1 << 64) - 1
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _zz(v: int) -> int:          # two's-complement int64 for negatives
    return v - (1 << 64) if v >= (1 << 63) else v


def _fields(buf: bytes) -> Dict[int, list]:
    """Parse a message into {field_number: [raw values]} (varints as
    ints, length-delimited as bytes, fixed32/64 as ints)."""
    pos, out = 0, {}
    n = len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        fno, wt = key >> 3, key & 7
        if wt == _WT_VARINT:
            v, pos = _read_varint(buf, pos)
        elif wt == _WT_LEN:
            ln, pos = _read_varint(buf, pos)
            v = buf[pos:pos + ln]
            pos += ln
        elif wt == _WT_32:
            v = struct.unpack("<I", buf[pos:pos + 4])[0]
            pos += 4
        elif wt == _WT_64:
            v = struct.unpack("<Q", buf[pos:pos + 8])[0]
            pos += 8
        else:
            raise InvalidArgumentError(
                f"__model__ parse: unsupported wire type {wt} "
                f"(field {fno})")
        out.setdefault(fno, []).append(v)
    return out


def _f32(raw: int) -> float:
    return struct.unpack("<f", struct.pack("<I", raw))[0]


def _key(fno: int, wt: int) -> bytes:
    return _write_varint((fno << 3) | wt)


def _emit_len(fno: int, payload: bytes) -> bytes:
    return _key(fno, _WT_LEN) + _write_varint(len(payload)) + payload


def _emit_varint(fno: int, v: int) -> bytes:
    return _key(fno, _WT_VARINT) + _write_varint(v)


def _emit_f32(fno: int, v: float) -> bytes:
    return _key(fno, _WT_32) + struct.pack("<f", float(v))


# ---------------------------------------------------------------------------
# framework.proto enums
# ---------------------------------------------------------------------------
# AttrType (framework.proto:26)
_A_INT, _A_FLOAT, _A_STRING, _A_INTS, _A_FLOATS, _A_STRINGS = range(6)
_A_BOOLEAN, _A_BOOLEANS, _A_BLOCK, _A_LONG, _A_BLOCKS, _A_LONGS = \
    range(6, 12)

# VarType.Type (framework.proto:104) <-> the canonical dtype names
_DTYPES = {0: "bool", 1: "int16", 2: "int32", 3: "int64", 4: "float16",
           5: "float32", 6: "float64", 20: "uint8", 21: "int8",
           22: "bfloat16"}
_DTYPES_REV = {v: k for k, v in _DTYPES.items()}

_VTYPE_NAMES = {7: "LOD_TENSOR", 8: "SELECTED_ROWS", 9: "FEED_MINIBATCH",
                10: "FETCH_LIST", 11: "STEP_SCOPES", 12: "LOD_RANK_TABLE",
                13: "LOD_TENSOR_ARRAY", 14: "PLACE_LIST", 15: "READER",
                17: "RAW", 18: "TUPLE"}
_VTYPE_REV = {v: k for k, v in _VTYPE_NAMES.items()}


# ---------------------------------------------------------------------------
# decode: ProgramDesc bytes -> Program
# ---------------------------------------------------------------------------
def _decode_attr(buf: bytes):
    f = _fields(buf)
    name = f[1][0].decode()
    atype = f[2][0]
    if atype == _A_INT:
        val = _zz(f.get(3, [0])[0])
        if val >= 1 << 31:
            val -= 1 << 32
    elif atype == _A_FLOAT:
        val = _f32(f.get(4, [0])[0])
    elif atype == _A_STRING:
        val = f.get(5, [b""])[0].decode()
    elif atype == _A_INTS:
        val = [v - (1 << 32) if v >= 1 << 31 else v for v in f.get(6, [])]
    elif atype == _A_FLOATS:
        val = [_f32(v) for v in f.get(7, [])]
    elif atype == _A_STRINGS:
        val = [v.decode() for v in f.get(8, [])]
    elif atype == _A_BOOLEAN:
        val = bool(f.get(10, [0])[0])
    elif atype == _A_BOOLEANS:
        val = [bool(v) for v in f.get(11, [])]
    elif atype == _A_BLOCK:
        val = int(f.get(12, [0])[0])
    elif atype == _A_LONG:
        val = _zz(f.get(13, [0])[0])
    elif atype == _A_BLOCKS:
        val = [int(v) for v in f.get(14, [])]
    elif atype == _A_LONGS:
        val = [_zz(v) for v in f.get(15, [])]
    else:
        raise InvalidArgumentError(
            f"__model__ parse: unknown AttrType {atype} for attr "
            f"{name!r}")
    return name, atype, val


def _decode_op(buf: bytes) -> OpDesc:
    f = _fields(buf)
    op_type = f[3][0].decode()
    ins, outs, attrs = {}, {}, {}
    for raw in f.get(1, []):
        vf = _fields(raw)
        ins[vf[1][0].decode()] = [a.decode() for a in vf.get(2, [])]
    for raw in f.get(2, []):
        vf = _fields(raw)
        outs[vf[1][0].decode()] = [a.decode() for a in vf.get(2, [])]
    for raw in f.get(4, []):
        name, atype, val = _decode_attr(raw)
        if atype == _A_BLOCK:
            name = name if name != "sub_block" else "sub_block"
            attrs[name] = val          # block index (our IR convention)
        else:
            attrs[name] = val
    return OpDesc(op_type, ins, outs, attrs)


def _decode_tensor_desc(buf: bytes) -> Tuple[str, List[int]]:
    f = _fields(buf)
    dtype = _DTYPES.get(f[1][0], "float32")
    dims = [_zz(d) for d in f.get(2, [])]
    return dtype, dims


def _decode_var(buf: bytes) -> VarDesc:
    f = _fields(buf)
    name = f[1][0].decode()
    tf = _fields(f[2][0])
    vtype_no = tf[1][0]
    vtype = _VTYPE_NAMES.get(vtype_no, "LOD_TENSOR")
    dtype, dims, lod_level = None, None, 0
    if 3 in tf:                       # lod_tensor
        lf = _fields(tf[3][0])
        dtype, dims = _decode_tensor_desc(lf[1][0])
        lod_level = lf.get(2, [0])[0]
    elif 2 in tf:                     # selected_rows
        dtype, dims = _decode_tensor_desc(tf[2][0])
    elif 4 in tf:                     # tensor_array
        lf = _fields(tf[4][0])
        dtype, dims = _decode_tensor_desc(lf[1][0])
        lod_level = lf.get(2, [0])[0]
    persistable = bool(f.get(3, [0])[0])
    is_data = vtype_no == 9 or bool(f.get(4, [0])[0])
    return VarDesc(name, shape=dims, dtype=dtype, lod_level=lod_level,
                   persistable=persistable, is_data=is_data, type=vtype)


def program_from_bytes(data: bytes, check_ops: bool = True) -> Program:
    """Parse a reference `__model__` ProgramDesc into our Program IR.
    With check_ops, unmapped op types raise loudly, listing every
    offender."""
    f = _fields(data)
    prog = Program()
    prog.blocks = []
    for raw in f.get(1, []):
        bf = _fields(raw)
        blk = Block(prog, int(bf[1][0]), int(_zz(bf[2][0])))
        for vraw in bf.get(3, []):
            v = _decode_var(vraw)
            blk.vars[v.name] = v
        for oraw in bf.get(4, []):
            blk.ops.append(_decode_op(oraw))
        prog.blocks.append(blk)
    enforce(prog.blocks, "__model__ parse: no blocks", InvalidArgumentError)
    if check_ops:
        from ..core.registry import OpInfoMap
        reg = OpInfoMap.instance()
        skip = {"feed", "fetch"}
        missing = sorted({op.type for b in prog.blocks for op in b.ops
                          if op.type not in skip and not reg.has(op.type)})
        if missing:
            raise NotFoundError(
                "reference model uses ops with no registered "
                f"kernel: {missing} — add kernels or pass "
                f"check_ops=False to import anyway")
    return prog


# ---------------------------------------------------------------------------
# encode: Program -> ProgramDesc bytes
# ---------------------------------------------------------------------------
def _encode_attr(name: str, val) -> bytes:
    body = _emit_len(1, name.encode())
    if isinstance(val, bool):
        body += _emit_varint(2, _A_BOOLEAN) + _emit_varint(10, int(val))
    elif isinstance(val, int):
        if -(1 << 31) <= val < (1 << 31):
            body += _emit_varint(2, _A_INT) + _emit_varint(3, val)
        else:
            body += _emit_varint(2, _A_LONG) + _emit_varint(13, val)
    elif isinstance(val, float):
        body += _emit_varint(2, _A_FLOAT) + _emit_f32(4, val)
    elif isinstance(val, str):
        body += _emit_varint(2, _A_STRING) + _emit_len(5, val.encode())
    elif isinstance(val, (list, tuple, np.ndarray)):
        items = list(np.asarray(val).tolist()) \
            if isinstance(val, np.ndarray) else list(val)
        if any(isinstance(v, (list, tuple, dict, np.ndarray)) for v in items):
            # nested structures (e.g. ndim>1 ndarray blobs) have no
            # framework.proto attr slot
            raise InvalidArgumentError(
                f"cannot encode nested attr {name!r}")
        if items and isinstance(items[0], bool):
            body += _emit_varint(2, _A_BOOLEANS)
            for v in items:
                body += _emit_varint(11, int(v))
        elif items and isinstance(items[0], float):
            body += _emit_varint(2, _A_FLOATS)
            for v in items:
                body += _emit_f32(7, v)
        elif items and isinstance(items[0], str):
            body += _emit_varint(2, _A_STRINGS)
            for v in items:
                body += _emit_len(8, v.encode())
        else:
            big = any(not -(1 << 31) <= int(v) < (1 << 31)
                      for v in items)
            if big:
                body += _emit_varint(2, _A_LONGS)
                for v in items:
                    body += _emit_varint(15, int(v))
            else:
                body += _emit_varint(2, _A_INTS)
                for v in items:
                    body += _emit_varint(6, int(v) & ((1 << 32) - 1))
    else:
        raise InvalidArgumentError(
            f"cannot encode attr {name!r} of type {type(val).__name__}")
    return body


def _encode_op(op: OpDesc) -> bytes:
    body = b""
    for slot, names in op.inputs.items():
        var = _emit_len(1, slot.encode())
        for n in names:
            var += _emit_len(2, n.encode())
        body += _emit_len(1, var)
    for slot, names in op.outputs.items():
        var = _emit_len(1, slot.encode())
        for n in names:
            var += _emit_len(2, n.encode())
        body += _emit_len(2, var)
    body += _emit_len(3, op.type.encode())
    dropped = []
    for name, val in op.attrs.items():
        try:
            body += _emit_len(4, _encode_attr(name, val))
        except InvalidArgumentError:
            dropped.append(name)      # non-proto-able attr (e.g. ndarray blobs)
    if dropped:
        import warnings
        warnings.warn(
            f"proto export: op '{op.type}' dropped non-serializable "
            f"attr(s) {dropped}; the reference toolchain will use op "
            f"defaults for these", stacklevel=2)
    return body


def _encode_tensor_desc(dtype: str, dims) -> bytes:
    body = _emit_varint(1, _DTYPES_REV.get(str(dtype), 5))
    for d in (dims or []):
        body += _emit_varint(2, int(d) & ((1 << 64) - 1))
    return body


def _encode_var(v: VarDesc) -> bytes:
    vtype_no = _VTYPE_REV.get(v.type, 7)
    dtype = (dtypes.dtype_name(v.dtype) if v.dtype is not None
             else "float32")
    tdesc = _encode_tensor_desc(dtype, v.shape)
    lod = _emit_len(1, tdesc) + _emit_varint(2, int(v.lod_level or 0))
    vtype = _emit_varint(1, vtype_no)
    if v.type == "SELECTED_ROWS":
        vtype += _emit_len(2, tdesc)
    elif v.type == "LOD_TENSOR_ARRAY":
        vtype += _emit_len(4, lod)
    else:
        vtype += _emit_len(3, lod)
    body = _emit_len(1, v.name.encode()) + _emit_len(2, vtype)
    if v.persistable:
        body += _emit_varint(3, 1)
    if v.is_data:
        body += _emit_varint(4, 1)
    return body


def program_to_bytes(program: Program) -> bytes:
    out = b""
    for blk in program.blocks:
        body = _emit_varint(1, blk.idx)
        body += _emit_varint(2, blk.parent_idx & ((1 << 32) - 1))
        for v in blk.vars.values():
            body += _emit_len(3, _encode_var(v))
        for op in blk.ops:
            body += _emit_len(4, _encode_op(op))
        out += _emit_len(1, body)
    return out


# ---------------------------------------------------------------------------
# LoDTensor parameter streams (lod_tensor.cc SerializeToStream layout)
# ---------------------------------------------------------------------------
def _host_tensor(value) -> torch.Tensor:
    """``value`` (a torch tensor, or a numpy array, ml_dtypes' bfloat16
    taken by its 16-bit words) as a contiguous CPU tensor."""
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().contiguous()
    arr = np.asarray(value)
    if not arr.flags.c_contiguous:
        arr = np.ascontiguousarray(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def write_lod_tensor(f, value):
    """One LoDTensor stream (no LoD) of ``value``, a torch tensor or a
    numpy array; bfloat16 is written as its raw 16-bit words."""
    t = _host_tensor(value)
    f.write(struct.pack("<I", 0))            # LoDTensor version
    f.write(struct.pack("<Q", 0))            # lod_level = 0
    f.write(struct.pack("<I", 0))            # tensor version
    desc = _encode_tensor_desc(dtypes.dtype_name(t.dtype), t.shape)
    f.write(struct.pack("<i", len(desc)))
    f.write(desc)
    words = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
    f.write(words.numpy().tobytes())


def read_lod_tensor(f) -> torch.Tensor:
    """One LoDTensor stream as a CPU torch tensor of its dtype (bfloat16
    from its raw 16-bit words); the LoD is skipped."""
    ver = struct.unpack("<I", f.read(4))[0]
    enforce(ver == 0, f"unsupported LoDTensor version {ver}",
            InvalidArgumentError)
    lod_levels = struct.unpack("<Q", f.read(8))[0]
    for _ in range(lod_levels):
        nbytes = struct.unpack("<Q", f.read(8))[0]
        f.read(nbytes)
    tver = struct.unpack("<I", f.read(4))[0]
    enforce(tver == 0, f"unsupported Tensor version {tver}",
            InvalidArgumentError)
    dsize = struct.unpack("<i", f.read(4))[0]
    dtype, dims = _decode_tensor_desc(f.read(dsize))
    tdtype = dtypes.convert_dtype(dtype)
    count = int(np.prod(dims)) if dims else 1
    data = bytearray(f.read(count * tdtype.itemsize))
    if not data:
        return torch.empty(dims, dtype=tdtype)
    return torch.frombuffer(data, dtype=tdtype).reshape(dims)


# ---------------------------------------------------------------------------
# directory-level load/save (io.py:1164,1374 artifact layout)
# ---------------------------------------------------------------------------
def _persistable_names(program: Program) -> List[str]:
    skip_types = {"FEED_MINIBATCH", "FETCH_LIST", "RAW", "STEP_SCOPES",
                  "READER"}
    return [v.name for v in program.global_block().vars.values()
            if v.persistable and v.type not in skip_types]


def strip_feed_fetch(program: Program):
    """Drop feed/fetch plumbing ops, returning (feed_names,
    fetch_names) recorded in their attrs (ref:
    inference/api/analysis_predictor.cc PrepareProgram)."""
    blk = program.global_block()
    feeds, fetches = [], []
    kept = []
    for op in blk.ops:
        if op.type == "feed":
            feeds.append((op.attr("col", len(feeds)),
                          op.output_names()[0]))
        elif op.type == "fetch":
            fetches.append((op.attr("col", len(fetches)),
                            op.input_names()[0]))
        else:
            kept.append(op)
    blk.ops = kept
    program._invalidate_fingerprint()
    feeds = [n for _, n in sorted(feeds)]
    fetches = [n for _, n in sorted(fetches)]
    return feeds, fetches


def load_reference_inference_model(dirname, model_filename=None,
                                   params_filename=None, scope=None,
                                   place=None):
    """Load a reference-format artifact dir (binary `__model__` +
    LoDTensor params) → (Program, feed_names, fetch_names); params go
    into the scope, on ``place`` (the default device when None) (ref:
    fluid/io.py:1374 load_inference_model)."""
    from ..core.scope import global_scope
    from ..core.tensor import TpuTensor
    from ..device import get_device
    scope = scope or global_scope()
    place = place if place is not None else get_device()
    model_path = os.path.join(dirname, model_filename or "__model__")
    with open(model_path, "rb") as f:
        program = program_from_bytes(f.read())
    feeds, fetches = strip_feed_fetch(program)
    names = _persistable_names(program)
    if params_filename:
        with open(os.path.join(dirname, params_filename), "rb") as f:
            for name in names:
                scope.var(name).set(TpuTensor(read_lod_tensor(f),
                                             device=place))
    else:
        for name in names:
            with open(os.path.join(dirname, name), "rb") as f:
                scope.var(name).set(TpuTensor(read_lod_tensor(f),
                                             device=place))
    return program, feeds, fetches


def save_reference_inference_model(dirname, feed_names, fetch_names,
                                   program: Program, scope=None,
                                   model_filename=None,
                                   params_filename=None):
    """Emit the reference artifact layout (binary `__model__` +
    LoDTensor params + feed/fetch ops) from our Program + scope —
    export parity AND the fixture generator for import tests."""
    from ..core.scope import global_scope
    scope = scope or global_scope()
    prog = program.clone(for_test=True)
    blk = prog.global_block()
    # reference programs carry feed/fetch plumbing ops
    blk.create_var("feed", persistable=True, type="FEED_MINIBATCH")
    blk.create_var("fetch", persistable=True, type="FETCH_LIST")
    for i, n in enumerate(feed_names):
        blk.insert_op(i, "feed", {"X": ["feed"]}, {"Out": [n]},
                      {"col": i})
    for i, n in enumerate(fetch_names):
        blk.append_op("fetch", {"X": [n]}, {"Out": ["fetch"]},
                      {"col": i})
    os.makedirs(dirname, exist_ok=True)
    with open(os.path.join(dirname, model_filename or "__model__"),
              "wb") as f:
        f.write(program_to_bytes(prog))
    names = _persistable_names(program)
    if params_filename:
        with open(os.path.join(dirname, params_filename), "wb") as f:
            for name in names:
                write_lod_tensor(f, scope.find_var(name).get().value)
    else:
        for name in names:
            with open(os.path.join(dirname, name), "wb") as f:
                write_lod_tensor(f, scope.find_var(name).get().value)
