"""Program IR: Program / Block / OpDesc / VarDesc.

Port of ``paddle_tpu/core/program.py`` (ref:
paddle/fluid/framework/framework.proto:42-217 and the python mirror
python/paddle/fluid/framework.py: Program :3944, Block :2482,
Operator :1891, Variable :899). The IR is plain python serialized to
JSON, and the JSON is a format the two packages share: a program the
JAX package writes loads here and writes back byte for byte. A VarDesc
holds a ``torch.dtype`` and writes its canonical name ("float32"), as
the JAX package writes ``np.dtype.name``. The port's executor
interprets a block op by op (``executor.py``).
"""
from __future__ import annotations

import copy
import hashlib
import json
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from . import dtype as dtypes
from .enforce import NotFoundError, enforce

GRAD_SUFFIX = "@GRAD"


def _jsonable_attr(v):
    if isinstance(v, (np.dtype, torch.dtype)):
        return {"__dtype__": dtypes.dtype_name(v)}
    if isinstance(v, np.ndarray):
        return {"__ndarray__": v.tolist(), "dtype": v.dtype.name}
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    if isinstance(v, np.bool_):
        return bool(v)
    if isinstance(v, (list, tuple)):
        return [_jsonable_attr(x) for x in v]
    return v


def _unjson_attr(v):
    if isinstance(v, dict) and "__dtype__" in v:
        return dtypes.convert_dtype(v["__dtype__"])
    if isinstance(v, dict) and "__ndarray__" in v:
        return np.asarray(v["__ndarray__"], dtype=v["dtype"])
    return v


class VarDesc:
    """Variable metadata (ref: framework.proto:165 VarDesc)."""

    __slots__ = ("name", "shape", "dtype", "lod_level", "persistable",
                 "stop_gradient", "is_data", "type")

    def __init__(self, name: str, shape=None, dtype=None, lod_level: int = 0,
                 persistable: bool = False, stop_gradient: bool = False,
                 is_data: bool = False, type: str = "LOD_TENSOR"):
        self.name = name
        self.shape = tuple(shape) if shape is not None else None
        self.dtype = dtypes.convert_dtype(dtype) if dtype is not None else None
        self.lod_level = lod_level
        self.persistable = persistable
        self.stop_gradient = stop_gradient
        self.is_data = is_data
        self.type = type  # LOD_TENSOR | SELECTED_ROWS | ... (framework.proto:104)

    def to_dict(self):
        return {
            "name": self.name,
            "shape": list(self.shape) if self.shape is not None else None,
            "dtype": (dtypes.dtype_name(self.dtype)
                      if self.dtype is not None else None),
            "lod_level": self.lod_level,
            "persistable": self.persistable,
            "stop_gradient": self.stop_gradient,
            "is_data": self.is_data,
            "type": self.type,
        }

    @classmethod
    def from_dict(cls, d):
        d = dict(d)
        return cls(**d)


class OpDesc:
    """Operator node (ref: framework.proto:74 OpDesc, op_desc.h)."""

    __slots__ = ("type", "inputs", "outputs", "attrs")

    def __init__(self, type_: str, inputs: Optional[Dict[str, List[str]]] = None,
                 outputs: Optional[Dict[str, List[str]]] = None,
                 attrs: Optional[Dict[str, Any]] = None):
        self.type = type_
        self.inputs = {k: list(v) for k, v in (inputs or {}).items()}
        self.outputs = {k: list(v) for k, v in (outputs or {}).items()}
        self.attrs = dict(attrs or {})

    def input_names(self) -> List[str]:
        return [n for ns in self.inputs.values() for n in ns]

    def output_names(self) -> List[str]:
        return [n for ns in self.outputs.values() for n in ns]

    def attr(self, name, default=None):
        return self.attrs.get(name, default)

    def to_dict(self):
        return {
            "type": self.type,
            "inputs": self.inputs,
            "outputs": self.outputs,
            "attrs": {k: _jsonable_attr(v) for k, v in self.attrs.items()},
        }

    @classmethod
    def from_dict(cls, d):
        return cls(d["type"], d.get("inputs"), d.get("outputs"),
                   {k: _unjson_attr(v) for k, v in d.get("attrs", {}).items()})

    def __repr__(self):
        return f"OpDesc({self.type}, in={self.inputs}, out={self.outputs})"


class Block:
    """Op list + var table (ref: framework.proto:42 BlockDesc)."""

    def __init__(self, program: "Program", idx: int, parent_idx: int = -1):
        self.program = program
        self.idx = idx
        self.parent_idx = parent_idx
        self.vars: Dict[str, VarDesc] = {}
        self.ops: List[OpDesc] = []

    # -- var management --
    def create_var(self, name: str, **kwargs) -> VarDesc:
        if name in self.vars:
            return self.vars[name]
        v = VarDesc(name, **kwargs)
        self.vars[name] = v
        self.program._invalidate_fingerprint()
        return v

    def var(self, name: str) -> VarDesc:
        v = self.find_var_recursive(name)
        if v is None:
            raise NotFoundError(f"var {name!r} not in block {self.idx}")
        return v

    def has_var(self, name: str) -> bool:
        return self.find_var_recursive(name) is not None

    def find_var_recursive(self, name: str) -> Optional[VarDesc]:
        blk: Optional[Block] = self
        while blk is not None:
            if name in blk.vars:
                return blk.vars[name]
            blk = (self.program.blocks[blk.parent_idx]
                   if blk.parent_idx >= 0 else None)
        return None

    # -- op management --
    def append_op(self, type: str, inputs=None, outputs=None, attrs=None) -> OpDesc:
        op = OpDesc(type, inputs, outputs, attrs)
        self.ops.append(op)
        self.program._invalidate_fingerprint()
        return op

    def append_op_desc(self, op: OpDesc) -> OpDesc:
        self.ops.append(op)
        self.program._invalidate_fingerprint()
        return op

    def insert_op(self, index: int, type: str, inputs=None, outputs=None,
                  attrs=None) -> OpDesc:
        op = OpDesc(type, inputs, outputs, attrs)
        self.ops.insert(index, op)
        self.program._invalidate_fingerprint()
        return op

    def remove_op(self, index: int) -> OpDesc:
        """Remove and return the op at ``index``. Rewrite passes (e.g.
        analysis.eliminate_dead_ops) MUST mutate through this so the
        fingerprint — and with it every executor cache key — changes."""
        op = self.ops.pop(index)
        self.program._invalidate_fingerprint()
        return op

    def to_dict(self):
        return {
            "idx": self.idx,
            "parent_idx": self.parent_idx,
            "vars": {n: v.to_dict() for n, v in self.vars.items()},
            "ops": [op.to_dict() for op in self.ops],
        }


class Program:
    """The whole graph (ref: framework.proto:212 ProgramDesc;
    python mirror fluid/framework.py:3944)."""

    def __init__(self):
        self.blocks: List[Block] = []
        self.blocks.append(Block(self, 0))
        self.random_seed = 0
        self._name_counter = 0
        self._fingerprint: Optional[str] = None

    def _invalidate_fingerprint(self):
        self._fingerprint = None

    def global_block(self) -> Block:
        return self.blocks[0]

    def current_block(self) -> Block:
        return self.blocks[getattr(self, "_current_block_idx", 0)]

    def append_block(self, parent: Block) -> Block:
        blk = Block(self, len(self.blocks), parent.idx)
        self.blocks.append(blk)
        return blk

    def unique_name(self, prefix: str = "tmp") -> str:
        self._name_counter += 1
        return f"{prefix}_{self._name_counter}"

    # -- introspection used by transpile-check style tests --
    def op_types(self, block_idx: int = 0) -> List[str]:
        return [op.type for op in self.blocks[block_idx].ops]

    def list_vars(self) -> List[VarDesc]:
        return [v for b in self.blocks for v in b.vars.values()]

    def all_parameters(self) -> List[VarDesc]:
        return [v for v in self.list_vars() if v.persistable and not v.is_data]

    def prune(self, targets) -> "Program":
        """Backward-slice the global block to the ops needed for
        ``targets`` (ref: framework.py Program._prune / prune_backward)."""
        names = [t if isinstance(t, str) else t.name for t in targets]
        p = copy.deepcopy(self)
        blk = p.global_block()
        needed = set(names)
        kept = []
        for op in reversed(blk.ops):
            outs = set(op.output_names())
            if outs & needed:
                kept.append(op)
                needed.update(n for n in op.input_names() if n)
        blk.ops = list(reversed(kept))
        p._invalidate_fingerprint()
        return p

    def clone(self, for_test: bool = False) -> "Program":
        p = copy.deepcopy(self)
        p._invalidate_fingerprint()
        if for_test:
            for blk in p.blocks:
                for op in blk.ops:
                    if op.type in _TEST_MODE_OPS:
                        op.attrs["is_test"] = True
        return p

    # -- serialization (ref: ProgramDesc protobuf round-trip) --
    def to_json(self) -> str:
        return json.dumps({
            "version": 1,
            "blocks": [b.to_dict() for b in self.blocks],
        }, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "Program":
        data = json.loads(text)
        p = cls()
        p.blocks = []
        for bd in data["blocks"]:
            blk = Block(p, bd["idx"], bd["parent_idx"])
            blk.vars = {n: VarDesc.from_dict(v) for n, v in bd["vars"].items()}
            blk.ops = [OpDesc.from_dict(od) for od in bd["ops"]]
            p.blocks.append(blk)
        enforce(len(p.blocks) > 0, "program has no blocks")
        return p

    def fingerprint(self) -> str:
        """Memoized program hash for executor cache keys; invalidated by
        structural mutations (append/insert op, create var). Mutating an
        OpDesc's attrs in place after a run bypasses this — rebuild or
        clone the program instead."""
        if self._fingerprint is None:
            self._fingerprint = hashlib.sha1(self.to_json().encode()).hexdigest()
        return self._fingerprint


_TEST_MODE_OPS = frozenset({"dropout", "batch_norm", "sync_batch_norm"})


# ---- default program/ambient state (fluid.default_main_program contract) ----
_main_program = Program()
_startup_program = Program()


def default_main_program() -> Program:
    return _main_program


def default_startup_program() -> Program:
    return _startup_program


class program_guard:
    """Swap ambient main/startup programs (ref: fluid.program_guard)."""

    def __init__(self, main_program: Program,
                 startup_program: Optional[Program] = None):
        self._main = main_program
        self._startup = startup_program

    def __enter__(self):
        global _main_program, _startup_program
        self._saved = (_main_program, _startup_program)
        _main_program = self._main
        if self._startup is not None:
            _startup_program = self._startup
        return self._main

    def __exit__(self, *exc):
        global _main_program, _startup_program
        _main_program, _startup_program = self._saved
