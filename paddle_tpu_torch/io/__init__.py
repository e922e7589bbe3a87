"""IO: persistence of state dicts and static programs.

Port of the persistence half of ``paddle_tpu/io/__init__.py`` (ref:
python/paddle/fluid/io.py save/load :1669,1730, save/load_persistables
:598,966, save/load_inference_model :1164,1374), in the same layout, so
the two packages read each other's files: state dicts as ``np.savez``
archives, a program as JSON next to a ``params.npz`` archive;
``load_inference_model`` also reads the reference's protobuf
``__model__`` (``inference/proto_program.py``). The DataLoader and
datasets wait for ROADMAP Queue 1 item 6.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np
import torch

from ..core.enforce import NotFoundError
from ..core.program import Program
from ..core.scope import Scope, global_scope
from ..core.tensor import TpuTensor

_STATE_SUFFIX = ".pdparams.npz"
_OPT_SUFFIX = ".pdopt.npz"


def _esc(k: str) -> str:
    # '/' is the nesting separator; escape it (and the escape char) in
    # key components so flatten/unflatten is a true inverse even for
    # state-dict keys that legitimately contain '/'
    return k.replace("%", "%25").replace("/", "%2F")


def _unesc(k: str) -> str:
    return k.replace("%2F", "/").replace("%25", "%")


def _flatten_state(state: Dict, prefix="") -> Dict[str, np.ndarray]:
    flat = {}
    for k, v in state.items():
        key = f"{prefix}{_esc(str(k))}"
        if isinstance(v, dict):
            flat.update(_flatten_state(v, key + "/"))
        elif isinstance(v, torch.Tensor):
            flat[key] = TpuTensor(v).numpy()
        elif hasattr(v, "numpy"):
            flat[key] = v.numpy()
        else:
            flat[key] = np.asarray(v)
    return flat


def save(obj: Dict, path: str):
    """paddle.save parity for state dicts (ref: dygraph/checkpoint.py
    save_dygraph). ``path`` may carry .pdparams/.pdopt; stored as npz with
    the matching suffix so params and optimizer state never clobber each
    other when sharing a base name."""
    base = _strip_suffix(path)
    suffix = (_OPT_SUFFIX if path.endswith((".pdopt", _OPT_SUFFIX))
              else _STATE_SUFFIX)
    os.makedirs(os.path.dirname(os.path.abspath(base)) or ".", exist_ok=True)
    flat = _flatten_state(obj)
    np.savez(base + suffix, **flat)


def _unflatten_state(flat: Dict[str, np.ndarray]) -> Dict:
    """Invert _flatten_state: 'a/b' keys (nested sub-dicts, e.g. the
    optimizer's LR_Scheduler state) back into dicts; plain keys stay."""
    out: Dict = {}
    for k, v in flat.items():
        parts = [_unesc(p) for p in k.split("/")]
        d = out
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = v
    return out


def load(path: str) -> Dict[str, np.ndarray]:
    """paddle.load parity; returns the saved state dict (nested
    sub-dicts restored)."""
    base = _strip_suffix(path)
    if path.endswith((".pdopt", _OPT_SUFFIX)):
        candidates = (path, base + _OPT_SUFFIX)
    else:
        candidates = (path, base + _STATE_SUFFIX)
    for candidate in candidates:
        if os.path.exists(candidate):
            with np.load(candidate, allow_pickle=False) as data:
                return _unflatten_state({k: data[k] for k in data.files})
    raise FileNotFoundError(f"no saved state at {path!r}")


def _strip_suffix(path: str) -> str:
    for suf in (_STATE_SUFFIX, _OPT_SUFFIX, ".pdparams", ".pdopt"):
        if path.endswith(suf):
            return path[:-len(suf)]
    return path


def save_dygraph(state_dict, model_path):
    save(state_dict, model_path)


def load_dygraph(model_path):
    try:
        params = load(model_path + ".pdparams")
    except FileNotFoundError:
        params = load(model_path)
    try:
        opt = load(model_path + ".pdopt")
    except FileNotFoundError:
        opt = None
    return params, opt


# ---- static program persistence (fluid.io surface) ----
def save_persistables(executor, dirname, main_program: Optional[Program] = None,
                      filename: Optional[str] = None,
                      scope: Optional[Scope] = None):
    """ref: fluid/io.py:598 — save every persistable var in the scope."""
    from ..core.program import default_main_program
    program = main_program or default_main_program()
    scope = scope or global_scope()
    os.makedirs(dirname, exist_ok=True)
    arrays = {}
    for var in program.list_vars():
        if not var.persistable:
            continue
        v = scope.find_var(var.name)
        if v is not None and v.is_initialized():
            arrays[var.name] = TpuTensor(v.get()).numpy()
    np.savez(os.path.join(dirname, filename or "params.npz"), **arrays)


def load_persistables(executor, dirname, main_program: Optional[Program] = None,
                      filename: Optional[str] = None,
                      scope: Optional[Scope] = None):
    """ref: fluid/io.py:966. The values go onto the executor's place
    (the default device when it has none). bfloat16, which npz cannot
    hold, was written as float32 (exact, ``TpuTensor.numpy``): a var
    the program declares bfloat16 comes back as bfloat16."""
    scope = scope or global_scope()
    place = getattr(executor, "place", None)
    block = main_program.global_block() if main_program is not None \
        else None
    with np.load(os.path.join(dirname, filename or "params.npz")) as data:
        for name in data.files:
            t = TpuTensor(data[name], device=place)
            desc = block.find_var_recursive(name) if block else None
            if desc is not None and desc.dtype == torch.bfloat16 and \
                    t.dtype == torch.float32:
                t = TpuTensor(t.value.to(torch.bfloat16))
            scope.var(name).set(t)


def save_inference_model(dirname, feeded_var_names, target_vars, executor,
                         main_program: Optional[Program] = None,
                         model_filename=None, params_filename=None,
                         scope: Optional[Scope] = None):
    """ref: fluid/io.py:1164 — persist program (JSON) + params, recording
    feed/fetch names for the predictor."""
    from ..core.program import default_main_program
    program = (main_program or default_main_program()).clone(for_test=True)
    program = program.prune(target_vars)
    os.makedirs(dirname, exist_ok=True)
    meta = {
        "feed_names": list(feeded_var_names),
        "fetch_names": [t if isinstance(t, str) else t.name
                        for t in target_vars],
    }
    with open(os.path.join(dirname, model_filename or "__model__.json"),
              "w") as f:
        json.dump({"program": json.loads(program.to_json()), "meta": meta}, f)
    save_persistables(executor, dirname, program,
                      params_filename or "params.npz", scope)
    return meta["fetch_names"]


def load_inference_model(dirname, executor, model_filename=None,
                         params_filename=None,
                         scope: Optional[Scope] = None):
    """ref: fluid/io.py:1374 -> (program, feed_names, fetch_names).

    Reads both artifact families, as the JAX package does: the JSON-IR
    layout, and the reference's binary protobuf ``__model__`` with its
    LoDTensor parameter streams (``inference/proto_program.py``), so a
    real Paddle export, or one the JAX package wrote, loads unchanged. A
    model file named for JSON that is not JSON is sniffed and read as
    protobuf. The values go onto the executor's place (the default
    device when it has none)."""
    json_path = os.path.join(dirname, model_filename or "__model__.json")
    proto_path = os.path.join(dirname, model_filename or "__model__")
    if os.path.exists(json_path):
        # sniff: a named artifact may itself be binary protobuf
        with open(json_path, "rb") as f:
            head = f.read(1)
        if head not in (b"{", b""):
            json_path = None
    else:
        json_path = None
    if json_path is None:
        if os.path.exists(proto_path):
            from ..inference.proto_program import (
                load_reference_inference_model)
            return load_reference_inference_model(
                dirname, model_filename, params_filename, scope,
                place=getattr(executor, "place", None))
        raise NotFoundError(
            f"no inference model found under {dirname!r}: neither "
            f"JSON ({model_filename or '__model__.json'}) nor "
            f"reference-format ({model_filename or '__model__'}) "
            f"artifact exists")
    with open(json_path) as f:
        payload = json.load(f)
    program = Program.from_json(json.dumps(payload["program"]))
    load_persistables(executor, dirname, program,
                      params_filename or "params.npz", scope)
    feeds = payload["meta"]["feed_names"]
    fetches = payload["meta"]["fetch_names"]
    program._feed_target_names = list(feeds)
    program._fetch_target_names = list(fetches)
    return program, feeds, fetches
