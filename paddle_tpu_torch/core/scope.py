"""Scope/Variable: hierarchical name → value store.

Port of ``paddle_tpu/core/scope.py`` (ref:
paddle/fluid/framework/scope.h:52, variable.h:26). A Variable is a typed
holder (TpuTensor / SelectedRows / python object for readers etc.); a
Scope maps names to Variables and chains to a parent for lookup, with kid
scopes used per-microbatch / per-thread exactly like the reference.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch

from .enforce import NotFoundError
from .tensor import TpuTensor


class Variable:
    """Type-erased value holder (ref: framework/variable.h:26)."""

    __slots__ = ("name", "_value")

    def __init__(self, name: str):
        self.name = name
        self._value = None

    def get(self):
        return self._value

    def set(self, value):
        self._value = value

    def get_tensor(self) -> TpuTensor:
        if self._value is None:
            # an empty placeholder until ``.set(value, place)`` fills it
            self._value = TpuTensor(torch.zeros((0,), dtype=torch.float32))
        return self._value

    def is_initialized(self) -> bool:
        return self._value is not None


class Scope:
    """Hierarchical variable store (ref: framework/scope.h:52)."""

    def __init__(self, parent: Optional["Scope"] = None):
        self._vars: Dict[str, Variable] = {}
        self._parent = parent
        self._kids: List[Scope] = []

    def var(self, name: str) -> Variable:
        """Find-or-create in THIS scope (ref: scope.h:68 Var)."""
        v = self._vars.get(name)
        if v is None:
            v = self._vars[name] = Variable(name)
        return v

    def find_var(self, name: str) -> Optional[Variable]:
        """Search this scope then ancestors (ref: scope.h FindVar)."""
        scope: Optional[Scope] = self
        while scope is not None:
            v = scope._vars.get(name)
            if v is not None:
                return v
            scope = scope._parent
        return None

    def get_var(self, name: str) -> Variable:
        v = self.find_var(name)
        if v is None:
            raise NotFoundError(f"Variable {name!r} not found in scope")
        return v

    def erase(self, names):
        for n in names:
            self._vars.pop(n, None)

    def new_scope(self) -> "Scope":
        """Create a kid scope (ref: scope.h:60 NewScope)."""
        kid = Scope(self)
        self._kids.append(kid)
        return kid

    def drop_kids(self):
        self._kids.clear()

    def local_var_names(self) -> List[str]:
        return list(self._vars)


_global_scope = Scope()


class _ScopeGuard:
    _stack: List[Scope] = []


def global_scope() -> Scope:
    """The ambient scope. Matches fluid semantics (ref:
    python/paddle/fluid/executor.py global_scope/_switch_scope): a
    scope_guard swaps what global_scope() returns, and Executor.run's
    default scope follows it."""
    return _ScopeGuard._stack[-1] if _ScopeGuard._stack else _global_scope


def current_scope() -> Scope:
    return global_scope()


class scope_guard:
    """Context manager switching the ambient scope (ref: fluid.scope_guard)."""

    def __init__(self, scope: Scope):
        self._scope = scope

    def __enter__(self):
        _ScopeGuard._stack.append(self._scope)
        return self._scope

    def __exit__(self, *exc):
        _ScopeGuard._stack.pop()
