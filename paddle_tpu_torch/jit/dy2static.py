"""AST-based dygraph->static conversion.

Port of ``paddle_tpu/jit/dy2static.py`` (ref: python/paddle/fluid/dygraph/
dygraph_to_static/program_translator.py:691 and ifelse_transformer.py /
loop_transformer.py / logical_transformer.py). ``if``/``while``
statements and ``and``/``or``/``not`` are rewritten into calls of the
runtime helpers below, which dispatch on what the condition turns out
to be at run time; plain-Python conditions keep eager Python semantics.
The AST half (``_AssignedNames`` ... ``ast_transform``) is the JAX
package's, copied.

The port has no tracer: it runs the converted function eagerly. The
reference traces every tensor that derives from the inputs under
``to_static``, and the port follows the reference's *traced* behaviour
for a torch tensor condition:

- ``convert_ifelse`` runs both branches and merges each output pair with
  ``torch.where`` on the condition's ``all()``: no host sync, the
  defined side wins for a name only one branch assigns, and mismatched
  shapes raise the reference's ``TypeError``;
- ``convert_while`` loops on the host and reads the condition once an
  iteration (its ``all()``), as the port's unbounded ``while_loop`` op
  does. The body rebinding a loop variable that is not a tensor, a
  number or a TensorArray raises the reference's ``TypeError``. Numbers
  stay Python numbers while the loop runs (an index into a TensorArray
  costs no sync) and come out as tensors, where the reference's
  ``lax.while_loop`` makes them arrays: int32, float32 or bool;
- ``and``, ``or`` and ``not`` on tensors reduce with ``all()`` and do
  not short-circuit, as the reference's traced route does.

A numpy condition keeps the reference's untraced route: the branch or
the iteration is chosen on the host by its ``all()``.

Where the port differs from the reference:

- a loop whose carry changes shape from one iteration to the next (a
  growing sequence) runs here; ``lax.while_loop`` cannot trace it;
- a variable the reference carries statically (not a tensor or a
  number before the loop) that the body rebinds to a tensor comes out
  with the body's value, where the reference keeps the value from
  before the loop;
- the rebinding check runs on the iterations that run, so a loop that
  runs no iteration raises nothing (the reference probes the body once
  whatever the trip count).

Statements containing ``return``/``break``/``continue`` inside a
converted block are left un-rewritten (plain Python, as in the
reference).
"""
from __future__ import annotations

import ast
import inspect
import textwrap
from typing import Callable

import numpy as np
import torch

from ..tensor_array import TensorArray


class _Undefined:
    """Sentinel for names only assigned in one branch (the reference's
    UndefinedVar, ifelse_transformer.py)."""

    _inst = None

    def __new__(cls):
        if cls._inst is None:
            cls._inst = super().__new__(cls)
        return cls._inst

    def __repr__(self):
        return "<undefined>"


UNDEFINED = _Undefined()


# ---------------------------------------------------------------- runtime
def _truthiness(v):
    """(is_tensor, value): torch tensors and numpy arrays are tensors,
    everything else keeps plain-Python truthiness (None, lists, strings
    ... must behave exactly as eager python — ref convert_operators.py
    convert_var_to_bool)."""
    if isinstance(v, torch.Tensor):
        return True, v
    if type(v).__module__ == "numpy" and hasattr(v, "ndim"):
        return True, v
    return False, v


def _traced(v) -> bool:
    """Whether the reference traces ``v`` under to_static: a torch
    tensor (numpy values stay on the host)."""
    return isinstance(v, torch.Tensor)


def _all(v):
    """The condition of a tensor: a 0-d bool tensor of ``v``'s
    ``all()`` (a torch tensor), or a Python bool (numpy)."""
    if isinstance(v, torch.Tensor):
        return v.all()
    return bool(np.all(v))


def _as_tensor(v, device):
    """``v`` as a tensor on ``device``; a number is filled in there, so
    that no copy from host memory waits for the card's stream."""
    if isinstance(v, torch.Tensor):
        return v
    if isinstance(v, (bool, int, float)):
        return torch.full((), v, device=device)
    return torch.as_tensor(v, device=device)


def convert_ifelse(cond, true_fn, false_fn, seed_vals):
    """Runtime dispatch (ref: convert_operators.py convert_ifelse).
    ``seed_vals`` are the current values of every name either branch
    assigns — passed as branch-fn arguments so read-modify-write
    patterns (y = y + 1) see the outer value instead of hitting
    UnboundLocalError.

    Tensor condition: SELECT semantics — both branches execute and each
    output pair merges through ``torch.where`` on the condition's
    ``all()``, with no host sync; a name assigned in only one branch
    takes that branch's value (the defined side wins; reading such a
    name after the if when the other branch ran is user error in eager
    paddle too)."""
    is_tensor, c = _truthiness(cond)
    if not is_tensor:
        return true_fn(*seed_vals) if c else false_fn(*seed_vals)
    if not _traced(c):
        return (true_fn(*seed_vals) if _all(c)
                else false_fn(*seed_vals))

    pred = _all(c)
    t_out = tuple(true_fn(*seed_vals))
    f_out = tuple(false_fn(*seed_vals))

    merged = []
    for t, f in zip(t_out, f_out):
        if t is UNDEFINED and f is UNDEFINED:
            merged.append(UNDEFINED)
        elif f is UNDEFINED:
            merged.append(_as_tensor(t, pred.device))
        elif t is UNDEFINED:
            merged.append(_as_tensor(f, pred.device))
        else:
            ta, fa = _as_tensor(t, pred.device), _as_tensor(f, pred.device)
            if ta.shape != fa.shape:
                raise TypeError(
                    "if/else branches produce mismatched shapes "
                    f"{tuple(ta.shape)} vs {tuple(fa.shape)} for the same "
                    "variable under a traced condition")
            merged.append(torch.where(pred, ta, fa))
    return tuple(merged)


def _is_dynamic(v):
    """A loop carry the reference's lax.while_loop takes: a tensor, a
    number, or a TensorArray (a registered pytree there)."""
    return isinstance(v, (torch.Tensor, TensorArray, int, float, bool))


_NUMBER_DTYPES = ((bool, torch.bool), (int, torch.int32),
                  (float, torch.float32))


def _number_tensor(v, device):
    """A number carried through the loop as the reference's
    lax.while_loop gives it back: a 0-d bool, int32 or float32 tensor."""
    for kind, dt in _NUMBER_DTYPES:
        if isinstance(v, kind):
            return torch.full((), v, dtype=dt, device=device)
    return v


def convert_while(cond_fn, body_fn, loop_vars):
    """Runtime dispatch (ref: convert_operators.py convert_while_loop).

    The reference's traced route, taken when the condition or a loop
    variable is a torch tensor: the loop runs on the host, reading the
    condition's ``all()`` once an iteration. Loop vars that aren't
    tensors/numbers/TensorArrays (modules, layers, lists read by the
    condition) ride along; the body rebinding one to such a value raises
    the reference's TypeError. Numbers come out as tensors."""
    loop_vars = tuple(loop_vars)
    first = cond_fn(*loop_vars)
    is_tensor, c = _truthiness(first)
    if not _traced(c) and not any(_traced(v) for v in loop_vars):
        while _all(c) if is_tensor else c:
            loop_vars = tuple(body_fn(*loop_vars))
            is_tensor, c = _truthiness(cond_fn(*loop_vars))
        return loop_vars

    device = next((v.device for v in (c,) + loop_vars
                   if isinstance(v, torch.Tensor)), None)
    dyn = [_is_dynamic(v) for v in loop_vars]
    while bool(_all(c)) if is_tensor else c:
        out = tuple(body_fn(*loop_vars))
        for i, (v, o) in enumerate(zip(loop_vars, out)):
            if not dyn[i] and o is not v and not _is_dynamic(o):
                raise TypeError(
                    f"while body rebinds loop variable #{i} of type "
                    f"{type(v).__name__}, which cannot be carried through "
                    "a traced lax.while_loop; hoist it out of the loop or "
                    "make it a tensor")
        loop_vars = out
        is_tensor, c = _truthiness(cond_fn(*loop_vars))
    return tuple(_number_tensor(v, device) if d else v
                 for v, d in zip(loop_vars, dyn))


def convert_logical_and(x_fn, y_fn):
    """Python `and` semantics preserved exactly for non-tensor operands
    (returns the OPERAND, short-circuits); tensor operands combine via
    logical_and over all elements."""
    x = x_fn()
    x_is_tensor, xv = _truthiness(x)
    if not x_is_tensor:
        return y_fn() if x else x      # exact python `and`
    if not _traced(xv) and not _all(xv):
        return x                       # short-circuit, operand out
    y = y_fn()
    y_is_tensor, yv = _truthiness(y)
    if not y_is_tensor:
        return y
    if _traced(xv) or _traced(yv):
        return _logical(torch.logical_and, xv, yv)
    return y if _all(xv) else x


def convert_logical_or(x_fn, y_fn):
    x = x_fn()
    x_is_tensor, xv = _truthiness(x)
    if not x_is_tensor:
        return x if x else y_fn()
    if not _traced(xv) and _all(xv):
        return x
    y = y_fn()
    y_is_tensor, yv = _truthiness(y)
    if not y_is_tensor:
        return y
    if _traced(xv) or _traced(yv):
        return _logical(torch.logical_or, xv, yv)
    return x if _all(xv) else y


def _logical(op, xv, yv):
    """``op`` of the two operands' ``all()``, on the torch one's device."""
    device = (xv if isinstance(xv, torch.Tensor) else yv).device
    return op(_as_tensor(_all(xv), device), _as_tensor(_all(yv), device))


def convert_logical_not(x):
    is_tensor, v = _truthiness(x)
    if not is_tensor:
        return not v
    if _traced(v):
        return torch.logical_not(_all(v))
    return not _all(v)


_RUNTIME = {
    "_pt_ifelse": convert_ifelse,
    "_pt_while": convert_while,
    "_pt_and": convert_logical_and,
    "_pt_or": convert_logical_or,
    "_pt_not": convert_logical_not,
    "_pt_undefined": UNDEFINED,
}


# ------------------------------------------------------------ AST analysis
class _AssignedNames(ast.NodeVisitor):
    def __init__(self):
        self.names = set()

    def visit_Name(self, node):
        if isinstance(node.ctx, (ast.Store, ast.Del)):
            self.names.add(node.id)

    def visit_FunctionDef(self, node):
        self.names.add(node.name)   # don't descend

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Lambda(self, node):
        pass


class _LoadedNames(ast.NodeVisitor):
    def __init__(self):
        self.names = set()

    def visit_Name(self, node):
        if isinstance(node.ctx, ast.Load):
            self.names.add(node.id)


def _assigned(stmts):
    v = _AssignedNames()
    for s in stmts:
        v.visit(s)
    return v.names


def _loaded(nodes):
    v = _LoadedNames()
    for n in nodes:
        v.visit(n)
    return v.names


def _has_flow_escape(stmts):
    """return/break/continue anywhere in the block (not inside nested
    function defs) — those blocks are left un-rewritten."""
    class F(ast.NodeVisitor):
        found = False

        def visit_Return(self, node):
            self.found = True

        def visit_Break(self, node):
            self.found = True

        def visit_Continue(self, node):
            self.found = True

        def visit_FunctionDef(self, node):
            pass

        visit_AsyncFunctionDef = visit_FunctionDef
        visit_Lambda = visit_FunctionDef

    f = F()
    for s in stmts:
        f.visit(s)
    return f.found


class _Transformer(ast.NodeTransformer):
    """Rewrites if/while/bool-ops into runtime-dispatch calls."""

    def __init__(self):
        self._ctr = 0

    def _name(self, base):
        self._ctr += 1
        return f"__pt_{base}_{self._ctr}"

    @staticmethod
    def _make_seeds(names):
        """Pre-seed possibly-unbound names with the sentinel so the
        generated block fns can always take/return them."""
        return [ast.Assign(
            targets=[ast.Name(id=n, ctx=ast.Store())],
            value=ast.IfExp(
                test=ast.Compare(
                    left=ast.Constant(value=n),
                    ops=[ast.In()],
                    comparators=[ast.Call(
                        func=ast.Name(id="locals", ctx=ast.Load()),
                        args=[], keywords=[])]),
                body=ast.Name(id=n, ctx=ast.Load()),
                orelse=ast.Name(id="_pt_undefined", ctx=ast.Load())))
            for n in names]

    # -- logical ops ---------------------------------------------------
    def visit_BoolOp(self, node):
        self.generic_visit(node)
        fn = "_pt_and" if isinstance(node.op, ast.And) else "_pt_or"
        out = node.values[-1]
        for val in reversed(node.values[:-1]):
            out = ast.Call(
                func=ast.Name(id=fn, ctx=ast.Load()),
                args=[ast.Lambda(
                          args=ast.arguments(posonlyargs=[], args=[],
                                             kwonlyargs=[],
                                             kw_defaults=[], defaults=[]),
                          body=val),
                      ast.Lambda(
                          args=ast.arguments(posonlyargs=[], args=[],
                                             kwonlyargs=[],
                                             kw_defaults=[], defaults=[]),
                          body=out)],
                keywords=[])
        return ast.copy_location(out, node)

    def visit_UnaryOp(self, node):
        self.generic_visit(node)
        if isinstance(node.op, ast.Not):
            return ast.copy_location(
                ast.Call(func=ast.Name(id="_pt_not", ctx=ast.Load()),
                         args=[node.operand], keywords=[]), node)
        return node

    # -- if ------------------------------------------------------------
    def visit_If(self, node):
        self.generic_visit(node)
        if _has_flow_escape(node.body) or _has_flow_escape(node.orelse):
            return node
        outs = sorted(_assigned(node.body) | _assigned(node.orelse))
        outs = [n for n in outs if not n.startswith("__pt_")]
        if not outs:
            return node
        tname, fname = self._name("true"), self._name("false")
        ret = ast.Return(value=ast.Tuple(
            elts=[ast.Name(id=n, ctx=ast.Load()) for n in outs],
            ctx=ast.Load()))
        # branch fns take the assigned names as PARAMETERS so
        # read-modify-write (y = y + 1) sees the outer value instead of
        # an UnboundLocalError (the reference passes them the same way)
        branch_args = ast.arguments(
            posonlyargs=[], args=[ast.arg(arg=n) for n in outs],
            kwonlyargs=[], kw_defaults=[], defaults=[])
        t_def = ast.FunctionDef(
            name=tname, args=branch_args,
            body=list(node.body) + [ret], decorator_list=[])
        f_def = ast.FunctionDef(
            name=fname, args=branch_args,
            body=(list(node.orelse) or [ast.Pass()]) + [ret],
            decorator_list=[])
        seeds = self._make_seeds(outs)
        call = ast.Assign(
            targets=[ast.Tuple(
                elts=[ast.Name(id=n, ctx=ast.Store()) for n in outs],
                ctx=ast.Store())],
            value=ast.Call(
                func=ast.Name(id="_pt_ifelse", ctx=ast.Load()),
                args=[node.test,
                      ast.Name(id=tname, ctx=ast.Load()),
                      ast.Name(id=fname, ctx=ast.Load()),
                      ast.Tuple(elts=[ast.Name(id=n, ctx=ast.Load())
                                      for n in outs],
                                ctx=ast.Load())],
                keywords=[]))
        block = seeds + [t_def, f_def, call]
        for st in block:
            ast.copy_location(st, node)
            ast.fix_missing_locations(st)
        return block

    # -- while ---------------------------------------------------------
    def visit_While(self, node):
        self.generic_visit(node)
        if _has_flow_escape(node.body) or node.orelse:
            return node
        # EVERY name the body assigns is loop-carried (a write-only
        # accumulator still must propagate out), plus everything the
        # test reads
        carried = sorted(_assigned(node.body) | _loaded([node.test])
                         - {"locals"})
        carried = [n for n in carried if not n.startswith("__pt_")
                   and n not in _RUNTIME]
        if not carried:
            return node
        cname, bname = self._name("cond"), self._name("body")
        args = ast.arguments(
            posonlyargs=[],
            args=[ast.arg(arg=n) for n in carried],
            kwonlyargs=[], kw_defaults=[], defaults=[])
        c_def = ast.FunctionDef(
            name=cname, args=args,
            body=[ast.Return(value=node.test)], decorator_list=[])
        ret = ast.Return(value=ast.Tuple(
            elts=[ast.Name(id=n, ctx=ast.Load()) for n in carried],
            ctx=ast.Load()))
        b_def = ast.FunctionDef(
            name=bname, args=args,
            body=list(node.body) + [ret], decorator_list=[])
        call = ast.Assign(
            targets=[ast.Tuple(
                elts=[ast.Name(id=n, ctx=ast.Store()) for n in carried],
                ctx=ast.Store())],
            value=ast.Call(
                func=ast.Name(id="_pt_while", ctx=ast.Load()),
                args=[ast.Name(id=cname, ctx=ast.Load()),
                      ast.Name(id=bname, ctx=ast.Load()),
                      ast.Tuple(elts=[ast.Name(id=n, ctx=ast.Load())
                                      for n in carried],
                                ctx=ast.Load())],
                keywords=[]))
        block = self._make_seeds(carried) + [c_def, b_def, call]
        for st in block:
            ast.copy_location(st, node)
            ast.fix_missing_locations(st)
        return block


def ast_transform(fn: Callable) -> Callable:
    """Rewrite ``fn``'s control flow for trace-safety and return the new
    function (the ProgramTranslator.get_func analogue)."""
    try:
        src = textwrap.dedent(inspect.getsource(fn))
    except (OSError, TypeError):
        return fn                      # builtins/lambdas: no source
    tree = ast.parse(src)
    fdef = tree.body[0]
    # drop decorators so exec doesn't re-apply to_static recursively
    fdef.decorator_list = []
    new_tree = _Transformer().visit(tree)
    ast.fix_missing_locations(new_tree)
    code = compile(new_tree, filename=f"<dy2static {fn.__name__}>",
                   mode="exec")
    glb = dict(fn.__globals__)
    glb.update(_RUNTIME)
    closure = inspect.getclosurevars(fn)
    glb.update(closure.nonlocals)
    loc = {}
    exec(code, glb, loc)
    new_fn = loc[fdef.name]
    new_fn.__wrapped_original__ = fn
    if inspect.ismethod(fn):
        new_fn = new_fn.__get__(fn.__self__)
    return new_fn
