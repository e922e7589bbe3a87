"""Static-graph control flow builders: while_loop / While / cond /
case / switch_case / StaticRNN / DynamicRNN.

Port of ``paddle_tpu/static/control_flow.py``, copied (it is pure Python
over the Program IR, which both packages share): the reference's
control-flow layer builders (ref:
python/paddle/fluid/layers/control_flow.py: While :971, while_loop
:1110, cond :2298, case :2528, switch_case :2603; layers/rnn.py
StaticRNN :449). Each builder traces the user's python functions into
sub-blocks of the Program and appends ONE control-flow OpDesc, the same
in both packages, whose kernel (``ops/control_flow_ops.py``) interprets
the sub-blocks.

Differentiability: ``StaticRNN``, ``cond``, ``switch_case`` and a
``while_loop`` with ``max_trip_count`` differentiate in both packages;
an unbounded ``while_loop`` only in the port. ``DynamicRNN`` takes a
ragged input (a LoD feed, which the executor pads beside its
``@seq_len`` companion) through a ``sequence_mask`` of the companion
that freezes each finished row's state, as the reference does.
"""
from __future__ import annotations

import contextlib
from typing import Callable, List, Optional, Sequence

from ..core.enforce import InvalidArgumentError, enforce
from ..core.program import Block, Program, default_main_program


def _front():
    # late import: static/__init__ imports this module
    from . import Variable, _current_block, _op
    return Variable, _current_block, _op


@contextlib.contextmanager
def _block_guard(program: Program, block: Block):
    prev = getattr(program, "_current_block_idx", 0)
    program._current_block_idx = block.idx
    try:
        yield block
    finally:
        program._current_block_idx = prev


def _external_reads(block: Block, local_names, returned=()) -> List[str]:
    """Names a sub-block reads from outside itself: read before any
    write inside the block and not provided as carry/step locals.
    ``returned`` are names the block hands back without necessarily
    reading them in any op (a branch returning an outer var verbatim) —
    they count as reads occurring after every write."""
    local = set(local_names)
    written = set()
    external: List[str] = []
    seen = set()
    for op in block.ops:
        # nested control-flow ops already list their outer reads in
        # their own input slots, so one flat pass suffices
        for n in op.input_names():
            if n and n not in written and n not in local and n not in seen:
                external.append(n)
                seen.add(n)
        for n in op.output_names():
            if n:
                written.add(n)
    for n in returned:
        if n and n not in written and n not in local and n not in seen:
            external.append(n)
            seen.add(n)
    return external


def _clone_out(parent: Block, src_var, prefix: str):
    Variable, _, _ = _front()
    name = parent.program.unique_name(prefix)
    return Variable(parent, name, shape=src_var.shape, dtype=src_var.dtype)


def while_loop(cond: Callable, body: Callable, loop_vars: Sequence,
               is_test: bool = False, name: Optional[str] = None,
               max_trip_count: Optional[int] = None) -> List:
    """Functional while (ref: control_flow.py:1110). ``cond`` and
    ``body`` are traced once into sub-blocks; returns new Variables
    holding the final loop-var values."""
    Variable, _current_block, _ = _front()
    enforce(len(loop_vars) > 0, "while_loop needs at least one loop var",
            InvalidArgumentError)
    parent = _current_block()
    program = parent.program

    cond_blk = program.append_block(parent)
    with _block_guard(program, cond_blk):
        c = cond(*loop_vars)
    enforce(isinstance(c, Variable),
            "while_loop cond must return a Variable", InvalidArgumentError)

    body_blk = program.append_block(parent)
    with _block_guard(program, body_blk):
        outs = body(*loop_vars)
    if isinstance(outs, Variable):
        outs = [outs]
    outs = list(outs)
    enforce(len(outs) == len(loop_vars),
            f"body returned {len(outs)} vars, expected {len(loop_vars)}",
            InvalidArgumentError)

    carry_names = [v.name for v in loop_vars]
    captured = sorted(
        set(_external_reads(cond_blk, carry_names, returned=[c.name]))
        | set(_external_reads(body_blk, carry_names,
                              returned=[v.name for v in outs])))
    results = [_clone_out(parent, v.desc, "while_out") for v in loop_vars]
    parent.append_op(
        "while_loop",
        inputs={"X": carry_names, "Captured": captured},
        outputs={"Out": [r.name for r in results]},
        attrs={"cond_block": cond_blk.idx, "body_block": body_blk.idx,
               "carry_names": carry_names,
               "body_out_names": [v.name for v in outs],
               "cond_out_name": c.name, "captured_names": captured,
               "max_trip_count": max_trip_count, "is_test": is_test})
    return results


class While:
    """Block-form while (ref: control_flow.py:971). The body mutates
    parent vars in place (fluid style)::

        i = fill_constant([1], 'int64', 0)
        cond = less_than(i, n)
        w = While(cond)
        with w.block():
            ...                     # ops writing parent vars
            increment(i, in_place=True)
            less_than(i, n, out=cond)
    """

    def __init__(self, cond, is_test: bool = False,
                 name: Optional[str] = None,
                 max_trip_count: Optional[int] = None):
        Variable, _current_block, _ = _front()
        enforce(isinstance(cond, Variable),
                "While(cond=...) takes a Variable", InvalidArgumentError)
        self._cond = cond
        self._max_trip = max_trip_count
        self._parent = _current_block()
        self._program = self._parent.program
        self._blk = self._program.append_block(self._parent)

    @contextlib.contextmanager
    def block(self):
        with _block_guard(self._program, self._blk):
            yield
        self._finalize()

    def _finalize(self):
        parent, blk = self._parent, self._blk
        # carried = parent vars the body overwrites (incl. the cond var)
        written = []
        seen = set()
        for op in blk.ops:
            for n in op.output_names():
                if n and n not in seen and n not in blk.vars \
                        and parent.find_var_recursive(n) is not None:
                    written.append(n)
                    seen.add(n)
        carry = [self._cond.name] + [n for n in written
                                     if n != self._cond.name]
        captured = _external_reads(blk, carry)
        # empty cond block: the condition is simply the carried cond var
        cond_blk = self._program.append_block(parent)
        parent.append_op(
            "while_loop",
            inputs={"X": list(carry), "Captured": captured},
            outputs={"Out": list(carry)},
            attrs={"cond_block": cond_blk.idx, "body_block": blk.idx,
                   "carry_names": list(carry), "body_out_names": list(carry),
                   "cond_out_name": self._cond.name,
                   "captured_names": captured,
                   "max_trip_count": self._max_trip})


def cond(pred, true_fn: Callable, false_fn: Callable,
         name: Optional[str] = None) -> object:
    """Two-branch conditional (ref: control_flow.py:2298). The branches
    must return matching structures; the predicate picks the one that
    runs."""
    Variable, _current_block, _ = _front()
    parent = _current_block()
    program = parent.program

    def trace(fn):
        blk = program.append_block(parent)
        with _block_guard(program, blk):
            out = fn()
        single = isinstance(out, Variable)
        outs = [out] if single else list(out)
        return blk, outs, single

    t_blk, t_outs, t_single = trace(true_fn)
    f_blk, f_outs, f_single = trace(false_fn)
    enforce(len(t_outs) == len(f_outs) and t_single == f_single,
            "cond branches must return the same structure",
            InvalidArgumentError)

    t_names = [v.name for v in t_outs]
    f_names = [v.name for v in f_outs]
    # pred stays in captured if a branch reads (or returns) it — the
    # kernel's env is built solely from Captured, so no subtraction
    captured = sorted(set(_external_reads(t_blk, (), returned=t_names))
                      | set(_external_reads(f_blk, (), returned=f_names)))
    results = [_clone_out(parent, v.desc, "cond_out") for v in t_outs]
    parent.append_op(
        "conditional_block",
        inputs={"Cond": [pred.name], "Captured": captured},
        outputs={"Out": [r.name for r in results]},
        attrs={"true_block": t_blk.idx, "false_block": f_blk.idx,
               "true_out_names": [v.name for v in t_outs],
               "false_out_names": [v.name for v in f_outs],
               "captured_names": captured})
    return results[0] if t_single else results


def case(pred_fn_pairs, default: Optional[Callable] = None,
         name: Optional[str] = None):
    """First-match-wins chain of (pred, fn) pairs (ref:
    control_flow.py:2528): nested conds. With ``default=None`` the
    last pair's fn is the default (fluid semantics: it runs when no
    pred matches)."""
    enforce(len(pred_fn_pairs) > 0, "case needs at least one pair",
            InvalidArgumentError)
    pairs = list(pred_fn_pairs)
    if default is None:
        default = pairs[-1][1]
        pairs = pairs[:-1]
        if not pairs:        # single pair, no default: fn runs either way
            return default()

    def chain(pairs):
        (pred, fn), rest = pairs[0], pairs[1:]
        if not rest:
            return cond(pred, fn, default)
        return cond(pred, fn, lambda: chain(rest))

    return chain(pairs)


def switch_case(branch_index, branch_fns, default: Optional[Callable] = None,
                name: Optional[str] = None):
    """Indexed dispatch (ref: control_flow.py:2603): one switch op.
    ``branch_fns`` is a list of fns or (index, fn) pairs; indices must
    then be dense 0..N-1. The default arm (last) runs for out-of-range
    indices."""
    Variable, _current_block, _ = _front()
    parent = _current_block()
    program = parent.program

    if isinstance(branch_fns, dict):
        items = sorted(branch_fns.items())
    elif branch_fns and isinstance(branch_fns[0], (tuple, list)):
        items = sorted((i, f) for i, f in branch_fns)
    else:
        items = list(enumerate(branch_fns))
    enforce([i for i, _ in items] == list(range(len(items))),
            "switch_case branch indices must be dense 0..N-1",
            InvalidArgumentError)
    fns = [f for _, f in items]
    if default is not None:
        fns.append(default)
    else:
        fns.append(fns[-1])

    blks, outs_per = [], []
    single = None
    for fn in fns:
        blk = program.append_block(parent)
        with _block_guard(program, blk):
            out = fn()
        s = isinstance(out, Variable)
        enforce(single is None or single == s,
                "switch_case branches must return the same structure",
                InvalidArgumentError)
        single = s
        outs = [out] if s else list(out)
        blks.append(blk)
        outs_per.append([v.name for v in outs])

    captured = sorted(set().union(
        *[set(_external_reads(b, (), returned=o))
          for b, o in zip(blks, outs_per)]))
    first_outs = outs_per[0]
    ref_blk = blks[0]
    results = []
    for n in first_outs:
        d = ref_blk.find_var_recursive(n)
        results.append(_clone_out(parent, d, "switch_out"))
    parent.append_op(
        "switch",
        inputs={"BranchIndex": [branch_index.name], "Captured": captured},
        outputs={"Out": [r.name for r in results]},
        attrs={"blocks": [b.idx for b in blks], "out_names": outs_per,
               "captured_names": captured})
    return results[0] if single else results


class StaticRNN:
    """Scan-form RNN over a step block (ref: layers/rnn.py StaticRNN
    :449). Sequence inputs are time-major [T, ...]::

        rnn = StaticRNN()
        with rnn.step():
            x_t = rnn.step_input(x)          # [T, B, D] -> [B, D]
            h_prev = rnn.memory(init=h0)
            h = nn.fc(concat([x_t, h_prev]), size)
            rnn.update_memory(h_prev, h)
            rnn.step_output(h)
        hs = rnn()                            # [T, B, size]
    """

    def __init__(self, name: Optional[str] = None):
        Variable, _current_block, _ = _front()
        self._parent = _current_block()
        self._program = self._parent.program
        self._blk = self._program.append_block(self._parent)
        self._seqs: List[tuple] = []     # (outer, step) names
        self._mems: List[tuple] = []     # (step mem, init) names
        self._updates = {}               # mem step name -> new name
        self._step_outs: List[str] = []
        self.outputs: List = []
        self._length = None

    @contextlib.contextmanager
    def step(self):
        with _block_guard(self._program, self._blk):
            yield
        self._finalize()

    def step_input(self, x):
        Variable, _, _ = _front()
        enforce(x.shape is not None and len(x.shape) >= 1,
                "step_input needs a known time-major shape",
                InvalidArgumentError)
        if self._length is None and x.shape[0] not in (None, -1):
            self._length = int(x.shape[0])
        step = Variable(self._blk, self._program.unique_name("rnn_in"),
                        shape=x.shape[1:], dtype=x.dtype)
        self._seqs.append((x.name, step.name))
        return step

    def memory(self, init=None, shape=None, dtype="float32",
               init_value: float = 0.0, batch_ref=None):
        Variable, _, _ = _front()
        if init is None:
            from . import fill_constant
            enforce(shape is not None,
                    "StaticRNN.memory needs init or shape",
                    InvalidArgumentError)
            with _block_guard(self._program, self._parent):
                init = fill_constant(shape=list(shape), dtype=dtype,
                                     value=init_value)
        mem = Variable(self._blk, self._program.unique_name("rnn_mem"),
                       shape=init.shape, dtype=init.dtype)
        self._mems.append((mem.name, init.name))
        return mem

    def update_memory(self, mem, new):
        self._updates[mem.name] = new.name

    def step_output(self, o):
        self._step_outs.append(o.name)

    def output(self, *outputs):
        for o in outputs:
            self.step_output(o)

    def _finalize(self):
        Variable, _, _ = _front()
        enforce(self._step_outs, "StaticRNN needs at least one step_output",
                InvalidArgumentError)
        mem_names = [m for m, _ in self._mems]
        for m in mem_names:
            enforce(m in self._updates,
                    f"StaticRNN memory {m!r} has no update_memory",
                    InvalidArgumentError)
        locals_ = [s for _, s in self._seqs] + mem_names
        captured = _external_reads(
            self._blk, locals_,
            returned=list(self._step_outs)
            + [self._updates[m] for m in mem_names])
        t = self._length
        outs = []
        for n in self._step_outs:
            d = self._blk.find_var_recursive(n)
            shape = ((t if t else -1),) + tuple(d.shape or ())
            name = self._program.unique_name("rnn_out")
            outs.append(Variable(self._parent, name, shape=shape,
                                 dtype=d.dtype))
        finals = []
        for m in mem_names:
            d = self._blk.find_var_recursive(m)
            finals.append(Variable(self._parent,
                                   self._program.unique_name("rnn_final"),
                                   shape=d.shape, dtype=d.dtype))
        self._parent.append_op(
            "static_rnn",
            inputs={"Sequences": [o for o, _ in self._seqs],
                    "Inits": [i for _, i in self._mems],
                    "Captured": captured},
            outputs={"Out": [o.name for o in outs],
                     "FinalStates": [f.name for f in finals]},
            attrs={"sub_block": self._blk.idx,
                   "seq_step_names": [s for _, s in self._seqs],
                   "mem_names": mem_names,
                   "mem_update_names": [self._updates[m]
                                        for m in mem_names],
                   "step_out_names": list(self._step_outs),
                   "captured_names": captured, "length": self._length})
        self.outputs = outs
        self.final_states = finals

    def __call__(self):
        if len(self.outputs) == 1:
            return self.outputs[0]
        return self.outputs


class DynamicRNN:
    """LoD-driven RNN over ragged batches (ref: layers/control_flow.py
    DynamicRNN :1528). Design departure for the dense-padding
    convention: where the reference sorts sequences and SHRINKS the
    batch as shorter ones finish, here the step block runs over the
    full padded [B, T, ...] (time-major scan via static_rnn) and
    ``update_memory`` FREEZES states of finished rows with the
    sequence_mask of the input's @seq_len companion — numerically the
    same recurrences on every valid step. ::

        rnn = DynamicRNN()
        with rnn.block():
            w = rnn.step_input(trg_emb)        # [B, T, D] -> [B, D]
            prev = rnn.memory(init=context)
            cur = nn.fc([w, prev], size, act='tanh')
            rnn.update_memory(prev, cur)
            rnn.output(score_of(cur))
        out = rnn()                             # [B, T, V] + companion
    """

    def __init__(self, name: Optional[str] = None):
        self._srnn = StaticRNN(name)
        self._parent = self._srnn._parent
        self._program = self._srnn._program
        self._mask_step = None
        self._comp = None
        self._outputs = None

    @contextlib.contextmanager
    def block(self):
        with self._srnn.step():
            yield
        # batch-major outputs with the ragged association restored
        Variable, _, _ = _front()
        from . import nn
        outs = []
        for o in self._srnn.outputs:
            nd = len(o.shape or ())
            perm = [1, 0] + list(range(2, nd))
            with _block_guard(self._program, self._parent):
                bm = nn.transpose(o, axis=perm)
            if self._comp:
                bm.lod_companion = self._comp
            outs.append(bm)
        self._outputs = outs

    def step_input(self, x, level=0):
        Variable, _, _ = _front()
        from . import nn
        comp = getattr(x, "lod_companion", None)
        nd = len(x.shape or ())
        enforce(nd >= 2, "DynamicRNN.step_input needs [B, T, ...] input",
                InvalidArgumentError)
        if not self._srnn._seqs:
            self._x_outer = x.name            # batch-shape reference
        perm = [1, 0] + list(range(2, nd))
        with _block_guard(self._program, self._parent):
            xt = nn.transpose(x, axis=perm)          # time-major
            if comp and self._mask_step is None:
                self._comp = comp
                ln = Variable(self._parent, comp)
                # maxlen = xt's leading (time) dim, jit-static
                m = Variable(self._parent,
                             self._program.unique_name("drnn_mask"),
                             shape=[-1, -1], dtype="int64")
                self._parent.append_op(
                    "sequence_mask",
                    inputs={"X": [ln.name], "MaxLenTensor": [xt.name]},
                    outputs={"Y": [m.name]},
                    attrs={"maxlen": -1, "out_dtype": "int64"})
                mf = nn.cast(m, out_dtype="float32")
                mt = nn.transpose(mf, axis=[1, 0])   # [T, B]
                m3 = nn.unsqueeze(mt, axes=[2])      # [T, B, 1]
                self._mask_vec = m3
        step = self._srnn.step_input(xt)
        if comp and self._mask_step is None:
            self._mask_step = self._srnn.step_input(self._mask_vec)
        return step

    def static_input(self, x):
        """Non-stepped input visible in the block (captured)."""
        return x

    def memory(self, init=None, shape=None, value=0.0, dtype="float32",
               need_reorder=False):
        if init is None:
            # the reference creates a [batch, *shape] tensor filled with
            # ``value``; the batch extent comes from the first
            # step_input at runtime: zeros[B,1] @ ones[1,prod(shape)]
            enforce(self._srnn._seqs, "DynamicRNN.memory(shape=...) "
                    "needs a prior step_input to size the batch",
                    InvalidArgumentError)
            enforce(shape, "DynamicRNN.memory needs init or shape",
                    InvalidArgumentError)
            from . import fill_constant, nn
            shape = [int(d) for d in shape]
            total = 1
            for d in shape:
                total *= d
            with _block_guard(self._program, self._parent):
                Variable, _, _ = _front()
                x = Variable(self._parent, self._x_outer)
                nd = len(x.shape or ())
                red = nn.reduce_sum(x, dim=list(range(1, nd)))   # [B]
                zb = nn.cast(nn.scale(red, scale=0.0),
                             out_dtype=dtype)
                z2 = nn.unsqueeze(zb, axes=[1])                  # [B,1]
                row = fill_constant([1, total], dtype, 0.0)
                init = nn.scale(nn.matmul(z2, row), bias=float(value))
                if len(shape) > 1:
                    init = nn.reshape(init, shape=[-1] + shape)
            return self._srnn.memory(init=init)
        return self._srnn.memory(init=init)

    def update_memory(self, mem, new):
        if self._mask_step is not None:
            from . import nn
            # finished rows keep their state: m*new + (1-m)*mem
            keep = nn.elementwise_mul(self._mask_step, new)
            inv = nn.scale(self._mask_step, scale=-1.0, bias=1.0)
            hold = nn.elementwise_mul(inv, mem)
            new = nn.elementwise_add(keep, hold)
        self._srnn.update_memory(mem, new)

    def output(self, *outputs):
        for o in outputs:
            self._srnn.step_output(o)

    def __call__(self):
        enforce(self._outputs is not None,
                "DynamicRNN: call after the block() context closes",
                InvalidArgumentError)
        if len(self._outputs) == 1:
            return self._outputs[0]
        return self._outputs
