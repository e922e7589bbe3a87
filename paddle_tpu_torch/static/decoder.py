"""fluid.contrib.decoder: InitState / StateCell / TrainingDecoder /
BeamSearchDecoder (ref: python/paddle/fluid/contrib/decoder/
beam_search_decoder.py:43,159,384,525).

Port of ``paddle_tpu/static/decoder.py``, builder for builder: the
training decoder drives the port's DynamicRNN (``control_flow.py``:
padded [B, T, ...] scan with frozen finished rows, or ragged LoD feeds);
the beam-search decoder builds the same While + array + beam_search
program as the book machine-translation decode, with the StateCell
contract layered on top, and the JAX package's builders write the same
program JSON. ``InitState.need_reorder`` is accepted and inert: the
reference reorders the init state to the source batch's LoD rank order
because its LoD beams are rank-sorted; under the dense-padding + eager
true-LoD convention, batch order is preserved end to end.
"""
from __future__ import annotations

import contextlib

from ..core.enforce import InvalidArgumentError, enforce


def _L(name):
    """Resolve a fluid.layers-visible builder from the static surface."""
    from .. import static as st
    fn = getattr(st, name, None)
    if fn is None:
        fn = getattr(st.nn, name, None)
    enforce(fn is not None, f"builder {name} not found",
            InvalidArgumentError)
    return fn


class _DecoderType:
    TRAINING = 1
    BEAM_SEARCH = 2


class InitState:
    """Initial state of a decoding cell (ref:
    beam_search_decoder.py:43)."""

    def __init__(self, init=None, shape=None, value=0.0,
                 init_boot=None, need_reorder=False, dtype="float32"):
        if init is not None:
            self._init = init
        elif init_boot is None:
            raise ValueError("init_boot must be provided to infer the "
                             "init state shape when init is None")
        else:
            fill = _L("fill_constant_batch_size_like")
            self._init = fill(input=init_boot, value=value,
                              shape=[-1] + list(shape or [1]),
                              dtype=dtype)
        self._shape = shape
        self._value = value
        self._need_reorder = need_reorder  # inert: dense batch order
        self._dtype = dtype

    @property
    def value(self):
        return self._init

    @property
    def need_reorder(self):
        return self._need_reorder


class StateCell:
    """Named states + step inputs + an updater (ref:
    beam_search_decoder.py:159). The SAME cell definition drives both
    the TrainingDecoder (states become DynamicRNN memories) and the
    BeamSearchDecoder (states become while-loop arrays)."""

    def __init__(self, inputs, states, out_state, name=None):
        self._cur_states = {}
        self._state_names = []
        for sname, state in states.items():
            enforce(isinstance(state, InitState),
                    "StateCell states must be InitState objects",
                    InvalidArgumentError)
            self._cur_states[sname] = state
            self._state_names.append(sname)
        self._inputs = dict(inputs)
        self._out_state = out_state
        self._state_updater = None
        self._in_decoder = False
        self._decoder = None
        self._memories = {}          # training mode: state -> drnn memory
        enforce(out_state in self._cur_states,
                "out_state must be one of states", InvalidArgumentError)

    # -- decoder lifecycle --
    def _enter_decoder(self, decoder):
        enforce(not self._in_decoder,
                "StateCell has already entered a decoder",
                InvalidArgumentError)
        self._in_decoder = True
        self._decoder = decoder

    def _leave_decoder(self, decoder):
        enforce(self._in_decoder and self._decoder is decoder,
                "inconsistent decoder in StateCell", InvalidArgumentError)
        self._in_decoder = False
        self._decoder = None

    def _init_training_states(self, drnn):
        """Inside the TrainingDecoder block: each InitState becomes a
        DynamicRNN memory."""
        for sname in self._state_names:
            st = self._cur_states[sname]
            if isinstance(st, InitState):
                mem = drnn.memory(init=st.value)
                self._memories[sname] = mem
                self._cur_states[sname] = mem

    # -- user surface --
    def state_updater(self, updater):
        self._state_updater = updater
        return updater

    def get_input(self, input_name):
        enforce(input_name in self._inputs and
                self._inputs[input_name] is not None,
                f"input {input_name!r} has not been set",
                InvalidArgumentError)
        return self._inputs[input_name]

    def get_state(self, state_name):
        enforce(state_name in self._cur_states,
                f"unknown state {state_name!r}", InvalidArgumentError)
        st = self._cur_states[state_name]
        return st.value if isinstance(st, InitState) else st

    def set_state(self, state_name, state_value):
        enforce(state_name in self._cur_states,
                f"unknown state {state_name!r}", InvalidArgumentError)
        self._cur_states[state_name] = state_value

    def compute_state(self, inputs):
        for name, value in inputs.items():
            enforce(name in self._inputs,
                    f"unknown input {name!r}", InvalidArgumentError)
            self._inputs[name] = value
        enforce(self._state_updater is not None,
                "no state_updater registered", InvalidArgumentError)
        self._state_updater(self)

    def update_states(self):
        """Training mode: commit the computed states into the RNN
        memories (the beam decoder commits via its arrays instead)."""
        for sname, mem in self._memories.items():
            new = self._cur_states[sname]
            if new is not mem:
                self._decoder._drnn.update_memory(mem, new)

    def out_state(self):
        return self.get_state(self._out_state)


class TrainingDecoder:
    """Teacher-forced decoding over DynamicRNN (ref:
    beam_search_decoder.py:384)."""

    def __init__(self, state_cell, name=None):
        from .control_flow import DynamicRNN
        self._drnn = DynamicRNN(name)
        self._state_cell = state_cell
        self._state_cell._enter_decoder(self)
        self._type = _DecoderType.TRAINING
        self._in_block = False

    @property
    def type(self):
        return self._type

    @property
    def dynamic_rnn(self):
        return self._drnn

    @property
    def state_cell(self):
        enforce(self._in_block,
                "state_cell must be accessed inside block()",
                InvalidArgumentError)
        return self._state_cell

    @contextlib.contextmanager
    def block(self):
        self._in_block = True
        with self._drnn.block():
            self._state_cell._init_training_states(self._drnn)
            yield
        self._in_block = False
        self._state_cell._leave_decoder(self)

    def step_input(self, x):
        return self._drnn.step_input(x)

    def static_input(self, x):
        return self._drnn.static_input(x)

    def output(self, *outputs):
        self._drnn.output(*outputs)

    def __call__(self):
        return self._drnn()


class BeamSearchDecoder:
    """Beam-search inference decoder (ref:
    beam_search_decoder.py:525). ``decode()`` assembles the standard
    flow — embed previous ids, expand states to the live beams,
    StateCell step, softmax fc over the target dictionary, topk +
    accumulated log-prob, one beam_search op per step — inside a While
    program identical in shape to the book machine-translation decode.
    """

    def __init__(self, state_cell, init_ids, init_scores,
                 target_dict_dim, word_dim, input_var_dict=None,
                 topk_size=50, sparse_emb=True, max_len=100,
                 beam_size=1, end_id=1, name=None):
        self._state_cell = state_cell
        self._init_ids = init_ids
        self._init_scores = init_scores
        self._target_dict_dim = target_dict_dim
        self._word_dim = word_dim
        self._input_var_dict = dict(input_var_dict or {})
        self._topk_size = topk_size
        self._sparse_emb = sparse_emb
        self._max_len = max_len
        self._beam_size = beam_size
        self._end_id = end_id
        self._type = _DecoderType.BEAM_SEARCH
        self._decoded = False
        self._ids_array = None
        self._scores_array = None
        self._state_cell._enter_decoder(self)

    @property
    def type(self):
        return self._type

    @property
    def state_cell(self):
        return self._state_cell

    def decode(self):
        zeros = _L("zeros")
        fill_constant = _L("fill_constant")
        less_than = _L("less_than")
        increment = _L("increment")
        create_array = _L("create_array")
        array_write = _L("array_write")
        array_read = _L("array_read")
        sequence_expand = _L("sequence_expand")
        lod_reset = _L("lod_reset")
        embedding = _L("embedding")
        fc = _L("fc")
        topk = _L("topk")
        log = _L("log")
        reshape = _L("reshape")
        elementwise_add = _L("elementwise_add")
        beam_search = _L("beam_search")
        While = _L("While")

        cell = self._state_cell
        counter = zeros(shape=[1], dtype="int64")
        max_len = fill_constant(shape=[1], dtype="int64",
                                value=self._max_len)
        cond = less_than(x=counter, y=max_len)

        # per-state arrays seeded with the init state / ids / scores
        state_arrays = {}
        for sname in cell._state_names:
            init = cell._cur_states[sname]
            init = init.value if isinstance(init, InitState) else init
            arr = create_array("float32")
            array_write(init, i=counter, array=arr)
            state_arrays[sname] = arr
        input_arrays = {}
        for iname, ivar in self._input_var_dict.items():
            enforce(iname in cell._inputs,
                    f"input_var_dict name {iname!r} not a StateCell "
                    f"input", InvalidArgumentError)
            arr = create_array("float32")
            array_write(ivar, i=counter, array=arr)
            input_arrays[iname] = arr
        ids_array = create_array("int64")
        scores_array = create_array("float32")
        array_write(self._init_ids, i=counter, array=ids_array)
        array_write(self._init_scores, i=counter, array=scores_array)

        w = While(cond=cond)
        with w.block():
            prev_ids = array_read(array=ids_array, i=counter)
            prev_scores = array_read(array=scores_array, i=counter)
            prev_emb = embedding(input=prev_ids,
                                 size=[self._target_dict_dim,
                                       self._word_dim],
                                 dtype="float32",
                                 is_sparse=self._sparse_emb)
            feed = {}
            for iname, arr in input_arrays.items():
                v = array_read(array=arr, i=counter)
                feed[iname] = sequence_expand(v, prev_scores)
            for sname in cell._state_names:
                prev_state = array_read(array=state_arrays[sname],
                                        i=counter)
                cell.set_state(sname,
                               sequence_expand(prev_state, prev_scores))
            for iname in cell._inputs:
                if iname not in feed:
                    feed[iname] = prev_emb
            cell.compute_state(inputs=feed)
            current_state = cell.out_state()
            current_state = lod_reset(x=current_state, y=prev_scores)
            scores = fc(current_state, size=self._target_dict_dim,
                        act="softmax")
            topk_scores, topk_indices = topk(scores, k=self._topk_size)
            accu = elementwise_add(x=log(topk_scores),
                                   y=reshape(prev_scores, shape=[-1]),
                                   axis=0)
            sel_ids, sel_scores = beam_search(
                prev_ids, prev_scores, topk_indices, accu,
                self._beam_size, end_id=self._end_id, level=0)

            increment(x=counter, value=1.0, in_place=True)
            for sname in cell._state_names:
                array_write(cell.get_state(sname), i=counter,
                            array=state_arrays[sname])
            for iname, arr in input_arrays.items():
                array_write(feed[iname], i=counter, array=arr)
            array_write(sel_ids, i=counter, array=ids_array)
            array_write(sel_scores, i=counter, array=scores_array)
            less_than(x=counter, y=max_len, out=cond)

        self._ids_array = ids_array
        self._scores_array = scores_array
        self._decoded = True
        self._state_cell._leave_decoder(self)

    def __call__(self):
        enforce(self._decoded,
                "call decode() before reading the decoder's result",
                InvalidArgumentError)
        beam_search_decode = _L("beam_search_decode")
        return beam_search_decode(ids=self._ids_array,
                                  scores=self._scores_array,
                                  beam_size=self._beam_size,
                                  end_id=self._end_id)
