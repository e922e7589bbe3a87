"""Recurrent layers (paddle.nn.SimpleRNN / LSTM / GRU).

Port of ``paddle_tpu/nn/rnn.py`` (ref: python/paddle/nn/layer/rnn.py).
Each (layer, direction) runs one ``rnn_scan`` op: on the card one call
of torch's cuDNN RNN, on the CPU the plain loop over time. Parameter
names, shapes and initialisation are the reference's
(``weight_ih_l{k}[_reverse]`` [G*H, I], ``weight_hh_l{k}[_reverse]``
[G*H, H], ``bias_ih_l{k}``, ``bias_hh_l{k}``; uniform ±1/sqrt(H)), so
weights carry across by structured name.

I/O contract (batch-major by default, ``time_major=False``)::

    outputs, final_states = rnn(x)            # x: [B, T, I]
    outputs: [B, T, H * num_directions]
    LSTM final_states = (h, c), each [num_layers * num_dirs, B, H]
    GRU / SimpleRNN final_states = h
"""
from __future__ import annotations

from ..dygraph.layers import Layer
from ..dygraph.tracer import trace_op
from . import functional as F
from . import initializer

_GATES = {"LSTM": 4, "GRU": 3, "RNN_TANH": 1, "RNN_RELU": 1}


class _RNNBase(Layer):
    def __init__(self, mode, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 weight_ih_attr=None, weight_hh_attr=None,
                 bias_ih_attr=None, bias_hh_attr=None):
        super().__init__()
        if direction not in ("forward", "bidirect", "bidirectional"):
            raise ValueError(f"unknown direction {direction!r}")
        self.mode = mode
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.bidirectional = direction in ("bidirect", "bidirectional")
        self.num_directions = 2 if self.bidirectional else 1
        self.time_major = time_major
        self.dropout = dropout
        g = _GATES[mode]
        std = 1.0 / (hidden_size ** 0.5)
        init = initializer.Uniform(-std, std)
        self._weights = []
        for layer in range(num_layers):
            for d in range(self.num_directions):
                in_dim = (input_size if layer == 0
                          else hidden_size * self.num_directions)
                sfx = f"l{layer}" + ("_reverse" if d else "")
                w_ih = self.create_parameter((g * hidden_size, in_dim),
                                             attr=weight_ih_attr,
                                             default_initializer=init)
                w_hh = self.create_parameter((g * hidden_size, hidden_size),
                                             attr=weight_hh_attr,
                                             default_initializer=init)
                b_ih = None if bias_ih_attr is False else \
                    self.create_parameter((g * hidden_size,), is_bias=True,
                                          attr=bias_ih_attr,
                                          default_initializer=init)
                b_hh = None if bias_hh_attr is False else \
                    self.create_parameter((g * hidden_size,), is_bias=True,
                                          attr=bias_hh_attr,
                                          default_initializer=init)
                self.add_parameter(f"weight_ih_{sfx}", w_ih)
                self.add_parameter(f"weight_hh_{sfx}", w_hh)
                if b_ih is not None:
                    self.add_parameter(f"bias_ih_{sfx}", b_ih)
                if b_hh is not None:
                    self.add_parameter(f"bias_hh_{sfx}", b_hh)
                self._weights.append((f"weight_ih_{sfx}", f"weight_hh_{sfx}",
                                      b_ih is not None, b_hh is not None,
                                      sfx))

    def _run_single(self, x, widx, reverse, h0, c0):
        ih, hh, has_bih, has_bhh, sfx = self._weights[widx]
        # by name: a parameter replaced after construction (a load, a
        # cast) is the one that runs
        ins = {"X": [x], "WeightIh": [getattr(self, ih)],
               "WeightHh": [getattr(self, hh)]}
        if has_bih:
            ins["BiasIh"] = [getattr(self, f"bias_ih_{sfx}")]
        if has_bhh:
            ins["BiasHh"] = [getattr(self, f"bias_hh_{sfx}")]
        if h0 is not None:
            ins["InitH"] = [h0]
        if c0 is not None:
            ins["InitC"] = [c0]
        return trace_op("rnn_scan", ins,
                        {"mode": self.mode, "is_reverse": reverse},
                        out_slots=["Out", "LastH", "LastC"])

    def forward(self, inputs, initial_states=None):
        x = inputs.transpose(0, 1) if self.time_major else inputs
        if initial_states is not None:
            if self.mode == "LSTM":
                h_all, c_all = initial_states
            else:
                h_all, c_all = initial_states, None
        else:
            h_all = c_all = None
        last_h, last_c = [], []
        for layer in range(self.num_layers):
            outs = []
            for d in range(self.num_directions):
                idx = layer * self.num_directions + d
                o, h, c = self._run_single(
                    x, idx, bool(d),
                    h_all[idx] if h_all is not None else None,
                    c_all[idx] if c_all is not None else None)
                outs.append(o)
                last_h.append(h)
                last_c.append(c)
            x = (outs[0] if len(outs) == 1 else
                 trace_op("concat", {"X": outs}, {"axis": -1},
                          out_slots=["Out"])[0])
            if self.dropout and layer < self.num_layers - 1:
                x = F.dropout(x, self.dropout, training=self.training)
        out = x.transpose(0, 1) if self.time_major else x
        h = trace_op("stack", {"X": last_h}, {"axis": 0},
                     out_slots=["Y"])[0]
        if self.mode == "LSTM":
            c = trace_op("stack", {"X": last_c}, {"axis": 0},
                         out_slots=["Y"])[0]
            return out, (h, c)
        return out, h


class SimpleRNN(_RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 activation="tanh", **kw):
        mode = "RNN_TANH" if activation == "tanh" else "RNN_RELU"
        super().__init__(mode, input_size, hidden_size, num_layers,
                         direction, time_major, dropout, **kw)


class LSTM(_RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0, **kw):
        super().__init__("LSTM", input_size, hidden_size, num_layers,
                         direction, time_major, dropout, **kw)


class GRU(_RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0, **kw):
        super().__init__("GRU", input_size, hidden_size, num_layers,
                         direction, time_major, dropout, **kw)
