"""Fused recurrent layers ``RNN``, ``LSTM`` and ``GRU``, as the JAX
package's ``gluon/rnn/rnn_layer.py``.

Layout ``TNC`` or ``NTC``, ``num_layers``, ``bidirectional``, explicit
``states`` (then the call returns ``(outputs, states)``), ``begin_state``
and a deferred ``input_size``, with the reference's parameter names
(``l0_i2h_weight``, ``r0_h2h_bias``, ...).  Each layer, both directions
at once, is one call of the fused recurrence (``ops/rnn.py``: cuDNN on
the card, ATen on the CPU); dropout between layers is the port's own
``Dropout``, drawn from the device's ``mx.random`` stream in training
mode, as the reference applies it.  Under ``hybridize()`` a call without
explicit states is one replay of the block's CachedOp.
"""
from __future__ import annotations

import torch

from ... import ndarray as nd
from ...ops import nn as ops
from ...ops.rnn import recurrent_layer
from ..block import HybridBlock

__all__ = ["RNN", "LSTM", "GRU"]

_WEIGHTS = ("i2h_weight", "h2h_weight", "i2h_bias", "h2h_bias")


class _RNNLayer(HybridBlock):
    def __init__(self, hidden_size, num_layers, layout, dropout,
                 bidirectional, input_size, gates, mode, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        if layout not in ("TNC", "NTC"):
            raise ValueError(f"Invalid layout {layout}; must be TNC or NTC")
        self._hidden_size = hidden_size
        self._num_layers = num_layers
        self._layout = layout
        self._dropout = dropout
        self._dir = 2 if bidirectional else 1
        self._input_size = input_size
        self._gates = gates
        self._mode = mode
        ng, ni, nh = gates, input_size, hidden_size
        with self.name_scope():
            for i in range(num_layers):
                for j in self._directions():
                    self.params.get(f"{j}{i}_i2h_weight", shape=(ng * nh, ni),
                                    allow_deferred_init=True)
                    self.params.get(f"{j}{i}_h2h_weight", shape=(ng * nh, nh),
                                    allow_deferred_init=True)
                    self.params.get(f"{j}{i}_i2h_bias", shape=(ng * nh,),
                                    allow_deferred_init=True)
                    self.params.get(f"{j}{i}_h2h_bias", shape=(ng * nh,),
                                    allow_deferred_init=True)
                ni = nh * self._dir

    def _directions(self):
        return ("l", "r")[:self._dir]

    def state_info(self, batch_size=0):
        shape = (self._num_layers * self._dir, batch_size,
                 self._hidden_size)
        n = 2 if self._mode == "lstm" else 1
        return [{"shape": shape, "__layout__": "LNC"} for _ in range(n)]

    def begin_state(self, batch_size=0, func=None, **kwargs):
        """The initial states: ``func(shape, **kwargs)`` (default
        ``nd.zeros``) for each entry of ``state_info``."""
        if func is None:
            func = nd.zeros
        states = []
        for info in self.state_info(batch_size):
            info = dict(info)
            shape = info.pop("shape")
            info.pop("__layout__", None)
            states.append(func(shape, **dict(info, **kwargs)))
        return states

    def infer_shape(self, inputs, *args):
        ni = inputs.shape[2]
        nh = self._gates * self._hidden_size
        for i in range(self._num_layers):
            for j in self._directions():
                self._gluon_param(f"{j}{i}_i2h_weight").shape = (nh, ni)
            ni = self._hidden_size * self._dir

    def __call__(self, inputs, states=None):
        return super().__call__(inputs, states)

    def forward(self, inputs, states=None):
        explicit_states = states is not None
        x = inputs if self._layout == "TNC" else inputs.transpose(0, 1)
        if states is None:
            states = [torch.zeros(info["shape"], dtype=x.dtype,
                                  device=x.device)
                      for info in self.state_info(x.shape[1])]
        elif isinstance(states, torch.Tensor):
            states = [states]
        finals = [[] for _ in states]
        for i in range(self._num_layers):
            lo, hi = i * self._dir, (i + 1) * self._dir
            weights = [getattr(self, f"{j}{i}_{w}")
                       for j in self._directions() for w in _WEIGHTS]
            x, fin = recurrent_layer(self._mode, x,
                                     [s[lo:hi] for s in states], weights,
                                     bidirectional=self._dir == 2)
            for k, f in enumerate(fin):
                finals[k].append(f)
            if self._dropout and i < self._num_layers - 1:
                x = ops.dropout(x, p=self._dropout,
                                training=self._training_mode())
        outputs = x if self._layout == "TNC" else x.transpose(0, 1)
        if explicit_states:
            return outputs, [torch.cat(f, dim=0) for f in finals]
        return outputs


class RNN(_RNNLayer):
    """Multi-layer Elman RNN, ``activation`` relu (default) or tanh;
    one state, ``h``."""

    def __init__(self, hidden_size, num_layers=1, activation="relu",
                 layout="TNC", dropout=0, bidirectional=False,
                 input_size=0, **kwargs):
        if activation not in ("relu", "tanh"):
            raise ValueError(f"RNN activation must be relu or tanh, got "
                             f"{activation!r}")
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, 1, f"rnn_{activation}",
                         **kwargs)


class LSTM(_RNNLayer):
    """Multi-layer LSTM; states ``[h, c]``."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0, **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, 4, "lstm", **kwargs)


class GRU(_RNNLayer):
    """Multi-layer GRU, gate order [r, z, n]; one state, ``h``."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0, **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, 3, "gru", **kwargs)
