"""Recurrent cells, as the JAX package's ``gluon/rnn/rnn_cell.py``.

A cell takes one step, ``cell(inputs, states) -> (output, new_states)``,
with explicit states (``begin_state``); ``unroll`` loops it over a
sequence in Python (with ``merge_outputs`` and ``valid_length``), which a
hybridized block's CachedOp captures whole.  Gate orders and parameter
names are the reference's: LSTM ``[i, f, c, o]``, GRU ``[r, z, n]``,
``<prefix>i2h_weight``, ``h2h_weight``, ``i2h_bias``, ``h2h_bias``.
``input_size=0`` defers the input width to the first call.  Modifier and
composite cells: ``SequentialRNNCell``, ``DropoutCell``,
``ResidualCell``, ``ZoneoutCell``, ``BidirectionalCell``.
"""
from __future__ import annotations

from ... import autograd
from ... import ndarray as nd
from ...base import MXNetError
from ..block import HybridBlock

__all__ = ["RecurrentCell", "HybridRecurrentCell", "RNNCell", "LSTMCell",
           "GRUCell", "SequentialRNNCell", "HybridSequentialRNNCell",
           "ModifierCell", "DropoutCell", "ResidualCell",
           "BidirectionalCell", "ZoneoutCell"]


def _cells_state_info(cells, batch_size):
    return sum([c.state_info(batch_size) for c in cells], [])


def _cells_begin_state(cells, **kwargs):
    return sum([c.begin_state(**kwargs) for c in cells], [])


def _format_sequence(length, inputs, layout):
    """(list of per-step arrays, time axis) of ``inputs``: a list of
    steps, or one array with the time axis where ``layout`` says."""
    axis = layout.find("T")
    if isinstance(inputs, (list, tuple)):
        in_list = list(inputs)
        if length is not None and len(in_list) != length:
            raise MXNetError(f"unroll: expected {length} steps, got "
                             f"{len(in_list)}")
        return in_list, axis
    if axis != 0:
        inputs = inputs.swapaxes(0, axis)
    steps = inputs.shape[0]
    if length is not None and steps != length:
        raise MXNetError(f"unroll: expected length {length}, data has "
                         f"{steps}")
    return [inputs[i] for i in range(steps)], axis


def _merge_outputs(outputs, axis):
    stacked = nd.stack(*outputs, axis=0)
    if axis != 0:
        stacked = stacked.swapaxes(0, axis)
    return stacked


class RecurrentCell(HybridBlock):
    """Base class of the cells."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._modified = False
        self.reset()

    def _cells(self):
        return list(self._child_blocks())

    def reset(self):
        """Reset the step counters before a new sequence."""
        self._init_counter = -1
        self._counter = -1
        for cell in self._cells():
            if isinstance(cell, RecurrentCell):
                cell.reset()

    def state_info(self, batch_size=0):
        raise NotImplementedError

    def begin_state(self, batch_size=0, func=None, **kwargs):
        """The initial states: ``func(shape, **kwargs)`` (default
        ``nd.zeros``) for each entry of ``state_info``."""
        if self._modified:
            raise MXNetError("After applying modifier cells the base cell "
                             "cannot be called directly. Call the modifier "
                             "cell instead.")
        if func is None:
            func = nd.zeros
        states = []
        for info in self.state_info(batch_size):
            self._init_counter += 1
            info = dict(info)
            shape = info.pop("shape")
            info.pop("__layout__", None)
            states.append(func(shape, **dict(info, **kwargs)))
        return states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        """Run the cell over ``length`` steps of ``inputs``.  Returns
        ``(outputs, states)``: the outputs a list of steps, or one array
        in ``layout`` with ``merge_outputs``; with ``valid_length`` the
        steps past each row's length are zeros."""
        self.reset()
        in_list, axis = _format_sequence(length, inputs, layout)
        if begin_state is None:
            begin_state = self.begin_state(batch_size=in_list[0].shape[0],
                                           ctx=in_list[0].context)
        states = begin_state
        outputs = []
        for i in range(length):
            out, states = self(in_list[i], states)
            outputs.append(out)
        if valid_length is not None:
            masked = nd.SequenceMask(nd.stack(*outputs, axis=0),
                                     valid_length, use_sequence_length=True)
            outputs = [masked[i] for i in range(length)]
        if merge_outputs:
            return _merge_outputs(outputs, axis), states
        return outputs, states

    def forward(self, inputs, states):
        self._counter += 1
        return super().forward(inputs, states)

    def _alias(self):
        return "rnn"


class HybridRecurrentCell(RecurrentCell):
    pass


class _GatedCell(HybridRecurrentCell):
    """The parameters of a cell with ``gates`` gates of
    ``hidden_size``."""

    _gates = 1

    def __init__(self, hidden_size, i2h_weight_initializer=None,
                 h2h_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", input_size=0, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._input_size = input_size
        n = self._gates * hidden_size
        with self.name_scope():
            self.i2h_weight = self.params.get(
                "i2h_weight", shape=(n, input_size),
                init=i2h_weight_initializer, allow_deferred_init=True)
            self.h2h_weight = self.params.get(
                "h2h_weight", shape=(n, hidden_size),
                init=h2h_weight_initializer, allow_deferred_init=True)
            self.i2h_bias = self.params.get(
                "i2h_bias", shape=(n,), init=i2h_bias_initializer,
                allow_deferred_init=True)
            self.h2h_bias = self.params.get(
                "h2h_bias", shape=(n,), init=h2h_bias_initializer,
                allow_deferred_init=True)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}]

    def infer_shape(self, inputs, states):
        self._gluon_param("i2h_weight").shape = (
            self._gates * self._hidden_size, inputs.shape[-1])

    def _projections(self, F, inputs, h, i2h_weight, h2h_weight, i2h_bias,
                     h2h_bias):
        n = self._gates * self._hidden_size
        return (F.FullyConnected(inputs, i2h_weight, i2h_bias, num_hidden=n),
                F.FullyConnected(h, h2h_weight, h2h_bias, num_hidden=n))


class RNNCell(_GatedCell):
    """Elman cell: ``h' = act(W_ih x + b_ih + W_hh h + b_hh)``."""

    def __init__(self, hidden_size, activation="tanh",
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 input_size=0, prefix=None, params=None):
        self._activation = activation
        super().__init__(hidden_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, input_size, prefix=prefix,
                         params=params)

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h, h2h = self._projections(F, inputs, states[0], i2h_weight,
                                     h2h_weight, i2h_bias, h2h_bias)
        out = F.Activation(i2h + h2h, act_type=self._activation)
        return out, [out]


class LSTMCell(_GatedCell):
    """LSTM cell; gates ordered [i, f, c, o] (the reference's order)."""

    _gates = 4

    def __init__(self, hidden_size, i2h_weight_initializer=None,
                 h2h_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", input_size=0,
                 activation="tanh", recurrent_activation="sigmoid",
                 prefix=None, params=None):
        self._activation = activation
        self._recurrent_activation = recurrent_activation
        super().__init__(hidden_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, input_size, prefix=prefix,
                         params=params)

    def state_info(self, batch_size=0):
        return super().state_info(batch_size) * 2

    def _alias(self):
        return "lstm"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h, h2h = self._projections(F, inputs, states[0], i2h_weight,
                                     h2h_weight, i2h_bias, h2h_bias)
        slices = F.split(i2h + h2h, num_outputs=4, axis=1)
        rec = self._recurrent_activation
        in_gate = F.Activation(slices[0], act_type=rec)
        forget_gate = F.Activation(slices[1], act_type=rec)
        in_transform = F.Activation(slices[2], act_type=self._activation)
        out_gate = F.Activation(slices[3], act_type=rec)
        next_c = forget_gate * states[1] + in_gate * in_transform
        next_h = out_gate * F.Activation(next_c, act_type=self._activation)
        return next_h, [next_h, next_c]


class GRUCell(_GatedCell):
    """GRU cell; gates ordered [r, z, n] (the reference's order)."""

    _gates = 3

    def _alias(self):
        return "gru"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        prev_h = states[0]
        i2h, h2h = self._projections(F, inputs, prev_h, i2h_weight,
                                     h2h_weight, i2h_bias, h2h_bias)
        i2h_r, i2h_z, i2h_n = F.split(i2h, num_outputs=3, axis=1)
        h2h_r, h2h_z, h2h_n = F.split(h2h, num_outputs=3, axis=1)
        reset = F.sigmoid(i2h_r + h2h_r)
        update = F.sigmoid(i2h_z + h2h_z)
        new = F.tanh(i2h_n + reset * h2h_n)
        next_h = (1.0 - update) * new + update * prev_h
        return next_h, [next_h]


class SequentialRNNCell(RecurrentCell):
    """Cells stacked: each one's output is the next one's input."""

    def add(self, cell):
        self.register_child(cell)

    def __len__(self):
        return len(self._cells())

    def state_info(self, batch_size=0):
        return _cells_state_info(self._cells(), batch_size)

    def begin_state(self, **kwargs):
        if self._modified:
            raise MXNetError("After applying modifier cells the base cell "
                             "cannot be called directly.")
        return _cells_begin_state(self._cells(), **kwargs)

    def __call__(self, inputs, states):
        self._counter += 1
        next_states = []
        p = 0
        for cell in self._cells():
            if isinstance(cell, BidirectionalCell):
                raise MXNetError("a BidirectionalCell in a "
                                 "SequentialRNNCell can only be unrolled")
            n = len(cell.state_info())
            inputs, state = cell(inputs, states[p:p + n])
            p += n
            next_states.extend(state)
        return inputs, next_states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        self.reset()
        in_list, _ = _format_sequence(length, inputs, layout)
        if begin_state is None:
            begin_state = self.begin_state(batch_size=in_list[0].shape[0],
                                           ctx=in_list[0].context)
        p = 0
        next_states = []
        cells = self._cells()
        for i, cell in enumerate(cells):
            n = len(cell.state_info())
            inputs, states = cell.unroll(
                length, inputs, begin_state=begin_state[p:p + n],
                layout=layout,
                merge_outputs=None if i < len(cells) - 1 else merge_outputs,
                valid_length=valid_length)
            p += n
            next_states.extend(states)
        return inputs, next_states


HybridSequentialRNNCell = SequentialRNNCell


class ModifierCell(HybridRecurrentCell):
    """A cell that wraps ``base_cell`` and shares its parameters; the
    base cell is then called only through it."""

    def __init__(self, base_cell):
        if base_cell._modified:
            raise MXNetError(f"cell {base_cell.name!r} is already modified")
        base_cell._modified = True
        super().__init__(prefix=base_cell.prefix + self._alias(),
                         params=None)
        self.base_cell = base_cell

    @property
    def params(self):
        return self.base_cell.params

    def state_info(self, batch_size=0):
        return self.base_cell.state_info(batch_size)

    def begin_state(self, func=None, **kwargs):
        if self._modified:
            raise MXNetError("After applying modifier cells the base cell "
                             "cannot be called directly.")
        self.base_cell._modified = False
        try:
            return self.base_cell.begin_state(func=func, **kwargs)
        finally:
            self.base_cell._modified = True

    def _step_base(self, inputs, states):
        self.base_cell._modified = False
        try:
            return self.base_cell(inputs, states)
        finally:
            self.base_cell._modified = True


class DropoutCell(HybridRecurrentCell):
    """Dropout on the input (no state); active in training mode."""

    def __init__(self, rate, axes=(), prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._rate = rate
        self._axes = axes

    def state_info(self, batch_size=0):
        return []

    def _alias(self):
        return "dropout"

    def hybrid_forward(self, F, inputs, states):
        if self._rate > 0:
            inputs = F.Dropout(inputs, p=self._rate, axes=self._axes)
        return inputs, states


class ResidualCell(ModifierCell):
    """The base cell's output plus its input."""

    def __call__(self, inputs, states):
        output, states = self._step_base(inputs, states)
        return output + inputs, states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        self.reset()
        self.base_cell._modified = False
        try:
            outputs, states = self.base_cell.unroll(
                length, inputs, begin_state=begin_state, layout=layout,
                merge_outputs=False, valid_length=valid_length)
        finally:
            self.base_cell._modified = True
        in_list, axis = _format_sequence(length, inputs, layout)
        outputs = [o + x for o, x in zip(outputs, in_list)]
        if merge_outputs:
            return _merge_outputs(outputs, axis), states
        return outputs, states


class ZoneoutCell(ModifierCell):
    """Zoneout: in training mode each output and state element keeps its
    previous value with probability ``zoneout_outputs`` or
    ``zoneout_states``; the masks come from the device's ``mx.random``
    stream."""

    def __init__(self, base_cell, zoneout_outputs=0.0, zoneout_states=0.0):
        if isinstance(base_cell, BidirectionalCell):
            raise MXNetError("ZoneoutCell cannot wrap a BidirectionalCell")
        super().__init__(base_cell)
        self.zoneout_outputs = zoneout_outputs
        self.zoneout_states = zoneout_states
        self._prev_output = None

    def _alias(self):
        return "zoneout"

    def reset(self):
        super().reset()
        self._prev_output = None

    def __call__(self, inputs, states):
        next_output, next_states = self._step_base(inputs, states)
        if not autograd.is_training():
            return next_output, next_states

        def mask(p, like):
            return nd.random.uniform(0, 1, shape=like.shape,
                                     ctx=like.context) < p

        prev_output = self._prev_output
        if prev_output is None:
            prev_output = nd.zeros(next_output.shape,
                                   ctx=next_output.context)
        out = nd.where(mask(self.zoneout_outputs, next_output),
                       prev_output, next_output) \
            if self.zoneout_outputs > 0 else next_output
        new_states = [nd.where(mask(self.zoneout_states, ns), os, ns)
                      if self.zoneout_states > 0 else ns
                      for ns, os in zip(next_states, states)]
        self._prev_output = out
        return out, new_states


class BidirectionalCell(HybridRecurrentCell):
    """``l_cell`` forward and ``r_cell`` backward over the sequence, the
    outputs concatenated; it can only be unrolled."""

    def __init__(self, l_cell, r_cell, output_prefix="bi_"):
        super().__init__(prefix="", params=None)
        self.register_child(l_cell, "l_cell")
        self.register_child(r_cell, "r_cell")
        self._output_prefix = output_prefix

    def __call__(self, inputs, states):
        raise MXNetError("BidirectionalCell cannot be stepped — use "
                         "unroll()")

    def state_info(self, batch_size=0):
        return _cells_state_info(self._cells(), batch_size)

    def begin_state(self, **kwargs):
        if self._modified:
            raise MXNetError("After applying modifier cells the base cell "
                             "cannot be called directly.")
        return _cells_begin_state(self._cells(), **kwargs)

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        self.reset()
        in_list, axis = _format_sequence(length, inputs, layout)
        if begin_state is None:
            begin_state = self.begin_state(batch_size=in_list[0].shape[0],
                                           ctx=in_list[0].context)
        l_cell, r_cell = self._cells()
        n_l = len(l_cell.state_info())

        def _reverse(seq_list):
            """The time axis reversed; with ``valid_length`` only each
            row's valid prefix, so the backward cell starts on data."""
            if valid_length is None:
                return list(reversed(seq_list))
            vl = valid_length if isinstance(valid_length, nd.NDArray) \
                else nd.array(valid_length, ctx=seq_list[0].context)
            rev = nd.SequenceReverse(nd.stack(*seq_list, axis=0), vl,
                                     use_sequence_length=True)
            return [rev[i] for i in range(len(seq_list))]

        l_outputs, l_states = l_cell.unroll(
            length, in_list, begin_state=begin_state[:n_l], layout=layout,
            merge_outputs=False, valid_length=valid_length)
        r_outputs, r_states = r_cell.unroll(
            length, _reverse(in_list), begin_state=begin_state[n_l:],
            layout=layout, merge_outputs=False, valid_length=valid_length)
        r_outputs = _reverse(r_outputs)
        outputs = [nd.concat(left, right, dim=1)
                   for left, right in zip(l_outputs, r_outputs)]
        if merge_outputs:
            return _merge_outputs(outputs, axis), l_states + r_states
        return outputs, l_states + r_states
