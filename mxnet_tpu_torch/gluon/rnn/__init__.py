"""``gluon.rnn``: recurrent cells and fused layers, as the JAX package's
``gluon/rnn``."""
from .rnn_cell import (BidirectionalCell, DropoutCell, GRUCell,
                       HybridRecurrentCell, HybridSequentialRNNCell,
                       LSTMCell, ModifierCell, RecurrentCell, ResidualCell,
                       RNNCell, SequentialRNNCell, ZoneoutCell)
from .rnn_layer import GRU, LSTM, RNN

__all__ = ["RecurrentCell", "HybridRecurrentCell", "RNNCell", "LSTMCell",
           "GRUCell", "SequentialRNNCell", "HybridSequentialRNNCell",
           "ModifierCell", "DropoutCell", "ResidualCell", "BidirectionalCell",
           "ZoneoutCell", "RNN", "LSTM", "GRU"]
