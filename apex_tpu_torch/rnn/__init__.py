"""RNN cells and stacks: port of :mod:`apex_tpu.rnn` (upstream
``apex.RNN``): the cells, :class:`RNN`, :func:`stacked_rnn`,
:func:`bidirectional` and the factories (``:20-38``)."""

from apex_tpu_torch.rnn.backend import RNN, bidirectional, stacked_rnn  # noqa: F401
from apex_tpu_torch.rnn.cells import (  # noqa: F401
    GRUCell,
    LSTMCell,
    RNNReLUCell,
    RNNTanhCell,
    mLSTMCell,
)


def LSTM(input_size, hidden_size, num_layers=1, **kw):
    """``apex.RNN.LSTM`` (upstream ``apex/RNN/models.py``)."""
    return RNN(LSTMCell(input_size, hidden_size), num_layers=num_layers, **kw)


def GRU(input_size, hidden_size, num_layers=1, **kw):
    return RNN(GRUCell(input_size, hidden_size), num_layers=num_layers, **kw)


def ReLU(input_size, hidden_size, num_layers=1, **kw):
    return RNN(RNNReLUCell(input_size, hidden_size), num_layers=num_layers,
               **kw)


def Tanh(input_size, hidden_size, num_layers=1, **kw):
    return RNN(RNNTanhCell(input_size, hidden_size), num_layers=num_layers,
               **kw)


def mLSTM(input_size, hidden_size, num_layers=1, **kw):
    return RNN(mLSTMCell(input_size, hidden_size), num_layers=num_layers,
               **kw)
