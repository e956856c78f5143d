"""RNN cells: port of ``apex_tpu/rnn/cells.py`` (``:23-116``; upstream
``apex/RNN/cells.py``).

Each cell holds its sizes: ``init(generator, dtype, device) -> params``
(``w_ih`` (gates·H, in), ``w_hh`` (gates·H, H), ``b_ih``, ``b_hh``, all
U(±1/sqrt(H))), ``initial_state(batch, dtype, device)``, and
``step(params, state, x) -> (state, y)`` with the reference's gate order
and splits: LSTM (i, f, g, o), GRU (r, z, n) with ``n = tanh(in + r·hn)``
and ``b_hh`` inside ``hn``. ``input_proj(params, x)`` gives the input's
share of the gates (``x @ w_ih.T + b_ih``) for a whole sequence at once;
``step(..., xw=)`` takes a time step of it, so :class:`~apex_tpu_torch.
rnn.backend.RNN` runs one input GEMM per layer: the per-element sums are
the reference's, ``(x @ w_ih.T + b_ih) + h @ w_hh.T + b_hh``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Union

import torch

from apex_tpu_torch.ops import _backend

Device = Optional[Union[str, torch.device]]


def _uniform(generator, shape, dtype, device, bound):
    u = torch.rand(shape, generator=generator, dtype=torch.float32,
                   device=device)
    return ((u * 2 - 1) * bound).to(dtype)


@dataclasses.dataclass
class _Cell:
    input_size: int
    hidden_size: int
    n_gates: int = 1

    def init(self, generator: torch.Generator,
             dtype: torch.dtype = torch.float32, device: Device = None
             ) -> Dict[str, torch.Tensor]:
        dev = _backend.resolve_device(device)
        b = 1.0 / self.hidden_size ** 0.5
        g = self.n_gates * self.hidden_size
        return {
            "w_ih": _uniform(generator, (g, self.input_size), dtype, dev, b),
            "w_hh": _uniform(generator, (g, self.hidden_size), dtype, dev,
                             b),
            "b_ih": _uniform(generator, (g,), dtype, dev, b),
            "b_hh": _uniform(generator, (g,), dtype, dev, b),
        }

    def initial_state(self, batch: int, dtype: torch.dtype = torch.float32,
                      device: Device = None):
        return torch.zeros((batch, self.hidden_size), dtype=dtype,
                           device=device)

    def input_proj(self, p, x: torch.Tensor) -> torch.Tensor:
        """The input's share of the gates, ``x @ w_ih.T + b_ih``."""
        return x @ p["w_ih"].t() + p["b_ih"]

    def _xw(self, p, x, xw):
        return self.input_proj(p, x) if xw is None else xw


@dataclasses.dataclass
class RNNTanhCell(_Cell):
    def step(self, p, h, x, xw=None):
        h = torch.tanh(self._xw(p, x, xw) + h @ p["w_hh"].t() + p["b_hh"])
        return h, h


@dataclasses.dataclass
class RNNReLUCell(_Cell):
    def step(self, p, h, x, xw=None):
        h = torch.relu(self._xw(p, x, xw) + h @ p["w_hh"].t() + p["b_hh"])
        return h, h


@dataclasses.dataclass
class LSTMCell(_Cell):
    n_gates: int = 4

    def initial_state(self, batch, dtype=torch.float32, device=None):
        return (torch.zeros((batch, self.hidden_size), dtype=dtype,
                            device=device),
                torch.zeros((batch, self.hidden_size), dtype=dtype,
                            device=device))

    def step(self, p, state, x, xw=None):
        h, c = state
        gates = self._xw(p, x, xw) + h @ p["w_hh"].t() + p["b_hh"]
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        return (h, c), h


@dataclasses.dataclass
class GRUCell(_Cell):
    n_gates: int = 3

    def step(self, p, h, x, xw=None):
        gi = self._xw(p, x, xw)
        gh = h @ p["w_hh"].t() + p["b_hh"]
        ir, iz, in_ = gi.chunk(3, dim=-1)
        hr, hz, hn = gh.chunk(3, dim=-1)
        r = torch.sigmoid(ir + hr)
        z = torch.sigmoid(iz + hz)
        n = torch.tanh(in_ + r * hn)
        h = (1 - z) * n + z * h
        return h, h


@dataclasses.dataclass
class mLSTMCell(_Cell):
    """Multiplicative LSTM (upstream ``mLSTMRNNCell``): the hidden state is
    modulated by m = (x @ w_mx.T) * (h @ w_mh.T) before the gates."""

    n_gates: int = 4

    def init(self, generator, dtype=torch.float32, device=None):
        params = super().init(generator, dtype, device)
        dev = params["w_ih"].device
        b = 1.0 / self.hidden_size ** 0.5
        params["w_mx"] = _uniform(generator,
                                  (self.hidden_size, self.input_size),
                                  dtype, dev, b)
        params["w_mh"] = _uniform(generator,
                                  (self.hidden_size, self.hidden_size),
                                  dtype, dev, b)
        return params

    def initial_state(self, batch, dtype=torch.float32, device=None):
        return LSTMCell.initial_state(self, batch, dtype, device)

    def input_proj(self, p, x):
        """The input's shares: (x @ w_ih.T + b_ih, x @ w_mx.T)."""
        return (x @ p["w_ih"].t() + p["b_ih"], x @ p["w_mx"].t())

    def step(self, p, state, x, xw=None):
        h, c = state
        gx, mx = self._xw(p, x, xw)
        m = mx * (h @ p["w_mh"].t())
        gates = gx + m @ p["w_hh"].t() + p["b_hh"]
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        return (h, c), h
