"""RNN driver: the time loop, layer stacking, bidirection.

Port of ``apex_tpu/rnn/backend.py`` (``:20-97``; upstream
``apex/RNN/RNNBackend.py:25``): :class:`RNN` runs each layer's cell over
(batch, time, features), the reference's ``lax.scan`` a Python loop over
time steps, with the input's share of the gates computed for the whole
sequence by one GEMM a layer (the cell's ``input_proj``). Layers stack by
composition; :func:`bidirectional` concatenates a time-reversed stack.

Under an O1 policy, ``apply_op_rules("rnn", ...)`` casts x, the params and
user states on entry (``:50-59``; upstream ``rnn_cast``). Dropout between
layers draws its keep mask from a ``torch.Generator`` — the reference's
``jax.random.bernoulli(fold_in(key, layer))`` bits cannot be reproduced by
torch (ROADMAP queue 3 records the divergence): a kept element is
``h / (1 − p)``, the divisor rounded to h's dtype as the reference's weak
typing rounds it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional

import torch

from apex_tpu_torch.amp.lists import apply_op_rules
from apex_tpu_torch.utils.pytree import tree_map


def _cast(tree):
    return tree_map(lambda a: apply_op_rules("rnn", a)[0], tree)


@dataclasses.dataclass
class RNN:
    """Multi-layer unidirectional RNN over (batch, time, features)."""

    cell: Any
    num_layers: int = 1
    dropout: float = 0.0

    def init(self, generator: torch.Generator,
             dtype: torch.dtype = torch.float32, device=None) -> list:
        return [self._layer_cell(i).init(generator, dtype, device)
                for i in range(self.num_layers)]

    def _layer_cell(self, i):
        if i == 0:
            return self.cell
        return dataclasses.replace(self.cell,
                                   input_size=self.cell.hidden_size)

    def __call__(self, params: list, x: torch.Tensor,
                 initial_states: Optional[list] = None,
                 generator: Optional[torch.Generator] = None):
        """Returns (outputs (B, T, H), the final states, one a layer).
        ``generator`` draws the dropout masks between layers (none
        without it, as the reference without a key)."""
        (x,) = apply_op_rules("rnn", x)
        params = _cast(params)
        if initial_states is not None:
            # user states join the cast, or an fp32 carry would promote
            # every gate sum back to fp32
            initial_states = _cast(initial_states)
        b = x.shape[0]
        finals: List[Any] = []
        h = x
        for i, p in enumerate(params):
            cell = self._layer_cell(i)
            state = (initial_states[i] if initial_states is not None
                     else cell.initial_state(b, x.dtype, x.device))
            xw = cell.input_proj(p, h)
            ys = []
            for t in range(h.shape[1]):
                xw_t = (tuple(a[:, t] for a in xw) if isinstance(xw, tuple)
                        else xw[:, t])
                state, y = cell.step(p, state, None, xw=xw_t)
                ys.append(y)
            h = torch.stack(ys, dim=1)
            if (self.dropout > 0 and generator is not None
                    and i < len(params) - 1):
                keep = torch.rand(h.shape, generator=generator,
                                  device=h.device) < 1.0 - self.dropout
                d = torch.tensor(1.0 - self.dropout, dtype=h.dtype,
                                 device=h.device)
                h = torch.where(keep, h / d, torch.zeros((), dtype=h.dtype,
                                                          device=h.device))
            finals.append(state)
        return h, finals


def stacked_rnn(cell, num_layers: int, dropout: float = 0.0) -> RNN:
    """``stackedRNN`` (``RNNBackend.py``)."""
    return RNN(cell, num_layers=num_layers, dropout=dropout)


def bidirectional(rnn: RNN):
    """``bidirectionalRNN`` (``RNNBackend.py``): (init, apply) running the
    forward and the time-reversed stacks, features concatenated."""

    def init(generator, dtype=torch.float32, device=None):
        return {"fwd": rnn.init(generator, dtype, device),
                "bwd": rnn.init(generator, dtype, device)}

    def apply(params, x, **kw):
        yf, sf = rnn(params["fwd"], x, **kw)
        yb, sb = rnn(params["bwd"], x.flip(1), **kw)
        return torch.cat([yf, yb.flip(1)], dim=-1), (sf, sb)

    return init, apply
