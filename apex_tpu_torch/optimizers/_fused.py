"""The shared base of the port's optimizers.

Port of ``apex_tpu/optimizers/_fused.py:53-143`` (the per-tensor layout)
as a ``torch.optim.Optimizer`` base, :class:`FusedOptimizer`, and the
arithmetic every optimizer of the package shares:

* a step counter kept per tensor, incremented before use (1-based, for
  the bias corrections); a callable ``lr`` is a schedule evaluated at
  ``count - 1`` (:func:`schedule_value`, the reference's ``:53-57``);
* fp32 math on fp32 copies of the gradients and parameters, fp32 state;
* the reference's two roundings (:func:`apply_updates`): the update is
  ``u = (new_p32 - p32).to(p.dtype)`` (``:128``) and the parameter
  becomes ``p + u`` in its own dtype (``optax.apply_updates``). Writing
  ``new_p32.to(bf16)`` directly would differ by an ulp;
* a correctly rounded square root (:func:`ieee_sqrt`): CPU
  ``torch.sqrt`` in float32 is an ulp off on ~17% of inputs, the float64
  root rounded once to float32 is not; CUDA's ``sqrtf`` is IEEE (the
  kernels build without ``--use_fast_math``).

The updates are plain PyTorch (``torch._foreach_*`` over all tensors of
a group), as the reference's are XLA, not Pallas. A multi-tensor CUDA
apply and the reference's chunked ``layout`` are later candidates.
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Union

import numpy as np
import torch

LR = Union[float, Callable[[int], float]]


def f32(x) -> float:
    """``x`` rounded to fp32, as a Python float (exact in fp32 math)."""
    return float(np.float32(x))


def schedule_value(lr: LR, count: int) -> float:
    """The learning rate of step ``count`` (1-based): a schedule sees the
    0-based step, ``count - 1``."""
    return f32(lr(count - 1) if callable(lr) else lr)


def one_minus_pow(beta: float, count: int) -> float:
    """``1 - beta ** count`` in fp32, as the reference's traced scalars."""
    return f32(np.float32(1.0) - np.float32(beta) ** np.float32(count))


def fp32_copies(tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """fp32 copies: an fp32 tensor is copied too, never updated in place."""
    return [t.detach().to(torch.float32, copy=True) for t in tensors]


def ieee_sqrt(tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Correctly rounded fp32 square roots, as new tensors."""
    if all(t.is_cuda for t in tensors):
        return list(torch._foreach_sqrt(list(tensors)))
    return [t.double().sqrt_().float() for t in tensors]


def norms(tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Each fp32 tensor's L2 norm, a 0-dim fp32 tensor: ``sqrt(sum(t *
    t))`` on the CPU, as the reference's per-tensor ``sqnorm``;
    ``torch._foreach_norm`` (one launch) on the card."""
    if all(t.is_cuda for t in tensors):
        return list(torch._foreach_norm(list(tensors)))
    return ieee_sqrt([(t * t).sum() for t in tensors])


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """The L2 norm over every element of every tensor, in fp32 (the
    reference's ``sqrt(sum(jnp.sum(x * x) for x in leaves))`` over fp32
    leaves). A half tensor is read as fp32, never copied whole."""
    tensors = list(tensors)
    if all(t.is_cuda for t in tensors):
        return torch.linalg.vector_norm(torch.stack(
            torch._foreach_norm(tensors, 2, dtype=torch.float32)))
    total = torch.zeros((), dtype=torch.float32)
    for t in tensors:
        t = t.float()
        total = total + (t * t).sum()
    return ieee_sqrt([total])[0]


@torch.no_grad()
def apply_updates(params: Sequence[torch.Tensor],
                  new_p32: Sequence[torch.Tensor],
                  p32: Sequence[torch.Tensor]) -> None:
    """``p <- p + (new_p32 - p32).to(p.dtype)`` in ``p``'s dtype, in place.
    Consumes ``new_p32``."""
    torch._foreach_sub_(list(new_p32), list(p32))
    for p, u in zip(params, new_p32):
        p.add_(u.to(p.dtype))


class FusedOptimizer(torch.optim.Optimizer):
    """One fused update a step over the tensors that have a gradient.

    A subclass sets :meth:`_init_state` (the per-tensor fp32 state, beside
    ``step``) and :meth:`_update`, and may set :meth:`_global_stats` (a
    value computed once from every group's gradients before any group
    steps, e.g. LAMB's clip). Each group's fp32 gradient copies live only
    while that group steps. Every tensor of a group steps together: their
    counts agree.
    """

    def _init_state(self, p: torch.Tensor, st: dict) -> None:
        st["step"] = 0

    def _global_stats(self, params: List[List[torch.Tensor]]):
        """From each stepping group's tensors (their ``.grad``)."""
        return None

    def _update(self, group: dict, params: List[torch.Tensor],
                g32: List[torch.Tensor], count: int, stats) -> None:
        raise NotImplementedError

    def _advance(self, params: List[torch.Tensor]) -> int:
        counts = set()
        for p in params:
            st = self.state[p]
            if not st:
                self._init_state(p, st)
            st["step"] += 1
            counts.add(st["step"])
        if len(counts) != 1:
            raise RuntimeError(f"{type(self).__name__} steps every tensor "
                               f"of a group together; their step counts "
                               f"differ")
        return counts.pop()

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        work = []
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if params:
                work.append((group, params, self._advance(params)))
        if work:
            stats = self._global_stats([w[1] for w in work])
            for group, params, count in work:
                self._update(group, params,
                             fp32_copies([p.grad for p in params]), count,
                             stats)
        return loss
