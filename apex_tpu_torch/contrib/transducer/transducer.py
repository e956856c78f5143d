"""Transducer (RNN-T) joint and loss.

Port of ``apex_tpu/contrib/transducer/transducer.py``:

* :func:`transducer_joint` and :class:`TransducerJoint` (``:30-65``): the
  broadcast add f[:, :, None, :] + g[:, None, :, :], optional ReLU and
  dropout, and positions past each element's lengths zeroed (the
  reference's stand-in for apex's packed output).
* :func:`transducer_loss` and :class:`TransducerLoss` (``:85-163``): the
  RNN-T negative log-likelihood per batch element. The reference runs the
  alpha recursion as a ``lax.scan`` over T with a sequential scan over U
  inside (``_alpha_beta``, ``:95-129``) and takes its gradient by autodiff
  through it. Eager PyTorch would pay a launch per lattice cell, tens of
  thousands at an RNN-T step's shapes; here the lattice is skewed so that
  its anti-diagonals d = t + u are rows, and the recursion walks the T + U
  diagonals, each step a few elementwise ops over (batch, t). The
  gradient is a ``torch.autograd.Function`` whose backward walks beta the
  same way and forms the alpha/beta occupancies, the formula of apex's
  ``transducer_loss_kernel.cu``, which equals the reference's autodiff.
  The log-probabilities keep x's precision (at least fp32); the small
  lattice walks in fp64, where the reference's fp32 would move the
  occupancies of a 278 x 100 lattice by about 1e-3.

No kernel: the reference computes both in XLA, with no Pallas kernel.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

NEG = -1e30


def _no_packing(what: str, flag: bool) -> None:
    """The reference accepts ``pack_output=``/``packed_input=`` and ignores
    them (``:56-60``, ``:159-160``); by the port's knob rule only their
    default is accepted."""
    if flag:
        raise TypeError(f"{what}=True is not supported: the joint's output "
                        f"is masked past each element's lengths, not "
                        f"packed (pass {what}=False)")


def transducer_joint(f: torch.Tensor, g: torch.Tensor,
                     f_len: Optional[torch.Tensor] = None,
                     g_len: Optional[torch.Tensor] = None, *,
                     relu: bool = False, dropout_rate: float = 0.0,
                     key: Optional[torch.Generator] = None) -> torch.Tensor:
    """Joint: (B, T, H) x (B, U, H) -> (B, T, U, H); positions at or past
    ``f_len`` (frames) or ``g_len`` (labels) zeroed. Dropout (with
    ``dropout_rate`` > 0 and a ``key`` generator on the tensors' device)
    keeps each entry with probability 1 - rate, scaled by 1 / (1 - rate)."""
    h = f[:, :, None, :] + g[:, None, :, :]
    zero = torch.zeros((), dtype=h.dtype, device=h.device)
    if relu:
        h = torch.relu(h)
    if dropout_rate > 0 and key is not None:
        keep = torch.rand(h.shape, generator=key, device=h.device) \
            >= dropout_rate
        h = torch.where(keep, h / (1.0 - dropout_rate), zero)
    if f_len is not None:
        t = torch.arange(f.shape[1], device=h.device)
        h = torch.where(t[None, :, None, None]
                        < f_len.to(h.device)[:, None, None, None], h, zero)
    if g_len is not None:
        u = torch.arange(g.shape[1], device=h.device)
        h = torch.where(u[None, None, :, None]
                        < g_len.to(h.device)[:, None, None, None], h, zero)
    return h


class TransducerJoint(nn.Module):
    """``apex.contrib.transducer.TransducerJoint``'s constructor
    (``transducer.py:5``); ``pack_output`` only False."""

    def __init__(self, pack_output: bool = False, relu: bool = False,
                 dropout: bool = False, dropout_prob: float = 0.0):
        super().__init__()
        _no_packing("pack_output", pack_output)
        self.relu = relu
        self.dropout_prob = dropout_prob if dropout else 0.0

    def forward(self, f, g, f_len=None, g_len=None, key=None):
        return transducer_joint(f, g, f_len, g_len, relu=self.relu,
                                dropout_rate=self.dropout_prob, key=key)


# --- the loss -----------------------------------------------------------------

def _log_probs(x: torch.Tensor, labels: torch.Tensor, blank_idx: int):
    """log_softmax over V in at least fp32, and its blank and label
    streams: (lp (B, T, U1, V), lp_blank (B, T, U1), lp_label (B, T, U))."""
    lp = torch.log_softmax(x.to(torch.promote_types(x.dtype, torch.float32)),
                           dim=-1)
    B, T, U1, _ = lp.shape
    lab = labels.long()[:, None, :, None].expand(B, T, U1 - 1, 1)
    return lp, lp[..., blank_idx], lp[:, :, :-1, :].gather(-1, lab)[..., 0]


def _skew(a: torch.Tensor, D: int) -> torch.Tensor:
    """(B, T, W) -> (B, D, T): entry (d, t) is a[:, t, d - t], NEG where
    d - t is no column of ``a``."""
    B, T, W = a.shape
    u = (torch.arange(D, device=a.device)[:, None]
         - torch.arange(T, device=a.device)[None, :])          # (D, T)
    idx = u.clamp(0, W - 1).T[None].expand(B, T, D)
    s = a.gather(2, idx).transpose(1, 2)
    return torch.where(((u >= 0) & (u < W))[None], s,
                       torch.full((), NEG, dtype=a.dtype, device=a.device))


def _unskew(s: torch.Tensor, W: int) -> torch.Tensor:
    """(B, D, T) -> (B, T, W): entry (t, u) is s[:, t + u, t]."""
    B, D, T = s.shape
    idx = (torch.arange(T, device=s.device)[None, :]
           + torch.arange(W, device=s.device)[:, None])        # (W, T)
    return s.gather(1, idx[None].expand(B, W, T)).transpose(1, 2)


def _alpha(s_lb: torch.Tensor, s_ll: torch.Tensor) -> torch.Tensor:
    """alpha on the skewed lattice (B, D, T): alpha[0, 0] = 0, alpha[t, u]
    = logaddexp(alpha[t-1, u] + lb[t-1, u], alpha[t, u-1] + ll[t, u-1]),
    one anti-diagonal a step; NEG off the lattice (``_skew``'s NEG
    entries keep it there)."""
    B, D, T = s_lb.shape
    neg = torch.full((B, 1), NEG, dtype=s_lb.dtype, device=s_lb.device)
    prev = torch.cat([torch.zeros_like(neg), neg.expand(B, T - 1)], dim=1)
    out = [prev]
    for d in range(1, D):
        blank = torch.cat([neg, (prev + s_lb[:, d - 1])[:, :-1]], dim=1)
        prev = torch.logaddexp(blank, prev + s_ll[:, d - 1])
        out.append(prev)
    return torch.stack(out, dim=1)


def _beta(s_lb, s_ll, live, end):
    """beta on the skewed lattice: beta[T'-1, U'] = lb[T'-1, U'] at each
    element's end cell (``end``), beta[t, u] = logaddexp(beta[t+1, u] +
    lb[t, u], beta[t, u+1] + ll[t, u]) on its ``live`` cells (t < T', u <=
    U'), NEG elsewhere; walked from the last diagonal down."""
    B, D, T = s_lb.shape
    neg_col = torch.full((B, 1), NEG, dtype=s_lb.dtype, device=s_lb.device)
    neg = torch.full((), NEG, dtype=s_lb.dtype, device=s_lb.device)
    nxt = neg_col.expand(B, T)
    out = [None] * D
    for d in range(D - 1, -1, -1):
        blank = torch.cat([nxt[:, 1:], neg_col], dim=1) + s_lb[:, d]
        cur = torch.logaddexp(blank, nxt + s_ll[:, d])
        cur = torch.where(end[:, d], s_lb[:, d], cur)
        nxt = out[d] = torch.where(live[:, d], cur, neg)
    return torch.stack(out, dim=1)


def _lattice(x, labels, f_len, y_len, blank_idx):
    lp, lb, ll = _log_probs(x, labels, blank_idx)
    B, T, U1 = lb.shape
    D = T + U1 - 1
    # the lattice in fp64: alpha and beta add T + U log-probabilities, so
    # at an RNN-T step's lengths fp32 rounding would move the occupancies
    # (the gradient) by ~1e-3; the (B, T, U + 1) lattice is small beside
    # the (B, T, U + 1, V) log-probabilities, which stay in x's precision
    s_lb, s_ll = _skew(lb.double(), D), _skew(ll.double(), D)
    alpha = _alpha(s_lb, s_ll)
    t_end = f_len.long().to(x.device) - 1
    u_end = y_len.long().to(x.device)
    bi = torch.arange(B, device=x.device)
    loss = -(alpha[bi, t_end + u_end, t_end] + lb[bi, t_end, u_end].double())
    return lp, s_lb, s_ll, alpha, t_end, u_end, loss


class _TransducerLossFn(torch.autograd.Function):
    """The loss per element, with the occupancy gradient: for every
    transition out of (t, u), minus its probability of lying on a path,
    exp(alpha + lp + beta(next) - logP), then through log_softmax."""

    @staticmethod
    def forward(ctx, x, labels, f_len, y_len, blank_idx):
        with torch.no_grad():
            lp, s_lb, s_ll, alpha, t_end, u_end, loss = _lattice(
                x, labels, f_len, y_len, blank_idx)
        ctx.save_for_backward(x, labels, s_lb, s_ll, alpha, t_end, u_end,
                              loss)
        ctx.blank_idx = blank_idx
        return loss.to(lp.dtype)

    @staticmethod
    def backward(ctx, dloss):
        x, labels, s_lb, s_ll, alpha, t_end, u_end, loss = ctx.saved_tensors
        B, T, U1, V = x.shape
        D = s_lb.shape[1]
        dev = x.device
        d_i = torch.arange(D, device=dev)[None, :, None]
        t_i = torch.arange(T, device=dev)[None, None, :]
        u_i = d_i - t_i
        te, ue = t_end[:, None, None], u_end[:, None, None]
        live = (u_i >= 0) & (t_i <= te) & (u_i <= ue)
        end = (t_i == te) & (u_i == ue)
        beta = _beta(s_lb, s_ll, live, end)
        # beta one diagonal on: at t (the label's next cell, u + 1) and at
        # t + 1 (the blank's, t + 1); the end cell's blank ends the path
        b_label = torch.cat([beta[:, 1:], torch.full(
            (B, 1, T), NEG, dtype=beta.dtype, device=dev)], dim=1)
        b_blank = torch.cat([b_label[:, :, 1:], torch.full(
            (B, D, 1), NEG, dtype=beta.dtype, device=dev)], dim=2)
        b_blank = torch.where(end, torch.zeros_like(b_blank), b_blank)
        log_p = -loss[:, None, None]                      # beta[0, 0]
        scale = dloss.to(beta.dtype)[:, None, None]
        zero = torch.zeros((), dtype=beta.dtype, device=dev)
        g_lb = torch.where(live, -scale * torch.exp(
            alpha + s_lb + b_blank - log_p), zero)
        g_ll = torch.where(live & (u_i < ue), -scale * torch.exp(
            alpha + s_ll + b_label - log_p), zero)
        lp = torch.log_softmax(
            x.to(torch.promote_types(x.dtype, torch.float32)), dim=-1)
        g_lb = _unskew(g_lb, U1).to(lp.dtype)
        g_ll = _unskew(g_ll, U1 - 1).to(lp.dtype)
        total = g_lb + torch.nn.functional.pad(g_ll, (0, 1))
        dx = -torch.exp(lp) * total[..., None]
        dx[..., ctx.blank_idx] += g_lb
        dx[:, :, :-1].scatter_add_(
            -1, labels.long()[:, None, :, None].expand(B, T, U1 - 1, 1),
            g_ll[..., None])
        return dx.to(x.dtype), None, None, None, None


def transducer_loss(x: torch.Tensor, labels: torch.Tensor,
                    f_len: torch.Tensor, y_len: torch.Tensor,
                    blank_idx: int = 0) -> torch.Tensor:
    """RNN-T negative log-likelihood per batch element: x (B, T, U+1, V)
    joint logits, labels (B, U) int, f_len (B,) frames of each element
    (at least 1), y_len (B,) its labels. The log-probabilities in at least
    fp32 (the loss has that dtype, x's gradient x's), the lattice in
    fp64."""
    return _TransducerLossFn.apply(x, labels, f_len, y_len, int(blank_idx))


class TransducerLoss(nn.Module):
    """``apex.contrib.transducer.TransducerLoss``'s constructor
    (``transducer.py:68``); ``packed_input`` only False."""

    def __init__(self, packed_input: bool = False):
        super().__init__()
        _no_packing("packed_input", packed_input)

    def forward(self, x, label, f_len, y_len, blank_idx=0):
        return transducer_loss(x, label, f_len, y_len, blank_idx)
