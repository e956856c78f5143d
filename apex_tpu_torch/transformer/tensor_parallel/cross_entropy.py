"""Vocab-parallel softmax cross-entropy, at tp=1.

Port of ``apex_tpu/transformer/tensor_parallel/cross_entropy.py``: the
forward of ``_vce_fwd``'s kernel branch (``:72-93``, ``:109-123``) — one
pass of :func:`apex_tpu_torch.ops.xentropy.xent_stats` over the logits
gives the row max, exp-sum, target logit and (for label smoothing) row sum,
so no full-size fp32 ``logits - max`` temporary is written — and the
backward of ``_vce_bwd`` (``:126-137``), which recomputes the softmax from
the saved logits and the O(tokens) stats and casts to the logits' dtype.
The backward is plain PyTorch, as the reference's is XLA. The sharded
forms (tp > 1) are a later slice.
"""

from __future__ import annotations

from typing import Optional

import torch

from apex_tpu_torch.ops.xentropy import xent_stats


class _VocabParallelCE(torch.autograd.Function):

    @staticmethod
    def forward(ctx, logits, target, label_smoothing, impl):
        vocab = logits.shape[-1]
        stats_shape = logits.shape[:-1]
        in_shard = (target >= 0) & (target < vocab)
        t_idx = torch.where(in_shard, target, 0)
        m, sum_exp, t_raw, s_raw = (
            x.reshape(stats_shape) for x in xent_stats(
                logits.reshape(-1, vocab), target.reshape(-1), impl=impl))
        # tp = 1: the global max is the local one, so sum_exp needs no
        # rebase and only an owned label subtracts the max
        t_logit = t_raw - torch.where(in_shard, m, 0.0)
        log_sum_exp = torch.log(sum_exp)
        loss = log_sum_exp - t_logit
        if label_smoothing > 0:
            # loss = (1 - eps) * nll + eps / V * sum_i nll_i (:68-77)
            sum_logits = s_raw - vocab * m
            smooth = label_smoothing / vocab
            loss = (1.0 - label_smoothing) * loss + smooth * (
                vocab * log_sum_exp - sum_logits)
        # residuals: the logits themselves (no fp32 copy) and O(tokens) stats
        ctx.save_for_backward(logits, m, sum_exp, in_shard, t_idx)
        ctx.label_smoothing = label_smoothing
        return loss

    @staticmethod
    def backward(ctx, dloss):
        logits, m, sum_exp, in_shard, t_idx = ctx.saved_tensors
        eps = ctx.label_smoothing
        vocab = logits.shape[-1]
        # the softmax recompute, in place in ONE fp32 buffer
        g = logits.to(torch.float32, copy=True)
        g.sub_(m[..., None]).exp_().div_(sum_exp[..., None])
        g.scatter_add_(-1, t_idx[..., None].long(),
                       -(1.0 - eps) * in_shard[..., None].to(torch.float32))
        if eps > 0:
            g.sub_(eps / vocab)
        g.mul_(dloss[..., None])
        out = g.to(logits.dtype)
        del g
        return out, None, None, None


def vocab_parallel_cross_entropy(logits: torch.Tensor, target: torch.Tensor,
                                 label_smoothing: float = 0.0,
                                 impl: str = "auto") -> torch.Tensor:
    """Per-token loss over (..., V) logits and (...) integer targets;
    targets outside [0, V) contribute a zero target logit, as in the
    reference. The port runs tp=1: the reference's ``axis_name`` comes
    with the tp > 1 slice. ``impl``: ``auto`` (the tensor's device
    decides) or ``torch`` (the plain statistics)."""
    if logits.shape[:-1] != target.shape:
        raise ValueError(f"targets {tuple(target.shape)} must match the "
                         f"logits' leading dims {tuple(logits.shape[:-1])}")
    return _VocabParallelCE.apply(logits, target, float(label_smoothing),
                                  impl)


def masked_mean(losses: torch.Tensor,
                loss_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean per-token loss, optionally weighted by a 0/1 ``loss_mask``
    (1 = count); the 1.0 floor on the denominator keeps an all-masked batch
    finite (loss 0) instead of NaN (``:143-152``)."""
    if loss_mask is None:
        return losses.mean()
    m = loss_mask.to(losses.dtype)
    return (losses * m).sum() / torch.clamp(m.sum(), min=1.0)
