"""The O1 per-op cast tables and the cast every op applies.

Port of ``apex_tpu/amp/lists.py``: the four tables over op families —
``HALF_OPS`` (matmul-shaped: run in the compute dtype), ``FLOAT_OPS``
(numerically sensitive: fp32), ``PROMOTE_OPS`` (the widest input dtype)
and ``BANNED_OPS`` (unsafe in half precision) — the registries that move a
name between them (apex's ``register_half_function`` and friends, also in
their ``(module, name)`` spelling), :func:`check_banned`,
:func:`op_cast_dtype` and :func:`apply_op_rules`, which the ported ops call
on their floating inputs where the reference's do. It is the identity
unless the policy has ``per_op_rules`` (O1), so O0, O2 and O3 pay one
thread-local read. PROMOTE takes :func:`torch.promote_types` over the
inputs, as the reference takes ``jnp.result_type``.
"""

from __future__ import annotations

import functools

import torch

from apex_tpu_torch.amp.policy import current_policy

HALF_OPS = {
    "conv", "conv1d", "conv2d", "conv3d", "conv_transpose",
    "dense", "linear", "matmul", "bmm", "einsum", "attention", "mlp",
    "rnn", "lstm", "gru",
}

FLOAT_OPS = {
    "softmax", "log_softmax", "layer_norm", "rms_norm", "batch_norm",
    "group_norm", "cross_entropy", "nll_loss", "mse_loss", "l1_loss",
    "smooth_l1_loss", "kl_div", "cosine_similarity", "focal_loss",
    "exp", "log", "log1p", "pow", "erf", "erfinv", "softplus",
    "sum", "prod", "cumsum", "cumprod", "norm", "mean", "var", "std",
}

PROMOTE_OPS = {
    "add", "sub", "mul", "div", "addcmul", "addcdiv",
    "cat", "stack", "concatenate", "where", "equal", "dot",
}

BANNED_OPS = {
    "binary_cross_entropy": (
        "binary_cross_entropy on half inputs is numerically unsafe; compute "
        "the loss in fp32 (policy.cast_to_output) or use "
        "sigmoid_cross_entropy_with_logits"
    ),
}


def register_half_op(name: str) -> None:
    """Run ``name`` in the compute dtype under O1
    (``amp.register_half_function``)."""
    FLOAT_OPS.discard(name)
    HALF_OPS.add(name)


def register_float_op(name: str) -> None:
    HALF_OPS.discard(name)
    FLOAT_OPS.add(name)


def register_promote_op(name: str) -> None:
    HALF_OPS.discard(name)
    FLOAT_OPS.discard(name)
    PROMOTE_OPS.add(name)


def _ref_spelling(register):
    """apex's ``amp.register_half_function(module, 'fn')`` spelling: the
    tables key on the op name alone, so the module is accepted and
    ignored."""

    def wrapper(module_or_name, function_name: str | None = None) -> None:
        register(function_name if function_name is not None
                 else module_or_name)

    wrapper.__doc__ = _ref_spelling.__doc__
    return wrapper


register_half_function = _ref_spelling(register_half_op)
register_float_function = _ref_spelling(register_float_op)
register_promote_function = _ref_spelling(register_promote_op)

_HALF_DTYPES = (torch.float16, torch.bfloat16)


def check_banned(name: str, *input_dtypes) -> None:
    """Raise for an op of ``BANNED_OPS`` when a half input is present (or
    no dtype is given), as apex's ``err_if_any_half``."""
    if name in BANNED_OPS and (
            not input_dtypes or any(dt in _HALF_DTYPES
                                    for dt in input_dtypes)):
        raise RuntimeError(f"amp: {BANNED_OPS[name]}")


def op_cast_dtype(op: str, policy, *input_dtypes) -> torch.dtype:
    """The dtype ``policy`` computes ``op`` in: without per-op rules its
    compute dtype; under O1 HALF → the compute dtype, FLOAT → fp32,
    PROMOTE or unknown → the widest input dtype (the compute dtype with
    none)."""
    if not getattr(policy, "per_op_rules", False):
        return policy.compute_dtype
    check_banned(op, *input_dtypes)
    if op in HALF_OPS:
        return policy.compute_dtype
    if op in FLOAT_OPS:
        return torch.float32
    if input_dtypes:
        return functools.reduce(torch.promote_types, input_dtypes)
    return policy.compute_dtype


def _is_float_tensor(a) -> bool:
    return isinstance(a, torch.Tensor) and a.is_floating_point()


def apply_op_rules(op: str, *tensors, policy=None) -> tuple:
    """``tensors`` cast to the dtype the (ambient) policy gives ``op``:
    the identity unless the policy has per-op rules; ``None`` and
    non-float tensors pass through. Under autograd the cast is an op like
    any other, so gradients reach the uncast tensors in their own dtype."""
    if policy is None:
        policy = current_policy()
    if not getattr(policy, "per_op_rules", False):
        return tensors
    in_dtypes = [a.dtype for a in tensors if _is_float_tensor(a)]
    target = op_cast_dtype(op, policy, *in_dtypes)
    return tuple(a.to(target) if _is_float_tensor(a) and a.dtype != target
                 else a for a in tensors)
