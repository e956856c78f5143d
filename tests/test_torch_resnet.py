"""Port parity for ResNet-50: ``apex_tpu_torch.models.resnet`` against
``apex_tpu.models.resnet`` on the same weights (the reference's init,
moved over by ``models.convert``) and the same seeded numpy images, fp32.

A cut config (one bottleneck a stage, 10 classes) on 64² images, batch 4:
logits within 1e-5 of the largest, every new batch-norm state within
1e-5, the mean cross-entropy loss within 1e-5 relative, and every
gradient leaf within 2e-4 of the leaf's largest entry, in training and in
eval (on the state one training call left). The weight bridge both ways
bit for bit; the full config's parameter count from shapes alone.

The size is 64², not 32²: at 32² the last stages' batch norms see 4-16
rows, and a 1e-6 relative change of the images moves a gradient leaf of
the port itself by 1e-4 to 1e-1 (ReLU and max-pool near-ties, measured
over 4 seeds at batch 2-4), past any rounding-level tolerance. At 64²
that change moves no leaf by more than 1.1e-5; the test checks it.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.models.resnet import ResNet50 as JResNet50
from apex_tpu.models.resnet import ResNetConfig as JResNetConfig
from apex_tpu.ops import softmax_cross_entropy_loss as j_xent
from apex_tpu_torch.models.convert import (bn_state_from_jax,
                                           resnet_params_from_jax,
                                           resnet_params_to_jax)
from apex_tpu_torch.models.resnet import ResNet50, ResNetConfig
from apex_tpu_torch.ops.xentropy import softmax_cross_entropy_loss
from apex_tpu_torch.utils.pytree import tree_leaves, tree_map

OUT_TOL = 1e-5
LOSS_RTOL = 1e-5
GRAD_TOL = 2e-4
LAYERS, CLASSES, B, S = (1, 1, 1, 1), 10, 4, 64
#: the case must be well conditioned: a 1e-6 relative change of the
#: images may move each gradient leaf by at most this share of GRAD_TOL
CONDITION_SHARE = 0.25


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port_state_np(state):
    if isinstance(state, dict):
        return {k: _port_state_np(v) for k, v in state.items()}
    return {"running_mean": state.running_mean.numpy(),
            "running_var": state.running_var.numpy(),
            "num_batches_tracked": state.num_batches_tracked.numpy()}


def _ref_state_np(state):
    if isinstance(state, dict):
        return {k: _ref_state_np(v) for k, v in state.items()}
    return {"running_mean": np.asarray(state.running_mean),
            "running_var": np.asarray(state.running_var),
            "num_batches_tracked": np.asarray(state.num_batches_tracked)}


def _close(got, want, tol, what):
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(np.asarray(got, np.float64) - want).max())
    assert err <= tol * scale, f"{what}: {err} > {tol} x {scale}"


@pytest.fixture(scope="module")
def case():
    jmodel = JResNet50(JResNetConfig(layers=LAYERS, num_classes=CLASSES))
    jparams, jstate = jmodel.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, S, S, 3)).astype(np.float32)
    y = rng.integers(0, CLASSES, (B,)).astype(np.int32)

    def loss_fn(params, state, training):
        logits, new_state = jmodel.apply(params, state, jnp.asarray(x),
                                         training=training)
        return jnp.mean(j_xent(logits, jnp.asarray(y))), (logits, new_state)

    grad = jax.jit(jax.value_and_grad(loss_fn, has_aux=True),
                   static_argnums=2)
    (loss_t, (logits_t, state_t)), g_t = grad(jparams, jstate, True)
    (loss_e, (logits_e, _)), g_e = grad(jparams, state_t, False)
    ref = {"train": (float(loss_t), np.asarray(logits_t), _np(g_t),
                     _ref_state_np(state_t)),
           "eval": (float(loss_e), np.asarray(logits_e), _np(g_e), None)}
    return _np(jparams), _np(jstate), _np(state_t), x, y, ref


def _port_step(cfg, params_np, state_np, x, y, training):
    """(loss, logits, gradients in the reference's layout, new state)."""
    model = ResNet50(cfg)
    params = resnet_params_from_jax(params_np, cfg, device="cpu")
    state = bn_state_from_jax(state_np, device="cpu")
    for t in tree_leaves(params):
        t.requires_grad_(True)
    logits, new_state = model.apply(params, state, torch.tensor(x),
                                    training=training)
    loss = softmax_cross_entropy_loss(logits, torch.tensor(y).long()).mean()
    loss.backward()
    grads = resnet_params_to_jax(tree_map(lambda t: t.grad, params), cfg)
    return loss.item(), logits.detach().numpy(), grads, new_state


@pytest.mark.parametrize("mode", ["train", "eval"])
def test_resnet_matches_reference(case, mode):
    params_np, state0_np, state_t_np, x, y, ref = case
    cfg = ResNetConfig(layers=LAYERS, num_classes=CLASSES)
    training = mode == "train"
    loss, logits, grads, new_state = _port_step(
        cfg, params_np, state0_np if training else state_t_np, x, y,
        training)
    loss_r, logits_r, grads_r, state_r = ref[mode]
    _close(logits, logits_r, OUT_TOL, "logits")
    assert abs(loss - loss_r) <= LOSS_RTOL * abs(loss_r), (loss, loss_r)
    flat_r = dict(jax.tree_util.tree_flatten_with_path(grads_r)[0])
    flat_p = dict(jax.tree_util.tree_flatten_with_path(grads)[0])
    assert flat_r.keys() == flat_p.keys()
    for path, want in flat_r.items():
        _close(flat_p[path], want, GRAD_TOL, jax.tree_util.keystr(path))
    if training:
        got_state = _port_state_np(new_state)
        for path, want in jax.tree_util.tree_flatten_with_path(state_r)[0]:
            got = got_state
            for k in path:
                got = got[k.key]
            if path[-1].key == "num_batches_tracked":
                assert int(got) == int(want) == 1
            else:
                _close(got, want, OUT_TOL, jax.tree_util.keystr(path))
    else:  # eval returns the state it was given
        assert new_state is not None
        assert (new_state["bn1"].running_mean.numpy()
                == state_t_np["bn1"].running_mean).all()


def test_case_is_well_conditioned(case):
    """The parity case's gradients barely move under a 1e-6 relative
    change of the images, so the 2e-4 tolerance measures the port and
    not a near-tie."""
    params_np, state0_np, _, x, y, _ = case
    cfg = ResNetConfig(layers=LAYERS, num_classes=CLASSES)
    g0 = _port_step(cfg, params_np, state0_np, x, y, True)[2]
    g1 = _port_step(cfg, params_np, state0_np, x * np.float32(1 + 1e-6),
                    y, True)[2]
    for (path, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(g1)[0],
                                 jax.tree_util.tree_flatten_with_path(g0)[0]):
        _close(a, b, CONDITION_SHARE * GRAD_TOL, jax.tree_util.keystr(path))


def test_weight_bridge_round_trips(case):
    params_np = case[0]
    cfg = ResNetConfig(layers=LAYERS, num_classes=CLASSES)
    port = resnet_params_from_jax(params_np, cfg, device="cpu")
    assert tuple(port["conv1"].shape) == (64, 3, 7, 7)
    assert tuple(port["s0b0"]["conv_b"].shape) == (64, 64, 3, 3)
    assert tuple(port["fc_w"].shape) == (CLASSES, 2048)
    np.testing.assert_array_equal(
        port["s1b0"]["conv_b"].numpy(),
        np.transpose(params_np["s1b0"]["conv_b"], (3, 2, 0, 1)))
    back = resnet_params_to_jax(port, cfg)
    for (pa, want), (pb, got) in zip(
            jax.tree_util.tree_flatten_with_path(params_np)[0],
            jax.tree_util.tree_flatten_with_path(back)[0]):
        assert pa == pb
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="ResNetConfig"):
        resnet_params_from_jax(params_np, ResNetConfig(
            layers=LAYERS, num_classes=CLASSES + 1), device="cpu")


def test_full_config_parameter_count_from_shapes():
    shapes = ResNet50(ResNetConfig()).param_shapes()
    count = sum(math.prod(s) for s in jax.tree.leaves(
        shapes, is_leaf=lambda s: isinstance(s, tuple)))
    assert count == 25_557_032  # torchvision's ResNet-50
    blocks = list(ResNet50(ResNetConfig()).blocks())
    assert len(blocks) == 16
    assert [b[1] for b in blocks if b[0].endswith("b0")] == [1, 2, 2, 2]


def test_init_shapes_and_distributions():
    model = ResNet50(ResNetConfig(layers=LAYERS, num_classes=CLASSES))
    params, state = model.init(torch.Generator().manual_seed(0),
                               device="cpu")
    shapes = model.param_shapes()
    got = tree_map(lambda t: tuple(t.shape), params)
    assert got == shapes
    w = params["s0b0"]["conv_b"]
    assert abs(w.std().item() - math.sqrt(2 / (64 * 9))) < 0.1 * math.sqrt(
        2 / (64 * 9))
    assert params["s0b0"]["bn_c"]["scale"].eq(1).all()
    assert state["s3b0"]["bn_proj"].running_var.eq(1).all()
    with pytest.raises(TypeError, match="item 6"):
        ResNetConfig(bn_axis="dp")
