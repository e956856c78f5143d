"""Port parity for the T5 train step: apex_tpu_torch's
``EncoderDecoderModel.loss_fn``, its gradients and three FusedAdam steps
against apex_tpu's ``EncoderDecoderModel`` with ``attention_impl="flash"``,
on the same weights (the reference's own init, through the weight bridge)
and the same seeded tokens.

The reference runs once with its Pallas kernels in interpret mode
(``APEX_TPU_PALLAS=interpret``: the bh-flat ``flash_fwd``/``flash_bwd``
with kv_lens, the in-kernel bucketed bias and the ``_dtable_pallas`` table
gradient, the xent statistics) and once on its XLA paths (``=0``); the
port runs its plain versions (CPU tensors). fp32, full-precision matmuls
on both sides. Tolerances: the loss to 1e-5 relative; every gradient leaf,
the two bucket tables included, to 2e-4 relative of its largest entry;
after 3 Adam steps m and v to 1e-4 of the leaf's largest entry, params to
1e-6 of it except where the reference's gradient entry was below 1e-3 of
its leaf's largest in some step, and those within 3·lr: Adam divides by
sqrt(v), so an entry whose gradient is near zero takes an lr-sized step
whose size fp32 noise decides (test_torch_train.py states the same
cause; measured here, 13 such entries of ~700k, each with a relative
gradient of 3e-4 or less).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from apex_tpu.models.t5 import EncoderDecoderModel as JModel
from apex_tpu.models.t5 import T5Config as JConfig
from apex_tpu.models.t5 import relative_bias as j_relative_bias
from apex_tpu.optimizers import fused_adam
from apex_tpu_torch.models.convert import t5_params_from_jax, t5_params_to_jax
from apex_tpu_torch.models.t5 import (EncoderDecoderModel, T5Config,
                                      param_leaves, relative_bias)
from apex_tpu_torch.ops import attention as amod
from apex_tpu_torch.optimizers import FusedAdam

torch.backends.cuda.matmul.allow_tf32 = False

SMALL = dict(vocab_size=256, max_seq_len=128, hidden_size=128,
             num_encoder_layers=1, num_decoder_layers=1, num_heads=2,
             relative_num_buckets=32, relative_max_distance=64)
B, S_ENC = 2, 128
LOSS_RTOL = 1e-5
GRAD_RTOL = 2e-4


def _tree(position_encoding, seed=0):
    jm = JModel(JConfig(**SMALL, attention_impl="flash", remat=False,
                        position_encoding=position_encoding))
    jp = jm.init(jax.random.PRNGKey(seed))
    # non-unit LN affines so every leaf's gradient path matters
    rng = np.random.default_rng(seed + 1)
    tree = jax.tree.map(lambda a: np.asarray(a) + 0.02 * rng.standard_normal(
        a.shape).astype(np.float32), jp)
    return jm, tree


def _batch(s_dec, seed=2):
    rng = np.random.default_rng(seed)
    V = SMALL["vocab_size"]
    return (rng.integers(0, V, (B, S_ENC)).astype(np.int32),
            rng.integers(0, V, (B, s_dec)).astype(np.int32),
            rng.integers(0, V, (B, s_dec)).astype(np.int32))


def _port(tree, position_encoding, remat=False, remat_policy="blocks"):
    cfg = T5Config(**SMALL, position_encoding=position_encoding, remat=remat,
                   remat_policy=remat_policy, attention_impl="flash")
    params = t5_params_from_jax(tree, cfg, device="cpu")
    for t in param_leaves(params):
        t.requires_grad_()
    return EncoderDecoderModel(cfg), cfg, params


def _grads(params):
    def walk(x):
        if isinstance(x, torch.Tensor):
            return x.grad
        if isinstance(x, dict):
            return {k: walk(v) for k, v in x.items()}
        return [walk(v) for v in x]
    return walk(params)


def _assert_trees_close(got, want, rel, what):
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert len(flat_g) == len(flat_w)
    for path, w in flat_w:
        w = np.asarray(w, np.float32)
        g = flat_g[path]
        scale = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(
            g, w, rtol=0, atol=rel * scale,
            err_msg=f"{what} {jax.tree_util.keystr(path)}")


def _torch(*arrays):
    return [None if a is None else torch.tensor(a) for a in arrays]


@pytest.mark.parametrize("pallas", ["interpret", "0"])
@pytest.mark.parametrize("pe,s_dec,pad", [
    pytest.param("relative", 128, [100, 128], id="relative-padded"),
    pytest.param("learned", 128, None, id="learned"),
    # decoder length 114 (T5's target length): the reference's decoder
    # attention takes its XLA path, its encoder the kernels
    pytest.param("relative", 114, [128, 77], id="relative-dec114"),
])
def test_loss_and_every_gradient_match_reference(pallas, pe, s_dec, pad,
                                                 monkeypatch):
    monkeypatch.setenv("APEX_TPU_PALLAS", pallas)
    jm, tree = _tree(pe)
    enc, dec, tgt = _batch(s_dec)
    lens = None if pad is None else np.asarray(pad, np.int32)
    jp = jax.tree.map(jnp.asarray, tree)
    with jax.default_matmul_precision("highest"):
        loss_j, grads_j = jax.jit(jax.value_and_grad(lambda p: jm.loss_fn(
            p, jnp.asarray(enc), jnp.asarray(dec), jnp.asarray(tgt),
            enc_pad_lens=None if lens is None else jnp.asarray(lens))))(jp)
    model, cfg, params = _port(tree, pe)
    loss = model.loss_fn(params, *_torch(enc, dec, tgt),
                         enc_pad_lens=None if lens is None
                         else torch.tensor(lens))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=LOSS_RTOL)
    _assert_trees_close(t5_params_to_jax(_grads(params), cfg), grads_j,
                        GRAD_RTOL, "grad")


def test_remat_and_loss_mask_match():
    """Per-block recompute gives the same loss and gradients; a loss mask
    weights the mean as the reference's masked_mean does."""
    _, tree = _tree("relative")
    enc, dec, tgt = _batch(128)
    mask = (np.random.default_rng(3).random(dec.shape) < 0.6).astype(
        np.float32)
    out = []
    for remat in (False, True):
        model, cfg, params = _port(tree, "relative", remat=remat)
        loss = model.loss_fn(params, *_torch(enc, dec, tgt),
                             loss_mask=torch.tensor(mask),
                             enc_pad_lens=torch.tensor([90, 128]))
        loss.backward()
        out.append((loss.detach(), param_leaves(_grads(params))))
    torch.testing.assert_close(out[1][0], out[0][0], rtol=0, atol=0)
    for a, b in zip(out[1][1], out[0][1]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("pallas", ["interpret", "0"])
def test_three_train_steps_match_reference(pallas, monkeypatch):
    """value_and_grad(loss_fn), one fused_adam(1e-3) update and
    optax.apply_updates, three times, against loss_fn, backward() and
    FusedAdam.step()."""
    monkeypatch.setenv("APEX_TPU_PALLAS", pallas)
    jm, tree = _tree("relative")
    enc, dec, tgt = _batch(128)
    lens = np.asarray([100, 128], np.int32)
    lr = 1e-3
    opt = fused_adam(learning_rate=lr)

    @jax.jit
    def train_step(params, opt_state):
        loss, grads = jax.value_and_grad(jm.loss_fn)(
            params, jnp.asarray(enc), jnp.asarray(dec), jnp.asarray(tgt),
            enc_pad_lens=jnp.asarray(lens))
        updates, opt_state = opt.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss, grads

    def rel_size(g):  # |g| over the leaf's largest |g|
        g = np.abs(np.asarray(g, np.float32))
        return g / max(float(g.max()), 1e-30)

    pj = jax.tree.map(jnp.asarray, tree)
    state = opt.init(pj)
    model, cfg, params = _port(tree, "relative", remat=True)
    topt = FusedAdam(param_leaves(params), lr=lr)
    args = _torch(enc, dec, tgt)
    with jax.default_matmul_precision("highest"):
        for step in range(3):
            pj, state, loss_j, grads_j = train_step(pj, state)
            sizes = jax.tree.map(rel_size, grads_j)
            small = sizes if step == 0 else jax.tree.map(
                np.minimum, small, sizes)
            loss = model.loss_fn(params, *args,
                                 enc_pad_lens=torch.tensor(lens))
            loss.backward()
            topt.step()
            topt.zero_grad()
            np.testing.assert_allclose(loss.item(), float(loss_j),
                                       rtol=LOSS_RTOL, err_msg=f"step {step}")
    assert int(state.count) == 3
    flat_w = jax.tree_util.tree_flatten_with_path(pj)[0]
    flat_g = dict(jax.tree_util.tree_flatten_with_path(
        t5_params_to_jax(params, cfg))[0])
    flat_small = dict(jax.tree_util.tree_flatten_with_path(small)[0])
    for path, w in flat_w:
        w = np.asarray(w, np.float32)
        diff = np.abs(flat_g[path] - w)
        where = f"param {jax.tree_util.keystr(path)}"
        loose = diff > 1e-6 * np.abs(w).max()
        assert (flat_small[path][loose] < 1e-3).all(), where
        assert (diff <= 3 * lr).all(), where
    for name, key in (("m", "exp_avg"), ("v", "exp_avg_sq")):
        moments = {id(t): topt.state[t][key] for t in param_leaves(params)}

        def swap(x):
            if isinstance(x, torch.Tensor):
                return moments[id(x)]
            if isinstance(x, dict):
                return {k: swap(v) for k, v in x.items()}
            return [swap(v) for v in x]
        _assert_trees_close(t5_params_to_jax(swap(params), cfg),
                            state.buffers[name], 1e-4, name)


@pytest.mark.parametrize("pallas", ["interpret", "0"])
def test_encode_only_matches_reference(pallas, monkeypatch):
    """``remat_policy="encode_only"`` (``t5.py:425-431``): the whole
    encoder one checkpoint, the decoder not rematted — the loss and every
    gradient against the reference under the same policy, on a padded
    batch with the relative bias."""
    monkeypatch.setenv("APEX_TPU_PALLAS", pallas)
    _, tree = _tree("relative")
    jm = JModel(JConfig(**SMALL, attention_impl="flash", remat=True,
                        remat_policy="encode_only",
                        position_encoding="relative"))
    enc, dec, tgt = _batch(128)
    lens = np.asarray([100, 128], np.int32)
    jp = jax.tree.map(jnp.asarray, tree)
    with jax.default_matmul_precision("highest"):
        loss_j, grads_j = jax.jit(jax.value_and_grad(lambda p: jm.loss_fn(
            p, jnp.asarray(enc), jnp.asarray(dec), jnp.asarray(tgt),
            enc_pad_lens=jnp.asarray(lens))))(jp)
    model, cfg, params = _port(tree, "relative", remat=True,
                               remat_policy="encode_only")
    loss = model.loss_fn(params, *_torch(enc, dec, tgt),
                         enc_pad_lens=torch.tensor(lens))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=LOSS_RTOL)
    _assert_trees_close(t5_params_to_jax(_grads(params), cfg), grads_j,
                        GRAD_RTOL, "grad")


def test_encode_only_equals_blocks():
    """The two remat policies recompute different spans of the same
    operations: the same loss, the gradients within 1e-6 of each other."""
    _, tree = _tree("relative")
    enc, dec, tgt = _batch(128)
    out = []
    for policy in ("blocks", "encode_only"):
        model, cfg, params = _port(tree, "relative", remat=True,
                                   remat_policy=policy)
        loss = model.loss_fn(params, *_torch(enc, dec, tgt),
                             enc_pad_lens=torch.tensor([90, 128]))
        loss.backward()
        out.append((loss.detach(), param_leaves(_grads(params))))
    torch.testing.assert_close(out[1][0], out[0][0], rtol=0, atol=0)
    for a, b in zip(out[1][1], out[0][1]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("bidirectional", [True, False])
def test_relative_bias_matches_reference(bidirectional):
    table = np.random.default_rng(5).standard_normal((32, 3)).astype(
        np.float32)
    kw = dict(bidirectional=bidirectional, num_buckets=32, max_distance=128)
    want = np.asarray(j_relative_bias(jnp.asarray(table), 114, 300, **kw))
    got = relative_bias(torch.tensor(table), 114, 300, **kw).numpy()
    np.testing.assert_array_equal(got, want)


def test_weight_bridge_round_trip_and_shape_checks():
    _, tree = _tree("relative")
    cfg = T5Config(**SMALL, position_encoding="relative")
    params = t5_params_from_jax(tree, cfg, device="cpu")
    assert len(params["encoder"]) == 1 and len(params["decoder"]) == 1
    back = t5_params_to_jax(params, cfg)
    for path, w in jax.tree_util.tree_flatten_with_path(tree)[0]:
        got = dict(jax.tree_util.tree_flatten_with_path(back)[0])[path]
        np.testing.assert_array_equal(got, w)
    with pytest.raises(ValueError, match="rel_bias_enc"):
        t5_params_from_jax(tree, T5Config(**dict(
            SMALL, relative_num_buckets=16), position_encoding="relative"),
            device="cpu")
    with pytest.raises(ValueError, match="encoder"):
        t5_params_from_jax(tree, T5Config(**dict(
            SMALL, num_encoder_layers=2), position_encoding="relative"),
            device="cpu")
    model = EncoderDecoderModel(cfg)
    own = model.init(torch.Generator().manual_seed(0), device="cpu")
    assert [tuple(t.shape) for t in param_leaves(own)] == [
        tuple(t.shape) for t in param_leaves(params)]


def test_knobs_of_later_slices_raise():
    """The reference's knobs with one working value in the port are not
    config fields, and dropout with an array bias raises at the op;
    ``relative_bias_impl`` (its second value, "materialized", runs through
    the array bias), ``remat_policy`` (blocks | encode_only) and
    ``attention_impl`` (softmax | flash) are fields, validated as the
    reference validates them."""
    for kw in (dict(tp_overlap=False), dict(plan=None)):
        with pytest.raises(TypeError, match=next(iter(kw))):
            T5Config(**SMALL, **kw)
    with pytest.raises(ValueError, match="remat_policy"):
        T5Config(**SMALL, remat_policy="decode_only")
    with pytest.raises(ValueError, match="attention_impl"):
        T5Config(**SMALL, attention_impl="naive")
    with pytest.raises(ValueError, match="position_encoding"):
        T5Config(**SMALL, position_encoding="rotary")
    with pytest.raises(ValueError, match="relative_bias_impl"):
        T5Config(**SMALL, relative_bias_impl="dense")
    x = torch.zeros((1, 2, 128, 64))
    assert amod.flash_attention(
        x, x, x, bias=torch.zeros((2, 128, 128))).shape == x.shape
    with pytest.raises(NotImplementedError, match="dropout"):
        amod.flash_attention(x, x, x, bias=torch.zeros((2, 128, 128)),
                             dropout_rate=0.1, dropout_seed=torch.tensor(1))


@pytest.mark.parametrize("pallas", ["interpret", "0"])
def test_materialized_bias_matches_reference(pallas, monkeypatch):
    """``relative_bias_impl="materialized"``: the (h, sq, sk) fp32 array
    through flash_attention's array bias (the reference's ``_dbias_pallas``
    under interpret mode), the tables' gradients through the gather —
    against the reference's materialized mode on the same weights."""
    monkeypatch.setenv("APEX_TPU_PALLAS", pallas)
    _, tree = _tree("relative")
    jm = JModel(JConfig(**SMALL, attention_impl="flash", remat=False,
                        position_encoding="relative",
                        relative_bias_impl="materialized"))
    enc, dec, tgt = _batch(128)
    lens = np.asarray([100, 128], np.int32)
    jp = jax.tree.map(jnp.asarray, tree)
    with jax.default_matmul_precision("highest"):
        loss_j, grads_j = jax.jit(jax.value_and_grad(lambda p: jm.loss_fn(
            p, jnp.asarray(enc), jnp.asarray(dec), jnp.asarray(tgt),
            enc_pad_lens=jnp.asarray(lens))))(jp)
    cfg = T5Config(**SMALL, position_encoding="relative",
                   relative_bias_impl="materialized", remat=True,
                   attention_impl="flash")
    params = t5_params_from_jax(tree, cfg, device="cpu")
    for t in param_leaves(params):
        t.requires_grad_()
    loss = EncoderDecoderModel(cfg).loss_fn(
        params, *_torch(enc, dec, tgt), enc_pad_lens=torch.tensor(lens))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=LOSS_RTOL)
    _assert_trees_close(t5_params_to_jax(_grads(params), cfg), grads_j,
                        GRAD_RTOL, "grad")


def test_materialized_bias_matches_bucketed():
    """The port's two bias modes on the same params and batch: the same
    loss and gradients (the tables' included), the materialized mode's
    table gradient arriving through the gather of
    ``BucketedBias.materialize``."""
    _, tree = _tree("relative")
    enc, dec, tgt = _batch(114)
    out = {}
    for impl in ("bucketed", "materialized"):
        cfg = T5Config(**SMALL, position_encoding="relative",
                       relative_bias_impl=impl, attention_impl="flash")
        params = t5_params_from_jax(tree, cfg, device="cpu")
        for t in param_leaves(params):
            t.requires_grad_()
        model = EncoderDecoderModel(cfg)
        bias = model.enc_bias(params, S_ENC, S_ENC)
        assert isinstance(bias, amod.BucketedBias) == (impl == "bucketed")
        loss = model.loss_fn(params, *_torch(enc, dec, tgt),
                             enc_pad_lens=torch.tensor([128, 77]))
        loss.backward()
        out[impl] = (loss.item(), t5_params_to_jax(_grads(params), cfg))
    np.testing.assert_allclose(out["materialized"][0], out["bucketed"][0],
                               rtol=LOSS_RTOL)
    _assert_trees_close(out["materialized"][1], out["bucketed"][1],
                        GRAD_RTOL, "grad")
    assert np.abs(out["materialized"][1]["rel_bias_enc"]).max() > 0
