"""Port parity for ``contrib.multihead_attn``: apex_tpu_torch's
``SelfMultiheadAttn`` and ``EncdecMultiheadAttn`` (``nn.Module``s, the
reference's parameters loaded through ``models/convert.py``'s
``self_mha_from_jax``/``encdec_mha_from_jax``) against apex_tpu's
dataclass modules on seeded numpy inputs, forward and every parameter's
and input's gradient, over each option: biases, separate q/k/v, the
fused pre-norm and residual, causal, an additive ``attn_mask`` (sq, sk)
and (hb, sq, sk), ``key_padding_mask`` (the head-major bh-flat route),
``pad_lens`` (the bshd ``kv_lens`` route, alone and with ``attn_mask``),
and dropout 0.1 on each route with the reference's seed (the int its
``seed_from_key`` gives for the PRNG key, passed as ``key=``). Each of the
reference's refusals raises in the port too (the messages may differ).

The reference runs its own CPU dispatch (the XLA composition at these
short rows); the port its plain versions (CPU tensors). fp32,
full-precision matmuls. Tolerances: outputs within 1e-5, gradients within
2e-4 of their leaf's largest entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.contrib import multihead_attn as jm
from apex_tpu.ops.attention import seed_from_key as j_seed
from apex_tpu_torch.contrib import multihead_attn as tm
from apex_tpu_torch.models.convert import encdec_mha_from_jax, \
    self_mha_from_jax

E, H, B, SQ, SK = 64, 2, 2, 12, 16
O_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_RTOL = 2e-4


def _f(rng, *s):
    return rng.standard_normal(s).astype(np.float32)


def _close(name, got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=GRAD_RTOL * max(np.abs(want).max(),
                                                    1e-30), err_msg=name)


def _masks(rng, kind, sq, sk):
    """(reference kwargs, port kwargs) of one mask option."""
    if kind == "attn_mask":
        m = 0.5 * _f(rng, sq, sk)
        return dict(attn_mask=jnp.asarray(m)), dict(attn_mask=torch.tensor(m))
    if kind == "attn_mask_heads":
        m = 0.5 * _f(rng, H, sq, sk)
        return dict(attn_mask=jnp.asarray(m)), dict(attn_mask=torch.tensor(m))
    if kind == "key_padding_mask":
        kpm = np.zeros((B, sk), bool)
        kpm[1, sk - 5:] = True
        return (dict(key_padding_mask=jnp.asarray(kpm)),
                dict(key_padding_mask=torch.tensor(kpm)))
    if kind in ("pad_lens", "pad_lens_attn_mask"):
        lens = np.asarray([sk, sk - 6], np.int32)
        j, t = dict(pad_lens=jnp.asarray(lens)), dict(
            pad_lens=torch.tensor(lens))
        if kind == "pad_lens_attn_mask":
            m = 0.5 * _f(rng, sq, sk)
            j["attn_mask"], t["attn_mask"] = jnp.asarray(m), torch.tensor(m)
        return j, t
    return {}, {}


def _run_pair(jmod, params, tmod, j_args, t_args, cot, jkw, tkw):
    """Forward and the gradients of <out, cot> on both sides."""
    def jloss(p, *xs):
        return jnp.sum(jmod(p, *xs, **jkw) * cot), jmod(p, *xs, **jkw)
    with jax.default_matmul_precision("highest"):
        (_, jo), (jgp, *jgx) = jax.jit(jax.value_and_grad(
            jloss, argnums=tuple(range(1 + len(j_args))), has_aux=True))(
            params, *j_args)
    xs = [torch.tensor(np.asarray(a), requires_grad=True) for a in j_args]
    o = tmod(*xs, **tkw)
    o.backward(torch.tensor(cot))
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(jo), **O_TOL)
    for name, p in tmod.named_parameters():
        if name == "k_bias":  # an exact 0: softmax ignores a per-row shift
            assert np.abs(p.grad.numpy()).max() < 1e-5
            assert np.abs(np.asarray(jgp[name])).max() < 1e-5
            continue
        _close(name, p.grad.numpy(), jgp[name])
    for i, (x, g) in enumerate(zip(xs, jgx)):
        _close(f"input {i}", x.grad.numpy(), g)


SELF_CASES = [
    # (bias, separate_qkv_params, include_norm_add, causal, mask, dropout)
    pytest.param(True, True, True, True, None, 0.0, id="separate-norm-causal"),
    pytest.param(False, False, True, True, "attn_mask_heads", 0.1,
                 id="mask-heads-dropout"),
    pytest.param(True, False, True, False, "key_padding_mask", 0.1,
                 id="keypad-dropout"),
    pytest.param(False, True, False, False, "pad_lens", 0.1,
                 id="pad-lens-dropout"),
    pytest.param(True, False, True, True, "pad_lens_attn_mask", 0.0,
                 id="pad-lens-mask-causal"),
]


@pytest.mark.parametrize("bias,sep,norm,causal,mask,rate", SELF_CASES)
def test_self_mha_matches_reference(bias, sep, norm, causal, mask, rate):
    rng = np.random.default_rng(hash((bias, sep, norm, causal, mask,
                                      rate)) % 2 ** 31)
    jmod = jm.SelfMultiheadAttn(E, H, dropout=rate, bias=bias,
                                include_norm_add=norm,
                                separate_qkv_params=sep)
    params = jmod.init(jax.random.PRNGKey(3))
    # non-zero biases and norm parameters, so each gradient path shows
    params = {k: jnp.asarray(np.asarray(v) + 0.1 * _f(rng, *v.shape))
              for k, v in params.items()}
    tmod = tm.SelfMultiheadAttn(E, H, dropout=rate, bias=bias,
                                include_norm_add=norm,
                                separate_qkv_params=sep, device="cpu")
    self_mha_from_jax({k: np.asarray(v) for k, v in params.items()}, tmod)
    x, cot = _f(rng, B, SK, E), _f(rng, B, SK, E)
    jkw, tkw = _masks(rng, mask, SK, SK)
    jkey = jax.random.PRNGKey(11)
    if rate:
        jkw["key"], tkw["key"] = jkey, int(j_seed(jkey))
    _run_pair(jmod, params, tmod, [x], [x], cot, dict(jkw, causal=causal),
              dict(tkw, causal=causal))


ENCDEC_CASES = [
    pytest.param(True, True, "key_padding_mask", 0.1, id="keypad-dropout"),
    pytest.param(True, False, "pad_lens", 0.1, id="pad-lens-dropout"),
    pytest.param(False, False, "attn_mask", 0.0, id="mask"),
]


@pytest.mark.parametrize("bias,norm,mask,rate", ENCDEC_CASES)
def test_encdec_mha_matches_reference(bias, norm, mask, rate):
    rng = np.random.default_rng(hash((bias, norm, mask, rate)) % 2 ** 31)
    jmod = jm.EncdecMultiheadAttn(E, H, dropout=rate, bias=bias,
                                  include_norm_add=norm)
    params = jmod.init(jax.random.PRNGKey(5))
    params = {k: jnp.asarray(np.asarray(v) + 0.1 * _f(rng, *v.shape))
              for k, v in params.items()}
    tmod = tm.EncdecMultiheadAttn(E, H, dropout=rate, bias=bias,
                                  include_norm_add=norm, device="cpu")
    encdec_mha_from_jax({k: np.asarray(v) for k, v in params.items()}, tmod)
    q, mem, cot = _f(rng, B, SQ, E), _f(rng, B, SK, E), _f(rng, B, SQ, E)
    jkw, tkw = _masks(rng, mask, SQ, SK)
    jkey = jax.random.PRNGKey(17)
    if rate:
        jkw["key"], tkw["key"] = jkey, int(j_seed(jkey))
    _run_pair(jmod, params, tmod, [q, mem], [q, mem], cot, jkw, tkw)


def test_eval_mode_and_generator_key():
    """is_training=False (or module.eval()) runs dropout-free, equal to a
    rate-0 module; a torch.Generator key draws its seed (the same seed,
    the same output)."""
    rng = np.random.default_rng(1)
    x = torch.tensor(_f(rng, B, SK, E))
    mod = tm.SelfMultiheadAttn(E, H, dropout=0.1, device="cpu",
                               generator=torch.Generator().manual_seed(0))
    ref = tm.SelfMultiheadAttn(E, H, dropout=0.0, device="cpu",
                               generator=torch.Generator().manual_seed(0))
    want = ref(x)
    assert torch.equal(mod(x, is_training=False), want)
    assert torch.equal(mod.eval()(x), want)
    mod.train()
    a = mod(x, key=torch.Generator().manual_seed(9))
    b = mod(x, key=torch.Generator().manual_seed(9))
    assert torch.equal(a, b) and not torch.equal(a, want)


def test_refusals_match_reference():
    """Each case the reference refuses raises ValueError in the port."""
    jself = jm.SelfMultiheadAttn(E, H, dropout=0.1)
    params = jself.init(jax.random.PRNGKey(0))
    tself = tm.SelfMultiheadAttn(E, H, dropout=0.1, device="cpu")
    x = np.zeros((B, SK, E), np.float32)
    kpm = np.zeros((B, SK), bool)
    lens = np.full((B,), SK, np.int32)
    mask = np.zeros((SK, SK), np.float32)
    key = jax.random.PRNGKey(0)
    cases = [
        ({}, {}),  # dropout in training without a key
        (dict(key_padding_mask=kpm, pad_lens=lens), {}),
        (dict(key_padding_mask=kpm, attn_mask=mask), {}),
        (dict(key_padding_mask=kpm[:, :-1]), {}),
        (dict(attn_mask=np.zeros((3, SK, SK), np.float32)), {}),
        (dict(attn_mask=mask[:-1]), {}),
        (dict(pad_lens=lens[:1]), {}),
    ]
    for i, (kw, _) in enumerate(cases):
        jkw = {k: jnp.asarray(v) for k, v in kw.items()}
        tkw = {k: torch.tensor(v) for k, v in kw.items()}
        if i:
            jkw["key"], tkw["key"] = key, 1
        with pytest.raises(ValueError):
            jself(params, jnp.asarray(x), **jkw)
        with pytest.raises(ValueError):
            tself(torch.tensor(x), **tkw)
    with pytest.raises(ValueError, match="multiple"):
        tm.SelfMultiheadAttn(E, 3, device="cpu")
    with pytest.raises(ValueError, match="leaves"):
        self_mha_from_jax({"qkv_weight": np.zeros((3 * E, E))}, tself)
