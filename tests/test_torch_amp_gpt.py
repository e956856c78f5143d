"""Port parity for amp on GPT: a small GPT (2 layers, hidden 128, 2 heads of
64, vocab 256, seq 64, the flash route) on every route an amp policy
reaches, against the reference on the same weights (the reference's own
init through the weight bridge, with noise on every leaf) and tokens.

The reference runs its XLA paths (``APEX_TPU_PALLAS=0``): fp16 lands there
by design (Mosaic has no f16), and the port's plain versions (CPU tensors)
are the kernels' arithmetic. TF32 off here, ``highest`` matmul precision
there.

* O0 at fp32: the loss to 1e-5 relative, every gradient leaf to 2e-4 of
  its largest entry (``test_torch_train.py``'s bounds).
* O1, O2 and O3 at bf16 and at fp16: every gradient leaf's dtype is the
  reference's (O1 on :data:`FUSED`'s config, 1 head of 128 over 128
  positions, where the reference takes the fused flash route the port
  ports, its kernels in interpret mode), and the loss and each leaf are as
  close to an fp32 truth
  (the reference's O0 gradients) as the reference's own: error <= 2x the
  reference's + 1e-3, the errors measured relative to the truth's largest
  entry (the loss: to its value).
* A 6-step fp16 O2 run in the flagship's structure
  (``scaled_value_and_grad`` -> ``skip_step_if_nonfinite(FusedAdam)`` ->
  ``apply_updates_with_master``) from ``init_scale=2**24``: the scaler's
  state and the finite flag equal the reference's at every step, and the
  masters and Adam moments after the run match within the fp16 bound
  stated at the test.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import amp as japp
from apex_tpu.models.gpt import GPTConfig as JGPTConfig
from apex_tpu.models.gpt import GPTModel as JGPTModel
from apex_tpu.optimizers import fused_adam
from apex_tpu_torch import amp
from apex_tpu_torch.models.convert import params_from_jax, params_to_jax
from apex_tpu_torch.models.gpt import GPTConfig, GPTModel
from apex_tpu_torch.optimizers import FusedAdam
from apex_tpu_torch.utils.pytree import tree_leaves, tree_map

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

SMALL = dict(vocab_size=256, max_seq_len=64, hidden_size=128, num_layers=2,
             num_heads=2)
B = 2
#: O1's flash route as the reference takes it: its fused packed-QKV gate
#: (``gpt.py:387-392``) wants head_dim 128 and 128-multiple sequences (and
#: bf16: fp16 lands on its head-batched XLA route, which casts q, k and v
#: only); at head_dim 64 the reference's O1 runs that route, which the
#: port does not have
FUSED = dict(SMALL, num_heads=1, max_seq_len=128)
HALVES = {"bf16": (torch.bfloat16, jnp.bfloat16),
          "fp16": (torch.float16, jnp.float16)}
T2J = {torch.float32: jnp.dtype(jnp.float32),
       torch.bfloat16: jnp.dtype(jnp.bfloat16),
       torch.float16: jnp.dtype(jnp.float16)}
#: the flagship run's batch: at this seed's data the reference's fp16
#: gradients first stay finite at a loss scale of 2**20.52, so from 2**24
#: the dynamic scaler sees 4 overflows, then finite steps at 2**20
FLAG_BATCH = 32


def _setup(small):
    jm = JGPTModel(JGPTConfig(**small, tp_size=1, remat=False,
                              attention_impl="flash"))
    jp = jm.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    tree = jax.tree.map(lambda a: np.asarray(a) + 0.02 * rng.standard_normal(
        a.shape).astype(np.float32), jp)
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, small["vocab_size"], (B, small["max_seq_len"]))
    targets = rng.integers(0, small["vocab_size"], (B, small["max_seq_len"]))
    cfg = GPTConfig(**small, attention_impl="flash", remat=False)
    return (jm, tree, tokens.astype(np.int32), targets.astype(np.int32),
            GPTModel(cfg), cfg)


@pytest.fixture(scope="module")
def setup():
    return _setup(SMALL)


@pytest.fixture(scope="module")
def setup_fused():
    return _setup(FUSED)


@pytest.fixture(autouse=True)
def xla_reference(monkeypatch):
    monkeypatch.setenv("APEX_TPU_PALLAS", "0")



def _jgrads(jm, params, tokens, targets, policy=None):
    def f(p):
        return jm.loss_fn(p, jnp.asarray(tokens), jnp.asarray(targets))

    with jax.default_matmul_precision("highest"):
        if policy is None:
            loss, g = jax.value_and_grad(f)(params)
        else:
            with japp.with_policy(policy):
                loss, g = jax.value_and_grad(f)(params)
    return float(loss), g


def _tgrads(model, params, tokens, targets, policy=None):
    for t in tree_leaves(params):
        t.requires_grad_()
    if policy is None:
        loss = model.loss_fn(params, torch.tensor(tokens),
                             torch.tensor(targets))
    else:
        with amp.with_policy(policy):
            loss = model.loss_fn(params, torch.tensor(tokens),
                                 torch.tensor(targets))
    loss.backward()
    return loss.item(), tree_map(lambda t: t.grad, params)


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v) for k, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_o0_fp32_matches_reference(setup):
    jm, tree, tokens, targets, model, cfg = setup
    loss_j, g_j = _jgrads(jm, jax.tree.map(jnp.asarray, tree), tokens,
                          targets, japp.O0)
    params = params_from_jax(tree, cfg, device="cpu")
    loss_t, g_t = _tgrads(model, params, tokens, targets, amp.O0)
    np.testing.assert_allclose(loss_t, loss_j, rtol=1e-5)
    got, want = _flat(params_to_jax(g_t, cfg)), _flat(g_j)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=0,
                                   atol=2e-4 * np.abs(w).max(), err_msg=k)


@pytest.mark.parametrize("half", list(HALVES))
@pytest.mark.parametrize("level", ["O1", "O2", "O3"])
def test_mixed_precision_routes_match_reference(setup, setup_fused, level,
                                                half, monkeypatch):
    """Each level's route: O1 (fp32 params, the flash route's x and
    weights cast to the half type, norms and the loss fp32; on
    :data:`FUSED`'s config, where the reference's fused route runs, its
    kernels in interpret mode), O2 (half model params derived from fp32
    masters), O3 (half params). The leaves' dtypes, and each leaf's and the
    loss's error from the fp32 truth against the reference's own."""
    if level == "O1":
        monkeypatch.setenv("APEX_TPU_PALLAS", "interpret")
        setup = setup_fused
    jm, tree, tokens, targets, model, cfg = setup
    tdt, jdt = HALVES[half]
    jpol = japp.get_policy(level, half_dtype=jdt)
    pol = amp.get_policy(level, half_dtype=tdt)
    loss_true, g_true = _jgrads(jm, jax.tree.map(jnp.asarray, tree), tokens,
                                targets)
    j32 = jax.tree.map(jnp.asarray, tree)
    t32 = params_from_jax(tree, cfg, device="cpu")
    if level == "O1":
        jparams, tparams = j32, t32
    elif level == "O2":
        jparams = japp.MasterWeights.create(j32, jpol).model
        tparams = amp.MasterWeights.create(t32, pol).model
    else:
        jparams, tparams = jpol.cast_to_param(j32), pol.cast_to_param(t32)
    loss_j, g_j = _jgrads(jm, jparams, tokens, targets,
                          jpol if jpol.per_op_rules else None)
    loss_t, g_t = _tgrads(model, tparams, tokens, targets,
                          pol if pol.per_op_rules else None)
    assert abs(loss_t - loss_true) <= 2 * abs(loss_j - loss_true) \
        + 1e-3 * abs(loss_true)
    # one dtype a level (fp32 under O1, the half type under O2 and O3)
    assert {T2J[g.dtype] for g in tree_leaves(g_t)} == {
        w.dtype for w in jax.tree.leaves(g_j)}
    got = _flat(params_to_jax(g_t, cfg))
    want, truth = _flat(g_j), _flat(g_true)
    for k, w in want.items():
        t = truth[k].astype(np.float32)
        scale = np.abs(t).max()
        e_ref = np.abs(w.astype(np.float32) - t).max() / scale
        e_port = np.abs(got[k].astype(np.float32) - t).max() / scale
        assert e_port <= 2 * e_ref + 1e-3, (k, e_port, e_ref)


def test_fp16_o2_flagship_steps_match_reference(setup):
    """Six fp16 O2 steps from init_scale=2**24 at lr 1e-4, batch 32 x 64:
    the finite flag and the scaler's (scale, tracker, skipped) equal the
    reference's at every step. Unambiguous flags: at each step the
    reference's flag is the same at 0.8 and at 1.25 times the step's
    scale, so no flag rests on an fp16 gradient within a third of an
    octave of 65504 (the port's fp16 arithmetic differs from XLA's in the
    last bits only); this batch (:data:`FLAG_BATCH`, the setup's seed)
    gives four overflows, then finite steps. The fp16 bound
    after the run: every master entry within 2·lr of the reference's per
    finite step (Adam moves an entry by at most ~lr a step, and fp16
    gradients near zero may flip its direction), 99% of all entries
    within lr/10 (this run: 99.83%); Adam's exp_avg within 2e-2 and exp_avg_sq within 5e-2 of
    their leaf's largest entry (fp16 gradients: ~1e-3 relative rounding
    each, summed over the steps)."""
    jm, tree, tokens, targets, model, cfg = setup
    lr, steps = 1e-4, 6
    jpol = japp.get_policy("O2", half_dtype=jnp.float16)
    master = japp.MasterWeights.create(jax.tree.map(jnp.asarray, tree), jpol)
    jopt = japp.skip_step_if_nonfinite(fused_adam(learning_rate=lr))
    jstate = jopt.init(master.master)
    jscaler = japp.init_loss_scaler("dynamic", init_scale=2.0 ** 24)
    rng = np.random.default_rng(2)
    tokens, targets = (rng.integers(0, SMALL["vocab_size"], (
        FLAG_BATCH, SMALL["max_seq_len"])).astype(np.int32) for _ in "tt")
    tok, tgt = jnp.asarray(tokens), jnp.asarray(targets)

    @jax.jit
    def jgrad(scaler, p):
        return japp.scaled_value_and_grad(
            lambda q: jm.loss_fn(q, tok, tgt))(scaler, p)

    pol = amp.get_policy("O2", half_dtype=torch.float16)
    mw = amp.MasterWeights.create(params_from_jax(tree, cfg, device="cpu"),
                                  pol)
    topt = amp.skip_step_if_nonfinite(FusedAdam(tree_leaves(mw.master),
                                                lr=lr))
    tscaler = amp.init_loss_scaler("dynamic", init_scale=2.0 ** 24,
                                   device="cpu")
    flags = []
    with jax.default_matmul_precision("highest"):
        for _ in range(steps):
            flag = bool(jgrad(jscaler, master.model)[1][1])
            for f in (0.8, 1.25):
                near = dataclasses.replace(
                    jscaler, loss_scale=jscaler.loss_scale * f)
                assert bool(jgrad(near, master.model)[1][1]) == flag
            _, (jg, jfin, jscaler) = jgrad(jscaler, master.model)
            upd, jstate = jopt.update(jg, jstate, master.master)
            master = japp.apply_updates_with_master(master, upd,
                                                    grads_finite=jfin)
            _, (tg, tfin, tscaler) = amp.scaled_value_and_grad(
                model.loss_fn)(tscaler, mw.model, torch.tensor(tokens),
                               torch.tensor(targets))
            amp.apply_updates_with_master(mw, topt, tg, grads_finite=tfin)
            assert bool(tfin) == bool(jfin)
            assert (float(tscaler.loss_scale), int(tscaler.growth_tracker),
                    int(tscaler.skipped_steps)) == (
                float(jscaler.loss_scale), int(jscaler.growth_tracker),
                int(jscaler.skipped_steps))
            flags.append(bool(tfin))
    assert flags == [False] * 4 + [True] * 2, flags
    finite_steps = sum(flags)
    got = _flat(params_to_jax(tree_map(lambda t: t.detach(), mw.master), cfg))
    want = _flat(master.master)
    close = 0
    total = 0
    for k, w in want.items():
        d = np.abs(got[k] - w)
        assert d.max() <= 2 * lr * finite_steps, k
        close += int((d <= lr / 10).sum())
        total += d.size
    assert close >= total * 0.99
    assert all(topt.state[t]["step"] == finite_steps
               for t in tree_leaves(mw.master))
    assert int(jstate.count) == finite_steps
    for name, key, tol in (("m", "exp_avg", 2e-2), ("v", "exp_avg_sq", 5e-2)):
        mine = _flat(params_to_jax(tree_map(lambda t: topt.state[t][key],
                                            mw.master), cfg))
        for k, w in _flat(jstate.buffers[name]).items():
            np.testing.assert_allclose(mine[k], w, rtol=0,
                                       atol=tol * np.abs(w).max(),
                                       err_msg=f"{name} {k}")
