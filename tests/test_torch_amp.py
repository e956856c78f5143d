"""Port parity for amp: apex_tpu_torch.amp (and transformer.amp at tp=1)
against apex_tpu.amp, case by case after the reference's
``tests/test_amp.py``, each case run through both packages on the same
inputs rather than held to constants.

Exact where the reference is exact: every policy field, every cast dtype
(over each table entry and dtype pair), the registries, the scaler's
trajectories (scale, tracker and skipped steps equal at every step, over
hypothesis-drawn finite/overflow sequences, static scales and the min/max
clamps), state dicts. Optimizer state after a skipped step: the port's
params, exp_avg, exp_avg_sq and step count bit-identical to before it, as
the reference's; after finite steps the reference's fp32 Adam bounds
(``test_torch_optimizers.py``: 1e-6 relative).
"""

import dataclasses
import threading
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from apex_tpu import amp as japp
from apex_tpu.amp import lists as jlists
from apex_tpu.optimizers import fused_adam
from apex_tpu.transformer import amp as jtamp
from apex_tpu_torch import amp
from apex_tpu_torch.amp import lists
from apex_tpu_torch.optimizers import FusedAdam
from apex_tpu_torch.transformer import amp as tamp
from apex_tpu_torch.utils.pytree import (tree_all_finite, tree_cast,
                                         tree_leaves)

T2J = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
       torch.float16: jnp.float16, torch.int32: jnp.int32}
J2T = {jnp.dtype(v): k for k, v in T2J.items()}
LEVELS = ("O0", "O1", "O2", "O3")
HALVES = (torch.bfloat16, torch.float16)
FLOATS = (torch.float32, torch.bfloat16, torch.float16)


def _jdt(dt):
    return jnp.dtype(T2J[dt])


def _same_policy(p, q):
    for f in dataclasses.fields(p):
        a, b = getattr(p, f.name), getattr(q, f.name)
        if isinstance(a, torch.dtype):
            assert _jdt(a) == jnp.dtype(b), f.name
        else:
            assert a == b, f.name


# --- policies -----------------------------------------------------------------

@pytest.mark.parametrize("level", LEVELS)
def test_levels_match_reference(level):
    _same_policy(getattr(amp, level), getattr(japp, level))
    assert amp.get_policy(level).norm_dtype == J2T[jnp.dtype(
        japp.get_policy(level).norm_dtype)]


@pytest.mark.parametrize("keep_norm", [None, True, False])
@pytest.mark.parametrize("master", [None, True, False])
@pytest.mark.parametrize("half", HALVES, ids=str)
@pytest.mark.parametrize("level", LEVELS + ("O5",))
def test_get_policy_matches_reference(level, half, master, keep_norm):
    kw = dict(keep_norm_f32=keep_norm, master_weights=master)
    try:
        want = japp.get_policy(level, half_dtype=T2J[half], **kw)
    except ValueError:
        with pytest.raises(ValueError):
            amp.get_policy(level, half_dtype=half, **kw)
        return
    _same_policy(amp.get_policy(level, half_dtype=half, **kw), want)


def test_get_policy_takes_two_half_dtypes():
    with pytest.raises(ValueError, match="half_dtype"):
        amp.get_policy("O2", half_dtype=torch.float32)


def test_cast_skips_non_float_and_run_casts_output():
    p = {"w": torch.ones(4, 4), "b": torch.zeros(4),
         "step": torch.zeros((), dtype=torch.int32), "n": 3, "none": None}
    c = amp.O2.cast_to_compute(p)
    assert c["w"].dtype == torch.bfloat16 and c["step"].dtype == torch.int32
    assert c["n"] == 3 and c["none"] is None
    assert amp.O0.cast_to_compute(p)["w"] is p["w"]  # no copy at fp32
    out = amp.O2.run(lambda q, x: x @ q["w"], p, torch.ones(2, 4))
    want = japp.O2.run(lambda q, x: x @ q["w"],
                       {"w": jnp.ones((4, 4))}, jnp.ones((2, 4)))
    assert _jdt(out.dtype) == want.dtype


def test_ambient_policy_nests_decorates_and_is_per_thread():
    assert amp.current_policy().name == japp.current_policy().name == "O0"
    with amp.with_policy(amp.O2):
        with amp.with_policy(amp.O1):
            assert amp.current_policy().name == "O1"
        assert amp.current_policy().name == "O2"
        seen = []
        t = threading.Thread(target=lambda: seen.append(
            amp.current_policy().name))
        t.start()
        t.join()
        assert seen == ["O0"]
    assert amp.current_policy().name == "O0"
    assert amp.with_policy(amp.O3)(lambda: amp.current_policy().name)() \
        == "O3"


# --- the O1 tables ------------------------------------------------------------

def test_tables_match_reference():
    assert lists.HALF_OPS == jlists.HALF_OPS
    assert lists.FLOAT_OPS == jlists.FLOAT_OPS
    assert lists.PROMOTE_OPS == jlists.PROMOTE_OPS
    assert lists.BANNED_OPS == jlists.BANNED_OPS


ALL_OPS = sorted(jlists.HALF_OPS | jlists.FLOAT_OPS | jlists.PROMOTE_OPS
                 | set(jlists.BANNED_OPS)) + ["no_such_op"]
DTYPE_SETS = [()] + [(a,) for a in FLOATS] + [
    (a, b) for i, a in enumerate(FLOATS) for b in FLOATS[i:]]
POLICIES = {"O0": amp.O0, "O1": amp.O1, "O1_f16": amp.get_policy(
    "O1", half_dtype=torch.float16), "O2_f16": amp.get_policy(
    "O2", half_dtype=torch.float16), "O3": amp.O3}


@pytest.mark.parametrize("op", ALL_OPS)
def test_op_cast_dtype_matches_reference(op):
    """Every policy and input dtype set (none, one, every pair): the same
    dtype, or both raise the banned-op error."""
    for name, pol in POLICIES.items():
        jpol = japp.get_policy(name[:2], half_dtype=T2J[
            torch.float16 if name.endswith("f16") else torch.bfloat16])
        for dts in DTYPE_SETS:
            try:
                want = jlists.op_cast_dtype(op, jpol, *(T2J[d] for d in dts))
            except RuntimeError:
                with pytest.raises(RuntimeError, match="numerically unsafe"):
                    lists.op_cast_dtype(op, pol, *dts)
                continue
            got = lists.op_cast_dtype(op, pol, *dts)
            assert _jdt(got) == jnp.dtype(want), (name, dts)


@pytest.mark.parametrize("op", ALL_OPS)
def test_apply_op_rules_matches_reference(op):
    """Float tensors of each dtype pair, an int tensor and None through
    apply_op_rules: the reference's dtypes; outside O1 the same objects
    back (no copy, so every non-O1 path is unchanged bit for bit)."""
    for name, pol in POLICIES.items():
        jpol = japp.get_policy(name[:2], half_dtype=T2J[
            torch.float16 if name.endswith("f16") else torch.bfloat16])
        for dts in DTYPE_SETS[1:]:
            ins = [torch.ones(3, dtype=d) for d in dts] + [
                torch.zeros(3, dtype=torch.int32), None]
            jins = [jnp.ones(3, T2J[d]) for d in dts] + [
                jnp.zeros(3, jnp.int32), None]
            try:
                want = jlists.apply_op_rules(op, *jins, policy=jpol)
            except RuntimeError:
                with pytest.raises(RuntimeError):
                    lists.apply_op_rules(op, *ins, policy=pol)
                continue
            got = lists.apply_op_rules(op, *ins, policy=pol)
            assert got[-1] is None and got[-2].dtype == torch.int32
            for g, w in zip(got[:-1], want[:-1]):
                assert _jdt(g.dtype) == w.dtype, (name, dts)
            if not pol.per_op_rules:
                assert all(g is i for g, i in zip(got, ins))
            with amp.with_policy(pol):  # the ambient policy: the same
                amb = lists.apply_op_rules(op, *ins)
            assert [None if t is None else t.dtype for t in amb] == \
                [None if t is None else t.dtype for t in got]


@pytest.mark.parametrize("dts", [(), (torch.float32,), (torch.bfloat16,),
                                 (torch.float16, torch.float32)], ids=str)
def test_check_banned_matches_reference(dts):
    try:
        jlists.check_banned("binary_cross_entropy", *(T2J[d] for d in dts))
        raised = False
    except RuntimeError:
        raised = True
    if raised:
        with pytest.raises(RuntimeError, match="numerically unsafe"):
            lists.check_banned("binary_cross_entropy", *dts)
    else:
        lists.check_banned("binary_cross_entropy", *dts)
    lists.check_banned("dense", torch.float16)


@pytest.fixture
def restore_tables():
    saved = [set(t) for t in (lists.HALF_OPS, lists.FLOAT_OPS,
                              lists.PROMOTE_OPS, jlists.HALF_OPS,
                              jlists.FLOAT_OPS, jlists.PROMOTE_OPS)]
    yield
    for t, s in zip((lists.HALF_OPS, lists.FLOAT_OPS, lists.PROMOTE_OPS,
                     jlists.HALF_OPS, jlists.FLOAT_OPS, jlists.PROMOTE_OPS),
                    saved):
        t.clear()
        t.update(s)


def test_registries_match_reference(restore_tables):
    """The same registrations, in both spellings, move the same names."""
    steps = [("register_float_op", ("mlp",)),
             ("register_half_op", ("softmax",)),
             ("register_promote_op", ("linear",)),
             ("register_half_function", (torch, "my_op")),
             ("register_float_function", ("my_op",)),
             ("register_promote_function", (torch.nn.functional, "gelu"))]
    for name, args in steps:
        getattr(lists, name)(*args)
        getattr(jlists, name)(*((jnp,) + args[1:] if len(args) == 2
                                else args))
        assert lists.HALF_OPS == jlists.HALF_OPS, name
        assert lists.FLOAT_OPS == jlists.FLOAT_OPS, name
        assert lists.PROMOTE_OPS == jlists.PROMOTE_OPS, name
    x = torch.ones(4, dtype=torch.bfloat16)
    assert lists.apply_op_rules("mlp", x, policy=amp.O1)[0].dtype == \
        torch.float32


def test_decorators_cast_warn_and_disable(restore_tables):
    seen = {}

    @amp.half_function
    def my_matmul_like_op(a, b, *, scale=None):
        seen["dtypes"] = (a.dtype, b.dtype, scale.dtype)
        return a @ b

    @amp.float_function
    def my_loss_like_op(a):
        seen["f"] = a.dtype
        return a.sum()

    @amp.promote_function
    def my_sum_like_op(a, b):
        seen["p"] = (a.dtype, b.dtype)
        return a

    a = torch.ones(4, 4)
    s = torch.ones(1)
    with amp.with_policy(amp.get_policy("O1", half_dtype=torch.float16)):
        my_matmul_like_op(a, a, scale=s)
        assert seen["dtypes"] == (torch.float16, torch.float16, torch.float32)
        my_loss_like_op(torch.ones(4, dtype=torch.bfloat16))
        assert seen["f"] == torch.float32
        my_sum_like_op(torch.ones(2, dtype=torch.float16), torch.ones(2))
        assert seen["p"] == (torch.float32, torch.float32)
        with amp.disable_casts():
            my_matmul_like_op(a, a, scale=s)
            assert seen["dtypes"][0] == torch.float32
    my_matmul_like_op(a, a, scale=s)
    assert seen["dtypes"][0] == torch.float32
    assert my_matmul_like_op.__name__ == "my_matmul_like_op"
    def softmax(x):
        return x

    for deco, jdeco, table in (
            (amp.half_function, japp.half_function, "HALF_OPS"),
            (amp.float_function, japp.float_function, "FLOAT_OPS")):
        with pytest.warns(UserWarning, match="already a registered op"):
            deco(softmax)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            jdeco(softmax)
        assert "softmax" in getattr(lists, table)
        assert "softmax" in getattr(jlists, table)


# --- the loss scaler ----------------------------------------------------------

def _snap(s):
    return (float(s.loss_scale), int(s.growth_tracker),
            int(s.skipped_steps))


@settings(max_examples=60, deadline=None)
@given(flags=st.lists(st.booleans(), max_size=40),
       dynamic=st.booleans(),
       init=st.sampled_from([1.0, 1.5, 3.0, 1024.0, 2.0 ** 16, 2.0 ** 24]),
       interval=st.integers(1, 5),
       growth=st.sampled_from([2.0, 1.5, 3.0]),
       backoff=st.sampled_from([0.5, 0.25, 0.75]),
       lo=st.sampled_from([1.0, 0.5, 4.0]),
       hi=st.sampled_from([2.0 ** 24, 2.0 ** 18, 1e6]))
def test_scaler_trajectories_equal_reference(flags, dynamic, init, interval,
                                             growth, backoff, lo, hi):
    kw = dict(growth_interval=interval, growth_factor=growth,
              backoff_factor=backoff, min_loss_scale=lo, max_loss_scale=hi)
    mode = "dynamic" if dynamic else init
    s = amp.init_loss_scaler(mode, init_scale=init, device="cpu", **kw)
    j = japp.init_loss_scaler(mode, init_scale=init, **kw)
    assert _snap(s) == _snap(j)
    for f in flags:
        s = amp.update_loss_scaler(s, torch.tensor(f))
        j = japp.update_loss_scaler(j, jnp.asarray(f))
        assert _snap(s) == _snap(j), flags
        assert s.loss_scale.dtype == torch.float32
        assert s.growth_tracker.dtype == s.skipped_steps.dtype == torch.int32


def test_scaler_lives_on_the_params_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        amp.init_loss_scaler()
    s = amp.init_loss_scaler(device="cpu")
    assert s.loss_scale.device.type == "cpu" and s.loss_scale.ndim == 0


def test_scaled_value_and_grad_matches_reference():
    rng = np.random.default_rng(0)
    w, b, x = (rng.standard_normal(s).astype(np.float32)
               for s in ((3, 4), (4,), (5, 3)))

    def jfn(p, x):
        return jnp.sum(jnp.tanh(x @ p["w"] + p["b"]) ** 2), {"n": 1}

    def tfn(p, x):
        return torch.sum(torch.tanh(x @ p["w"] + p["b"]) ** 2), {"n": 1}

    for init in (1024.0, 2.0 ** 16):
        js = japp.init_loss_scaler("dynamic", init_scale=init)
        ts = amp.init_loss_scaler("dynamic", init_scale=init, device="cpu")
        (jl, jaux), (jg, jf, js2) = japp.scaled_value_and_grad(
            jfn, has_aux=True)(js, {"w": jnp.asarray(w), "b": jnp.asarray(b)},
                               jnp.asarray(x))
        p = {"w": torch.tensor(w), "b": torch.tensor(b),
             "step": torch.zeros((), dtype=torch.int32)}
        (tl, taux), (tg, tf, ts2) = amp.scaled_value_and_grad(
            tfn, has_aux=True)(ts, p, torch.tensor(x))
        assert taux == jaux and bool(tf) == bool(jf)
        assert tg["step"] is None and _snap(ts2) == _snap(js2)
        np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-6)
        for k in ("w", "b"):
            assert tg[k].dtype == torch.float32
            np.testing.assert_allclose(tg[k].numpy(), np.asarray(jg[k]),
                                       rtol=1e-5, atol=1e-6)


def test_overflow_detection_and_apply_if_finite_match_reference():
    js = japp.init_loss_scaler("dynamic")
    ts = amp.init_loss_scaler("dynamic", device="cpu")
    _, (jg, jf, js2) = japp.scaled_value_and_grad(
        lambda p, x: jnp.sum(p["w"] * x))(js, {"w": jnp.asarray([2.0])},
                                          jnp.asarray([jnp.inf]))
    p = {"w": torch.tensor([2.0])}
    _, (tg, tf, ts2) = amp.scaled_value_and_grad(
        lambda p, x: torch.sum(p["w"] * x))(ts, p, torch.tensor([np.inf]))
    assert bool(tf) == bool(jf) is False and _snap(ts2) == _snap(js2)
    new = {"w": p["w"].detach() - tg["w"]}
    kept = amp.apply_if_finite({"w": p["w"].detach()}, new, tf)
    want = japp.apply_if_finite({"w": jnp.asarray([2.0])},
                                {"w": jnp.asarray([2.0]) - jg["w"]}, jf)
    np.testing.assert_array_equal(kept["w"].numpy(), np.asarray(want["w"]))


@pytest.mark.parametrize("mode", ["dynamic", 128.0])
def test_state_dict_and_metrics_round_trip(mode):
    s = amp.update_loss_scaler(amp.init_loss_scaler(mode, device="cpu"),
                               torch.tensor(False))
    j = japp.update_loss_scaler(japp.init_loss_scaler(mode),
                                jnp.asarray(False))
    assert amp.state_dict(s) == japp.state_dict(j)
    assert amp.scaler_metrics(s) == japp.scaler_metrics(j)
    back = amp.load_state_dict(amp.init_loss_scaler("dynamic", device="cpu"),
                               amp.state_dict(s))
    jback = japp.load_state_dict(japp.init_loss_scaler("dynamic"),
                                 japp.state_dict(j))
    assert _snap(back) == _snap(jback) and back.dynamic == jback.dynamic


def test_tree_helpers():
    t = {"a": [torch.ones(2), torch.tensor([1.0, np.inf])],
         "i": torch.zeros(2, dtype=torch.int32), "n": None}
    assert not bool(tree_all_finite(t))
    t["a"][1] = torch.ones(2)
    assert bool(tree_all_finite(t)) and bool(tree_all_finite({}))
    c = tree_cast(t, torch.float16)
    assert c["a"][0].dtype == torch.float16 and c["i"].dtype == torch.int32
    assert [x.shape for x in tree_leaves(c)] == [(2,), (2,), (2,)]


# --- skip_step_if_nonfinite with FusedAdam ------------------------------------

SHAPES = {"b": (6,), "w": (5, 6)}


def _grads(i, bad=False):
    rng = np.random.default_rng(10 + i)
    g = {k: rng.standard_normal(s).astype(np.float32) for k, s in
         SHAPES.items()}
    if bad:
        g["w"][1, 2] = np.inf
    return g


@pytest.mark.parametrize("pattern", [(False, True, False), (True, True, False),
                                     (False, False, True, False)],
                         ids=["middle", "first_two", "third"])
def test_skip_step_matches_reference_adam(pattern):
    """A step whose gradients are not all finite leaves params, exp_avg,
    exp_avg_sq and the step count exactly as before (bit-identical, as the
    reference's selected state); the finite steps match the reference's
    fused_adam to its fp32 bounds, with the same counts."""
    rng = np.random.default_rng(3)
    p0 = {k: (0.1 * rng.standard_normal(s)).astype(np.float32)
          for k, s in SHAPES.items()}
    jopt = japp.skip_step_if_nonfinite(fused_adam(learning_rate=1e-2))
    pj = {k: jnp.asarray(v) for k, v in p0.items()}
    state = jopt.init(pj)
    pt = {k: torch.tensor(v) for k, v in p0.items()}
    topt = amp.skip_step_if_nonfinite(FusedAdam([pt[k] for k in sorted(pt)],
                                                lr=1e-2))
    for i, bad in enumerate(pattern):
        g = _grads(i, bad)
        upd, state = jopt.update({k: jnp.asarray(v) for k, v in g.items()},
                                 state, pj)
        pj = optax.apply_updates(pj, upd)
        before = {k: (pt[k].clone(), dict(topt.state[pt[k]])) for k in pt}
        before = {k: (v[0], {n: (x.clone() if torch.is_tensor(x) else x)
                             for n, x in v[1].items()})
                  for k, v in before.items()}
        for k in pt:
            pt[k].grad = torch.tensor(g[k])
        stepped = topt.step()
        assert stepped is not bad
        for k in pt:
            st_ = topt.state[pt[k]]
            if bad:
                assert torch.equal(pt[k], before[k][0])
                for n, x in before[k][1].items():
                    assert (torch.equal(st_[n], x) if torch.is_tensor(x)
                            else st_[n] == x)
            np.testing.assert_allclose(pt[k].numpy(), np.asarray(pj[k]),
                                       rtol=1e-6, atol=1e-9)
            if st_:
                assert st_["step"] == int(state.count)
                np.testing.assert_allclose(
                    st_["exp_avg"].numpy(), np.asarray(state.buffers["m"][k]),
                    rtol=1e-6, atol=1e-9)
                np.testing.assert_allclose(
                    st_["exp_avg_sq"].numpy(),
                    np.asarray(state.buffers["v"][k]), rtol=1e-6, atol=1e-12)
            else:
                assert int(state.count) == 0
    assert int(state.count) == sum(not b for b in pattern)


def test_skip_step_takes_the_flag_and_delegates():
    p = torch.ones(3)
    opt = amp.skip_step_if_nonfinite(FusedAdam([p], lr=0.1))
    p.grad = torch.ones(3)
    assert opt.step(grads_finite=torch.tensor(False)) is False
    assert torch.equal(p, torch.ones(3)) and not opt.state
    assert opt.step(grads_finite=torch.tensor(True)) is True
    assert opt.state[p]["step"] == 1 and opt.param_groups[0]["lr"] == 0.1


# --- master weights and initialize --------------------------------------------

def test_master_weights_match_reference():
    """create, resync, the O2 epilogue (a finite step, then a skipped one)
    against the reference's with its fused_adam."""
    rng = np.random.default_rng(4)
    p0 = {k: (0.1 * rng.standard_normal(s)).astype(np.float32)
          for k, s in SHAPES.items()}
    pol = amp.get_policy("O2", half_dtype=torch.float16)
    jpol = japp.get_policy("O2", half_dtype=jnp.float16)
    mw = amp.MasterWeights.create({k: torch.tensor(v).half()
                                   for k, v in p0.items()}, pol)
    jmw = japp.MasterWeights.create({k: jnp.asarray(v, jnp.float16)
                                     for k, v in p0.items()}, jpol)
    jopt = fused_adam(learning_rate=1e-3)
    state = jopt.init(jmw.master)
    topt = FusedAdam(tree_leaves(mw.master), lr=1e-3)
    for i, finite in enumerate((True, False, True)):
        g = _grads(i)
        upd, new_state = jopt.update({k: jnp.asarray(v) for k, v in g.items()},
                                     state, jmw.master)
        if finite:
            state = new_state
        jmw = japp.apply_updates_with_master(
            jmw, upd, grads_finite=jnp.asarray(finite))
        before = [t.clone() for t in tree_leaves(mw.master)]
        amp.apply_updates_with_master(mw, topt, {
            k: torch.tensor(v) for k, v in g.items()},
            grads_finite=torch.tensor(finite))
        for k in SHAPES:
            assert mw.master[k].dtype == torch.float32
            assert mw.model[k].dtype == torch.float16
            assert mw.model[k].requires_grad and mw.master[k].grad is None
            np.testing.assert_allclose(mw.master[k].numpy(),
                                       np.asarray(jmw.master[k]), rtol=1e-6,
                                       atol=1e-9)
            np.testing.assert_array_equal(
                mw.model[k].detach().numpy(),
                np.asarray(jmw.model[k]).astype(np.float16))
        if not finite:
            assert all(torch.equal(a, b) for a, b in
                       zip(before, tree_leaves(mw.master)))
    assert amp.master_params(mw) == tree_leaves(mw.master)
    from apex_tpu_torch.amp.master import o2_state_dict_params
    assert o2_state_dict_params(mw) is mw.master


@pytest.mark.parametrize("num_losses", [1, 2])
@pytest.mark.parametrize("half", HALVES, ids=str)
@pytest.mark.parametrize("level", LEVELS)
def test_initialize_matches_reference(level, half, num_losses):
    """Every level: the policy, the params' dtypes (masters under O2), the
    scaler (None, one, or num_losses independent ones, each the
    reference's), the optimizer wrapped where a scaler is active and
    stepping over the params the forward does not read under O2 (the
    masters)."""
    def params():
        return {"w": torch.ones(4, 4), "step": torch.zeros(
            (), dtype=torch.int32)}

    p = params()
    opt = FusedAdam([p["w"]], lr=1e-3)
    st_ = amp.initialize(p, opt, level, half_dtype=half,
                         num_losses=num_losses)
    jst = japp.initialize({"w": jnp.ones((4, 4)),
                           "step": jnp.zeros((), jnp.int32)},
                          fused_adam(1e-3), level, half_dtype=T2J[half],
                          num_losses=num_losses)
    _same_policy(st_.policy, jst.policy)
    if isinstance(jst.params, japp.MasterWeights):
        assert isinstance(st_.params, amp.MasterWeights)
        for part in ("master", "model"):
            got, want = getattr(st_.params, part), getattr(jst.params, part)
            assert {k: _jdt(v.dtype) for k, v in got.items()} == \
                {k: v.dtype for k, v in want.items()}
        assert st_.optimizer.param_groups[0]["params"] == [
            st_.params.master["w"]]
    else:
        assert {k: _jdt(v.dtype) for k, v in st_.params.items()} == \
            {k: v.dtype for k, v in jst.params.items()}
        assert st_.optimizer.param_groups[0]["params"][0] is st_.params["w"]
    if jst.scaler is None:
        assert st_.scaler is None and isinstance(st_.optimizer, FusedAdam)
        return
    assert isinstance(st_.optimizer, amp.scaler.SkipStepIfNonfinite)
    ts = st_.scaler if isinstance(st_.scaler, list) else [st_.scaler]
    js = jst.scaler if isinstance(jst.scaler, list) else [jst.scaler]
    assert len(ts) == len(js) == (num_losses if num_losses > 1 else 1)
    for a, b in zip(ts, js):
        assert _snap(a) == _snap(b) and a.dynamic == b.dynamic
    if len(ts) > 1:  # independent: an overflow backs off one scaler only
        s0 = amp.update_loss_scaler(ts[0], torch.tensor(False))
        assert float(s0.loss_scale) == float(ts[1].loss_scale) / 2


def test_initialize_explicit_loss_scale_and_overrides():
    for level, kw in (("O0", dict(loss_scale=128.0)),
                      ("O3", dict(loss_scale="dynamic")),
                      ("O2", dict(master_weights=False,
                                  keep_batchnorm_fp32=False))):
        st_ = amp.initialize({"w": torch.ones(2)}, None, level, **kw)
        jst = japp.initialize({"w": jnp.ones(2)}, None, level, **kw)
        _same_policy(st_.policy, jst.policy)
        assert (st_.scaler is None) == (jst.scaler is None)
        if jst.scaler is not None:
            assert _snap(st_.scaler) == _snap(jst.scaler)
    with pytest.raises(ValueError):
        amp.initialize({"w": torch.ones(2)}, None, "O1", master_weights=True)


def test_num_losses_overflow_backs_off_its_own_scaler():
    st_ = amp.initialize({"w": torch.ones(4, 4)}, None, "O2",
                         half_dtype=torch.float16, num_losses=2)
    s0, s1 = st_.scaler
    p16 = {"w": torch.ones(4, 4, dtype=torch.float16)}
    _, (_, fin1, s1n) = amp.scaled_value_and_grad(
        lambda p: torch.sum(p["w"].float() * 1e-3))(s1, p16)
    _, (_, fin0, s0n) = amp.scaled_value_and_grad(
        lambda p: torch.sum((p["w"] * 3e4).float()))(s0, p16)
    assert bool(fin1) and not bool(fin0)
    assert float(s0n.loss_scale) == float(s0.loss_scale) / 2
    assert float(s1n.loss_scale) == float(s1.loss_scale)


# --- transformer.amp at tp=1 --------------------------------------------------

@pytest.mark.parametrize("bad", [False, True])
def test_model_parallel_scaler_matches_reference_at_tp1(bad):
    g = _grads(0, bad)
    tg = {k: torch.tensor(v) for k, v in g.items()}
    jg = {k: jnp.asarray(v) for k, v in g.items()}
    fin = tamp.model_parallel_all_finite(tg)
    assert bool(fin) == bool(jtamp.model_parallel_all_finite(jg, axes=()))
    s, f2 = tamp.GradScaler(amp.init_loss_scaler(device="cpu"), tg)
    js, jf2 = jtamp.update_scaler_model_parallel(japp.init_loss_scaler(), jg,
                                                 axes=())
    assert _snap(s) == _snap(js) and bool(f2) == bool(jf2)
    with pytest.raises(TypeError):
        tamp.update_scaler_model_parallel(s, tg, axes=("tp",))


# --- the O1 call sites of the ported ops --------------------------------------

def test_o1_casts_at_the_ops_match_reference():
    """Each op under an O1 policy gives the reference's output dtype: dense
    and MLP half, softmax and the norms fp32, flash attention half; and
    the gradient reaches an fp32 weight as fp32."""
    from apex_tpu.ops import fused_dense as jdense
    from apex_tpu.ops import fused_layer_norm as jln
    from apex_tpu.ops import mlp as jmlp
    from apex_tpu.ops import scaled_upper_triang_masked_softmax as jsm
    from apex_tpu.ops.attention import flash_attention as jflash
    from apex_tpu_torch.ops.attention import flash_attention
    from apex_tpu_torch.ops.fused_dense import fused_dense
    from apex_tpu_torch.ops.layer_norm import fused_layer_norm, fused_rms_norm
    from apex_tpu_torch.ops.mlp import mlp
    from apex_tpu_torch.ops.softmax import (
        scaled_masked_softmax, scaled_upper_triang_masked_softmax)

    for half in HALVES:
        pol = amp.get_policy("O1", half_dtype=half)
        jpol = japp.get_policy("O1", half_dtype=T2J[half])
        x, w = torch.ones(4, 8), torch.ones(8, 8, requires_grad=True)
        xb = torch.ones(2, 4, 4, dtype=torch.bfloat16)
        q = torch.ones(2, 8, 16)
        with amp.with_policy(pol):
            got = [fused_dense(x, w).dtype,
                   mlp(x, [w], [torch.zeros(8)]).dtype,
                   scaled_upper_triang_masked_softmax(xb).dtype,
                   scaled_masked_softmax(xb, None).dtype,
                   fused_layer_norm(xb, torch.ones(4, dtype=torch.bfloat16),
                                    torch.zeros(4, dtype=torch.bfloat16)).dtype,
                   fused_rms_norm(xb, torch.ones(4, dtype=torch.bfloat16)).dtype,
                   flash_attention(q, q, q, causal=True).dtype]
            fused_dense(x, w).float().sum().backward()
        assert w.grad.dtype == torch.float32
        np.testing.assert_allclose(w.grad.numpy(), 4.0, rtol=1e-2)
        with japp.with_policy(jpol):
            jx, jw = jnp.ones((4, 8)), jnp.ones((8, 8))
            jxb = jnp.ones((2, 4, 4), jnp.bfloat16)
            jq = jnp.ones((2, 8, 16))
            want = [jdense(jx, jw).dtype,
                    jmlp(jx, [jw], [jnp.zeros(8)]).dtype,
                    jsm(jxb).dtype, jsm(jxb).dtype,
                    jln(jxb, jnp.ones(4, jnp.bfloat16),
                        jnp.zeros(4, jnp.bfloat16)).dtype,
                    jln(jxb, jnp.ones(4, jnp.bfloat16),
                        jnp.zeros(4, jnp.bfloat16)).dtype,
                    jflash(jq, jq, jq, causal=True).dtype]
        assert [_jdt(d) for d in got] == want, half
    with amp.with_policy(amp.O2):  # outside O1 nothing is cast
        assert fused_dense(x, w).dtype == torch.float32
