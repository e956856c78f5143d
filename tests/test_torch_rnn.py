"""Port parity for the RNNs: ``apex_tpu_torch.rnn`` against
``apex_tpu.rnn`` on the same seeded numpy weights and inputs, fp32.

* every cell's step (Tanh, ReLU, LSTM, GRU, mLSTM): state and output
  within 1e-5 of the largest entry;
* stacks of two layers and the factories: outputs and final states within
  1e-5, every weight's and the input's gradient within 2e-4 of its
  largest entry; the input GEMM hoisted over the sequence changes nothing
  beyond that;
* ``bidirectional``; user-supplied initial states (their gradients too);
* O1: x, the weights and the user states cast to bf16 by the "rnn" rule
  in both packages, outputs within 2^-6 of the largest (a few bf16 ulps:
  each of the 2 × 6 recurrent steps rounds its bf16 ops at other points
  than XLA's CPU backend);
* dropout between layers: at p = 0 (or without a generator) the plain
  stack; at p > 0 the keep rate within 5 sigma of 1 − p and kept entries
  h / (1 − p) of the dropout-free layer's output (the mask's bits come
  from a torch.Generator, not the reference's threefry).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import apex_tpu.rnn as jrnn
import apex_tpu_torch.rnn as trnn
from apex_tpu import amp as jamp
from apex_tpu_torch import amp

OUT_TOL = 1e-5
GRAD_TOL = 2e-4
CELLS = ["RNNTanhCell", "RNNReLUCell", "LSTMCell", "GRUCell", "mLSTMCell"]
FACTORIES = {"RNNTanhCell": "Tanh", "RNNReLUCell": "ReLU",
             "LSTMCell": "LSTM", "GRUCell": "GRU", "mLSTMCell": "mLSTM"}


def _close(got, want, tol, what=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: {err} > {tol} x {scale}"


def _params(cell, rng):
    b = 1.0 / cell.hidden_size ** 0.5
    g = cell.n_gates * cell.hidden_size
    u = lambda *s: rng.uniform(-b, b, s).astype(np.float32)  # noqa: E731
    p = {"w_ih": u(g, cell.input_size), "w_hh": u(g, cell.hidden_size),
         "b_ih": u(g), "b_hh": u(g)}
    if type(cell).__name__ == "mLSTMCell":
        p["w_mx"] = u(cell.hidden_size, cell.input_size)
        p["w_mh"] = u(cell.hidden_size, cell.hidden_size)
    return p


def _state(cell, B, rng):
    if type(cell).__name__ in ("LSTMCell", "mLSTMCell"):
        return tuple(rng.standard_normal((B, cell.hidden_size))
                     .astype(np.float32) for _ in range(2))
    return rng.standard_normal((B, cell.hidden_size)).astype(np.float32)


def _t(tree, grad=False):
    return jax.tree.map(lambda a: torch.tensor(np.asarray(a))
                        .requires_grad_(grad), tree)


def _leaves(tree):
    return jax.tree.leaves(tree, is_leaf=lambda a: isinstance(
        a, torch.Tensor))


@pytest.mark.parametrize("name", CELLS)
def test_cell_step_matches_reference(name):
    rng = np.random.default_rng(CELLS.index(name))
    jcell, tcell = getattr(jrnn, name)(5, 7), getattr(trnn, name)(5, 7)
    p = _params(jcell, rng)
    h = _state(jcell, 3, rng)
    x = rng.standard_normal((3, 5)).astype(np.float32)
    s_r, y_r = jcell.step(jax.tree.map(jnp.asarray, p),
                          jax.tree.map(jnp.asarray, h), jnp.asarray(x))
    s, y = tcell.step(_t(p), _t(h), torch.tensor(x))
    _close(y, y_r, OUT_TOL, "y")
    for a, b in zip(_leaves(s), jax.tree.leaves(s_r)):
        _close(a, b, OUT_TOL, "state")
    # the hoisted input share gives the same step
    s2, y2 = tcell.step(_t(p), _t(h), None,
                        xw=tcell.input_proj(_t(p), torch.tensor(x)))
    _close(y2, y_r, OUT_TOL, "y (hoisted)")


def _stack_case(name, layers, B=3, T=6, I=5, H=7, seed=0, states=False):
    rng = np.random.default_rng(seed)
    jcell = getattr(jrnn, name)(I, H)
    params = [_params(jcell if i == 0 else getattr(jrnn, name)(H, H), rng)
              for i in range(layers)]
    x = rng.standard_normal((B, T, I)).astype(np.float32)
    init = ([_state(jcell, B, rng) for _ in range(layers)] if states
            else None)
    dy = rng.standard_normal((B, T, H)).astype(np.float32)
    return params, x, init, dy


@pytest.mark.parametrize("states", [False, True], ids=["zeros", "user"])
@pytest.mark.parametrize("name", CELLS)
def test_stack_matches_reference(name, states):
    params, x, init, dy = _stack_case(name, 2, seed=len(name), states=states)
    jr = getattr(jrnn, FACTORIES[name])(5, 7, num_layers=2)
    tr = getattr(trnn, FACTORIES[name])(5, 7, num_layers=2)

    def ref(p, x, s):
        y, finals = jr(p, x, initial_states=s)
        return jnp.sum(y * dy), (y, finals)

    (_, (y_r, f_r)), g_r = jax.value_and_grad(
        ref, argnums=(0, 1, 2) if states else (0, 1), has_aux=True)(
            jax.tree.map(jnp.asarray, params), jnp.asarray(x),
            None if init is None else jax.tree.map(jnp.asarray, init))
    tp, tx = _t(params, True), torch.tensor(x, requires_grad=True)
    ts = None if init is None else _t(init, True)
    y, finals = tr(tp, tx, initial_states=ts)
    (y * torch.tensor(dy)).sum().backward()
    _close(y.detach(), y_r, OUT_TOL, "y")
    for a, b in zip(_leaves(finals), jax.tree.leaves(f_r)):
        _close(a.detach(), b, OUT_TOL, "final state")
    for a, b in zip(_leaves(tp), jax.tree.leaves(g_r[0])):
        _close(a.grad, b, GRAD_TOL, "weight grad")
    _close(tx.grad, g_r[1], GRAD_TOL, "dx")
    if states:
        for a, b in zip(_leaves(ts), jax.tree.leaves(g_r[2])):
            _close(a.grad, b, GRAD_TOL, "state grad")


def test_bidirectional_matches_reference():
    params_f, x, _, _ = _stack_case("GRUCell", 2, seed=1)
    params_b, _, _, _ = _stack_case("GRUCell", 2, seed=2)
    params = {"fwd": params_f, "bwd": params_b}
    _, japply = jrnn.bidirectional(jrnn.stacked_rnn(jrnn.GRUCell(5, 7), 2))
    tinit, tapply = trnn.bidirectional(
        trnn.stacked_rnn(trnn.GRUCell(5, 7), 2))
    y_r, (sf_r, sb_r) = japply(jax.tree.map(jnp.asarray, params),
                               jnp.asarray(x))
    y, (sf, sb) = tapply(_t(params), torch.tensor(x))
    assert y.shape == (3, 6, 14)
    _close(y, y_r, OUT_TOL, "y")
    for a, b in zip(sf + sb, list(sf_r) + list(sb_r)):
        _close(a, b, OUT_TOL, "final")
    p = tinit(torch.Generator().manual_seed(0), device="cpu")
    assert set(p) == {"fwd", "bwd"} and len(p["fwd"]) == 2
    assert tuple(p["bwd"][1]["w_ih"].shape) == (21, 7)


@pytest.mark.parametrize("name", ["LSTMCell", "GRUCell"])
def test_o1_casts_like_the_reference(name):
    params, x, init, _ = _stack_case(name, 2, seed=5, states=True)
    jr = getattr(jrnn, FACTORIES[name])(5, 7, num_layers=2)
    tr = getattr(trnn, FACTORIES[name])(5, 7, num_layers=2)
    with jamp.with_policy(jamp.get_policy("O1")):
        y_r, _ = jr(jax.tree.map(jnp.asarray, params), jnp.asarray(x),
                    initial_states=jax.tree.map(jnp.asarray, init))
    with amp.with_policy(amp.get_policy("O1")):
        y, finals = tr(_t(params), torch.tensor(x), initial_states=_t(init))
    assert y.dtype == torch.bfloat16 and str(y_r.dtype) == "bfloat16"
    assert all(t.dtype == torch.bfloat16 for t in _leaves(finals))
    _close(y.float(), np.asarray(y_r.astype(jnp.float32)), 2 ** -6, "y")


def test_dropout_zero_and_no_generator_are_the_plain_stack():
    params, x, _, _ = _stack_case("LSTMCell", 3, seed=9)
    plain = trnn.LSTM(5, 7, num_layers=3)
    y0, _ = plain(_t(params), torch.tensor(x))
    y_r, _ = jrnn.LSTM(5, 7, num_layers=3, dropout=0.0)(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x),
        key=jax.random.PRNGKey(0))
    _close(y0, y_r, OUT_TOL, "y")
    for drop, gen in ((0.0, torch.Generator().manual_seed(1)), (0.5, None)):
        y, _ = trnn.LSTM(5, 7, num_layers=3, dropout=drop)(
            _t(params), torch.tensor(x), generator=gen)
        assert torch.equal(y, y0)


def test_dropout_keep_rate_and_scale():
    rng = np.random.default_rng(3)
    cell = trnn.RNNReLUCell(64, 64)
    p = {"w_ih": torch.eye(64), "w_hh": torch.zeros((64, 64)),
         "b_ih": torch.zeros(64), "b_hh": torch.zeros(64)}
    x = torch.tensor(rng.uniform(0.5, 1.5, (8, 32, 64)).astype(np.float32))
    rnn = trnn.RNN(cell, num_layers=2, dropout=0.25)
    layer1 = trnn.RNN(cell, num_layers=1)
    gen = torch.Generator().manual_seed(0)
    # layer 2 is the identity on positive inputs, so the output is layer
    # 1's dropped output
    y, _ = rnn([p, p], x, generator=gen)
    h1, _ = layer1([p], x)
    kept = y != 0
    n = kept.numel()
    share = kept.double().mean().item()
    assert abs(share - 0.75) <= 5 * (0.25 * 0.75 / n) ** 0.5, share
    torch.testing.assert_close(y[kept], (h1 / 0.75)[kept])
    y2, _ = rnn([p, p], x, generator=torch.Generator().manual_seed(0))
    assert torch.equal(y, y2)  # the generator decides the mask
