"""Port parity for the legacy fp16 API: apex_tpu_torch.fp16_utils against
apex_tpu.fp16_utils.

* ``convert_network``'s exemption set on GPT's, BERT's and T5's trees:
  the reference on its own (stacked) tree, the port on the per-layer tree
  the weight bridge makes of it; every leaf gets the same dtype, the cast
  values are equal.
* ``FP16_Optimizer`` over ``FusedAdam`` against the reference's over
  ``fused_adam`` on the same fp16 tree and the same scaled fp16 gradients:
  the dynamic scale's trajectory (growth after ``scale_window`` clean
  steps, halving on an overflow), the skipped step (masters, model tensors
  and Adam's state bit-identical across it), the clip by the master
  gradients' norm; masters to 1e-6 relative (atol 1e-9) or 1e-6 of the
  leaf's largest entry (the clip's norm is summed in each side's own
  order), fp16 model tensors by the half rule (at most 1 in 1000 one ulp
  off); and the ``state_dict`` round trip, bit for bit.
* the scalers, ``network_to_half``, ``FP16Model`` and the master/model
  helpers.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_opt_harness as H
from apex_tpu import fp16_utils as jfp
from apex_tpu.optimizers import fused_adam
from apex_tpu_torch import fp16_utils as fp
from apex_tpu_torch.optimizers import FusedAdam
from apex_tpu_torch.utils.pytree import tree_leaves

RTOL, ATOL, OF_LARGEST = 1e-6, 1e-9, 1e-6


def _gpt():
    from apex_tpu.models.gpt import GPTConfig as JC
    from apex_tpu.models.gpt import GPTModel as JM
    from apex_tpu_torch.models.convert import params_from_jax, params_to_jax
    from apex_tpu_torch.models.gpt import GPTConfig

    kw = dict(vocab_size=64, max_seq_len=16, hidden_size=32, num_layers=2,
              num_heads=2)
    tree = JM(JC(**kw, tp_size=1)).init(jax.random.PRNGKey(0))
    cfg = GPTConfig(**kw)
    return tree, (lambda t: params_from_jax(t, cfg, device="cpu"),
                  lambda p: params_to_jax(p, cfg))


def _bert():
    from apex_tpu.models.bert import BertConfig as JC
    from apex_tpu.models.bert import BertModel as JM
    from apex_tpu_torch.models.bert import BertConfig
    from apex_tpu_torch.models.convert import (bert_params_from_jax,
                                               bert_params_to_jax)

    kw = dict(vocab_size=64, max_seq_len=16, hidden_size=32, num_layers=2,
              num_heads=2)
    tree = JM(JC(**kw)).init(jax.random.PRNGKey(0))
    cfg = BertConfig(**kw)
    return tree, (lambda t: bert_params_from_jax(t, cfg, device="cpu"),
                  lambda p: bert_params_to_jax(p, cfg))


def _t5():
    from apex_tpu.models.t5 import EncoderDecoderModel as JM
    from apex_tpu.models.t5 import T5Config as JC
    from apex_tpu_torch.models.convert import (t5_params_from_jax,
                                               t5_params_to_jax)
    from apex_tpu_torch.models.t5 import T5Config

    kw = dict(vocab_size=64, max_seq_len=16, hidden_size=32,
              num_encoder_layers=2, num_decoder_layers=2, num_heads=2,
              relative_num_buckets=8, relative_max_distance=16)
    tree = JM(JC(**kw)).init(jax.random.PRNGKey(0))
    cfg = T5Config(**kw)
    return tree, (lambda t: t5_params_from_jax(t, cfg, device="cpu"),
                  lambda p: t5_params_to_jax(p, cfg))


@pytest.mark.parametrize("model", [_gpt, _bert, _t5],
                         ids=["gpt", "bert", "t5"])
def test_convert_network_exemptions_match_reference(model):
    jtree, (to_port, to_ref) = model()
    want = jfp.convert_network(jtree, jnp.float16)
    tree = jax.tree.map(np.asarray, jtree)
    got = to_ref(fp.convert_network(to_port(tree), torch.float16))
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert len(flat_g) == len(flat_w)
    kept = 0
    for path, w in flat_w:
        g = flat_g[path]
        where = jax.tree_util.keystr(path)
        assert np.dtype(g.dtype) == np.dtype(w.dtype), where
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=where)
        kept += w.dtype == jnp.float32
    assert 0 < kept < len(flat_w)  # the norms stay fp32, the rest is cast


def test_network_to_half_and_fp16_model():
    w = torch.randn(4, 3, requires_grad=True)
    tree = {"w": w, "ln_w": torch.ones(3), "ids": torch.arange(3),
            "layers": [{"bn_scale": torch.ones(2)}]}
    half = fp.network_to_half(tree)
    assert all(t.dtype == torch.bfloat16 for t in tree_leaves(half)
               if t.is_floating_point())
    assert half["ids"] is tree["ids"] and half["w"].requires_grad
    assert half["w"].is_leaf
    seen = {}

    def apply_fn(params, x, ids, *, y):
        seen.update(params=params, x=x.dtype, ids=ids.dtype, y=y.dtype)
        return x

    model = fp.FP16Model(apply_fn, tree, dtype=torch.float16)
    model(torch.ones(2), torch.arange(2), y=torch.ones(1, dtype=torch.float64))
    assert seen["x"] == seen["y"] == torch.float16
    assert seen["ids"] == torch.int64
    assert seen["params"]["w"].dtype == torch.float16
    assert seen["params"]["ln_w"].dtype == torch.float32
    assert seen["params"]["layers"][0]["bn_scale"].dtype == torch.float32


def test_master_helpers_match_reference():
    tree = H.init_params()
    jt = jax.tree.map(lambda a: jnp.asarray(a).astype(jnp.float16), tree)
    pt = H.to_torch(tree, torch.float16)
    model, master = fp.prep_param_lists(pt)
    jmodel, jmaster = jfp.prep_param_lists(jt)
    assert model is pt
    H.assert_close_leaves(tree_leaves(master), jax.tree.leaves(jmaster), 0,
                          0)
    assert all(m.dtype == torch.float32 for m in tree_leaves(master))
    for m in tree_leaves(master):
        m.mul_(1.5)
    fp.master_params_to_model_params(model, master)
    want = jfp.master_params_to_model_params(
        jmodel, jax.tree.map(lambda x: x * 1.5, jmaster))
    H.assert_close_leaves(tree_leaves(model), jax.tree.leaves(want), 0, 0)
    grads = fp.model_grads_to_master_grads(pt)
    assert all(g.dtype == torch.float32 for g in tree_leaves(grads))
    assert fp.to_python_float(torch.tensor(2.5)) == 2.5
    assert fp.to_python_float(np.float32(0.5)) == 0.5


def test_loss_scalers_match_reference():
    for cls, jcls, kw in ((fp.LossScaler, jfp.LossScaler, dict(scale=8.0)),
                          (fp.DynamicLossScaler, jfp.DynamicLossScaler,
                           dict(init_scale=4.0, scale_window=3))):
        s, js = cls(**kw), jcls(**kw)
        for overflow in (False, False, False, True, True, True, True, False,
                         False, False, False):
            s.update_scale(overflow)
            js.update_scale(overflow)
            assert s.loss_scale == js.loss_scale
        assert s.loss_scale >= 1.0
        g = {"a": torch.tensor([1.0, float("inf")])}
        assert s.has_overflow(g) == (cls is fp.DynamicLossScaler)
        assert not s.has_overflow({"a": torch.ones(2)})
    s = fp.DynamicLossScaler(init_scale=2.0)
    for _ in range(3):
        s.update_scale(True)
    assert s.loss_scale == 1.0  # never below 1


def _fp16_run(steps, clip=None, inf_at=(), scale_window=2):
    """Both FP16_Optimizers over Adam on the fp16 harness tree; step i's
    gradient is the harness's scaled by the current loss scale, in fp16
    (an inf in one entry at the steps ``inf_at``)."""
    kw = dict(dynamic_loss_scale=True,
              dynamic_loss_args={"init_scale": 2.0 ** 10,
                                 "scale_window": scale_window})
    tree = H.init_params()
    jt = jax.tree.map(lambda a: jnp.asarray(a).astype(jnp.float16), tree)
    jopt = jfp.FP16_Optimizer(fused_adam(learning_rate=1e-3), jt, **kw)
    pt = H.to_torch(tree, torch.float16, grad=True)
    leaves = tree_leaves(pt)
    opt = fp.FP16_Optimizer(FusedAdam(leaves, lr=1e-3), **kw)
    trail = []
    for i in range(steps):
        scale = opt.loss_scale
        assert scale == jopt.loss_scale
        g = jax.tree.map(lambda a: (a * scale).astype(np.float16),
                         H.grads(i))
        if i in inf_at:
            g["w"][3, 4] = np.inf
        jopt.step(jax.tree.map(jnp.asarray, g), clip_grad_norm=clip)
        for t, a in zip(leaves, jax.tree.leaves(g)):
            t.grad = torch.tensor(a)
        before = ([m.clone() for m in opt.master_params],
                  [t.detach().clone() for t in leaves],
                  copy.deepcopy(opt.optimizer.state_dict()["state"]))
        opt.step(clip_grad_norm=clip)
        opt.zero_grad()
        assert opt.overflow == jopt.overflow == (i in inf_at)
        trail.append((opt.overflow, opt.loss_scale))
        if opt.overflow:  # nothing touched
            for a, b in zip(before[0], opt.master_params):
                assert torch.equal(a, b)
            for a, b in zip(before[1], leaves):
                assert torch.equal(a, b)
            after = opt.optimizer.state_dict()["state"]
            assert before[2].keys() == after.keys()
            for k in after:
                assert before[2][k]["step"] == after[k]["step"]
                for name in ("exp_avg", "exp_avg_sq"):
                    assert torch.equal(before[2][k][name], after[k][name])
        H.assert_close_leaves(opt.master_params,
                              jax.tree.leaves(jopt.master_params), RTOL,
                              ATOL, f"master, step {i}", OF_LARGEST)
        H.assert_bf16_leaves(leaves, jax.tree.leaves(jopt.model_params),
                             f"model, step {i}", mantissa_bits=10)
    return opt, jopt, pt, trail


def test_fp16_optimizer_matches_reference_with_a_skipped_step():
    _, _, _, trail = _fp16_run(7, inf_at=(3,))
    # clean, clean: x2; an overflow: /2; then two clean: x2
    assert trail == [(False, 1024.0), (False, 2048.0), (False, 2048.0),
                     (True, 1024.0), (False, 1024.0), (False, 2048.0),
                     (False, 2048.0)]


def test_fp16_optimizer_clip_matches_reference():
    opt, jopt, _, _ = _fp16_run(3, clip=1.0)
    g = [torch.full((3,), 3.0), torch.full((4,), 4.0)]
    holder = [torch.zeros(3, requires_grad=True),
              torch.zeros(4, requires_grad=True)]
    wrapped = fp.FP16_Optimizer(FusedAdam(holder))
    for m, x in zip(wrapped.master_params, g):
        m.grad = x.clone()
    gnorm = wrapped.clip_master_grads(1.0)
    want = jopt.clip_master_grads(1.0, [jnp.asarray(x.numpy()) for x in g])
    assert float(gnorm) == pytest.approx(float(np.sqrt(27 + 64)), rel=1e-6)
    for m, w in zip(wrapped.master_params, want):
        np.testing.assert_allclose(m.grad.numpy(), np.asarray(w), rtol=1e-6)


def test_fp16_optimizer_state_dict_round_trip():
    opt, _, pt, _ = _fp16_run(3, inf_at=(1,))
    sd = copy.deepcopy(opt.state_dict())
    assert sd["dynamic"] and sd["loss_scale"] == opt.loss_scale
    assert sd["unskipped"] == 1
    fresh = H.to_torch(H.init_params(seed=9), torch.float16, grad=True)
    leaves2 = tree_leaves(fresh)
    opt2 = fp.FP16_Optimizer(FusedAdam(leaves2, lr=1e-3),
                             dynamic_loss_scale=True,
                             dynamic_loss_args={"scale_window": 2})
    opt2.load_state_dict(sd)
    assert opt2.loss_scale == opt.loss_scale
    leaves = tree_leaves(pt)
    for a, b in zip(leaves, leaves2):
        assert torch.equal(a.detach(), b.detach())
    for o, ts in ((opt, leaves), (opt2, leaves2)):
        for t, a in zip(ts, jax.tree.leaves(H.grads(5))):
            t.grad = torch.tensor(a * o.loss_scale).half()
        o.step()
    for a, b in zip(leaves, leaves2):
        assert torch.equal(a.detach(), b.detach())
    for a, b in zip(opt.master_params, opt2.master_params):
        assert torch.equal(a, b)
    assert opt2.loss_scale == opt.loss_scale


def test_fp16_optimizer_fp32_tensors_are_their_own_masters():
    """A tensor left fp32 by convert_network (a norm's) is stepped in
    place: it is its own master."""
    h = torch.zeros(3, dtype=torch.float16, requires_grad=True)
    w = torch.ones(2, requires_grad=True)
    opt = fp.FP16_Optimizer(FusedAdam([h, w], lr=0.1), static_loss_scale=4.0)
    assert opt.master_params[1] is w
    assert opt.master_params[0].dtype == torch.float32
    assert opt.optimizer.param_groups[0]["params"][0] is opt.master_params[0]
    h.grad = torch.full((3,), 4.0, dtype=torch.float16)
    w.grad = torch.full((2,), -4.0)
    opt.step()
    assert not opt.overflow and opt.loss_scale == 4.0
    assert (h < 0).all() and (w > 1).all()
    torch.testing.assert_close(h.float(), opt.master_params[0].half().float())
