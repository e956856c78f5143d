"""Port parity: inference.jit_encoder (BERT's encoder-serving entry)
against apex_tpu's, on the same weights (through the bridge) and the same
inputs.

The reference's small BERT (``tests/test_inference.py:213``), both
attention routes, with and without a pad mask and token types: hidden
states and pooler within 1e-5 of the reference's (fp32 on the CPU; the
reference's flash route runs its XLA path there). The encoder runs on the
card by default and on the CPU only when asked, under
``torch.inference_mode()``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.inference.engine import jit_encoder as jjit_encoder
from apex_tpu.models.bert import BertConfig as JBertConfig
from apex_tpu.models.bert import BertModel as JBertModel
from apex_tpu_torch.inference import jit_encoder
from apex_tpu_torch.models.bert import BertConfig, BertModel
from apex_tpu_torch.models.convert import bert_params_from_jax

TOL = dict(rtol=1e-5, atol=1e-5)
SMALL = dict(vocab_size=50, max_seq_len=32, hidden_size=32, num_layers=2,
             num_heads=4, remat=False)


@pytest.fixture(scope="module", params=["softmax", "flash"])
def berts(request):
    jm = JBertModel(JBertConfig(**SMALL, attention_impl=request.param))
    jp = jm.init(jax.random.PRNGKey(8))
    # non-zero biases and LN affines, so every leaf of the bridge matters
    rng = np.random.default_rng(1)
    np_tree = jax.tree.map(lambda a: np.asarray(a) + 0.02 * rng.standard_normal(
        a.shape).astype(np.float32), jp)
    tm = BertModel(BertConfig(**SMALL, attention_impl=request.param))
    return (jm, jax.tree.map(jnp.asarray, np_tree), tm,
            bert_params_from_jax(np_tree, tm.config, device="cpu"))


def _inputs(b=3, s=16, seed=9):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, 50, (b, s)).astype(np.int32)
    types = rng.integers(0, 2, (b, s)).astype(np.int32)
    lens = np.array([s, 11, 4])[:b]
    pad = np.arange(s)[None, :] >= lens[:, None]  # suffix padding
    return toks, types, pad


@pytest.mark.parametrize("with_types", [False, True])
@pytest.mark.parametrize("with_pad", [False, True])
@pytest.mark.parametrize("with_pooler", [True, False])
def test_encoder_matches_reference(berts, with_types, with_pad,
                                   with_pooler):
    jm, jp, tm, tp = berts
    toks, types, pad = _inputs()
    kw_j = dict(token_types=jnp.asarray(types) if with_types else None,
                pad_mask=jnp.asarray(pad) if with_pad else None)
    want_h, want_p = jjit_encoder(jm, with_pooler=with_pooler)(
        jp, jnp.asarray(toks), **kw_j)
    encode = jit_encoder(tm, with_pooler=with_pooler, device="cpu")
    # numpy inputs are taken as they come (moved onto the params' device)
    h, p = encode(tp, toks, token_types=types if with_types else None,
                  pad_mask=pad if with_pad else None)
    assert h.shape == (3, 16, 32) and h.dtype == torch.float32
    np.testing.assert_allclose(h.numpy(), np.asarray(want_h), **TOL)
    if with_pooler:
        assert p.shape == (3, 32)
        np.testing.assert_allclose(p.numpy(), np.asarray(want_p), **TOL)
    else:
        assert p is None and want_p is None
    # no autograd state rides along
    assert h.is_inference() and not h.requires_grad


def test_encoder_equals_the_models_forward(berts):
    _, _, tm, tp = berts
    toks, types, pad = _inputs(seed=3)
    t = [torch.from_numpy(x) for x in (toks, types, pad)]
    h, p = jit_encoder(tm, device="cpu")(tp, *t)
    with torch.no_grad():
        want = tm.hidden_states(tp, t[0], token_types=t[1], pad_mask=t[2])
    assert torch.equal(h, want)
    assert torch.equal(p, tm.pooled(tp, want))


def test_encoder_runs_on_the_card_by_default(berts, monkeypatch):
    _, _, tm, tp = berts
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        jit_encoder(tm)
    # params elsewhere than the encoder's device are refused, not moved
    meta = {k: v for k, v in tp.items()}
    meta["embedding"] = {"weight": torch.empty(
        tp["embedding"]["weight"].shape, device="meta")}
    with pytest.raises(ValueError, match="meta"):
        jit_encoder(tm, device="cpu")(meta, torch.zeros((1, 4), dtype=
                                                        torch.int32))
