"""matmul_bias_act's launch plan (``apex_tpu_torch/ops/matmul.py::_plan``),
on the CPU: which kernel variant each call takes, how far K is split, and
the split-K workspace.

The operands are built as ``chip_smoke.py``'s ``mm_operands`` builds them
(the views the fused-dense and MLP paths pass: ``weight.t()`` forward,
``weight`` dgrad, ``dy.t()`` wgrad) at every call its ``mm_calls()``
lists, the block leg's and the MLP leg's, with ``torch.empty``: the plan
reads dtypes, shapes, strides and alignment only. Every such call takes
the wgmma variant; the MLP's five weight gradients split K, the block's
products do not. Operands no tensor map can describe (a base off 16
bytes, a row stride that is no multiple of 8 elements) take the sm80
variant.
"""

import importlib.util
from pathlib import Path

import pytest
import torch

from apex_tpu_torch.ops import matmul as mmmod

_SPEC = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(chip_smoke)

CALLS = chip_smoke.mm_calls()
MLP_WGRADS = {f"mlp{i}_wgrad" for i in range(len(chip_smoke.MLP_SIZES) - 1)}
BF16 = torch.bfloat16


def _operands(M, K, N, layout, bias, dtype=BF16):
    """x (M, K), w (K, N) and the bias as ``mm_operands`` lays them out,
    uninitialised."""
    if layout == "fwd":
        x, w = torch.empty((M, K), dtype=dtype), torch.empty(
            (N, K), dtype=dtype).t()
    elif layout == "dgrad":
        x, w = torch.empty((M, K), dtype=dtype), torch.empty(
            (K, N), dtype=dtype)
    else:
        x, w = torch.empty((K, M), dtype=dtype).t(), torch.empty(
            (K, N), dtype=dtype)
    return x, w, torch.empty(N, dtype=dtype) if bias else None


@pytest.mark.parametrize("what", sorted(CALLS))
def test_every_leg_call_takes_wgmma(what):
    M, K, N, layout, bias, act = CALLS[what]
    x, w, b = _operands(M, K, N, layout, bias)
    plan = mmmod._plan(x, w, b, act)
    assert plan.variant == "wgmma"
    # the path's views are read as they are: no operand copied
    assert plan.a[0].data_ptr() == x.data_ptr()
    assert plan.b[0].data_ptr() == w.data_ptr()
    if what in MLP_WGRADS:
        assert plan.split > 1
        assert plan.workspace == (plan.split, M, N)
        steps = -(-K // mmmod.TILE_K)
        # every slice walks K steps, the last one too
        assert (plan.split - 1) * plan.kt_split < steps
        assert plan.split * plan.kt_split >= steps
        assert plan.kt_split >= mmmod.SPLIT_MIN_STEPS
    else:
        assert plan.split == 1 and plan.workspace is None


@pytest.mark.parametrize("what,split", [
    ("mlp0_wgrad", 4), ("mlp1_wgrad", 2), ("mlp2_wgrad", 4),
    ("mlp3_wgrad", 16), ("mlp4_wgrad", 64), ("block_wgrad_dw1", 1),
    ("block_wgrad_dw2", 1), ("block_fwd_up", 1), ("mlp1_dgrad", 1)])
def test_split_k_sizes_and_workspace(what, split):
    """S fills at most one CTA per SM of 132 (64 for the 1 x 256 gradient,
    capped by SPLIT_MAX); the workspace is S x M x N fp32 (8.4 MB at the
    1024 x 1024 gradient)."""
    M, K, N, layout, bias, act = CALLS[what]
    plan = mmmod._plan(*_operands(M, K, N, layout, bias), act)
    assert plan.split == split
    tiles = -(-M // mmmod.TILE_M) * -(-N // mmmod.TILE_N)
    assert tiles * plan.split <= mmmod.H100_SMS or split == 1
    if what == "mlp1_wgrad":
        ws = plan.workspace
        assert ws[0] * ws[1] * ws[2] * 4 == 2 * 1024 * 1024 * 4


def test_split_k_follows_the_card_s_sms():
    M, K, N, layout, bias, act = CALLS["mlp1_wgrad"]
    ops = _operands(M, K, N, layout, bias)
    assert mmmod._plan(*ops, act, sms=132).split == 2
    assert mmmod._plan(*ops, act, sms=256).split == 4
    assert mmmod._plan(*ops, act, sms=100).split == 1  # 64 tiles > 50


@pytest.mark.parametrize("M,K,N", [(1, 32768, 256), (300, 8192, 200),
                                   (128, 1000, 128), (64, 513, 64),
                                   (1000, 4096, 480)])
def test_split_k_never_leaves_a_slice_empty(M, K, N):
    split, per = mmmod._split(M, N, K, mmmod.H100_SMS)
    steps = -(-K // mmmod.TILE_K)
    assert (split - 1) * per < steps <= split * per
    assert split == 1 or per >= mmmod.SPLIT_MIN_STEPS


def test_shallow_k_or_many_tiles_do_not_split():
    assert mmmod._split(128, 128, 64 * 15, 132)[0] == 1  # < 2 slices of 8
    assert mmmod._split(128, 128, 64 * 16, 132)[0] == 2
    assert mmmod._split(128 * 67, 128, 32768, 132)[0] == 1  # 67 > 66 tiles


def test_base_off_16_bytes_takes_sm80():
    buf = torch.empty(300 * 256 + 8, dtype=BF16)
    x = buf[1:1 + 300 * 256].view(300, 256)  # 2 bytes off
    w = torch.empty((128, 256), dtype=BF16).t()
    assert x.data_ptr() % 16 != 0
    assert mmmod._plan(x, w).variant == "sm80"
    assert mmmod._plan(x, w).split == 1
    assert mmmod._plan(buf[8:8 + 300 * 256].view(300, 256),
                       w).variant == "wgmma"


def test_row_stride_of_7_takes_sm80():
    x = torch.empty((4096, 7), dtype=BF16)[:, :5]  # (4096, 5), row stride 7
    w = torch.empty((5, 64), dtype=BF16)
    assert x.stride() == (7, 1)
    plan = mmmod._plan(x, w)
    assert plan.variant == "sm80" and plan.workspace is None
    # the same product over rows of 8 elements: a tensor map describes it
    x8 = torch.empty((4096, 8), dtype=BF16)[:, :5]
    assert mmmod._plan(x8, w).variant == "wgmma"


def test_fp32_and_empty_k_plans():
    x, w, b = _operands(300, 200, 130, "fwd", True, torch.float32)
    assert mmmod._plan(x, w, b, "gelu").variant == "fp32"
    x, w, _ = _operands(4, 0, 9, "dgrad", False)
    assert mmmod._plan(x, w).variant == "sm80"  # an empty operand: no map


def test_epilogue_outside_the_forward_layout_copies_into_it():
    """The bf16 epilogues run in the forward layout only: a bias or an
    activation on the dgrad layout plans on K-contiguous copies."""
    x, w, b = _operands(256, 128, 256, "dgrad", True)
    w.copy_(torch.arange(w.numel()).view(w.shape))
    plan = mmmod._plan(x, w, b, "relu")
    assert plan.a[1] and plan.b[1]
    assert plan.b[0].data_ptr() != w.data_ptr()
    assert plan.variant == "wgmma"
    assert torch.equal(plan.b[0], w)


def test_forced_variant_and_split_are_checked():
    """The private launcher's overrides (the A/B timing and the kernel
    tests): sm80 takes any bf16 operand, wgmma only what a tensor map
    describes, a split only into non-empty slices of the wgmma variant."""
    x, w, _ = _operands(304, 8192, 200, "wgrad", False)
    plan = mmmod._plan(x, w)
    assert plan.variant == "wgmma" and plan.split == 16
    sm80 = mmmod._forced(plan, "sm80", None, 8192, 304, 200)
    assert (sm80.variant, sm80.split, sm80.workspace) == ("sm80", 1, None)
    one = mmmod._forced(plan, None, 1, 8192, 304, 200)
    assert (one.split, one.workspace) == (1, None)
    four = mmmod._forced(plan, None, 4, 8192, 304, 200)
    assert (four.split, four.kt_split, four.workspace) == (4, 32,
                                                           (4, 304, 200))
    with pytest.raises(ValueError, match="split"):
        mmmod._forced(plan, None, 200, 8192, 304, 200)  # 128 K steps
    with pytest.raises(ValueError, match="split"):
        mmmod._forced(plan, "sm80", 4, 8192, 304, 200)
    bad = mmmod._plan(torch.empty((64, 7), dtype=BF16)[:, :5],
                      torch.empty((5, 64), dtype=BF16))
    with pytest.raises(ValueError, match="tensor map"):
        mmmod._forced(bad, "wgmma", None, 5, 64, 64)
    fp32 = mmmod._plan(*_operands(8, 8, 8, "fwd", False, torch.float32))
    with pytest.raises(ValueError, match="variant"):
        mmmod._forced(fp32, "wgmma", None, 8, 8, 8)
