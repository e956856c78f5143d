"""The A/B helpers for the row-wise, decode, sampling and verify kernels,
on the CPU: the ``-Xptxas -v`` log reader of ``apex_tpu_torch/tools/rowwise_ab.py``,
its library swap, the parent's signatures it binds, ``chip_smoke.py``'s
lookup of one kernel instance in the report (by its demangled name, or its
mangled one where ``c++filt`` is missing), and its turns (parent, this,
this, parent)."""

import importlib.util
import shutil
from pathlib import Path

import pytest

from apex_tpu_torch.ops import _build
from apex_tpu_torch.tools import rowwise_ab

_SPEC = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(chip_smoke)

LN = ("_ZN12_GLOBAL__N_113ln_bwd_kernelI13__nv_bfloat16Li1ELi3ELb1EEEvPKT_"
      "S4_PKfS6_PKvPS2_Pfiiibbb")
SM = ("_ZN12_GLOBAL__N_118softmax_fwd_kernelIfLi16ELi1ELi2EEEvPKT_PS2_NS_8"
      "MaskViewEiiifi")
LOG = f"""== layer_norm.cu (rc 0)
ptxas info    : Compiling entry function '{LN}' for 'sm_90a'
ptxas info    : Function properties for {LN}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 64 registers, used 6 barriers, 432 bytes cmem[0]
ptxas info    : Compiling entry function '{SM}' for 'sm_90a'
ptxas info    : Function properties for {SM}
    24 bytes stack frame, 16 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 255 registers, 420 bytes cmem[0]
"""


@pytest.mark.parametrize("demangle", [True, False])
def test_ptxas_report_reads_registers_and_spills(monkeypatch, demangle):
    if not demangle or shutil.which("c++filt") is None:
        monkeypatch.setattr(rowwise_ab.shutil, "which", lambda name: None)
    rep = rowwise_ab.ptxas_report(LOG)
    assert sorted(v["registers"] for v in rep.values()) == [64, 255]
    monkeypatch.setattr(chip_smoke, "PTXAS", rep)
    ln = chip_smoke.ptxas_of("ln_bwd_kernel",
                             ("__nv_bfloat16", "1", "3", "true"))
    assert ln["registers"] == 64 and ln["spill_stores"] == 0
    assert ln["kernel"] == "ln_bwd_kernel<__nv_bfloat16, 1, 3, true>"
    sm = chip_smoke.ptxas_of("softmax_fwd_kernel", ("float", "16", "1", "2"))
    assert (sm["stack"], sm["spill_stores"], sm["spill_loads"]) == (24, 16, 8)
    assert chip_smoke.ptxas_of("ln_bwd_kernel",
                               ("__nv_bfloat16", "1", "4", "true")) is None


def test_using_swaps_the_library_and_restores_it():
    before = _build.library
    sentinel = object()
    with rowwise_ab.using(sentinel):
        assert _build.library() is sentinel
    assert _build.library is before
    with pytest.raises(KeyError):
        with rowwise_ab.using(sentinel):
            raise KeyError("inside")
    assert _build.library is before


def test_other_library_builds_the_decode_kernels_with_the_parents_signatures():
    """The parent builds the decode, sampling and verify kernels too. Its
    decode, sampling and layer-norm entries take this tree's signatures
    (18, 16 and 19 arguments); the entries this tree changed keep the
    parent's own: ``apex_fused_verify`` and ``apex_fused_verify_tree``
    without a launch plan and a workspace (14 and 17 arguments, where this
    tree's take 22 and 25)."""
    assert {"paged_decode_attn.cu", "fused_sample.cu", "layer_norm.cu",
            "fused_verify.cu"} <= set(rowwise_ab.SOURCES)
    parent = rowwise_ab.PARENT_ENTRY_POINTS
    assert set(parent) == {"apex_fused_verify", "apex_fused_verify_tree"}
    assert len(parent["apex_fused_verify"]) == 14
    assert len(parent["apex_fused_verify_tree"]) == 17
    assert len(_build.ENTRY_POINTS["apex_fused_verify"]) == 22
    assert len(_build.ENTRY_POINTS["apex_fused_verify_tree"]) == 25
    assert len(_build.ENTRY_POINTS["apex_ln_fwd"]) == 19
    assert len(_build.ENTRY_POINTS["apex_fused_sample"]) == 16
    assert len(_build.ENTRY_POINTS["apex_paged_decode_attn"]) == 18
    assert len(_build.ENTRY_POINTS["apex_decode_attn"]) == 16


@pytest.mark.parametrize("parent_fn", [False, True])
def test_parent_turns_alternate_and_reach_the_parent(monkeypatch, parent_fn):
    """Turns run parent, this, this, parent; the parent's run either this
    tree's function on the parent's library or ``parent_fn(library,
    ...)``."""
    lib = object()
    turns = []

    def fake_time(fn, arg_sets, reps=20, trials=11):
        fn(*arg_sets[0])
        return float(len(turns))

    def fn(x):
        turns.append("parent" if _build.library() is lib else "this")

    def pfn(library, x):
        assert library is lib
        turns.append("parent")

    monkeypatch.setattr(chip_smoke, "time_ms", fake_time)
    monkeypatch.setattr(_build, "library", lambda: "this tree")
    monkeypatch.setattr(chip_smoke, "PARENT", (lib, ""))
    ms, parent_ms = chip_smoke.parent_turns(
        None, fn, [(1,)], parent_fn=pfn if parent_fn else None)
    assert turns == ["parent", "this", "this", "parent"]
    assert (ms, parent_ms) == ((2 + 3) / 2, (1 + 4) / 2)
    monkeypatch.setattr(chip_smoke, "PARENT", None)
    assert chip_smoke.parent_turns(None, fn, [(1,)])[1] is None


def test_empty_library_edits_find_their_lines():
    """The early returns of ``empty_library`` follow a line each source
    still has, once, inside the kernel it empties."""
    for name, (after, line) in rowwise_ab.EMPTY_EDITS.items():
        text = (_build.CSRC_DIR / name).read_text()
        assert text.count(after) == 1, name
        assert line.strip().startswith("if (") and "return;" in line
