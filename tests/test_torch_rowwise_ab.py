"""The A/B helpers for the row-wise kernels, on the CPU: the ``-Xptxas -v``
log reader of ``apex_tpu_torch/tools/rowwise_ab.py``, its library swap,
and ``chip_smoke.py``'s lookup of one kernel instance in the report (by
its demangled name, or its mangled one where ``c++filt`` is missing)."""

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
