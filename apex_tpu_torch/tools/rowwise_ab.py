"""The row-wise, decode, sampling, verify, flash, cross-entropy and GEMM
kernels of another checkout, for timing in turns.

Builds a second checkout's ``layer_norm.cu``, ``layer_norm_wide.cu``,
``softmax.cu``, ``paged_decode_attn.cu``, ``fused_sample.cu``,
``fused_verify.cu``, the flash forward and backward pair
(``flash_attn_fwd.cu``, ``flash_attn_bwd.cu``, the sm80 and dropout files their entries reach),
``xent_stats.cu`` and ``matmul_bias_act.cu`` (with its own headers and
``errors.cu``) into a library of their own, loads it with ``ctypes``, and
runs the port's wrappers through it inside :func:`using` — the wrappers
look the library up on every call, so the same Python code launches either
tree's kernels:

    from apex_tpu_torch.tools import rowwise_ab
    lib = rowwise_ab.other_library("/path/to/parent/checkout")
    with rowwise_ab.using(lib):
        ln_bwd_cuda(...)          # the other checkout's apex_ln_bwd

``chip_smoke.py --parent DIR`` times ``ln_fwd``, ``ln_bwd``,
``softmax_fwd``, ``softmax_bwd``, the two decode kernels, ``fused_sample``,
the two verify kernels, the dropout-free flash forward, dQ and dK/dV and
``xent_stats`` so, against a ``git archive`` of the parent commit unpacked
into a directory that ``.gitignore`` lists, and compares every kernel's
registers and spills with the parent's (:func:`ptxas_changes`). The entry
points take the signatures of this tree's ``_build.ENTRY_POINTS``, except
those this tree changed (:data:`PARENT_ENTRY_POINTS`): the library
:func:`other_library` returns drops the arguments a listed entry lacks
(those just before its last, the options this tree's entries gained)
from its calls, refusing a call that sets one of them. Needs ``nvcc``.

:func:`empty_library` builds this tree's ``ln_fwd``, sampling and verify
kernels returning at once, for the fixed cost of a launch.

:func:`ptxas_report` reads a build log written with ``-Xptxas -v`` into
registers and spills per kernel.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Tuple

from apex_tpu_torch import nvcc_path
from apex_tpu_torch.ops import _build

SOURCES = ("layer_norm.cu", "layer_norm_wide.cu", "softmax.cu",
           "paged_decode_attn.cu", "fused_sample.cu", "fused_verify.cu",
           "flash_attn_fwd.cu", "flash_attn_fwd_sm80.cu",
           "flash_attn_fwd_dropout.cu", "flash_attn_bwd.cu", "flash_attn_bwd_sm80.cu",
           "flash_attn_bwd_dropout.cu", "xent_stats.cu",
           "matmul_bias_act.cu", "errors.cu")
#: the parent commit's entries whose signatures this tree changed, by
#: their argtypes there: the decode pair's quantized-pool and bias options
#: (k_scale, v_scale, kv_dtype, lut, maxd before the stream; lut, maxd),
#: their occupancy query's (kv_dtype, maxd before the count) and the bshd
#: flash forward's bucketed bias (lut, maxd, rel_off before the stream)
PARENT_ENTRY_POINTS: Dict[str, list] = {
    "apex_paged_decode_attn": (_build.ENTRY_POINTS["apex_paged_decode_attn"]
                               [:17] + [ctypes.c_void_p]),
    "apex_decode_attn": (_build.ENTRY_POINTS["apex_decode_attn"][:15]
                         + [ctypes.c_void_p]),
    "apex_decode_attn_clusters": (
        _build.ENTRY_POINTS["apex_decode_attn_clusters"][:8]
        + _build.ENTRY_POINTS["apex_decode_attn_clusters"][-1:]),
    "apex_flash_fwd_bshd": (_build.ENTRY_POINTS["apex_flash_fwd_bshd"][:26]
                            + [ctypes.c_void_p]),
}


class ParentLibrary:
    """The parent's library under this tree's entry signatures: calls of
    the entries in :data:`PARENT_ENTRY_POINTS` drop the arguments the
    parent does not take, those just before the last (a call that sets
    one, not None or 0 — an option the parent's kernels have not —
    raises); every other entry is the parent's."""

    def __init__(self, lib):
        self._lib = lib

    def __getattr__(self, name):
        fn = getattr(self._lib, name)
        if name not in PARENT_ENTRY_POINTS:
            return fn
        keep = len(PARENT_ENTRY_POINTS[name]) - 1

        def call(*args):
            if any(a not in (None, 0) for a in args[keep:-1]):
                raise ValueError(f"the parent's {name} has no such option: "
                                 f"{args[keep:-1]}")
            return fn(*args[:keep], args[-1])
        return call


def other_library(root) -> Tuple[ParentLibrary, str]:
    """Build ``root``'s row-wise, decode, sampling, verify, flash,
    cross-entropy and GEMM kernels with
    this tree's flags into ``_build/other_<digest>/`` and load them:
    (library under this tree's signatures, ptxas log)."""
    csrc = Path(root).resolve() / "apex_tpu_torch" / "csrc"
    h = hashlib.sha256(" ".join(_build.ARCH_FLAGS
                                + _build.COMPILE_FLAGS).encode())
    for path in sorted(csrc.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    out = _build.BUILD_DIR / f"other_{h.hexdigest()[:16]}"
    out.mkdir(parents=True, exist_ok=True)
    if nvcc_path() is None:
        raise RuntimeError("nvcc not found: the other checkout's kernels "
                           "are built from source")
    lib_path = out / "librowwise.so"
    # a checkout older than a source in SOURCES builds without it (the
    # flash dropout units came with the flash entries' dropout arguments)
    log, failed = _build.compile_library(
        [csrc / src for src in SOURCES if (csrc / src).exists()], csrc,
        lib_path)
    if failed:
        raise RuntimeError(f"building {csrc}'s {', '.join(failed)} "
                           f"failed:\n{log}")
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in {**_build.ENTRY_POINTS,
                           **PARENT_ENTRY_POINTS}.items():
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    lib.apex_cuda_error_string.argtypes = [ctypes.c_int]
    lib.apex_cuda_error_string.restype = ctypes.c_char_p
    return ParentLibrary(lib), log


#: the edits that make this tree's ln_fwd, sampling and verify kernels
#: return at once, for the fixed cost of a launch at a plan's grid and
#: clusters: source -> (the line the early return follows, the early
#: return)
EMPTY_EDITS = {
    "layer_norm.cu": ("  constexpr int D = fwd_depth(C);\n",
                      "  if (rows > 0) return;\n"),
    "fused_sample.cu": ("  constexpr bool kKeepMass = P <= 16;\n",
                        "  if (V > 0) return;\n"),
    "fused_verify.cu": ("  __shared__ VerifyShared<kTopP> sh;\n",
                        "  if (V > 0) return;\n"),
}


def empty_library() -> ctypes.CDLL:
    """This tree's ``layer_norm.cu``, ``fused_sample.cu`` and
    ``fused_verify.cu`` with
    :data:`EMPTY_EDITS` applied to a copy under ``_build/`` (never to the
    sources), built and loaded with this tree's entry points: the same
    launches (grid, clusters, checks) doing no work."""
    csrc = _build.CSRC_DIR
    out = _build.BUILD_DIR / f"empty_{_build._digest()}"
    if out.exists():
        shutil.rmtree(out)
    shutil.copytree(csrc, out)
    for name, (after, line) in EMPTY_EDITS.items():
        text = (out / name).read_text()
        if after not in text:
            raise RuntimeError(f"{name} no longer has the line the empty "
                               f"launch's return follows: {after!r}")
        (out / name).write_text(text.replace(after, after + line, 1))
    lib_path = out / "libempty.so"
    log, failed = _build.compile_library(
        [out / name for name in (*EMPTY_EDITS, "errors.cu")], out, lib_path)
    if failed:
        raise RuntimeError(f"building the empty kernels failed:\n{log}")
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in _build.ENTRY_POINTS.items():
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    lib.apex_cuda_error_string.argtypes = [ctypes.c_int]
    lib.apex_cuda_error_string.restype = ctypes.c_char_p
    return lib


@contextlib.contextmanager
def using(lib: ctypes.CDLL):
    """Run the port's wrappers on ``lib`` inside the block."""
    saved = _build.library
    _build.library = lambda: lib
    try:
        yield lib
    finally:
        _build.library = saved


_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_SPILL = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                    r"(\d+) bytes spill loads")
_REGS = re.compile(r"Used (\d+) registers")


def _demangle(names):
    tool = shutil.which("c++filt")
    if tool is None or not names:
        return {n: n for n in names}
    out = subprocess.run([tool], input="\n".join(names), text=True,
                         capture_output=True).stdout.splitlines()
    return dict(zip(names, out)) if len(out) == len(names) else \
        {n: n for n in names}


def ptxas_report(log: str) -> Dict[str, Dict[str, int]]:
    """Each kernel of a ``-Xptxas -v`` log (demangled where ``c++filt``
    is found): registers, stack frame and spill bytes."""
    found, current = {}, None
    for line in log.splitlines():
        m = _ENTRY.search(line)
        if m:
            current = m.group(1)
            found[current] = {}
            continue
        if current is None:
            continue
        m = _SPILL.search(line)
        if m:
            found[current].update(stack=int(m.group(1)),
                                  spill_stores=int(m.group(2)),
                                  spill_loads=int(m.group(3)))
        m = _REGS.search(line)
        if m:
            found[current]["registers"] = int(m.group(1))
    names = _demangle(list(found))
    return {names[k]: v for k, v in found.items()}


def kernel_key(name: str) -> str:
    """A demangled kernel's name without its namespace, return type and
    parameter list, and with the template arguments a body gained for its
    fp16 instances dropped at their bf16 values (``, __nv_bfloat16, 0>``:
    the flash bodies' element type and planted fault; ``<__nv_bfloat16>``:
    the norms' reduction's parameter type): the key under which a bf16
    instance meets its parent's kernel."""
    base = name.replace("(anonymous namespace)::", "").split("(", 1)[0]
    base = base[5:] if base.startswith("void ") else base  # templates'
    for tail, repl in ((", __nv_bfloat16, 0>", ">"),
                       ("<__nv_bfloat16>", "")):
        base = base.replace(tail, repl)
    return base


def ptxas_changes(this: Dict[str, Dict[str, int]],
                  parent: Dict[str, Dict[str, int]]) -> dict:
    """Every parent kernel (by :func:`kernel_key`) against this tree's:
    how many were compared, those whose registers or spills differ, and
    those this tree lacks."""
    mine = {kernel_key(k): v for k, v in this.items()}
    keys = ("registers", "spill_stores", "spill_loads")
    changed, missing, compared = [], [], 0
    for name, want in parent.items():
        got = mine.get(kernel_key(name))
        if got is None:
            missing.append(name)
            continue
        compared += 1
        if any(got.get(k) != want.get(k) for k in keys):
            changed.append({"kernel": kernel_key(name),
                            "this": {k: got.get(k) for k in keys},
                            "parent": {k: want.get(k) for k in keys}})
    return {"compared": compared, "changed": changed, "missing": missing}
