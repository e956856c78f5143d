"""The row-wise kernels of another checkout, for timing in turns.

Builds a second checkout's ``layer_norm.cu`` and ``softmax.cu`` (with its
own headers and ``errors.cu``) into a library of their own, loads it with
``ctypes``, and runs the port's wrappers through it inside
:func:`using` — the wrappers look the library up on every call, so the
same Python code launches either tree's kernels:

    from apex_tpu_torch.tools import rowwise_ab
    lib = rowwise_ab.other_library("/path/to/parent/checkout")
    with rowwise_ab.using(lib):
        ln_bwd_cuda(...)          # the other checkout's apex_ln_bwd

``chip_smoke.py --parent DIR`` times ``ln_bwd`` and ``softmax_fwd`` so,
against a ``git archive`` of the parent commit unpacked into a directory
that ``.gitignore`` lists. The C entry points of the two files must have
the signatures of this tree's ``_build.ENTRY_POINTS``. Needs ``nvcc``.

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

SOURCES = ("layer_norm.cu", "softmax.cu", "errors.cu")


def other_library(root) -> Tuple[ctypes.CDLL, str]:
    """Build ``root``'s row-wise kernels with this tree's flags into
    ``_build/other_<digest>/`` and load them: (library, ptxas log)."""
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
    log, failed = _build.compile_library([csrc / src for src in SOURCES],
                                         csrc, lib_path)
    if failed:
        raise RuntimeError(f"building {csrc}'s {', '.join(failed)} "
                           f"failed:\n{log}")
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in _build.ENTRY_POINTS.items():
        if name.startswith(("apex_ln_", "apex_softmax_")) \
                and hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    lib.apex_cuda_error_string.argtypes = [ctypes.c_int]
    lib.apex_cuda_error_string.restype = ctypes.c_char_p
    return lib, log


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
