"""The row-wise, decode, sampling and verify kernels of another checkout,
for timing in turns.

Builds a second checkout's ``layer_norm.cu``, ``softmax.cu``,
``paged_decode_attn.cu``, ``fused_sample.cu`` and ``fused_verify.cu``
(with its own headers and ``errors.cu``) into a library of their own, loads it with ``ctypes``, and
runs the port's wrappers through it inside :func:`using` — the wrappers
look the library up on every call, so the same Python code launches either
tree's kernels:

    from apex_tpu_torch.tools import rowwise_ab
    lib = rowwise_ab.other_library("/path/to/parent/checkout")
    with rowwise_ab.using(lib):
        ln_bwd_cuda(...)          # the other checkout's apex_ln_bwd

``chip_smoke.py --parent DIR`` times ``ln_fwd``, ``ln_bwd``,
``softmax_fwd``, the two decode kernels, ``fused_sample`` and the two
verify kernels so, against a ``git archive`` of the parent commit unpacked
into a directory that ``.gitignore`` lists. The entry points take the
signatures of this tree's ``_build.ENTRY_POINTS``, except those this tree
changed (:data:`PARENT_ENTRY_POINTS`): the parent's ``apex_softmax_bwd``
takes no mask, and :func:`parent_softmax_bwd` launches it as the parent's
wrapper did. Needs ``nvcc``.

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

SOURCES = ("layer_norm.cu", "softmax.cu", "paged_decode_attn.cu",
           "fused_sample.cu", "fused_verify.cu", "errors.cu")
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: the parent commit's entries whose signatures this tree changed
PARENT_ENTRY_POINTS = {
    # dy, y, dx, dtype, rows, n, scale, stream: not told the mask
    "apex_softmax_bwd": [_P, _P, _P, _I, _I, _I, _F, _P],
}


def other_library(root) -> Tuple[ctypes.CDLL, str]:
    """Build ``root``'s row-wise, decode and sampling kernels with this
    tree's flags into ``_build/other_<digest>/`` and load them: (library,
    ptxas log)."""
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
    for name, argtypes in {**_build.ENTRY_POINTS,
                           **PARENT_ENTRY_POINTS}.items():
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    lib.apex_cuda_error_string.argtypes = [ctypes.c_int]
    lib.apex_cuda_error_string.restype = ctypes.c_char_p
    return lib, log


#: the edits that make this tree's ln_fwd, sampling and verify kernels
#: return at once, for the fixed cost of a launch at a plan's grid and
#: clusters: source -> (the line the early return follows, the early
#: return)
EMPTY_EDITS = {
    "layer_norm.cu": ("  constexpr int D = fwd_depth(C);\n",
                      "  if (rows > 0) return;\n"),
    "fused_sample.cu": ("  constexpr bool kKeepMass = P <= 16;\n",
                        "  if (V > 0) return;\n"),
    "fused_verify.cu": ("  __shared__ VerifyShared sh;\n",
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


def _stream(t):
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


def parent_softmax_bwd(lib, dy, y, scale):
    """The parent's softmax backward (every entry read, no mask) on the
    same operands, as its wrapper launched it: dx."""
    import torch

    from apex_tpu_torch.ops.softmax import _DTYPE_CODES

    sk = y.shape[-1]
    dx = torch.empty_like(y)
    rc = lib.apex_softmax_bwd(dy.data_ptr(), y.data_ptr(), dx.data_ptr(),
                              _DTYPE_CODES[y.dtype], y.numel() // sk, sk,
                              float(scale), _stream(y))
    if rc:
        raise RuntimeError(f"the parent's softmax backward: CUDA error {rc}")
    return dx


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
