"""The row-wise and decode kernels of another checkout, for timing in turns.

Builds a second checkout's ``layer_norm.cu``, ``softmax.cu`` and
``paged_decode_attn.cu`` (with its own headers and ``errors.cu``) into a
library of their own, loads it with ``ctypes``, and runs the port's
wrappers through it inside :func:`using` — the wrappers look the library
up on every call, so the same Python code launches either tree's kernels:

    from apex_tpu_torch.tools import rowwise_ab
    lib = rowwise_ab.other_library("/path/to/parent/checkout")
    with rowwise_ab.using(lib):
        ln_bwd_cuda(...)          # the other checkout's apex_ln_bwd

``chip_smoke.py --parent DIR`` times ``ln_bwd``, ``softmax_fwd`` and the
two decode kernels so, against a ``git archive`` of the parent commit
unpacked into a directory that ``.gitignore`` lists. The row-wise entry
points must have the signatures of this tree's ``_build.ENTRY_POINTS``;
the decode entries have the parent's own (:data:`PARENT_DECODE_ENTRY_POINTS`:
no launch plan, and rows-long lengths for the contiguous one), and
:func:`parent_decode_attn` and :func:`parent_paged_decode_attn` launch
them as the parent's wrappers did. Needs ``nvcc``.

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
           "errors.cu")
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: the parent commit's decode entries: one CTA a row, no plan arguments
PARENT_DECODE_ENTRY_POINTS = {
    # q, k_pool, v_pool, tables, lengths (b,), out, dtype, b, h_kv, group,
    # d, bs, nb, scale, stream
    "apex_paged_decode_attn": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                               _I, _I, _F, _P],
    # q, k, v, lengths (rows,), out, dtype, rows, group, d, max_s, scale,
    # stream
    "apex_decode_attn": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
}


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
    for name, argtypes in PARENT_DECODE_ENTRY_POINTS.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.apex_cuda_error_string.argtypes = [ctypes.c_int]
    lib.apex_cuda_error_string.restype = ctypes.c_char_p
    return lib, log


def _stream(t):
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


def parent_paged_decode_attn(lib, q, k_pool, v_pool, lengths, block_tables,
                             scale):
    """The parent's paged decode kernel on the tree wrapper's operands
    (q (b·h_kv, group, d), int32 lengths and tables), as its wrapper
    launched it."""
    import torch

    from apex_tpu_torch.ops.decode_attention import _DTYPE_CODES

    rows, group, d = q.shape
    _, h_kv, bs, _ = k_pool.shape
    b, nb = block_tables.shape
    out = torch.empty_like(q)
    rc = lib.apex_paged_decode_attn(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        _DTYPE_CODES[q.dtype], b, h_kv, group, d, bs, nb, float(scale),
        _stream(q))
    if rc:
        raise RuntimeError(f"the parent's paged decode kernel: CUDA error "
                           f"{rc}")
    return out


def parent_decode_attn(lib, q, k, v, row_lengths, scale):
    """The parent's contiguous decode kernel: q (rows, group, d), k/v
    (rows, max_s, d), ``row_lengths`` (rows,) int32 — the per-batch
    lengths repeated over kv heads, as its wrapper made them."""
    import torch

    from apex_tpu_torch.ops.decode_attention import _DTYPE_CODES

    rows, group, d = q.shape
    out = torch.empty_like(q)
    rc = lib.apex_decode_attn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), row_lengths.data_ptr(),
        out.data_ptr(), _DTYPE_CODES[q.dtype], rows, group, d, k.shape[1],
        float(scale), _stream(q))
    if rc:
        raise RuntimeError(f"the parent's decode kernel: CUDA error {rc}")
    return out


def parent_decode_attention(lib, q, k, v, lengths):
    """What the parent's ``decode_attention`` launched for a contiguous
    cache: q (b, h, d), k/v (b, h_kv, max_s, d), lengths (b,) int32 — the
    ``repeat_interleave`` of the lengths over kv heads, then its kernel."""
    b, h, d = q.shape
    h_kv, max_s = k.shape[1], k.shape[2]
    rows = b * h_kv
    out = parent_decode_attn(
        lib, q.reshape(rows, h // h_kv, d), k.reshape(rows, max_s, d),
        v.reshape(rows, max_s, d),
        lengths.repeat_interleave(h_kv).contiguous(), d ** -0.5)
    return out.reshape(b, h, d)


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
